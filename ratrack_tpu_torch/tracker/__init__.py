"""DBSCAN, log-Sinkhorn optimal transport, association and track state;
FLOT's unbalanced transport."""

from .dbscan import compact_dbscan, dbscan
from .sinkhorn import log_optimal_transport_masked, unbalanced_transport_flow
from .state import TrackState, init_state, reset_where, DESC_DIM
from .association import (cluster_descriptors, greedy_gt_match, associate,
                          AssocResult, MatchStructure, match_structure,
                          assign_ids)

__all__ = [
    "dbscan", "compact_dbscan", "log_optimal_transport_masked",
    "unbalanced_transport_flow",
    "TrackState", "init_state", "reset_where", "DESC_DIM", "cluster_descriptors", "greedy_gt_match",
    "associate", "AssocResult", "MatchStructure", "match_structure",
    "assign_ids",
]
