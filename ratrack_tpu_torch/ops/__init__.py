"""Point ops and the kernel wrappers (eval B1-B3, train B9 and B10,
stretch B4-B7, FLOT's transport B11)."""

from .neighborhood import (square_distance, point_distance, knn, knn_auto,
                           ball_query, three_nn)
from .sampling import (identity_sample, identity_gather, gather,
                       furthest_point_sample,
                       furthest_point_sample_reference)
from .morton import morton_code, morton_perm, invert_perm
from .grouping import group, three_interpolate, three_interpolate_weights
from .fused_sa import fused_sa_pair, sa_pair, sa_pair_reference
from .fused_fp import fused_three_interpolate, three_interpolate_reference
from .fused_correlator import (fused_knn_weight_aggregate,
                               knn_weight_aggregate_reference,
                               knn_gather_apply, knn_gather_apply_reference)
from .fused_knn import (knn_indices_tiled, knn_indices_tiled_reference,
                        knn_tiled)
from .fused_sinkhorn import sinkhorn_uv, sinkhorn_uv_reference
from .fused_transport import transport_flow, transport_flow_reference
from .fused_sa_train import (fused_sa_pair_train, sa_pair_train,
                             sa_pair_train_reference)
from .fused_correlator_train import (fused_knn_weight_aggregate_train,
                                     knn_weight_aggregate_train_reference)

__all__ = [
    "square_distance", "point_distance", "knn", "knn_auto", "ball_query",
    "three_nn", "identity_sample", "identity_gather", "gather",
    "furthest_point_sample", "furthest_point_sample_reference",
    "morton_code", "morton_perm", "invert_perm", "group",
    "three_interpolate", "three_interpolate_weights",
    "fused_sa_pair", "sa_pair", "sa_pair_reference",
    "fused_three_interpolate", "three_interpolate_reference",
    "fused_knn_weight_aggregate", "knn_weight_aggregate_reference",
    "knn_gather_apply", "knn_gather_apply_reference",
    "knn_indices_tiled", "knn_indices_tiled_reference", "knn_tiled",
    "sinkhorn_uv", "sinkhorn_uv_reference",
    "transport_flow", "transport_flow_reference",
    "fused_sa_pair_train", "sa_pair_train", "sa_pair_train_reference",
    "fused_knn_weight_aggregate_train",
    "knn_weight_aggregate_train_reference",
]
