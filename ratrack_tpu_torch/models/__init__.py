"""nn.Modules of the Track4D network (eval and train)."""

from .layers import (MaskedBatchNorm, PointwiseMLP, WeightNet, GRUCell,
                     StackedGRU, init_parameters)
from .pnhead import PNHead, SetAbstractionMSG, FeaturePropagation
from .correlator import FeatureCorrelator
from .decoder import FlowDecoder, FlowPredictor, ClsPredictor
from .affinity import Affinity
from .track4d import Track4D, model_from_config

__all__ = [
    "MaskedBatchNorm", "PointwiseMLP", "WeightNet", "GRUCell", "StackedGRU",
    "init_parameters", "PNHead", "SetAbstractionMSG", "FeaturePropagation",
    "FeatureCorrelator", "FlowDecoder", "FlowPredictor", "ClsPredictor",
    "Affinity", "Track4D", "model_from_config",
]
