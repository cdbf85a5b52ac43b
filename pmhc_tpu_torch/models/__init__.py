from pmhc_tpu_torch.models.egnn import EGNNLayer, egnn_forward
from pmhc_tpu_torch.models.score import (
    ScoreNetwork,
    ScoreNetworkConfig,
    relpos_edge_pre,
    score_network_forward,
)

__all__ = [
    "EGNNLayer",
    "ScoreNetwork",
    "ScoreNetworkConfig",
    "egnn_forward",
    "relpos_edge_pre",
    "score_network_forward",
]
