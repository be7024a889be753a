"""The paper's primary contribution: real-time federated evolutionary NAS
(double-sampling + fill-aggregation + NSGA-II in one communication round)."""
from repro_torch.core import (
    aggregate, choice, double_sampling, federated, flops, nsga2, supernet,
)
from repro_torch.core.supernet import SupernetAPI, cnn_supernet_api

__all__ = [
    "aggregate", "choice", "double_sampling", "federated", "flops", "nsga2",
    "supernet", "SupernetAPI", "cnn_supernet_api",
]
