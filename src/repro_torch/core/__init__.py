"""The paper's primary contribution: real-time federated evolutionary NAS
(double-sampling + fill-aggregation + NSGA-II in one communication round)."""
from repro_torch.core import (
    aggregate, choice, double_sampling, federated, flops, nsga2,
    offline_enas, rt_enas, supernet,
)
from repro_torch.core.rt_enas import CommStats, RunConfig
from repro_torch.core.supernet import SupernetAPI, cnn_supernet_api, \
    lm_supernet_api, make_api

__all__ = [
    "aggregate", "choice", "double_sampling", "federated", "flops", "nsga2",
    "offline_enas", "rt_enas", "supernet", "CommStats", "RunConfig",
    "SupernetAPI", "cnn_supernet_api", "lm_supernet_api", "make_api",
]
