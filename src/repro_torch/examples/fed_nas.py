"""Harness of the paper-shaped federated NAS experiment (Section IV) at
a small scale: 16x16 synthetic images on the smoke CIFAR supernet, tens
of generations.  The *relative* claims of the paper (the real-time
search against the offline one, the Pareto shape, the FLOPs against the
fixed baseline) are what it shows.

Everything routes through ``repro_torch.engine.FedEngine`` with
Algorithm 3 on the fill-aggregation kernel (its plain version on the
CPU); ``engine_backend`` selects the client-execution path (``"loop"``:
one local update per (individual, client) pair; ``"vmap"``: stacked
client shards; ``"mesh"``: those stacks with the population split over
the devices of ``make_host_mesh``) and ``device`` where the run lives.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import make_api, nsga2
from repro_torch.data import make_classification, make_clients, \
    partition_iid, partition_label
from repro_torch.engine import FedAvgBaseline, FedEngine, OfflineNas, \
    RealTimeNas, RunConfig

IMAGE = 16
RESNET_LIKE_KEY = np.ones(4, dtype=np.int32)   # all-residual master path


def build_clients(num_clients: int, iid: bool = True, seed: int = 0,
                  n: int = 2000, batch: int = 50, test_batch: int = 50):
    """``num_clients`` clients of ``make_classification``, IID or by label
    (5 classes a client)."""
    x, y = make_classification(seed, n, image=IMAGE, signal=1.2, noise=0.8)
    if iid:
        shards = partition_iid(seed, n, num_clients)
    else:
        shards = partition_label(seed, y, num_clients, classes_per_client=5)
    return make_clients(x, y, shards, batch=batch, test_batch=test_batch)


def build_api():
    return make_api(get_config("cifar-supernet", smoke=True))


def run_rt(api, clients, generations: int, population: int = 6,
           seed: int = 0, engine_backend: str = "loop",
           device: str = "cuda") -> Dict:
    rc = RunConfig(population=population, generations=generations,
                   seed=seed, backend=engine_backend, device=device)
    return FedEngine(api, clients, rc,
                     strategy=RealTimeNas()).run().history()


def run_offline(api, clients, generations: int, population: int = 6,
                seed: int = 0, engine_backend: str = "loop",
                device: str = "cuda") -> Dict:
    rc = RunConfig(population=population, generations=generations,
                   seed=seed, backend=engine_backend, device=device)
    return FedEngine(api, clients, rc,
                     strategy=OfflineNas()).run().history()


def run_fixed_baseline(api, clients, rounds: int, key=RESNET_LIKE_KEY,
                       seed: int = 0, engine_backend: str = "loop",
                       device: str = "cuda") -> Dict:
    """FedAvg on a fixed architecture (the paper's ResNet18 role)."""
    rc = RunConfig(generations=rounds, seed=seed, backend=engine_backend,
                   device=device)
    res = FedEngine(api, clients, rc,
                    strategy=FedAvgBaseline(key)).run()
    return {"err": [r.best_err for r in res.reports],
            "flops": res.extras["flops"],
            "params": res.extras["params"],
            "stats": res.stats}


def summarize_front(api, hist) -> List[Dict]:
    """Final-generation Pareto front -> [{err, flops}] (Fig 8)."""
    objs = hist["objs"][-1]
    sel = nsga2.select(objs, len(hist["parent_keys"][-1]))
    front = nsga2.fast_non_dominated_sort(objs[sel])[0]
    out = []
    for i in front:
        out.append({"err": float(objs[sel][i, 0]),
                    "flops": float(objs[sel][i, 1])})
    out.sort(key=lambda r: r["flops"])
    return out


def save_history(path: str, hist: Dict, extra: Optional[Dict] = None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rec = {
        "gen": hist["gen"],
        "best_err": hist["best_err"],
        "knee_err": hist.get("knee_err"),
        "down_gb": hist["down_gb"],
        "up_gb": hist["up_gb"],
        "train_passes": hist["train_passes"],
        "wall_s": hist["wall_s"],
        "final_objs": np.asarray(hist["objs"][-1]).tolist(),
    }
    if extra:
        rec.update(extra)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
