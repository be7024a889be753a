"""Quickstart: a minute with the real-time federated NAS framework.

1. build the paper's CNN supernet master model,
2. sample sub-networks with choice keys and inspect their FLOPs,
3. run TWO generations of real-time federated evolutionary NAS
   (double sampling + fill-aggregation + NSGA-II) on synthetic clients
   through the FedEngine's batched ("vmap") execution backend,
4. print the Pareto front.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      (on the CUDA card; ``--device cpu`` runs it on the CPU)
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import make_api, nsga2
from repro_torch.core.choice import random_key
from repro_torch.data import make_classification, make_clients, \
    partition_iid
from repro_torch.engine import FedEngine, RealTimeNas, RunConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # --- the master model (paper Fig. 3, reduced) -----------------------
    cfg = get_config("cifar-supernet", smoke=True)
    api = make_api(cfg)
    print(f"master model: {cfg.name}, {cfg.num_layers} choice blocks, "
          f"{api.master_params() / 1e6:.2f}M params")

    rng = np.random.default_rng(0)
    for _ in range(3):
        key = random_key(rng, api.num_blocks)
        print(f"  choice key {key} -> {api.flops(key) / 1e6:7.1f} MMACs, "
              f"payload {api.payload_params(key) / 1e6:.2f}M params")

    # --- synthetic federated clients ------------------------------------
    x, y = make_classification(0, 1200, image=16)
    clients = make_clients(x, y, partition_iid(0, len(x), 8),
                           batch=50, test_batch=50)
    print(f"{len(clients)} clients, ~{clients[0].n_train} train samples each")

    # --- two generations of real-time evolutionary NAS ------------------
    engine = FedEngine(api, clients,
                       RunConfig(population=4, generations=2, seed=0,
                                 backend="vmap", device=args.device),
                       strategy=RealTimeNas())
    hist = engine.run().history()
    objs = hist["objs"][-1]
    front = nsga2.fast_non_dominated_sort(objs)[0]
    print("\nPareto front after 2 generations (err, MMACs):")
    for i in sorted(front, key=lambda i: objs[i, 1]):
        print(f"  err={objs[i, 0]:.3f}  flops={objs[i, 1] / 1e6:8.1f}M")
    print(f"\ncomm so far: down {hist['down_gb'][-1]:.3f} GB, "
          f"up {hist['up_gb'][-1]:.3f} GB, "
          f"client passes {hist['train_passes'][-1]}, "
          f"batched dispatches {engine.backend.dispatches}")
    return hist


if __name__ == "__main__":
    main()
