"""How a mesh over several cards departs from the same mesh on one card.

    PYTHONPATH=src python -m repro_torch.launch.mesh_probe [--devices cuda:0,...]

Prints one JSON line.  ``align``: one client update of the smoke CIFAR
supernet from its fresh initial leaves, against the same update from
the same values held as views into one flat float32 vector (what
``core.aggregate`` hands back after Algorithm 3 on K1: some leaves then
start 4 bytes past an aligned address) and from clones of those views;
the largest |difference| of each.  ``runs``, with two or more devices: a
fused two-generation search on each Algorithm 3 route over the listed
devices against the same mesh on the first device repeated, the largest
|difference| of the masters and of the objectives.  ``--devices``
defaults to every visible card; ``cpu,cpu`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import cnn_supernet_api
from repro_torch.core.aggregate import _flat_f32, _unflatten_like
from repro_torch.core.federated import client_update_fn
from repro_torch.data import make_classification, make_clients, \
    partition_iid
from repro_torch.engine import FedEngine, MeshBackend, RunConfig
from repro_torch.launch.mesh import make_host_mesh


def _gap(a, b) -> float:
    return max(float((a[k] - b[k].to(a[k].device)).abs().max()) for k in a)


def _objectives(result) -> np.ndarray:
    return np.concatenate([np.ravel(r.objs) for r in result.reports
                           if r.objs is not None])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices (default: every card)")
    args = ap.parse_args(argv)
    devices = make_host_mesh(None if args.devices is None
                             else args.devices.split(",")).axis_devices("data")
    home = devices[0]
    api = cnn_supernet_api(get_config("cifar-supernet", smoke=True))
    x, y = make_classification(0, 480, image=8, signal=1.5, noise=0.5)
    clients = make_clients(x, y, partition_iid(0, 480, 8), batch=20,
                           test_batch=20)
    cfg = RunConfig(device=home.type, population=4, generations=2, seed=0,
                    lr0=0.01)
    update = client_update_fn(api, cfg.local_epochs, cfg.momentum)
    key = ((np.arange(api.num_blocks) + 1) % 4).astype(np.int32)
    xb, yb = (torch.as_tensor(a).to(home) for a in clients[0].train)
    fresh = {k: v.to(home) for k, v in
             api.init(torch.Generator().manual_seed(0)).items()}
    views = _unflatten_like(_flat_f32(list(fresh.values())), fresh)
    want = update(fresh, key, xb, yb, cfg.lr0)
    out = {"devices": [str(d) for d in devices], "align": {
        name: _gap(want, update(p, key, xb, yb, cfg.lr0))
        for name, p in (("views", views),
                        ("cloned views",
                         {k: v.clone() for k, v in views.items()}))},
        "runs": {}}
    if len(devices) > 1:
        for route in ("torch", "kernel"):
            run = dataclasses.replace(cfg, aggregate_backend=route)
            spread, one = (
                FedEngine(api, clients, run, backend=MeshBackend(
                    api, clients, run, mesh=make_host_mesh(devs))).run()
                for devs in (devices, [home] * len(devices)))
            out["runs"][route] = {
                "master": _gap(spread.extras["final_master"],
                               one.extras["final_master"]),
                "objectives": float(np.abs(_objectives(spread)
                                           - _objectives(one)).max())}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
