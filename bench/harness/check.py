"""The comparison that decides ``correct``.

The benchmark records one generation of the window (drawn from the
seed): the master the program's ``train_fill`` received and returned,
the keys and client groups it trained, the learning rate, and the keys,
participants and error rates of its evaluation, beside the generation's
report.  Once the window has closed, the plain reference follows that
generation from the same master and the benchmark's own clients, and
``readings`` gives:

* ``update_gap``: per leaf, the gap between the norms of the program's
  and the reference's change of the master, over the larger of the
  reference's norm of that leaf and the median leaf's; the median over
  the leaves.
* ``update_worst``: the same gap over the reference's norm of the leaf
  itself, the worst leaf: it sees a fault in one small leaf.
* ``update_diff``: per leaf, the norm of the difference of the two
  changes on the same scale, the median over the leaves: it sees a
  change that points the wrong way, which a gap of norms does not.
  The leaves are those some upload of the generation trained; a leaf
  that both sides move by less than a thousandth of the median change
  (round-off: an untrained leaf is the previous master times the
  weights' sum) is left out.
* ``count_gap``: the largest gap, over the evaluated keys, between the
  program's and the reference's wrong predictions on the program's new
  master.
* ``search_diff``: mismatches of the search's discrete decisions: the
  parents evaluated against the previous generation's selection, the
  offspring evaluated against the keys trained, the client groups (a
  disjoint split of the participants, equal sizes), the learning rate,
  the objective column against the benchmark's own count, and NSGA-II's
  selection on the program's objectives against the report's parents.

The numbers the cell's limits file names are compared; the others are
reported beside them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench.harness import counts
from bench.reference import search


def _shards(clients, ids, split, device):
    out = []
    for i in ids:
        xb, yb = getattr(clients[int(i)], split)
        out.append((torch.as_tensor(xb, device=device),
                    torch.as_tensor(yb, device=device)))
    return out


def reference_master(ref, snap, clients, config, run):
    """The reference's new master from the recorded generation's input."""
    keys, groups, _ = snap["train"]
    master = snap["master_in"]
    device = next(iter(master.values())).device
    lr = search.lr_at(run["lr0"], run["lr_decay"], snap["gen"])
    uploads = []
    for key, group in zip(keys, groups):
        for cid in group:
            (xb, yb), = _shards(clients, [cid], "train", device)
            leaves = search.client_update(
                ref, master, key, xb, yb, lr, run["momentum"],
                run["local_epochs"], config["model"])
            uploads.append((leaves, key, clients[int(cid)].weight))
    return search.fill_aggregate(ref, master, uploads)


def update_readings(master_in, got, want, trained) -> Dict[str, float]:
    """``update_gap``, ``update_worst`` and ``update_diff`` of the side
    judged (``got``, a new master) against the reference's (``want``);
    ``trained`` names the leaves some upload of the generation trained,
    whose median change is the scale."""
    da = {k: got[k].double() - master_in[k].double() for k in master_in}
    db = {k: want[k].double() - master_in[k].double() for k in master_in}
    na = {k: float(torch.linalg.vector_norm(v)) for k, v in da.items()}
    nb = {k: float(torch.linalg.vector_norm(v)) for k, v in db.items()}
    moved = [nb[k] for k in trained if nb[k] > 0]
    if not moved:
        return dict.fromkeys(("update_gap", "update_worst", "update_diff"),
                             float("inf"))
    med = float(np.median(moved))
    leaves = [k for k in nb if not (nb[k] < 1e-3 * med and na[k] < 1e-3 * med)]
    gaps = [abs(na[k] - nb[k]) / max(nb[k], med) for k in leaves]
    own = [abs(na[k] - nb[k]) / max(nb[k], 1e-3 * med) for k in leaves]
    diffs = [float(torch.linalg.vector_norm(da[k] - db[k])) / max(nb[k], med)
             for k in leaves]
    return {"update_gap": float(np.median(gaps)),
            "update_worst": float(max(own)),
            "update_diff": float(np.median(diffs))}


def trained_leaves(ref, snap, config) -> set:
    keys = snap["train"][0]
    return {k for k in snap["master_in"] for key in keys
            if ref.used(k, key, config["model"])}


def search_diff(snap, prev_parents, parents, config, run) -> int:
    keys, groups, lr = snap["train"]
    ekeys, ids, errs = snap["eval"]
    n = run["population"]
    bad = 0
    if prev_parents is not None:
        bad += sum(not np.array_equal(a, b)
                   for a, b in zip(ekeys[:n], prev_parents))
    bad += sum(not np.array_equal(a, b) for a, b in zip(ekeys[n:], keys))
    bad += abs(len(ekeys) - 2 * n) + abs(len(keys) - n)
    members = [int(c) for g in groups for c in g]
    size = len(ids) // n
    bad += len(members) - len(set(members))
    bad += sum(len(g) != size for g in groups)
    bad += len(set(members) - {int(i) for i in ids})
    bad += int(lr != search.lr_at(run["lr0"], run["lr_decay"], snap["gen"]))
    objs = snap["objs"]
    own = np.asarray([counts.objective(config, k) for k in ekeys])
    bad += int(np.sum(objs[:, 1] != own))
    bad += int(np.sum(objs[:, 0] != errs))
    chosen = [ekeys[i] for i in search.select(objs, n)]
    bad += sum(not np.array_equal(a, b) for a, b in zip(chosen, parents))
    return int(bad)


def program_counts(snap, clients) -> np.ndarray:
    """The program's wrong predictions per evaluated key, from its error
    rates: wrong predictions over the participants' test images."""
    _, ids, errs = snap["eval"]
    total = sum(int(clients[int(i)].test[1].size) for i in ids)
    return np.rint(np.asarray(errs) * total).astype(np.int64)


def reference_counts(ref, snap, clients, config) -> np.ndarray:
    """The reference's wrong predictions per evaluated key on the
    program's new master."""
    ekeys, ids, _ = snap["eval"]
    device = next(iter(snap["master_out"].values())).device
    return search.error_counts(ref, snap["master_out"], ekeys,
                               _shards(clients, ids, "test", device),
                               config["model"])


def readings(ref, snap, clients, config, run) -> Dict[str, float]:
    """Every number of the recorded generation."""
    out = update_readings(
        snap["master_in"], snap["master_out"],
        reference_master(ref, snap, clients, config, run),
        trained_leaves(ref, snap, config))
    wrong = reference_counts(ref, snap, clients, config)
    out["count_gap"] = float(np.max(np.abs(
        program_counts(snap, clients) - wrong)))
    out["search_diff"] = float(search_diff(
        snap, snap["prev_parents"], snap["parents"], config, run))
    return out
