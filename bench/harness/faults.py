"""The controls and the faults planted in the program underneath a run,
to show that the comparison sees them (``calibrate.py`` on the card, the
tests).  Each is a ``run_cell`` hook set.

Controls, the program's own path in the precision below the
configuration's float32 (on the card only: elsewhere the flags change
nothing):

* ``tf32``: TF32 on for cuBLAS and cuDNN in the whole run;
* ``tf32_train``: TF32 on in ``train_fill`` alone, the evaluation in
  float32.

Faults:

* ``unchanged``: ``train_fill`` hands the master back untouched;
* ``half_batch``: every client step takes the loss over the first half
  of its batch only (the mean over the rest);
* ``answer``: every evaluated batch's wrong count is one too many;
* ``tail``: the last four elements of ``train_fill``'s last trained
  leaf, in the master's order, keep their previous values (what an
  aggregation that drops the last 16-byte vector of its flattened rows
  would write).
"""
from __future__ import annotations

import dataclasses

import torch


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _tf32_all(engine):
    _tf32(True)


def _tf32_train(engine):
    inner = engine.backend
    fill = inner.train_fill

    def train_fill(*a, **k):
        _tf32(True)
        try:
            return fill(*a, **k)
        finally:
            _tf32(False)
    inner.train_fill = train_fill


def _unchanged(engine):
    engine.backend.train_fill = lambda master, *a, **k: master


def _tail(engine):
    inner = engine.backend
    fill = inner.train_fill

    def train_fill(master, *a, **k):
        prev = {n: v.clone() for n, v in master.items()}
        out = fill(master, *a, **k)
        moved = [n for n in out if not torch.equal(out[n], prev[n])]
        if moved:
            name = moved[-1]
            leaf = out[name].clone().reshape(-1)
            leaf[-4:] = prev[name].reshape(-1)[-4:]
            out = dict(out)
            out[name] = leaf.reshape(prev[name].shape)
        return out
    inner.train_fill = train_fill


def _half_batch(api):
    loss = api.loss

    def half(params, batch, key):
        n = batch["x"].shape[0] // 2
        return loss(params, {"x": batch["x"][:n], "y": batch["y"][:n]}, key)
    return dataclasses.replace(api, loss=half)


def _answer(api):
    count = api.error_count
    return dataclasses.replace(
        api, error_count=lambda params, batch, key:
        count(params, batch, key) + 1)


CONTROLS = {"tf32": {"engine": _tf32_all},
            "tf32_train": {"engine": _tf32_train}}

FAULTS = {"unchanged": {"engine": _unchanged},
          "half_batch": {"api": _half_batch},
          "answer": {"api": _answer},
          "tail": {"engine": _tail}}
