"""The measured window around the program's ``FedEngine.run``.

``Recorder`` stands between the program's strategy and its execution
backend: it forwards every call unchanged and notes, for each
generation, the keys and client groups trained and the keys and
participants evaluated (host lists: the FLOP and byte counts read
them), and for the one generation the check follows, copies of the
master the program received and returned.

``drive`` runs the engine with a callback at every generation's end.
Generations 1 to ``warmup`` are set-up; the window opens at the end of
generation ``warmup`` and closes at the end of the first generation that
ends ``seconds`` or more after it opened (and not before the checked
generation); a traced run goes on for the generations it profiles.
Every generation ends in host reads of its error counts, which wait for
the device, so the window's wall time covers the device's work.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np


class WindowClosed(Exception):
    """Raised from the engine's callback to end its run at the close."""


def _copy(master: dict) -> dict:
    return {k: v.detach().clone() for k, v in master.items()}


class Recorder:
    def __init__(self, inner, check_gen: int):
        self.inner = inner
        self.check_gen = check_gen
        self.gen = 1
        self.calls: Dict[int, dict] = {}
        self.snap: dict = {}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _rec(self) -> dict:
        return self.calls.setdefault(self.gen, {"train": [], "eval": []})

    def train_fill(self, master, keys, groups, lr, survivors=None):
        keys = [np.array(k, copy=True) for k in keys]
        groups = [np.array(g, copy=True) for g in groups]
        check = self.gen == self.check_gen
        if check:
            self.snap["master_in"] = _copy(master)
        out = self.inner.train_fill(master, keys, groups, lr,
                                    survivors=survivors)
        if check:
            self.snap["master_out"] = _copy(out)
            self.snap["train"] = (keys, groups, lr)
        self._rec()["train"].append((keys, groups))
        return out

    def eval_shared(self, params, keys, client_ids, survivors=None):
        errs = self.inner.eval_shared(params, keys, client_ids,
                                      survivors=survivors)
        keys = [np.array(k, copy=True) for k in keys]
        ids = np.array(client_ids, copy=True)
        if self.gen == self.check_gen:
            self.snap["eval"] = (keys, ids, np.array(errs, copy=True))
        self._rec()["eval"].append((keys, ids))
        return errs


def drive(engine, recorder: Recorder, warmup: int, seconds: float,
          on_gen: Optional[Callable] = None, after: int = 0,
          on_close: Optional[Callable] = None) -> dict:
    """Run ``engine`` through the window, then ``after`` generations more
    (the traced run profiles those: a profiler once started slows every
    later launch on the card, so it starts only once the window has
    closed).  Returns the window's open and close times, its generations
    and those after it, every generation's ``round_s`` and report."""
    state = {"open": None, "close": None, "gens": [], "after": [],
             "round_s": {}, "reports": {}}

    def callback(gen, report):
        now = time.perf_counter()
        state["reports"][gen] = report
        state["round_s"][gen] = report.round_s
        recorder.gen = gen + 1
        if gen <= warmup:
            state["open"] = now
            return
        if state["close"] is None:
            state["gens"].append(gen)
        else:
            state["after"].append(gen)
        if on_gen is not None:
            on_gen(gen)
        if state["close"] is None and now - state["open"] >= seconds \
                and gen >= recorder.check_gen:
            state["close"] = now
            if on_close is not None:
                on_close()
        if state["close"] is not None and len(state["after"]) >= after:
            raise WindowClosed

    try:
        engine.run(callback=callback)
    except WindowClosed:
        pass
    if state["close"] is None:
        raise RuntimeError("the engine ended before the window closed")
    return state
