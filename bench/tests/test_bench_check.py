"""The comparison that decides ``correct``, at CPU size with that size's
limits (``bench_tiny``): a sound run passes it, and a run with a fault
planted in the program underneath fails it, once for each fault the cell
can have (a step that hands its state back unchanged, half of each batch
left out, an answer altered where it is produced, the end of one leaf
left unwritten).  The cell runs on one card, so no exchange between
cards can be left out.  The controls (TF32 in the program's place) act
on the card alone: ``test_bench_chip.py`` holds them."""
from __future__ import annotations

import pytest
import torch

import bench_tiny
from bench.harness import check, faults


def test_sound_run_is_correct():
    res = bench_tiny.run(11)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(bench_tiny.TINY_LIMITS)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(fault):
    res = bench_tiny.run(12, hooks=faults.FAULTS[fault])
    assert not res["correct"], res["checks"]


def test_update_diff_sees_a_change_that_points_the_wrong_way():
    g = torch.Generator().manual_seed(0)
    master = {f"l{i}": torch.randn(64, generator=g) for i in range(5)}
    step = {k: 0.1 * torch.randn(64, generator=g) for k in master}
    want = {k: v + step[k] for k, v in master.items()}
    back = {k: v - step[k] for k, v in master.items()}
    same = check.update_readings(master, want, want, set(master))
    wrong = check.update_readings(master, back, want, set(master))
    assert same == {"update_gap": 0.0, "update_worst": 0.0,
                    "update_diff": 0.0}
    # float32 round-off of master +- step, no more
    assert wrong["update_gap"] == pytest.approx(0.0, abs=1e-6)
    assert wrong["update_diff"] == pytest.approx(2.0, abs=1e-6)
