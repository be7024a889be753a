"""The readings the limits of ``limits/<cell>.json`` are set from, on
the card at the cell's own size, each through the benchmark's own run
and comparison: the program's sound runs (the lower readings), the
controls (the program's own path in the precision below the
configuration's, ``harness/faults.py``'s ``CONTROLS``) and the program
with each planted fault (``FAULTS``; the upper readings).  Not run by
the benchmark's own runs.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--faults a,b]

Each run's window closes at its checked generation.  One JSON line a
run on standard output, with every reading, the compared numbers beside
their limits and ``correct``, and the same lines in
``chiprun_out/calibrate_<cell>.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run as bench_run  # noqa: E402
from bench.harness import faults  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default=",".join(faults.FAULTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, cell, config, traffic, limits = bench_run.load_cell(bench_run.ROOT,
                                                           args.workload)
    out_dir = bench_run.ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    plan = [(s, "sound", {}) for s in seeds(args.seeds)]
    plan += [(s, k, h) for s in seeds(args.control_seeds)
             for k, h in faults.CONTROLS.items()]
    plan += [(s, f, faults.FAULTS[f]) for s in seeds(args.fault_seeds)
             for f in args.faults.split(",") if f]
    with open(out_dir / f"calibrate_{args.workload}.jsonl", "a") as out:
        for seed, kind, hooks in plan:
            res = bench_run.run_cell(cell, config, traffic, limits, {}, seed,
                                     0.0, False, device=args.device,
                                     hooks=hooks)
            line = json.dumps({
                "workload": args.workload, "kind": kind, "seed": seed,
                "correct": res["correct"], "readings": res["readings"],
                "checks": res["checks"], "failed": res["failed"],
                "generation": res["window"]["checked_generation"]})
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
