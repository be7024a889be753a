"""Dry run: every (architecture x input shape) step, counted on meta
tensors, with its H100 roofline terms.

    python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes
    python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --arch granite-moe-1b-a400m \\
        --shape prefill_32k --backend kernel --save

For each combination this builds the port's own step (``make_train_step``,
``make_prefill_step`` or ``make_decode_step``) and runs it once on
tensors of the ``meta`` device (``launch/specs.py``): shapes and dtypes
flow through every op and nothing is allocated, so a full config runs on
the CPU in seconds.  A ``StepCounter`` (``launch/roofline.py``) counts
the run op by op: FLOPs, bytes moved and the peak of live storage.  The
JAX package lowers and compiles its step on 512 placeholder devices
instead, and reads XLA's memory and cost analyses.

The mesh (default ``make_production_mesh()``: 16 x 16, or 2 x 16 x 16
with ``multi_pod``; ``--host-mesh``: ``make_host_mesh()`` over the cards
present) shapes the per-device figures:

* the step runs on the rows one data shard holds (the global batch over
  the data axes when they divide it, else the whole batch, as
  ``sharding.batch_spec`` places it);
* FLOPs and bytes are split evenly over ``model`` (tensor parallelism
  taken as ideal);
* arguments count as the specs place them (``sharding.param_shardings``;
  the optimizer state as its parameter; the decode cache by
  ``sharding.cache_shardings``);
* of the storage the step makes, a tensor of a parameter's shape (a
  gradient, an accumulator, a moment) counts as that parameter is split,
  and every other one is split over ``model`` (tensor and sequence
  parallelism), so ``peak_bytes`` is one device's share;
* collectives come from the specs (``roofline.collective_bytes``).

On a (1, 1) mesh every per-device figure is the whole step's.

Where the JAX package needs two more compiles of shallow unrolled
models (``_depth_pair``) and forces ``microbatch=1`` for its cost
numbers, because XLA's cost analysis counts a loop body once, the meta
run executes every layer and every microbatch, so it counts them all:
neither exists here.  Nor does an environment variable: the meta device
needs no placeholder devices.

Records are JSON, one per combination, under ``RESULTS_DIR`` (``--save``;
``--out`` for another directory).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_ALIASES, SHAPES, InputShape, \
    ModelConfig, get_config, get_shape
from repro_torch.core import flops as flops_mod
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding, specs
from repro_torch.launch.mesh import Mesh, data_axes, make_host_mesh, \
    make_production_mesh, mesh_axis_size
from repro_torch.launch.serve import make_decode_step, make_prefill_step
from repro_torch.launch.train import init_opt, make_train_step
from repro_torch.models import transformer as tr

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_results")

# train_4k microbatching, as the JAX package's (activation memory scales
# as 1 / microbatch)
DEFAULT_MICROBATCH = {
    "deepseek-67b": 8,
    "llama4-scout-17b-a16e": 4,
    "whisper-large-v3": 4,
    "chatglm3-6b": 2,
    "starcoder2-3b": 2,
    "zamba2-2.7b": 2,
    "mamba2-780m": 4,
    "granite-moe-1b-a400m": 2,
}


def local_rows(shape: InputShape, mesh: Mesh) -> int:
    """The rows of the batch one data shard holds."""
    d = mesh_axis_size(mesh, data_axes(mesh))
    b = shape.global_batch
    return b // d if b % d == 0 else b


def supernet_key(cfg: ModelConfig) -> np.ndarray:
    """The choice key a supernet's step is counted on: every layer on
    branch 1, its full block (the most work, and the parameters a plain
    model has), where the JAX package's dry run takes an abstract key."""
    return np.ones(cfg.num_layers, dtype=np.int64)


def build_step(cfg: ModelConfig, shape: InputShape, *, backend: str =
               "torch", remat: bool = True, fused_ce: bool = True,
               microbatch: int = 1, optimizer: str = "sgd",
               on_microbatch: Optional[Callable[[int], None]] = None
               ) -> Callable[[tuple], Any]:
    """``call(args)``: the port's step for ``shape.kind`` on ``args``
    (``step_args``' layout), in the grad mode it runs in (a prefill and
    a decode under ``no_grad``).  The same call runs meta tensors here
    and the card's tensors in ``chip_smoke.py``."""
    window = specs.effective_window(cfg, shape)
    if shape.kind == "train":
        step = make_train_step(cfg, optimizer=optimizer, window=window,
                               backend=backend, remat=remat,
                               fused_ce=fused_ce, microbatch=microbatch,
                               on_microbatch=on_microbatch)
        return lambda args: step(*args)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, window=window, backend=backend)
    else:
        step = make_decode_step(cfg, window=window)

    def call(args):
        with torch.no_grad():
            return step(*args)
    return call


def step_args(cfg: ModelConfig, shape: InputShape, rows: int, *,
              optimizer: str = "sgd", params=None) -> tuple:
    """The step's arguments on the meta device at ``rows`` rows:
    (params, optimizer state, batch) to train, (params, batch) to
    prefill, (params, cache, batch) to decode."""
    params = specs.abstract_params(cfg) if params is None else params
    batch = specs.input_specs(cfg, shape, rows)
    if shape.kind == "train":
        if cfg.supernet:
            batch["choice_key"] = supernet_key(cfg)
        return params, init_opt(params, optimizer), batch
    if shape.kind == "prefill":
        return params, batch
    return params, specs.abstract_cache(cfg, shape, params, rows), batch


def _leaf_divisors(mesh: Mesh, params) -> Dict[str, int]:
    """Each parameter's flat (dotted) name -> the blocks its spec cuts it
    into."""
    return {path.replace("/", "."): sh.divisor(mesh) for path, sh in
            sharding.flat_shardings(sharding.param_shardings(
                mesh, params)).items()}


def _opt_divisors(opt, div: Dict[str, int]):
    """The optimizer state's leaves -> their parameter's divisor (the
    SGD velocity and AdamW's moments are per parameter; AdamW's step
    count is replicated)."""
    if isinstance(opt, dict) and "m" in opt and "v" in opt:
        return [(opt["m"][k], div[k]) for k in opt["m"]] + \
            [(opt["v"][k], div[k]) for k in opt["v"]] + [(opt["step"], 1)]
    return [(t, div[k]) for k, t in opt.items()]


def argument_bytes_from_specs(cfg: ModelConfig, shape: InputShape,
                              mesh: Mesh, *, optimizer: str = "sgd") -> int:
    """The per-device bytes of a step's arguments as the specs place
    them: each parameter leaf's block (``LeafSharding.local_nbytes``),
    the optimizer state as its parameter's, the decode cache's blocks
    (``cache_shardings`` at the global batch) and the inputs' rows over
    the data axes (``batch_spec``)."""
    params = specs.abstract_params(cfg)
    flat = sharding.flat_shardings(sharding.param_shardings(mesh, params))
    total = sum(sh.local_nbytes for sh in flat.values())
    if shape.kind == "train":
        opt = init_opt(params, optimizer)
        div = _leaf_divisors(mesh, params)
        total += sum(t.numel() * t.element_size() // d
                     for t, d in _opt_divisors(opt, div))
    if shape.kind == "decode":
        cache = specs.abstract_cache(cfg, shape, params)
        total += sum(sh.local_nbytes for sh in sharding.flat_shardings(
            sharding.cache_shardings(mesh, cache,
                                     shape.global_batch)).values())
    for t in specs.input_specs(cfg, shape).values():
        spec = sharding.batch_spec(mesh, shape.global_batch, t.dim())
        total += sharding.leaf_sharding(mesh, spec, t).local_nbytes
    return total


def count_step(cfg: ModelConfig, shape: InputShape, mesh: Mesh, *,
               backend: str = "torch", remat: bool = True,
               fused_ce: bool = True, microbatch: int = 1,
               optimizer: str = "sgd", roofline: bool = True,
               scale_microbatches: bool = True) -> Dict[str, Any]:
    """Run the step once on meta tensors at one data shard's rows under a
    ``StepCounter`` -> its per-device ``arguments``, ``outputs`` and
    ``peak`` bytes, the step's ``flops`` and ``bytes``, kernel
    ``launches``, the ``seconds`` of the run and the ``microbatches`` it
    ran.

    A training step of more than two microbatches runs two of them when
    ``scale_microbatches``: the microbatches are alike, so the work of
    the others is the second one's (read between the step's
    ``on_microbatch`` calls), and the peak, which the second already
    reaches, grows only by the rows of input left out."""
    params = specs.abstract_params(cfg)
    rows = local_rows(shape, mesh)
    runs = microbatch
    if shape.kind == "train" and scale_microbatches and microbatch > 2:
        runs = 2
    run_rows = rows // microbatch * runs if shape.kind == "train" else rows
    args = step_args(cfg, shape, run_rows, optimizer=optimizer,
                     params=params)
    m_size = mesh.shape.get("model", 1)
    div = _leaf_divisors(mesh, params)
    flat = tr.flat_params(params)
    by_shape: Dict[tuple, float] = {}
    for name, t in flat.items():
        share = 1.0 / div[name]
        by_shape[tuple(t.shape)] = max(by_shape.get(tuple(t.shape), 0.0),
                                       share)

    def share(t: torch.Tensor) -> float:
        return by_shape.get(tuple(t.shape), 1.0 / m_size)

    counter = rl.StepCounter(share, work=roofline)
    held = 0.0
    for name, t in flat.items():
        held += counter.hold(t, 1.0 / div[name]) / div[name]
    if shape.kind == "train":
        for t, d in _opt_divisors(args[1], div):
            held += counter.hold(t, 1.0 / d) / d
    if shape.kind == "decode":
        shards = sharding.flat_shardings(sharding.cache_shardings(
            mesh, specs.abstract_cache(cfg, shape, params),
            shape.global_batch))
        for path, sh in shards.items():
            leaf = _leaf_at(args[1], path)
            if isinstance(leaf, torch.Tensor):
                d = sh.divisor(mesh, ("model",))
                held += counter.hold(leaf, 1.0 / d) / d
    held += counter.hold(args[-1], 1.0)
    left_out = sum(t.numel() * t.element_size() for t in
                   specs.input_specs(cfg, shape, rows).values()) - \
        sum(t.numel() * t.element_size() for t in
            rl.tensor_leaves(args[-1]))
    marks = []

    def mark(i):
        marks.append((counter.flops, counter.bytes, dict(counter.launches)))

    call = build_step(cfg, shape, backend=backend, remat=remat,
                      fused_ce=fused_ce, microbatch=runs,
                      optimizer=optimizer, on_microbatch=mark)
    t0 = time.perf_counter()
    with counter:
        out = call(args)
    seconds = time.perf_counter() - t0
    res = {"flops": counter.flops, "bytes": counter.bytes,
           "launches": dict(counter.launches), "seconds": seconds,
           "microbatches": runs,
           "arguments": held + left_out,
           "peak": counter.peak_bytes_dev + left_out}
    if runs < microbatch:
        (f0, b0, l0), (f1, b1, l1) = marks[0], marks[1]
        extra = microbatch - runs
        res["flops"] += extra * (f1 - f0)
        res["bytes"] += extra * (b1 - b0)
        for k, n in l1.items():
            res["launches"][k] += extra * (n - l0.get(k, 0))
    arg_storages = {rl.StorageWeakRef(t.untyped_storage()).cdata
                    for t in rl.tensor_leaves(args)}
    out_bytes, seen = 0.0, set()
    for t in rl.tensor_leaves(out):
        key = rl.StorageWeakRef(t.untyped_storage()).cdata
        if key not in arg_storages and key not in seen:
            seen.add(key)
            out_bytes += t.untyped_storage().nbytes() * share(t)
    res["outputs"] = out_bytes
    return res


def _leaf_at(tree, path: str):
    for part in path.split("/"):
        tree = tree[int(part) if isinstance(tree, list) else part]
    return tree


def dry_run(arch: str, shape_name, *, multi_pod: bool = False,
            mesh: Optional[Mesh] = None, supernet: bool = False,
            backend: str = "torch", remat: bool = True,
            fused_ce: bool = True, roofline: bool = True,
            microbatch: int = 0, optimizer: str = "sgd",
            verbose: bool = True, extra_tag: str = "") -> Dict[str, Any]:
    """The record of one (arch x shape) step on ``mesh`` (default the
    production mesh).  ``shape_name`` is a key of ``SHAPES`` or an
    ``InputShape``.  ``microbatch`` 0 takes ``DEFAULT_MICROBATCH`` for a
    training shape; ``optimizer`` is the train step's (SGD, the JAX
    package's default, or AdamW).  ``supernet`` counts the supernet of
    ``arch`` on ``supernet_key``, training shapes only (the port serves
    no supernet).  ``roofline=False`` counts the memory only.  A
    training step of more than two microbatches is counted from two
    (``count_step``)."""
    cfg = get_config(arch)
    if supernet:
        cfg = cfg.replace(supernet=True)
    shape = shape_name if isinstance(shape_name, InputShape) \
        else get_shape(shape_name)
    if supernet and shape.kind != "train":
        raise ValueError(f"{cfg.name}: a supernet is dry-run on training "
                         "shapes only (the port serves no supernet)")
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    if microbatch <= 0:
        microbatch = DEFAULT_MICROBATCH.get(cfg.name, 1) \
            if shape.kind == "train" else 1
    rows = local_rows(shape, mesh)
    if shape.kind == "train" and rows % microbatch:
        raise ValueError(f"{cfg.name} x {shape.name}: {rows} rows a data "
                         f"shard do not split into {microbatch} "
                         "microbatches")
    counted = count_step(
        cfg, shape, mesh, backend=backend, remat=remat, fused_ce=fused_ce,
        microbatch=microbatch, optimizer=optimizer, roofline=roofline)
    rec: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "x".join(str(n) for n in mesh.shape.values()),
        "chips": chips, "kind": shape.kind,
        "window": specs.effective_window(cfg, shape), "rows": rows,
        "supernet": supernet, "backend": backend, "remat": remat,
        "fused_ce": fused_ce, "microbatch": microbatch,
        "counted_microbatches": counted["microbatches"],
        "optimizer": optimizer, "tag": extra_tag,
        "compile_s": counted["seconds"],
        "argument_size_in_bytes": int(round(counted["arguments"])),
        "output_size_in_bytes": int(round(counted["outputs"])),
        "temp_size_in_bytes": int(round(counted["peak"]
                                        - counted["arguments"])),
        "peak_bytes": int(round(counted["peak"])),
        "fits": bool(counted["peak"] <= rl.HBM_BYTES),
        "launches": counted["launches"],
    }
    if roofline:
        # no depth pair and no microbatch=1 here: the meta run executed
        # every layer and every microbatch, so its counts are the step's
        m_size = mesh.shape.get("model", 1)
        flops_dev = counted["flops"] / m_size
        bytes_dev = counted["bytes"] / m_size
        coll = rl.collective_bytes(cfg, shape, mesh, remat=remat,
                                   microbatch=microbatch)
        link = (coll["total"] / coll["seconds"] if coll["seconds"]
                else rl.NVLINK_BYTES_PER_S)
        terms = rl.roofline_terms(flops_dev, bytes_dev, coll["total"],
                                  link_bytes_per_s=link)
        tokens = shape.global_batch * shape.seq_len
        if shape.kind == "train":
            model_flops = flops_mod.train_flops(cfg, tokens)
        elif shape.kind == "prefill":
            model_flops = flops_mod.train_flops(cfg, tokens) / 3.0
        else:
            model_flops = flops_mod.decode_flops(cfg, shape.global_batch)
        rec.update({
            "flops_per_dev": flops_dev, "bytes_per_dev": bytes_dev,
            "collective_bytes_per_dev": coll["total"],
            "collectives": {k: coll[k] for k in rl.COLLECTIVE_KINDS},
            "collective_ops": coll["ops"],
            "model_flops_global": model_flops,
            "useful_flops_ratio": (model_flops / (flops_dev * chips)
                                   if flops_dev else 0.0),
            **terms,
        })
    if verbose:
        print(f"== {cfg.name} x {shape.name} on {rec['mesh']} ({chips} "
              f"devices){' [supernet]' if supernet else ''}"
              f"{' [' + extra_tag + ']' if extra_tag else ''}")
        print(f"   meta run {counted['seconds']:.1f}s | args "
              f"{rec['argument_size_in_bytes'] / 1e9:.2f}GB temp "
              f"{rec['temp_size_in_bytes'] / 1e9:.2f}GB per dev"
              f"{'' if rec['fits'] else ' (does not fit)'}")
        if roofline:
            print(f"   per-dev flops {flops_dev:.3e} bytes {bytes_dev:.3e} "
                  f"coll {coll['total']:.3e}")
            print(f"   roofline: compute {rec['compute_s'] * 1e3:.3f}ms "
                  f"memory {rec['memory_s'] * 1e3:.3f}ms "
                  f"collective {rec['collective_s'] * 1e3:.3f}ms "
                  f"-> {rec['dominant']}-bound | "
                  f"MODEL/counted {rec['useful_flops_ratio']:.3f}")
    return rec


def save_record(rec: Dict[str, Any], out_dir: str = RESULTS_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"_{rec['tag']}" if rec.get("tag") else ""
    sup = "_supernet" if rec.get("supernet") else ""
    route = "" if rec.get("backend") == "torch" else f"_{rec['backend']}"
    name = (f"dryrun_{rec['arch'].replace('.', 'p')}_{rec['shape']}_"
            f"{rec['mesh'].replace('x', '-')}{sup}{route}{tag}.json")
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def _dry_run_job(job: Tuple[str, str, Any, dict]) -> Tuple[tuple, Any]:
    """One combination in a worker process -> (its key, the record or
    the error's text)."""
    arch, shape, mp, kw = job
    torch.set_num_threads(1)
    try:
        mesh = make_host_mesh() if mp == "host" else None
        rec = dry_run(arch, shape, multi_pod=mp is True, mesh=mesh,
                      verbose=False, **kw)
        bad = [k for k, v in rec.items()
               if isinstance(v, float) and not np.isfinite(v)]
        if bad:
            raise ValueError(f"not finite: {bad}")
        return (arch, shape, mp), rec
    except Exception as e:  # noqa: BLE001 -- reported by the caller
        return (arch, shape, mp), repr(e)[:400]


def run_matrix(archs, shapes, meshes, *, jobs: int = 1, **kw) -> Tuple[
        list, list]:
    """``dry_run`` over archs x shapes x meshes (``False``: the pod,
    ``True``: multi-pod, ``"host"``: the host mesh), in ``jobs`` worker
    processes (spawned: the caller may hold a card) -> (records, failures
    as (arch, shape, mesh, error)), in that order.  Shapes a route
    cannot take are skipped with a note: training on the forward-only
    kernel route, serving a supernet."""
    todo = []
    for arch in archs:
        for shape in shapes:
            kind = get_shape(shape).kind
            if kw.get("backend") == "kernel" and kind == "train":
                print(f"-- {arch} x {shape}: skipped, the kernels are "
                      "forward-only (train on torch or chunked)")
                continue
            if kw.get("supernet") and kind != "train":
                print(f"-- {arch} x {shape}: skipped, a supernet is "
                      "dry-run on training shapes only")
                continue
            todo += [(arch, shape, mp, kw) for mp in meshes]
    # the training steps take longest: start them first
    todo.sort(key=lambda job: get_shape(job[1]).kind != "train")
    if jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            done = list(ex.map(_dry_run_job, todo))
    else:
        done = [_dry_run_job(job) for job in todo]
    records, failures = [], []
    for (arch, shape, mp), res in done:
        if isinstance(res, dict):
            records.append(res)
            print(f"== {arch} x {shape} on {res['mesh']}: meta run "
                  f"{res['compile_s']:.1f}s, args "
                  f"{res['argument_size_in_bytes'] / 1e9:.2f}GB, peak "
                  f"{res['peak_bytes'] / 1e9:.2f}GB per dev"
                  + (f", {res['dominant']}-bound" if "dominant" in res
                     else ""), flush=True)
        else:
            failures.append((arch, shape, mp, res))
            print(f"!! FAIL {arch} x {shape} mesh {mp}: {res}", flush=True)
    return records, failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dry run on meta tensors")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--host-mesh", action="store_true",
                    help="make_host_mesh() over the cards present")
    ap.add_argument("--supernet", action="store_true")
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "chunked", "kernel"])
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-fused-ce", action="store_true")
    ap.add_argument("--no-roofline", action="store_true",
                    help="count the memory only")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="0 = per-arch default")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (each one thread)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = ([a for a in ARCH_ALIASES if a != "cifar-supernet"]
             if args.arch == "all" else [args.arch])
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    if args.host_mesh:
        meshes = ["host"]
    else:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.perf_counter()
    records, failures = run_matrix(
        archs, shapes, meshes, jobs=args.jobs, supernet=args.supernet,
        backend=args.backend, remat=not args.no_remat,
        fused_ce=not args.no_fused_ce, roofline=not args.no_roofline,
        microbatch=args.microbatch, optimizer=args.optimizer,
        extra_tag=args.tag)
    if args.save:
        for rec in records:
            save_record(rec, args.out)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures")
    print(f"ALL {len(records)} DRY-RUNS PASSED in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
