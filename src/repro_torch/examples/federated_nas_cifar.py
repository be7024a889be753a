"""End-to-end driver: the paper's experiment (Section IV) at a small
scale.

Real-time federated evolutionary NAS on the CNN supernet over IID or
non-IID synthetic clients, against BOTH baselines the paper uses:
  * FedAvg on a fixed all-residual model (the ResNet18 role, Table IV),
  * offline evolutionary NAS (reinit + every client trains every
    individual, Section IV.G).

Writes the history as ``fednas_rt_torch_{tag}.json`` under ``--out``.

Run (quick, on the CUDA card; ``--device cpu`` runs it on the CPU):

    PYTHONPATH=src python -m repro_torch.examples.federated_nas_cifar \\
        --generations 5 --clients 8

Paper-shaped: --generations 40 --clients 10.
"""
import argparse
import os
import time

from repro_torch.examples import fed_nas


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--generations", type=int, default=5)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--population", type=int, default=6)
    ap.add_argument("--noniid", action="store_true")
    ap.add_argument("--offline-generations", type=int, default=2)
    ap.add_argument("--baseline-rounds", type=int, default=0,
                    help="0 = same as --generations")
    ap.add_argument("--engine-backend", default="loop",
                    choices=["loop", "vmap", "mesh"],
                    help="client-execution backend (FedEngine); 'mesh' "
                         "splits the population over every visible card "
                         "(one CPU device with --device cpu)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="benchmarks/results")
    args = ap.parse_args(argv)

    api = fed_nas.build_api()
    clients = fed_nas.build_clients(args.clients, iid=not args.noniid,
                                    seed=args.seed)
    tag = ("noniid" if args.noniid else "iid") + f"_c{args.clients}"
    run = dict(seed=args.seed, engine_backend=args.engine_backend,
               device=args.device)

    print(f"=== RT-FedENAS ({tag}): {args.generations} generations, "
          f"pop {args.population} ===")
    t0 = time.time()
    hist = fed_nas.run_rt(api, clients, args.generations,
                          population=args.population, **run)
    rt_wall = time.time() - t0
    front = fed_nas.summarize_front(api, hist)
    print(f"  wall {rt_wall:.0f}s | best err "
          f"{hist['best_err'][0]:.3f} -> {hist['best_err'][-1]:.3f}")
    for r in front:
        print(f"  front: err={r['err']:.3f} flops={r['flops']/1e6:.1f}M")

    print("=== FedAvg fixed baseline (ResNet role) ===")
    rounds = args.baseline_rounds or args.generations
    base = fed_nas.run_fixed_baseline(api, clients, rounds, **run)
    print(f"  err {base['err'][0]:.3f} -> {base['err'][-1]:.3f} "
          f"@ {base['flops']/1e6:.1f} MMACs")

    print(f"=== offline ENAS baseline: {args.offline_generations} gens ===")
    t0 = time.time()
    off = fed_nas.run_offline(api, clients, args.offline_generations,
                              population=args.population, **run)
    off_wall = time.time() - t0
    per_gen_rt = rt_wall / args.generations
    per_gen_off = off_wall / args.offline_generations
    print(f"  per-generation wall: RT {per_gen_rt:.1f}s vs offline "
          f"{per_gen_off:.1f}s -> RT is {per_gen_off/per_gen_rt:.1f}x "
          f"faster (paper: ~5x)")
    print(f"  upload volume: RT {hist['up_gb'][-1]:.3f} GB "
          f"({args.generations} gens) vs offline {off['up_gb'][-1]:.3f} GB "
          f"({args.offline_generations} gens)")

    path = os.path.join(args.out, f"fednas_rt_torch_{tag}.json")
    fed_nas.save_history(
        path, hist,
        extra={"front": front, "rt_wall_s": rt_wall,
               "baseline_err": base["err"],
               "baseline_flops": base["flops"],
               "offline_per_gen_s": per_gen_off,
               "rt_per_gen_s": per_gen_rt,
               "offline_up_gb": off["up_gb"][-1],
               "offline_gens": args.offline_generations,
               "offline_best_err": off["best_err"],
               "device": args.device})
    print(f"history saved to {path}")
    return path


if __name__ == "__main__":
    main()
