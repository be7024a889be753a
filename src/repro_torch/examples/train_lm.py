"""Train a reduced assigned-architecture LM on a synthetic Markov stream
through ``launch/train.py``'s ``make_train_step`` (AdamW), and check
that the loss goes down.

Run (on the CUDA card; ``--device cpu`` runs it on the CPU):

    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch qwen1.5-0.5b
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch mamba2-780m
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch whisper-large-v3

The VLM and audio models train on a zero prefix of ``num_prefix``
embeddings, as the JAX package's example.

Also demonstrates the paper technique on a transformer: --supernet samples
a random choice key per step (one-shot supernet training).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import make_lm_stream
from repro_torch.launch.train import init_opt, make_train_step
from repro_torch.models import transformer as tr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--supernet", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to train on the CPU")
    cfg = get_config(args.arch, smoke=True)
    if args.supernet:
        cfg = cfg.replace(supernet=True)
    params = tr.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg)
    n_params = sum(t.numel() for t in tr.flat_params(params).values())
    print(f"{cfg.name} (smoke): {n_params/1e6:.2f}M params"
          f"{' [supernet]' if args.supernet else ''} on {device}")

    opt = init_opt(params, "adamw")
    step_fn = make_train_step(cfg, optimizer="adamw", lr=args.lr,
                              remat=False)
    x, y = (torch.from_numpy(a).to(device) for a in make_lm_stream(
        0, args.steps * args.batch, args.seq, cfg.vocab_size))
    key_rng = np.random.default_rng(0)
    first = last = None
    for i in range(args.steps):
        rows = slice(i * args.batch, (i + 1) * args.batch)
        batch = {"tokens": x[rows], "labels": y[rows]}
        if cfg.family in ("vlm", "audio"):
            batch["prefix"] = torch.zeros(
                (args.batch, cfg.num_prefix, cfg.d_model), device=device)
        if args.supernet:
            batch["choice_key"] = key_rng.integers(0, 4, cfg.num_layers)
        params, opt, loss = step_fn(params, opt, batch)
        if first is None:
            first = float(loss)
        last = float(loss)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"  step {i:4d}  loss {last:.4f}")
    assert last < first, "loss did not decrease"
    print(f"loss {first:.3f} -> {last:.3f}  (decreased: OK)")


if __name__ == "__main__":
    main()
