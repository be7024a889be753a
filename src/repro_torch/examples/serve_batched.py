"""Serve a reduced model with batched requests: greedy generation through
``decode_step`` (the prompt replayed into the cache, then one token a
step), with a sliding-window ring-buffer decode (``--window``).

Run (the smoke config on the CUDA card; ``--device cpu`` runs it on the
CPU):

    PYTHONPATH=src python -m repro_torch.examples.serve_batched
    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --arch mamba2-780m --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --window 16

Decode launches no kernel (the MoE takes its torch route there); the
audio model encodes its zero frames once, on the kernel route.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import greedy_generate
from repro_torch.models import transformer as tr


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--window", type=int, default=0,
                    help=">0: sliding-window ring-buffer decode")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    cfg = get_config(args.arch, smoke=True)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.inference_mode():
        params = tr.init_params(gen, cfg)
        prompt = torch.randint(0, cfg.vocab_size,
                               (args.batch, args.prompt_len),
                               generator=gen, device=device)
        prefix = None
        if cfg.family in ("vlm", "audio"):
            prefix = torch.zeros((args.batch, cfg.num_prefix, cfg.d_model),
                                 device=device)
        total = args.prompt_len + args.steps
        cache_len = min(args.window, total) if args.window else total
        t0 = time.perf_counter()
        toks = greedy_generate(params, cfg, prompt, args.steps,
                               cache_len=cache_len, window=args.window,
                               prefix=prefix).cpu()
        dt = time.perf_counter() - t0
    n_new = args.batch * args.steps
    print(f"{cfg.name} on {device}: {args.batch} requests x {args.steps} "
          f"new tokens in {dt:.3f} s ({n_new / dt:.1f} tok/s, "
          f"cache_len={cache_len}{', sliding' if args.window else ''})")
    print("first request:", toks[0].tolist())
    return toks


if __name__ == "__main__":
    main()
