"""Serving steps: prefill (a full-sequence forward that yields the next
token's logits) and single-token decode against the KV/SSM cache, plus a
batched greedy generation driver.

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b             # card
    python -m repro_torch.launch.serve --arch mamba2-780m --device cpu # CPU
    python -m repro_torch.launch.serve --arch zamba2-2.7b --backend chunked
    python -m repro_torch.launch.serve --arch whisper-large-v3

``--arch`` takes ``qwen1.5-0.5b``, ``chatglm3-6b`` and ``starcoder2-3b``
(dense), ``mamba2-780m`` (SSM), ``granite-moe-1b-a400m`` (MoE),
``zamba2-2.7b`` (hybrid), ``internvl2-1b`` (VLM), ``whisper-large-v3``
(audio) and, on the CPU only, ``deepseek-67b`` (dense) and
``llama4-scout-17b-a16e`` (MoE with a shared expert): their full configs
do not fit one card.  The VLM and audio models get a zero prefix of
``num_prefix`` embeddings (patches, frames), as the JAX package's CLI.

On the card the config runs at full width in its dtype; on the CPU
(``--device cpu``) at its smoke size.  Weights are random, from a seeded
``torch.Generator``.  The CLI prefills the prompt on ``--backend``
(``kernel``, ``torch`` or ``chunked``) and prints the next token it
picks, then generates greedily (decode replays the prompt and launches
no kernel, whatever the backend).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.models import transformer as tr
from repro_torch.models.layers import unembed


def make_prefill_step(cfg: ModelConfig, *, window: int = 0,
                      backend: str = "kernel") -> Callable:
    """``prefill_step(params, batch)`` -> the last position's logits
    (B, 1, V) for ``batch["tokens"]`` (B, S), after ``batch["prefix"]``
    where the family takes one (VLM, audio).  Only that position is
    unembedded (the logits of the others are never read)."""
    def prefill_step(params, batch):
        h = tr.forward(params, cfg, batch["tokens"],
                       prefix=batch.get("prefix"), window=window,
                       backend=backend, return_hidden=True)
        return unembed(params["embed"], h[:, -1:, :])
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, window: int = 0) -> Callable:
    """``decode_step(params, cache, batch)`` -> (logits (B, 1, V), cache)
    for ``batch["token"]`` (B, 1); the cache is updated in place."""
    def decode_step(params, cache, batch):
        return tr.decode_step(params, cfg, batch["token"], cache,
                              window=window)
    return decode_step


def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor,
                    steps: int, cache_len: int = 0, window: int = 0,
                    prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched greedy decoding: (B, S) prompt -> (B, S + steps) tokens.
    The cache is built by replaying all but the last prompt token; the
    last one is decoded, so its logits pick the first new token.  The
    audio model's ``prefix`` (frames) runs through ``encode`` once, on
    the kernel route, and fills the cross K/V; a VLM's is accepted and
    not used, as in the JAX package (its decode is the text-only
    decoder)."""
    b, s = prompt.shape
    enc_out = None
    if cfg.family == "audio":
        if prefix is None:
            raise ValueError(f"{cfg.name}: greedy_generate needs the "
                             "frames (prefix)")
        enc_out = tr.encode(params, cfg, prefix)
    cache = tr.prefill_cache(params, cfg, prompt[:, :-1], window=window,
                             cache_len=cache_len or (s + steps),
                             enc_out=enc_out)
    step = make_decode_step(cfg, window=window)
    last = prompt[:, -1:]
    out = [prompt]
    for _ in range(steps):
        logits, cache = step(params, cache, {"token": last})
        last = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(
            prompt.dtype)
        out.append(last)
    return torch.cat(out, dim=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="greedy serving driver")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--backend", default="kernel",
                    help="the prefill's route: kernel, torch or chunked")
    ap.add_argument("--device", default="cuda",
                    help="cuda (full width) or cpu (smoke size)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run the smoke size on the "
                           "CPU")
    cfg = get_config(args.arch, smoke=device.type == "cpu")
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.inference_mode():
        params = tr.init_params(gen, cfg)
        prompt = torch.randint(0, cfg.vocab_size,
                               (args.batch, args.prompt_len),
                               generator=gen, device=device)
        batch = {"tokens": prompt}
        if cfg.family in ("vlm", "audio"):
            batch["prefix"] = torch.zeros(
                (args.batch, cfg.num_prefix, cfg.d_model), device=device)
        t0 = time.perf_counter()
        logits = make_prefill_step(cfg, window=args.window,
                                   backend=args.backend)(params, batch)
        first = torch.argmax(logits[:, -1, :], dim=-1).cpu()
        t1 = time.perf_counter()
        toks = greedy_generate(params, cfg, prompt, args.steps,
                               window=args.window,
                               prefix=batch.get("prefix"))
        toks = toks.cpu()
    print(f"{cfg.name} ({cfg.d_model} wide, {cfg.num_layers} layers, "
          f"{cfg.dtype}) on {device}: prefill of {tuple(prompt.shape)} "
          f"tokens on the {args.backend} route in {t1 - t0:.3f} s, next "
          f"tokens {first.tolist()}; generated {tuple(toks.shape)} tokens "
          f"in {time.perf_counter() - t1:.3f} s")
    print(toks[0].tolist())


if __name__ == "__main__":
    main()
