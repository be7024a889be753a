"""The LM training step and its CLI driver.

``make_train_step`` builds ``train_step(params, opt, batch) -> (params,
opt, loss)``, the JAX package's step: the loss (fused unembed + cross
entropy by default, plus ``AUX_WEIGHT`` times the MoE load-balance
loss), its gradient through autograd, optional microbatches with
float32 gradient accumulation, and SGD + momentum (the paper's client
optimizer, the default) or AdamW (LM pretraining).

    python -m repro_torch.launch.train                  # card
    python -m repro_torch.launch.train --device cpu     # CPU

Params are the port's nested dicts and lists (``tr.init_params``); the
optimizer state is kept per leaf under ``tr.flat_params``'s dotted
names.  Every leaf gets a gradient, as ``jax.grad`` gives one: a
supernet branch the step's ``choice_key`` did not select gets zeros, so
its moments decay, its weight decay applies and SGD moves it by its
velocity, as in the JAX package.  Training takes ``backend="torch"``
(the default) or ``"chunked"`` (attention over query blocks, each
recomputed in the backward pass, so that no layer holds the whole
(B, H, S, S) float32 score tensor): the kernels (K3, K4, K5) are
forward-only, and a gradient through the ``"kernel"`` route raises at
the first step.

    python -m repro_torch.launch.train --arch zamba2-2.7b --device cpu \
        --backend chunked
    python -m repro_torch.launch.train --arch whisper-large-v3 --device cpu

The VLM (``internvl2-1b``) and audio (``whisper-large-v3``) models train
on a zero prefix of ``num_prefix`` embeddings, as the JAX package's CLI.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.data import make_lm_stream
from repro_torch.models import transformer as tr
from repro_torch.models.layers import cross_entropy, fused_cross_entropy
from repro_torch.optim import adamw_init, adamw_update, sgd_init, \
    sgd_update

AUX_WEIGHT = 0.01
OPTIMIZERS = ("sgd", "adamw")


def make_loss_fn(cfg: ModelConfig, *, window: int = 0,
                 backend: str = "torch", remat: bool = True,
                 fused_ce: bool = True) -> Callable:
    """``loss_fn(params, batch)`` -> the mean token cross entropy of
    ``batch["labels"]`` given ``batch["tokens"]`` (and the VLM's or audio
    model's ``batch["prefix"]``, a supernet's ``batch["choice_key"]``,
    host ints), plus ``AUX_WEIGHT`` x aux."""
    def loss_fn(params, batch):
        out, aux = tr.forward(
            params, cfg, batch["tokens"], prefix=batch.get("prefix"),
            choice_key=batch.get("choice_key"), window=window,
            backend=backend, remat=remat, return_hidden=fused_ce,
            return_aux=True)
        if fused_ce:
            loss = fused_cross_entropy(out, params["embed"]["table"],
                                       batch["labels"])
        else:
            loss = cross_entropy(out, batch["labels"])
        return loss + AUX_WEIGHT * aux
    return loss_fn


def init_opt(params, optimizer: str = "sgd"):
    """The optimizer state of nested ``params``, per flat leaf name."""
    flat = tr.flat_params(params)
    return adamw_init(flat) if optimizer == "adamw" else sgd_init(flat)


def make_train_step(cfg: ModelConfig, *, optimizer: str = "sgd",
                    lr: float = 0.1, momentum: float = 0.5,
                    window: int = 0, backend: str = "torch",
                    remat: bool = True, fused_ce: bool = True,
                    microbatch: int = 1,
                    on_microbatch: Optional[Callable[[int], None]] = None
                    ) -> Callable:
    """``microbatch`` > 1 splits the batch on its leading axis into that
    many microbatches, run one after another with the same
    ``choice_key``: their gradients are summed in float32 (from zeros,
    in order) and scaled by ``1 / microbatch``, as is the loss.
    Activation memory falls by the same factor; the arithmetic is
    unchanged.  ``on_microbatch(i)``, where given, is called once
    microbatch i's gradients are summed (the dry run reads the work of
    one microbatch between two calls).  ``backend`` is taken as the JAX package's is, but only
    ``"torch"`` and ``"chunked"`` train: every LM family reaches K3, K4
    or K5 on ``"kernel"``, and those refuse a gradient."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}: the port takes "
                         f"{list(OPTIMIZERS)}")
    loss_fn = make_loss_fn(cfg, window=window, backend=backend, remat=remat,
                           fused_ce=fused_ce)

    def loss_and_grads(flat, batch):
        leaves = {k: v.detach().requires_grad_() for k, v in flat.items()}
        loss = loss_fn(tr.nested_params(leaves), batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), dict(zip(leaves, grads))

    def grads_of(flat, batch):
        if microbatch <= 1:
            loss, grads = loss_and_grads(flat, batch)
            return loss, {k: torch.zeros_like(flat[k]) if g is None else g
                          for k, g in grads.items()}
        b = batch["tokens"].shape[0]
        if b % microbatch:
            raise ValueError(f"batch of {b} does not split into "
                             f"{microbatch} microbatches")
        n = b // microbatch
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in flat.items()}
        tot = torch.zeros((), dtype=torch.float32,
                          device=batch["tokens"].device)
        for i in range(microbatch):
            mb = {k: v if k == "choice_key" else v[i * n:(i + 1) * n]
                  for k, v in batch.items()}
            loss, grads = loss_and_grads(flat, mb)
            for k, g in grads.items():
                if g is not None:
                    acc[k].add_(g)
            tot = tot + loss
            if on_microbatch is not None:
                on_microbatch(i)
        scale = 1.0 / microbatch
        return tot * scale, {k: g * scale for k, g in acc.items()}

    def train_step(params, opt, batch):
        flat = tr.flat_params(params)
        loss, grads = grads_of(flat, batch)
        with torch.no_grad():
            if optimizer == "adamw":
                flat, opt = adamw_update(flat, grads, opt, lr)
            else:
                flat, opt = sgd_update(flat, grads, opt, lr, momentum)
        return tr.nested_params(flat), opt, loss

    return train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="smoke-size training driver")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--backend", default="torch", help="torch or chunked")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to train on the CPU")
    cfg = get_config(args.arch, smoke=True)
    params = tr.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg)
    opt = init_opt(params, args.optimizer)
    step_fn = make_train_step(cfg, optimizer=args.optimizer, lr=args.lr,
                              backend=args.backend, remat=False)
    x, y = (torch.from_numpy(a).to(device) for a in make_lm_stream(
        0, args.steps * args.batch, args.seq, cfg.vocab_size))
    print(f"{cfg.name} (smoke) on {device}, {args.optimizer}, "
          f"{args.backend} route")
    for i in range(args.steps):
        rows = slice(i * args.batch, (i + 1) * args.batch)
        batch = {"tokens": x[rows], "labels": y[rows]}
        if cfg.family in ("vlm", "audio"):
            batch["prefix"] = torch.zeros(
                (args.batch, cfg.num_prefix, cfg.d_model), device=device)
        params, opt, loss = step_fn(params, opt, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(loss):.4f}")


if __name__ == "__main__":
    main()
