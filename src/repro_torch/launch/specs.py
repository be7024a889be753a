"""Meta-tensor stand-ins for every input of the step functions: the dry
run (``launch/dryrun.py``) runs the steps on these, and they allocate
nothing.

The JAX package's ``ShapeDtypeStruct``s become tensors on the ``meta``
device: the same shapes and dtypes (tokens and labels int32, as the
JAX package's; the models cast them to int64 where they index).
Functions, never module-level tensors: importing this module touches
no device.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as tr

META = torch.device("meta")


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: ``tr.init_params`` draws
    every leaf there, so a full config (deepseek-67b's 134 GB in bf16)
    allocates nothing.  (``torch.Generator(device="meta")`` itself
    raises: meta is not an accelerator.)"""
    device = META


def effective_window(cfg: ModelConfig, shape: InputShape) -> int:
    """long_500k forces the sliding-window attention variant for every
    attention-bearing arch; other shapes use full attention."""
    return cfg.sliding_window if shape.sliding else 0


def cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    w = effective_window(cfg, shape)
    return min(shape.seq_len, w) if w else shape.seq_len


def input_specs(cfg: ModelConfig, shape: InputShape,
                batch: int = 0) -> Dict[str, torch.Tensor]:
    """Step-function inputs for (arch x shape), meta tensors only:
    ``tokens`` and ``labels`` (train), ``tokens`` (prefill) or one new
    ``token`` (decode, against a ``seq_len``-deep cache), and the VLM's
    or audio model's ``prefix`` where the step takes one.  ``batch``
    (default the shape's global batch) is the rows they hold."""
    b, s = batch or shape.global_batch, shape.seq_len

    def ints(*dims):
        return torch.empty(dims, dtype=torch.int32, device=META)

    if shape.kind == "train":
        out = {"tokens": ints(b, s), "labels": ints(b, s)}
    elif shape.kind == "prefill":
        out = {"tokens": ints(b, s)}
    else:
        out = {"token": ints(b, 1)}
    if cfg.family in ("vlm", "audio") and shape.kind != "decode":
        out["prefix"] = torch.empty((b, cfg.num_prefix, cfg.d_model),
                                    dtype=cfg.torch_dtype, device=META)
    return out


def abstract_params(cfg: ModelConfig) -> Any:
    """``tr.init_params`` of ``cfg`` on the meta device."""
    return tr.init_params(MetaGenerator(), cfg)


def abstract_cache(cfg: ModelConfig, shape: InputShape, params=None,
                   batch: int = 0) -> Any:
    """``tr.init_cache`` over abstract params (``params``, or
    ``abstract_params(cfg)``): ``batch`` (default the global batch) rows
    of ``cache_len`` slots, and the audio model's cross K/V over its
    ``num_prefix`` frames."""
    enc_len = cfg.num_prefix if cfg.family == "audio" else 0
    return tr.init_cache(abstract_params(cfg) if params is None else params,
                         cfg, batch or shape.global_batch,
                         cache_len(cfg, shape), enc_len=enc_len)
