#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each fatal on failure:

1. device: the card's name and power limit (``nvidia-smi``); float32
   convolutions and matmuls in full float32 (TF32 off) and cuDNN
   deterministic, so that two runs differ only where the code differs;
2. build: every CUDA kernel of the main path, from ``csrc/`` with nvcc,
   one nvcc per source, all started together (ptxas's report of
   registers and spills logged); the tensor-core flash attention's
   registers, local and shared memory per variant, the tensor-core
   expert GEMM's, the TMA-fed float32 flash attention's per variant and
   float32 expert GEMM's, and those of the SSD scan's stage kernels, with
   no local memory (no spill);
3. check: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at ragged ones: fill-aggregation within
   rtol = atol = 1e-6, and its in-place variant (``donate_prev``) bit for
   bit the out-of-place result, in prev's storage, with
   ``memory_allocated`` unchanged across the call (out of place it grows
   by 4 P bytes); int8 quantize/dequantize bit for bit, per vector
   (exact ties, zeros, clipping, views 0-3 elements past a 16-byte
   boundary, the largest leaf and the whole master as one vector) and
   per tree with the scale pass (the 126-leaf master, the same master as
   views of one flat vector 1-3 elements past a boundary, a 600-leaf
   tree over a table's capacity, ties with zeros, all-zero and 1-element
   leaves, and ties and clipping at given scales), 3 launches a chunk;
4. timing: each kernel at the main path's shape (int8: its largest leaf,
   and the whole master as one vector; K1 out of place and in place),
   beside its bound, its plain
   version and the nearest single PyTorch call, all as device time
   (calls queued behind a spin kernel), and the kernel's time per call
   with the host's dispatch; the int8 kernels and the scale pass over
   the 126-leaf full-width master as one tree, and its roundtrip's
   device time beside its 14 P-byte bound and its time with dispatch on
   the kernel and torch routes;
5. main path: ``FedEngine`` + ``RealTimeNas`` on the full 12-block CIFAR
   supernet (26,119,059 parameters), 8 clients, 2 generations, with
   Algorithm 3 on the kernel; the launch counts are zeroed just before
   and read just after;
6. the same run with Algorithm 3 in plain PyTorch: equal keys and
   CommStats, masters within 1e-4; and the smoke-size run on the card
   against the same run on the CPU (the path the CPU tests hold against
   the JAX package);
7. codec path: the phase-5 run with ``uplink_codec`` and
   ``downlink_codec`` ``"int8:kernel"`` (launch counts zeroed before and
   read after: 8 roundtrips x 1 chunk of the scale pass and of each int8
   kernel, 3 fill-aggregations), then with ``"int8:torch"``: equal keys and
   CommStats, masters within 1e-4, wire bytes below logical bytes;
8. baselines at full width with the ``"int8:kernel"`` uplink:
   ``FedAvgBaseline`` on the all-residual key for 2 rounds and
   ``OfflineNas`` with population 2 for 1 generation, each with its
   launch counts zeroed before and read after (one launch of each int8
   kernel per roundtrip);
9. flash attention (K3), the SSD chunk scan (K4) and the grouped expert
   GEMM (K5) against their plain versions on the card: K3 in float32 and
   bfloat16 at the shapes of the
   JAX package's kernel sweep (GQA, MQA, S = 384), S = 100 (one ragged
   tile), S = 300 (a ragged last tile past 128), head dims 80, 36, 30
   and 256, qwen1.5-0.5b's prefill (4, 1024, 16, 16,
   64), granite-moe-1b-a400m's (4, 1024, 16, 8, 64) and the dense
   shelf's at head dim 128: chatglm3-6b's (4, 1024, 32, 2, 128),
   starcoder2-3b's (4, 1024, 24, 2, 128) and deepseek-67b's (4, 1024,
   64, 8, 128), zamba2-2.7b's shared block at head dim 80 (4, 1000,
   32, 32, 80), internvl2-1b's (4, 1280, 14, 2, 64) (256 patches and
   1024 tokens, GQA 7) and whisper-large-v3's encoder (4, 1500, 20, 20,
   64) (a ragged last tile of 92 keys) and decoder (4, 448, 20, 20, 64),
   each causal, with window 64 and 256, and bidirectional (rtol 2e-5 /
   atol 1e-4 in float32, 2^-7 / 1e-3 in bfloat16: one rounding of the
   output), each call on the kernel its dtype and head dim select (bf16
   with D % 8 == 0: the tensor-core kernel; float32 with D % 4 == 0: the
   TMA-fed float32 kernel; else the CUDA-core one), and
   starcoder2-3b's long prefill (1, 8192, 24, 2, 128) at its window of
   4096, longer than any tile, to the same limits, where the plain
   version without the window (and in float32 with it one key longer)
   must fall outside them; K4
   at the sweep's shapes, two P tiles, mamba2-780m's prefill,
   zamba2-2.7b's (4, 8, 128, 64, 80, 64) (P = 80), one chunk,
   32 chunks, no decay and strong decay (rtol = atol = 2e-4), each call
   one launch of each of its three stage kernels, and two calls equal
   bit for bit; without decay at 4 chunks and N 128, where the plain
   float32 recurrence itself drifts past 2e-4 from a float64 one, the
   kernel within the same limits of the float64 recurrence;
   K5 in float32 and bfloat16 at the JAX sweep's shapes, ragged C = 8,
   100 and 1256 (F 72, D 200), granite-moe-1b-a400m's prefill (wi/wg
   and wo) and decode shapes, and (2, 64, 100, 70), whose rows TMA
   cannot describe, after dividing by the output's largest magnitude
   (rtol = atol = 1e-5 in float32, 2^-7 / 1e-3 in bfloat16), each call
   on the kernel its dtype and shape select (bf16 with D and F multiples
   of 8: the tensor-core kernel; other bf16: the mma.sync kernel;
   float32 with D and F multiples of 4: the TMA-fed float32 kernel;
   other float32: the CUDA-core kernel), and ``ops.expert_ffn`` (three K5
   launches) against the einsum ``moe.expert_ffn`` at granite's prefill
   shape; each timed at its serving shape beside its bound and its plain
   version, K3 in bf16 and float32 also beside
   ``scaled_dot_product_attention`` of the same dtype (the kernels it
   launches in float32 logged) (at qwen's
   and granite's shapes and at window 256, at the dense shelf's three
   prefills, at starcoder2's 1 x 8192 tokens at window 4096, at
   zamba2's, at internvl2's and whisper's decoder's, causal, and at
   whisper's encoder's, bidirectional), K4 beside the torch route's
   chunked scan (at mamba2's and zamba2's shapes), and K5 in bf16 and
   float32 beside ``torch.bmm`` (at granite's wi and wo shapes);
10. the serving path at full width, bf16, seeded random weights on the
   card, 4 requests: for qwen1.5-0.5b (1024-token prompt; also with
   window 256), mamba2-780m (1000-token prompt: chunk padding),
   granite-moe-1b-a400m (1024-token prompt; also with window 256) and
   the dense shelf at head dim 128 (1024-token prompts):
   chatglm3-6b (28 layers, 5.98 B parameters), starcoder2-3b (30 layers;
   also one request of 8192 tokens at its sliding window of 4096) and
   deepseek-67b at full width but 8 of its 95 layers (6.38 B
   parameters: the whole model, about 134 GB in bf16, does not fit one
   card), the hybrid zamba2-2.7b (54 SSM layers at P = 80 and one
   shared attention block at head dim 80 after every 6th; 1000-token
   prompt), the VLM internvl2-1b (24 layers, GQA 7; 1024 tokens after
   256 patches through its projector) and the audio model
   whisper-large-v3 (32 bidirectional encoder layers over 1500 frames,
   32 decoder layers with cross attention; 448 tokens), the prefixes
   normal x 0.1 from the seed,
   ``make_prefill_step`` on the kernel route (launch counts zeroed
   before and read after: per layer one K3, one K4, or one K3 and three
   K5, one K3 per application point of zamba2's shared block: 54 K4
   and 9 K3, and one per whisper encoder layer: 64 K3, 32 of them
   bidirectional; every K3 and K5 of a bf16 prefill on its tensor-core kernel, of a
   float32 one on its TMA-fed float32 kernel; one launch of each of K4's stage
   kernels per K4 call) against the torch route, within
   LOGIT_TOL of the logits' largest
   magnitude (15 % in bf16; 0.1 % in a float32 prefill at the same
   widths and depth, for every arch).  For granite also: every MoE
   layer's input from
   the torch-route prefill through ``moe_apply`` on both routes (equal
   routing by construction: y within the phase-9 limits times three,
   the K5 products a layer chains; aux equal), and the number of top-k
   decisions that differ between the two routes' prefills, summed over
   the layers;
   ``greedy_generate`` of 16 tokens on a 64-token prompt with no kernel
   launch (decode replays, as the JAX package's ``prefill_cache``) but
   whisper's one encoder pass (32 K3);
   prefill time, decode tokens/s and peak memory; the ``chunked``
   route (attention over blocks of 512 queries, plain PyTorch) against
   the torch route with no kernel launch, within 15 % (bf16) / 1e-5
   (float32) of the largest logit, with each route's time and peak
   memory, for qwen1.5-0.5b's, zamba2-2.7b's, internvl2-1b's and
   whisper-large-v3's prefills in bf16 and float32 and starcoder2-3b's
   1 x 8192 tokens at window 4096; and, at smoke size in float32
   (zamba2 at 4 layers: two application points), prefill logits
   against the decode replay within 1e-3 (for the MoE at a capacity
   that cannot drop a choice: a prefill that drops differs from the
   replay, in the JAX package too; whisper's replay from the encoder's
   output; internvl2's replay, which never sees the patches as the JAX
   package's does not, against the text-only prefill of its weights,
   its gap to the VLM prefill logged);
11. the batched backend: the phase-5 run on ``backend="vmap"``, each
   with its launch counts zeroed before and read after, held against
   phase 5's ``loop`` run (equal keys and CommStats, masters within
   1e-4): fused on the kernel route (3 K1 launches, all in place; 8
   dispatches), fused on the torch route (no launch; 5 dispatches), and
   fused with ``uplink_codec="int8:kernel"`` (master donation off; 3
   launches each of the scale pass, K2a and K2b) against a ``loop`` run
   with the same uplink (masters within 1e-4 plus one int8 step of the
   leaf's update).  At this width a float32 client update lies about
   1e-3 from a float64 one, so a master is held to the loop's only
   where the run adds the same uploads in the loop's order; non-fused
   on the kernel route (12 K1 launches, 3 in place; 40 dispatches)
   adds K1's per-group partials, so its keys and CommStats are held to
   the loop run's, its master gap logged, and one ``train_fill`` held to
   the loop's within 1e-6; generation 2's ``round_s`` and the peak
   device memory of each run beside phase 5's;
12. telemetry and checkpoints at full width: phase 5's ``loop`` run,
   phase 11's fused kernel-route ``vmap`` run and phase 7's
   ``"int8:kernel"`` run again with ``telemetry={"sink": "jsonl:..."}``
   (launch counts zeroed before and read after), each against the same
   run off earlier in this process: keys and CommStats equal, masters bit
   for bit, dispatches, launches and K1's variants equal; the JAX
   package's signature counts (``client_update`` and ``evaluator``;
   ``fused_uploads`` and ``fused_eval_shared``), new signatures in
   generation 1 only, the codec, ``download`` and ``host_fetch`` span
   paths, one jsonl line a generation, ``live_device_bytes`` equal to
   ``torch.cuda.memory_allocated`` at each round's end, and generation
   2's ``round_s`` on and off logged; then the ``loop`` and ``vmap`` runs
   under ``torch.profiler`` (``profiler_dir``), masters still bit for bit,
   generation 2 split by phase from each Chrome trace (host ms, device
   ms of the kernels launched inside each span, device busy time, idle
   share, the five kernels with the most time); and phase 5's master
   through ``save_pytree`` and ``restore_latest`` onto a CUDA template,
   bit for bit with one key per leaf;
13. the LM supernet NAS path: (a) the qwen1.5-0.5b, mamba2-780m,
   granite-moe-1b-a400m, zamba2-2.7b and internvl2-1b (after its 256
   patches) supernets at full width, seeded random weights on the card,
   4 requests of 256 tokens,
   ``forward(..., choice_key=)`` on the kernel route (launch counts
   zeroed before and read after: one K3 or K4 call per layer that is
   not an identity, three K5 per MoE layer on the full or lite branch
   and none on the bottleneck, and zamba2's shared block 9 K3 on every
   key, the all-identity one too) against
   the torch route within LOGIT_TOL, on the all-1, all-2, all-3, all-0
   and mixed keys in bf16 and on the mixed key in float32, and an audio
   supernet's forward raising, as the JAX package's; (b) the
   qwen1.5-0.5b supernet's search (1,080,574,976 parameters, bf16; 4
   ``make_lm_stream`` clients, population 4, 2 generations) on the
   ``loop`` backend with K1, its launches asserted, one generation-1
   ``train_fill`` within one bf16 step of the torch route, and K1 timed
   at that master; (c) the same search at smoke size in float32 against
   the CPU (keys and CommStats equal, masters within 1e-4), and both
   examples at their default sizes;
14. the LM training launcher (``launch/train.py``): (a) qwen1.5-0.5b at
   full width and depth in bf16, ``make_train_step`` with AdamW, 2
   microbatches, remat and the fused cross entropy on the torch route,
   8 steps of 4 x 4096 ``make_lm_stream`` tokens: every loss finite,
   the last below the first, no kernel launched (counts zeroed before,
   read after); step time, tokens/s, peak memory and model FLOP/s
   logged; (b) at full width, 2 layers, float32: remat on against off
   (bit for bit) and 2 microbatches against 1 (parameters within 1e-6
   of their largest) on one SGD step, the fused cross entropy against the naive one at
   4 x 4096 tokens and V = 151936 (loss within 1e-6 relative, the
   table's gradient within 1e-5 of its largest, h's within 2e-4 of a
   float64 recomputation of 512 rows, a lower peak); (c) a train step on
   ``backend="kernel"`` raises (the kernels are forward-only), with no
   launch; (d) at smoke size in float32 one SGD and one AdamW step, 3
   SGD steps of the supernet with a key each, and one SGD step each of
   internvl2-1b and whisper-large-v3 with their prefixes, against the
   CPU (within
   1e-5; AdamW's parameters but for noise-gradient entries); (e)
   ``launch.train`` and the ``train_lm`` example (plain and
   ``--supernet``) at their defaults; (f) (a) again on the ``chunked``
   route (no kernel launched; step time and peak beside (a)'s); (g) in
   (b), one SGD step on the chunked route against the torch route
   (parameters within 1e-5 of their largest); (h) zamba2-2.7b at full
   width and 12 of its 54 layers (two application points of the shared
   block), bf16, AdamW, remat, 4 steps of 2 x 4096 tokens on the chunked
   route: losses finite and falling, no kernel launched, a gradient on
   every leaf of the shared block;
15. the mesh (``backend="mesh"``, ``launch/mesh|policy``): (a) phase 11's
   three fused runs (kernel route, torch route, ``"int8:kernel"``
   uplink) on ``make_host_mesh()`` (one device, cuda:0), and one
   non-fused run on each route, each bit for bit the fused ``vmap`` run
   of phase 11 on its route (keys, CommStats, masters, dispatches,
   launches, K1's variants; the mesh's kernel route takes the same
   partly fused path fused or not), generation 2's ``round_s`` and peak
   memory beside ``vmap``'s; (b) the kernel route on a mesh that names
   cuda:0 three times (population 4 padded to 6): keys and CommStats
   equal to (a)'s, 3 K1 launches, its master gap logged (the float32
   sums are grouped per device), and one generation-1 ``train_fill`` on
   the torch route within 1e-6 of ``vmap``'s; (c) (a)'s fused kernel route
   with a jsonl telemetry sink, bit for bit the run off, with the JAX
   mesh's program names (``train_uploads``, ``fused_eval_shared``: one
   signature each, in generation 1), then fused kernel-route ``vmap``
   and ``mesh`` runs in turns (vmap, mesh, mesh, vmap), nothing of an
   earlier run alive: generation 2's ``round_s`` and the peak memory
   above what the card held before each; (d) under ``policy.set_mesh(
   make_host_mesh())``: granite-moe-1b-a400m's prefill of 4 x 1024
   tokens at full width on the kernel route, bf16 and float32, with 24
   K3 and no K5 (the expert-parallel MoE runs its products as einsums)
   within MESH_PREFILL_TOL (1e-3 of the largest logit in bf16, 1e-5 in
   float32) of the same prefill with no mesh (24 K3, 72 K5), both timed
   in turns; qwen1.5-0.5b's ``greedy_generate`` at smoke size in
   float32 with the no-mesh tokens, and at full width in bf16 (the
   pinned decode rounds its probabilities to bf16) with its token
   agreement and decode step time logged; (e) the ``serve_batched``
   example at its defaults and ``federated_nas_cifar`` at its default
   size on ``--engine-backend mesh`` (6 K1 launches, all in place);
16. the dry run (``launch/dryrun.py``, on the meta device): (a) every
   arch but the CIFAR supernet x every shape on the 16 x 16 mesh, torch
   route, in worker processes: every record made and finite, its
   arguments the per-device sum of the specs; (b) on a (1, 1) mesh of
   cuda:0, qwen1.5-0.5b's training step at phase 14's setting and the
   4 x 1024 bf16 torch-route prefills of qwen1.5-0.5b and
   granite-moe-1b-a400m, each estimate against the same step on the
   card: arguments within 0.1 % of what ``memory_allocated`` grew by,
   the peak within 5 % (training) or 10 % (prefills) of
   ``max_memory_allocated``, the FLOPs equal to ``FlopCounterMode``'s on
   the card, ``compute_s`` and ``memory_s`` no larger than the measured
   step; (c) the kernel route on meta for qwen's, mamba2's and granite's
   phase-10 prefills: the counted K3, K4 and K5 launches equal phase
   10's.

Prints the traced rounds, the training, the mesh and the dry-run numbers
as one JSON line, the kernels as one JSON line,
then the ``nvidia-smi`` line, then ``{"ok": true, "device": {...}}`` as
the last line.  Exits non-zero
without that line if any phase fails or no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.ckpt import restore_latest, save_pytree  # noqa: E402
from repro_torch.configs import ARCH_ALIASES, SHAPES, InputShape, \
    get_config, get_shape  # noqa: E402
from repro_torch.core import cnn_supernet_api, lm_supernet_api  # noqa: E402
from repro_torch.data import ClientDataset, make_classification, \
    make_clients, make_lm_stream, partition_iid  # noqa: E402
from repro_torch.comm import make_codec  # noqa: E402
from repro_torch.engine import FedAvgBaseline, FedEngine, LoopBackend, \
    MeshBackend, OfflineNas, RunConfig, VmapBackend, backends  # noqa: E402
from repro_torch.core.flops import train_flops  # noqa: E402
from repro_torch.examples import federated_nas_cifar, quickstart, \
    serve_batched, train_lm  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import expert_gemm as egemm  # noqa: E402
from repro_torch.kernels import fill_aggregate as kfa  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import quantize as kq  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.launch import dryrun, policy  # noqa: E402
from repro_torch.launch.roofline import BF16_FLOPS, FP32_FLOPS, bound, \
    expert_gemm_cost, flash_attention_cost, ssd_scan_cost, \
    tensor_leaves  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh, \
    make_production_mesh  # noqa: E402
from repro_torch.launch.serve import greedy_generate, make_decode_step, \
    make_prefill_step  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.layers import cross_entropy, \
    fused_cross_entropy, unembed  # noqa: E402
from repro_torch.models.ssm import ssd_chunked_torch  # noqa: E402
from repro_torch.obs import load_trace, round_split, traced  # noqa: E402

TOL = 1e-6              # <= 8 float32 terms summed in another order, FMA
MASTER_TOL = 1e-4       # route-to-route gap of the final master
MAIN_M, MAIN_P = 8, 26_119_059   # uploads per train_fill x master params
LEAF_P = 2_359_296               # the master's largest leaf (512 x 512 x 3 x 3)
N_LEAVES = 126                   # float leaves of the full-width master
N_CHUNKS = -(-N_LEAVES // kq.CAPACITY)   # int8 launches per roundtrip
# lr0 0.01, as the CPU parity tests: the compared runs then differ at
# round-off and no argmax flips between them
RUN = dict(population=4, generations=2, backend="loop", lr0=0.01,
           device="cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def fill_inputs(m, p, seed, zero_weight_row=False, zero_masks=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    cl = torch.randn(m, p, device="cuda", generator=g)
    mk = torch.randint(0, 2, (m, p), device="cuda", generator=g).float()
    if zero_masks:
        mk.zero_()
    w = torch.rand(m, device="cuda", generator=g)
    if zero_weight_row:
        w[0] = 0.0
    w = w / w.sum()
    prev = torch.randn(p, device="cuda", generator=g)
    return cl, mk, w, prev


def check_fill_aggregate() -> tuple:
    """K1 out of place against its plain version, then in place
    (``donate_prev``): bit for bit the out-of-place result, in prev's
    storage, with ``memory_allocated`` unchanged across the call where
    the out-of-place call grows it by 4 P bytes (the allocator's 512-byte
    rounding aside).  Returns the largest |kernel - plain| of each."""
    cases = [dict(m=1, p=1000), dict(m=2, p=8193), dict(m=5, p=100_000),
             dict(m=MAIN_M, p=MAIN_P),
             dict(m=5, p=100_003, zero_weight_row=True),
             dict(m=MAIN_M, p=MAIN_P, zero_masks=True)]
    worst = worst_inplace = 0.0
    for i, case in enumerate(cases):
        cl, mk, w, prev = fill_inputs(seed=i, **case)
        p = prev.numel()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        out = ops.fill_aggregate(cl, mk, w, prev)
        torch.cuda.synchronize()
        grew = torch.cuda.memory_allocated() - before
        plain = ref.fill_aggregate(cl, mk, w, prev)
        torch.testing.assert_close(out, plain, rtol=TOL, atol=TOL)
        if case.get("zero_masks"):
            torch.testing.assert_close(out, prev, rtol=TOL, atol=TOL)
        err = float((out - plain).abs().max())
        worst = max(worst, err)
        ptr = prev.data_ptr()
        before = torch.cuda.memory_allocated()
        got = ops.fill_aggregate(cl, mk, w, prev, donate_prev=True)
        torch.cuda.synchronize()
        grew_inplace = torch.cuda.memory_allocated() - before
        err_inplace = float((got - plain).abs().max())
        worst_inplace = max(worst_inplace, err_inplace)
        log(f"check fill_aggregate {case}: max |kernel - plain| = {err!r}; "
            f"in place {err_inplace!r}, bit for bit the out-of-place "
            f"result: {torch.equal(got.view(torch.int32), out.view(torch.int32))}"
            f", memory_allocated grew {grew_inplace} B (out of place "
            f"{grew} B, 4 P = {4 * p})")
        if not (got is prev and got.data_ptr() == ptr):
            raise AssertionError(f"fill_aggregate in place {case}: the "
                                 "result is not prev's storage")
        if not torch.equal(got.view(torch.int32), out.view(torch.int32)):
            raise AssertionError(f"fill_aggregate in place {case}: differs "
                                 "from the out-of-place result")
        if grew_inplace != 0 or not 4 * p <= grew < 4 * p + 512:
            raise AssertionError(
                f"fill_aggregate {case}: memory_allocated grew "
                f"{grew_inplace} B in place, {grew} B out of place")
        del cl, mk, w, prev, out, plain, got
    torch.cuda.empty_cache()
    return worst, worst_inplace


def int8_inputs(p, seed, ties, offset=0):
    """(x, scale) on the card, x a view ``offset`` elements past the
    start of its buffer.  ``ties``: a power-of-two scale and x on the
    half-steps k + 0.5 of its grid (exact ties, which round half to
    even), every seventh entry zero and |k| up to 140 (beyond 127: they
    clip); else normal x with the main path's scale, max|x| / 127."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.empty(offset + p, device="cuda")[offset:]
    if not ties:
        x.copy_(torch.randn(p, device="cuda", generator=g))
        return x, ref.int8_scale(x)
    scale = torch.tensor(2.0 ** -6, device="cuda")
    k = torch.randint(-140, 140, (p,), device="cuda", generator=g).float()
    x.copy_((k + 0.5) * scale)
    x[::7] = 0.0
    return x, scale


def check_int8() -> tuple:
    """K2a and K2b against their plain versions, bit for bit.  Returns
    the largest absolute difference of each (int8 steps, and float32)."""
    worst_q = worst_d = 0.0
    for i, p in enumerate((1, 1000, 8193, 100_003, LEAF_P, MAIN_P)):
        for ties in (False, True):
            x, scale = int8_inputs(p, seed=100 + i, ties=ties,
                                   offset=(i + ties) % 4)
            q = ops.quantize_int8(x, scale)
            # and from an int8 vector 0-3 bytes past a 16-byte boundary
            q_view = torch.empty(i % 4 + p, dtype=torch.int8,
                                 device="cuda")[i % 4:]
            q_view.copy_(q)
            d = ops.dequantize_int8(q_view, scale)
            torch.cuda.synchronize()
            q_plain = ref.quantize_int8(x, scale)
            d_plain = ref.dequantize_int8(q, scale)
            err_q = float((q.int() - q_plain.int()).abs().max())
            err_d = float((d - d_plain).abs().max())
            log(f"check int8 (P={p}, ties={ties}, x offset "
                f"{(i + ties) % 4}, q offset {i % 4}): max |kernel - plain| = "
                f"{err_q!r} (quantize), {err_d!r} (dequantize)")
            if not (torch.equal(q, q_plain) and torch.equal(
                    d.view(torch.int32), d_plain.view(torch.int32))):
                raise AssertionError(f"int8 kernels differ from the plain "
                                     f"version at P={p}, ties={ties}")
            if ties and p >= 1000 and int(q.abs().max()) != 127:
                raise AssertionError("tie inputs did not reach the clip")
            worst_q, worst_d = max(worst_q, err_q), max(worst_d, err_d)
            del x, q, d, q_plain, d_plain
    torch.cuda.empty_cache()
    return worst_q, worst_d


def master_leaves(api) -> list:
    """The float leaves of the full-width master, on the card."""
    master = api.init(torch.Generator().manual_seed(0))
    leaves = [v.cuda() for v in master.values() if v.is_floating_point()]
    if len(leaves) != N_LEAVES:
        raise AssertionError(f"master has {len(leaves)} float leaves")
    return leaves


def flat_views(leaves, offset: int) -> list:
    """``leaves`` as K1 hands them back: views of one flat vector, the
    first ``offset`` elements past its start."""
    flat = torch.empty(offset + sum(x.numel() for x in leaves),
                       device="cuda")
    views, off = [], offset
    for x in leaves:
        views.append(flat[off: off + x.numel()].view(x.shape))
        views[-1].copy_(x)
        off += x.numel()
    return views


def int8_trees(api) -> list:
    """(label, leaves, given scales or None) for the tree checks."""
    leaves = master_leaves(api)
    g = torch.Generator(device="cuda").manual_seed(11)
    sizes = torch.randint(1, 3000, (600,), generator=torch.Generator(
        ).manual_seed(12)).tolist()
    many = flat_views([torch.randn(n, device="cuda", generator=g)
                       for n in sizes], 1)
    many[5].zero_()
    many[6] = many[6][:1]
    step = 2.0 ** -6
    # max|x| = 127 step gives the scale step exactly: every other entry is
    # a tie of x / scale, which rounds half to even
    ties = []
    for n in (3, 4100, 70_001, 100_003):
        k = torch.randint(-127, 127, (n,), device="cuda", generator=g)
        x = (k.float() + 0.5) * step
        x[0] = 127 * step
        x[1::7] = 0.0
        ties.append(x)
    ties += [torch.zeros(33, device="cuda"), torch.full((1,), -0.3,
                                                        device="cuda")]
    clip = [((torch.randint(-140, 140, (n,), device="cuda", generator=g)
              .float() + 0.5) * step) for n in (1, 17, 4096, 5000, 100_003)]
    return [("master", leaves, None),
            *[(f"master as views {o} elements past a boundary",
               flat_views(leaves, o), None) for o in (1, 2, 3)],
            ("600 leaves, 3 chunks", many, None),
            ("ties, zeros, all-zero and 1-element leaves", ties, None),
            ("ties and clipping at a given scale", clip,
             torch.full((len(clip),), step, device="cuda"))]


def check_int8_tree(api) -> tuple:
    """The scale pass, K2a and K2b over trees against the plain per-leaf
    route (``ref.int8_scale``, ``ref.quantize_int8``,
    ``ref.dequantize_int8``), bit for bit, with 3 launches a chunk (2
    with given scales).  Returns the largest absolute difference of the
    scales, the int8 steps and the float32 outputs."""
    worst = [0.0, 0.0, 0.0]
    for label, leaves, given in int8_trees(api):
        before = dict(ops.LAUNCHES)
        q, scales, layout = ops.quantize_int8_leaves(leaves, given)
        outs = ops.dequantize_int8_leaves(q, scales, layout)
        torch.cuda.synchronize()
        chunks = len(layout.chunks)
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        expected = {**dict.fromkeys(before, 0), "quantize_int8": chunks,
                    "dequantize_int8": chunks,
                    "int8_scale": chunks if given is None else 0}
        if launched != expected:
            raise AssertionError(f"int8 tree {label}: launches {launched}, "
                                 f"expected {expected}")
        errs, same, q_max = [0.0, 0.0, 0.0], True, 0
        for i, (x, off, out) in enumerate(zip(
                leaves, layout.offsets.tolist(), outs)):
            s_plain = ref.int8_scale(x) if given is None else given[i]
            q_plain = ref.quantize_int8(x.reshape(-1), s_plain)
            d_plain = ref.dequantize_int8(q_plain, s_plain)
            q_leaf = q[off: off + x.numel()]
            q_max = max(q_max, int(q_leaf.int().abs().max()))
            errs = [max(errs[0], float((scales[i] - s_plain).abs())),
                    max(errs[1], float((q_leaf.int() - q_plain.int())
                                       .abs().max())),
                    max(errs[2], float((out.reshape(-1) - d_plain)
                                       .abs().max()))]
            same &= (torch.equal(scales[i].view(torch.int32),
                                 s_plain.view(torch.int32))
                     and torch.equal(q_leaf, q_plain)
                     and out.shape == x.shape
                     and torch.equal(out.reshape(-1).view(torch.int32),
                                     d_plain.view(torch.int32)))
        log(f"check int8 tree ({label}; {len(leaves)} leaves, {chunks} "
            f"chunk(s), launches {launched}): max |kernel - plain| = "
            f"{errs[0]!r} (scales), {errs[1]!r} (quantize), {errs[2]!r} "
            f"(dequantize)")
        if not same:
            raise AssertionError(f"int8 tree kernels differ from the plain "
                                 f"per-leaf route: {label}")
        if given is not None and q_max != 127:
            raise AssertionError("tie inputs did not reach the clip")
        worst = [max(a, b) for a, b in zip(worst, errs)]
        del leaves, q, outs
    torch.cuda.empty_cache()
    return tuple(worst)


def device_ms(fn, reps: int, rounds: int = 5, spin: int = 100_000
              ) -> float:
    """Device time of one call: ``reps`` calls queued back to back behind
    a spin kernel (so the host's dispatch time is hidden: ``spin`` cycles
    per call, ~50 us by default, must outlast one call's dispatch), timed
    with CUDA events over the batch; the median over ``rounds`` batches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(reps * spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) / reps for s, e in times]))


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    """Time of one call as the main path makes it, the host's dispatch
    included: events around each single call, median over ``reps``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


def time_fill_aggregate(card: str) -> tuple:
    """K1 out of place and in place at the main path's shape, each beside
    the same bound (the same bytes: in place, prev is read once and
    written once), its plain version and the nearest PyTorch expression
    (lerp + matvec; in place with ``out=prev``, as the (1, P) product
    ``mm`` writes).  Out of place is timed
    before and after in place, and both are logged."""
    m, p = MAIN_M, MAIN_P
    cl, mk, w, prev = fill_inputs(m, p, seed=99)
    nbytes = (2 * m + 1) * p * 4 + m * 4 + p * 4
    flops = 6 * m * p      # (1 - mk), two products, a sum, then an FMA
    res = {
        "ms": device_ms(lambda: ops.fill_aggregate(cl, mk, w, prev), 10),
        "plain_ms": device_ms(lambda: ref.fill_aggregate(cl, mk, w, prev),
                              5),
        # nearest single PyTorch expression; timed here, never used
        "library_ms": device_ms(
            lambda: w @ torch.lerp(prev.expand_as(cl), cl, mk), 5),
        **bound(nbytes, flops, FP32_FLOPS),
    }
    call_ms = median_ms(lambda: ops.fill_aggregate(cl, mk, w, prev), 30)
    # in place: each call writes prev, a convex combination of the last,
    # so the values stay bounded over the repeats
    inplace = {
        "ms": device_ms(lambda: ops.fill_aggregate(cl, mk, w, prev,
                                                   donate_prev=True), 10),
        "plain_ms": device_ms(lambda: ref.fill_aggregate_(cl, mk, w, prev),
                              5),
        "library_ms": device_ms(lambda: torch.mm(
            w[None], torch.lerp(prev.expand_as(cl), cl, mk),
            out=prev.view(1, -1)), 5),
        **bound(nbytes, flops, FP32_FLOPS),
    }
    inplace_call_ms = median_ms(
        lambda: ops.fill_aggregate(cl, mk, w, prev, donate_prev=True), 30)
    again_ms = device_ms(lambda: ops.fill_aggregate(cl, mk, w, prev), 10)
    log(f"timing fill_aggregate (m={m}, P={p}) on {card}: kernel "
        f"{res['ms']!r} ms, again after the in-place runs {again_ms!r} ms "
        f"(one call with its dispatch {call_ms!r} ms), bound "
        f"{res['bound_ms']!r} ms ({res['bound_by']}, {nbytes} B), plain "
        f"{res['plain_ms']!r} ms, library {res['library_ms']!r} ms; in "
        f"place: kernel {inplace['ms']!r} ms (with its dispatch "
        f"{inplace_call_ms!r} ms), plain {inplace['plain_ms']!r} ms, "
        f"library (out=prev) {inplace['library_ms']!r} ms")
    del cl, mk, w, prev
    torch.cuda.empty_cache()
    return res, inplace


def time_int8(card: str, p: int) -> dict:
    """Each int8 kernel on one (P,) vector: kernel, bound, plain version
    and the nearest single PyTorch call (torch's own per-tensor
    quantization, whose grid reaches -128; timed here, never used)."""
    x, scale = int8_inputs(p, seed=7, ties=False)
    q = ops.quantize_int8(x, scale)
    s = float(scale)               # the library call takes a host float
    # bytes: quantize reads 4 B and writes 1 B per element, dequantize
    # the reverse, and each reads the 4-byte scale; operations: a
    # division, a rounding and two clamps per element, or one multiply
    nbytes = 5 * p + 4
    res = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # quantized tensors: deprecated
        try:
            qt = torch.quantize_per_tensor(x, s, 0, torch.qint8)
            lib = {"quantize_int8": lambda: torch.quantize_per_tensor(
                       x, s, 0, torch.qint8),
                   "dequantize_int8": qt.dequantize}
        except (RuntimeError, NotImplementedError) as e:
            log(f"library call torch.quantize_per_tensor unavailable on "
                f"the card: {e}")
            lib = None
        for name, kernel, plain, n_ops in (
                ("quantize_int8", lambda: ops.quantize_int8(x, scale),
                 lambda: ref.quantize_int8(x, scale), 4 * p),
                ("dequantize_int8", lambda: ops.dequantize_int8(q, scale),
                 lambda: ref.dequantize_int8(q, scale), p)):
            r = {"ms": device_ms(kernel, 50),
                 "plain_ms": device_ms(plain, 20),
                 "library_ms": (device_ms(lib[name], 20) if lib
                                else None),
                 **bound(nbytes, n_ops, FP32_FLOPS)}
            call_ms = median_ms(kernel, 50)
            log(f"timing {name} (P={p}) on {card}: kernel {r['ms']!r} ms "
                f"(one call with its dispatch {call_ms!r} ms), bound {r['bound_ms']!r} ms ({r['bound_by']}, {nbytes} B), "
                f"plain {r['plain_ms']!r} ms, library {r['library_ms']!r} ms")
            res[name] = r
    del x, q
    torch.cuda.empty_cache()
    return res


def time_tree(card: str, api) -> dict:
    """The scale pass, K2a and K2b over the 126-leaf full-width master as
    one tree (device time, each alone: K2a at the scales the scale pass
    made), its roundtrip's device time (all three) beside the bound of
    its 14 P bytes, and one roundtrip with the host's dispatch on the
    kernel and the torch route (the torch route's 756 launches)."""
    leaves = master_leaves(api)
    master = dict(enumerate(leaves))
    p, n = MAIN_P, len(leaves)
    q, scales, layout = ops.quantize_int8_leaves(leaves)
    spin = 4_000_000       # ~2 ms of spinning per call: the host's dispatch
    kernel = make_codec("int8:kernel")
    plain = make_codec("int8:torch")
    roundtrip = {
        "roundtrip_device_ms": device_ms(
            lambda: kernel.roundtrip(master), 10, spin=spin),
        **bound(14 * p + 12 * n, 6 * p, FP32_FLOPS),
        "roundtrip_ms": median_ms(lambda: kernel.roundtrip(master), 10),
        "roundtrip_torch_ms": median_ms(lambda: plain.roundtrip(master),
                                        10)}
    roundtrip["roundtrip_bound_ms"] = roundtrip.pop("bound_ms")
    roundtrip.pop("bound_by")
    res = {name: {"tree_ms": device_ms(fn, 20, spin=spin),
                  "tree_bound_ms": bound(nbytes, n_ops, FP32_FLOPS)[
                      "bound_ms"], **roundtrip}
           for name, fn, nbytes, n_ops in (
               ("quantize_int8",
                lambda: ops.quantize_int8_leaves(leaves, scales),
                5 * p + 4 * n, 4 * p),
               ("dequantize_int8",
                lambda: ops.dequantize_int8_leaves(q, scales, layout),
                5 * p + 4 * n, p))}
    # the scale pass: its own line of the kernels JSON; the nearest single
    # PyTorch call is max|x| per tensor, one launch for the list (timed
    # here, never used)
    try:
        torch._foreach_norm(leaves, float("inf"))
        library = device_ms(lambda: torch._foreach_norm(leaves, float("inf")),
                            20, spin=spin)
    except (RuntimeError, NotImplementedError) as e:
        log(f"library call torch._foreach_norm unavailable: {e}")
        library = None
    res["int8_scale"] = {
        "ms": device_ms(lambda: ops.int8_scales(leaves), 20, spin=spin),
        "plain_ms": device_ms(lambda: ref.int8_scales(leaves), 5,
                              spin=40_000_000),
        "library_ms": library,
        **bound(4 * p + 4 * n, 2 * p, FP32_FLOPS)}
    log(f"timing the int8 tree ({n} leaves, {len(layout.chunks)} chunk, P="
        f"{p}) on {card}: scale pass {res['int8_scale']['ms']!r} ms (bound "
        f"{res['int8_scale']['bound_ms']!r}, plain per leaf "
        f"{res['int8_scale']['plain_ms']!r}, torch._foreach_norm "
        f"{library!r}), K2a {res['quantize_int8']['tree_ms']!r} ms, K2b "
        f"{res['dequantize_int8']['tree_ms']!r} ms (bound "
        f"{res['quantize_int8']['tree_bound_ms']!r} each); roundtrip: "
        f"device {roundtrip['roundtrip_device_ms']!r} ms (bound "
        f"{roundtrip['roundtrip_bound_ms']!r}), with its dispatch "
        f"{roundtrip['roundtrip_ms']!r} ms, torch route "
        f"{roundtrip['roundtrip_torch_ms']!r} ms")
    del leaves, master, q
    torch.cuda.empty_cache()
    return res


def zero_launches() -> None:
    for counts in (ops.LAUNCHES, kfa.VARIANT_LAUNCHES,
                   flash.VARIANT_LAUNCHES, egemm.VARIANT_LAUNCHES,
                   kssd.STAGE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def expect_launches(label: str, expected: dict) -> dict:
    """Read the launch counts; every kernel not in ``expected`` must
    have launched no time."""
    expected = {**dict.fromkeys(ops.LAUNCHES, 0), **expected}
    got = dict(ops.LAUNCHES)
    log(f"{label} launches: {got}")
    if got != expected:
        raise AssertionError(f"{label}: launches {got}, expected {expected}")
    return got


def expect_fill_variants(label: str, in_place: int, out_of_place: int
                         ) -> None:
    """K1's launches by variant (``kernels/fill_aggregate.py``)."""
    expected = {"out_of_place": out_of_place, "in_place": in_place}
    got = dict(kfa.VARIANT_LAUNCHES)
    log(f"{label} fill_aggregate launches by variant: {got}")
    if got != expected:
        raise AssertionError(f"{label}: fill_aggregate variants {got}, "
                             f"expected {expected}")


def expect_variants(label: str, cfg, per_prefill: dict) -> None:
    """The K3 and K5 launches of one prefill by kernel: all on the
    tensor-core kernels in bf16 (every config's head dim and expert
    widths are multiples of 8), all on the TMA-fed float32 kernels in
    float32 (multiples of 4); and K4's: one launch of each of its stage
    kernels per call."""
    which = "tensor_core" if cfg.torch_dtype == torch.bfloat16 \
        else "fp32_tma"
    for name, counts in (("flash_attention", flash.VARIANT_LAUNCHES),
                         ("expert_gemm", egemm.VARIANT_LAUNCHES)):
        n = per_prefill.get(name, 0)
        expected = {**dict.fromkeys(counts, 0), which: n}
        got = dict(counts)
        log(f"{label} {name} launches by kernel: {got}")
        if got != expected:
            raise AssertionError(f"{label}: {name} kernels {got}, "
                                 f"expected {expected}")
    expected = dict.fromkeys(kssd.STAGES, per_prefill.get("ssd_scan", 0))
    got = dict(kssd.STAGE_LAUNCHES)
    log(f"{label} ssd_scan launches by stage kernel: {got}")
    if got != expected:
        raise AssertionError(f"{label}: ssd_scan stage kernels {got}, "
                             f"expected {expected}")


def full_width_clients():
    x, y = make_classification(0, 1600, image=32)
    return make_clients(x, y, partition_iid(0, 1600, 8), batch=50,
                        test_batch=50)


def master_diff(a, b) -> float:
    return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a)


def check_run(result, label: str) -> None:
    for r in result.reports:
        objs = r.objs if r.objs is not None else r.best_err
        if not np.isfinite(objs).all():
            raise AssertionError(f"{label}: non-finite objectives {objs}")
    for name in ("final_master", "params"):
        model = result.extras.get(name, {})
        bad = [k for k, v in model.items() if not torch.isfinite(v).all()]
        if bad:
            raise AssertionError(f"{label}: non-finite {name} leaves "
                                 f"{bad[:5]}")


def same_trajectory(a, b, label: str, tol: float | None) -> float:
    """Equal CommStats and parent keys, else raise; the final masters'
    largest gap is logged, and held within ``tol`` unless it is None."""
    if dataclasses.asdict(a.stats) != dataclasses.asdict(b.stats):
        raise AssertionError(f"{label}: CommStats differ: {a.stats} vs "
                             f"{b.stats}")
    for ra, rb in zip(a.reports, b.reports):
        if not all(np.array_equal(x, y)
                   for x, y in zip(ra.parent_keys, rb.parent_keys)):
            raise AssertionError(f"{label}: generation {ra.gen} parent keys "
                                 f"differ: {ra.parent_keys} vs "
                                 f"{rb.parent_keys}")
    diff = master_diff(a.extras["final_master"], b.extras["final_master"])
    log(f"{label}: equal keys and CommStats; final master max abs diff "
        f"{diff!r}")
    if tol is not None and not diff <= tol:
        raise AssertionError(f"{label}: master diff {diff} > {tol}")
    return diff


# ---------------------------------------------------------------------------
# phase 11: the batched vmap backend
# ---------------------------------------------------------------------------

def timed_run(api, clients, label, cfg_kw):
    """One full-width RealTimeNas run with the launch counts zeroed just
    before and read by the caller just after; returns (result, engine,
    peak device memory)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = FedEngine(api, clients, RunConfig(**cfg_kw))
    zero_launches()
    result = eng.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check_run(result, label)
    for r in result.reports:
        log(f"{label} generation {r.gen}: round_s {r.round_s!r}, best_err "
            f"{r.best_err!r}")
    return result, eng, peak


def int8_master_gap(a, b, init) -> float:
    """Largest |a - b| over the leaves beyond 1e-4 plus one step of the
    int8 grid of the leaf's update (``max|a - init| / 127``); <= 0 when
    every leaf is inside."""
    return max(float((a[k].cpu() - b[k].cpu()).abs().max())
               - (MASTER_TOL + float((a[k].cpu() - init[k]).abs().max())
                  / 127) for k in a)


def check_one_fill(api, clients, label: str, cfg_kw: dict) -> None:
    """One ``train_fill`` at full width from the strategies' init, four
    groups of two clients: the vmap backend configured by ``cfg_kw``
    against the loop backend's kernel route within TOL.  The clients
    train in turn on the loop's step, so the uploads are the loop's bit
    for bit and only Algorithm 3's sums are grouped otherwise."""
    master = {k: v.cuda() for k, v in
              api.init(torch.Generator().manual_seed(0)).items()}
    rng = np.random.default_rng(1)
    keys = [rng.integers(0, 4, api.num_blocks) for _ in range(4)]
    groups = [np.arange(2 * g, 2 * g + 2) for g in range(4)]
    loop = LoopBackend(api, clients, RunConfig(**dict(
        RUN, aggregate_backend="kernel"))).train_fill(master, keys, groups,
                                                      0.01)
    ours = VmapBackend(api, clients, RunConfig(**cfg_kw)).train_fill(
        master, keys, groups, 0.01)
    torch.cuda.synchronize()
    diff = master_diff(loop, ours)
    log(f"{label}, one train_fill against the loop backend's: master max "
        f"abs diff {diff!r}")
    if not diff <= TOL:
        raise AssertionError(f"{label}: one train_fill differs from the "
                             f"loop backend's by {diff} > {TOL}")
    del master, loop, ours
    torch.cuda.empty_cache()


def check_vmap(api, clients, loop_run, loop_peak: int, card: str
               ) -> tuple:
    """``backend="vmap"`` at full width against phase 5's ``loop`` run.
    Returns K1's in-place launches in the fused kernel-route run, and the
    three fused runs (``reference``, with generation 2's ``round_s`` and
    the peak memory) by route, ``"kernel"``, ``"torch"`` and ``"int8"``:
    phase 12 holds its telemetry twin to the first, phase 15 the mesh's
    runs to all three."""
    gens, pop = RUN["generations"], RUN["population"]
    n_fill = gens + 1
    fused_bound = 2 * gens + 1
    vm = dict(RUN, backend="vmap")
    # (label, config, K1 launches in place / out of place, dispatches,
    #  master held within MASTER_TOL of the loop run's).  Every run's
    # keys and CommStats equal the loop's.  At this width a float32
    # client update lies about 1e-3 from a float64 one, so a one-ulp
    # difference in a generation-1 master grows to about 1e-3 by the end
    # of generation 2: a run's master is held to the loop's only where it
    # adds the same uploads in the loop's order.  The non-fused kernel
    # route adds K1's per-group partials; it is held on one train_fill
    # (check_one_fill) and its run's master gap logged.
    nonfused = dict(vm, aggregate_backend="kernel", fused=False)
    cases = [
        ("vmap fused, kernel route", dict(vm, aggregate_backend="kernel"),
         n_fill, 0, fused_bound + n_fill, True, "kernel"),
        ("vmap fused, torch route", dict(vm, aggregate_backend="torch"),
         0, 0, fused_bound, True, "torch"),
        ("vmap non-fused, kernel route", nonfused, n_fill,
         n_fill * (pop - 1), 2 * pop * (n_fill + gens), False, None),
    ]
    rows = [("loop (phase 5)", loop_run.reports[-1].round_s, loop_peak)]
    in_place_launches = None
    refs = {}
    for (label, cfg_kw, in_place, out_of_place, dispatches,
         strict, ref_key) in cases:
        result, eng, peak = timed_run(api, clients, label, cfg_kw)
        expect_launches(label, {"fill_aggregate": in_place + out_of_place})
        expect_fill_variants(label, in_place, out_of_place)
        if in_place_launches is None:
            in_place_launches = kfa.VARIANT_LAUNCHES["in_place"]
        if ref_key is not None:
            refs[ref_key] = dict(reference(result, eng), peak=peak)
        log(f"{label}: dispatches {eng.backend.dispatches}, peak device "
            f"memory {peak} B")
        if eng.backend.dispatches != dispatches:
            raise AssertionError(f"{label}: {eng.backend.dispatches} "
                                 f"dispatches, expected {dispatches}")
        same_trajectory(loop_run, result, f"{label} vs loop",
                        MASTER_TOL if strict else None)
        log(f"{label}: generation 2 best_err {result.reports[-1].best_err!r}"
            f" (loop {loop_run.reports[-1].best_err!r})")
        rows.append((label, result.reports[-1].round_s, peak))
        del result, eng
    check_one_fill(api, clients, "vmap non-fused, kernel route", nonfused)

    # fused, kernel route, int8 uplink: no master donation, one launch of
    # the scale pass, K2a and K2b per roundtrip (one uplink per train_fill)
    up = dict(RUN, uplink_codec="int8:kernel")
    loop8, _, _ = timed_run(api, clients, "loop, int8 uplink", up)
    label = "vmap fused, kernel route, int8 uplink"
    vmap8, eng, peak = timed_run(api, clients, label,
                                 dict(up, backend="vmap"))
    n_int8 = n_fill * N_CHUNKS
    expect_launches(label, {"fill_aggregate": n_fill, "int8_scale": n_int8,
                            "quantize_int8": n_int8,
                            "dequantize_int8": n_int8})
    expect_fill_variants(label, n_fill, 0)
    if eng.backend.inner.donate_master is not False:
        raise AssertionError(f"{label}: master donation is on")
    if eng.backend.dispatches != fused_bound + n_fill:
        raise AssertionError(f"{label}: {eng.backend.dispatches} dispatches")
    refs["int8"] = dict(reference(vmap8, eng), peak=peak)
    # the strategies' init (seed 0), from which the updates are measured
    init = api.init(torch.Generator().manual_seed(0))
    same_trajectory(loop8, vmap8, f"{label} vs loop", math.inf)
    gap = int8_master_gap(loop8.extras["final_master"],
                          vmap8.extras["final_master"], init)
    log(f"{label} vs loop: largest master gap beyond 1e-4 + one int8 step "
        f"of the leaf's update: {gap!r}")
    if gap > 0:
        raise AssertionError(f"{label}: master outside 1e-4 + one int8 step")
    rows.append((label, vmap8.reports[-1].round_s, peak))
    del loop8, vmap8, eng
    for label, round_s, peak in rows:
        log(f"generation 2 round_s on {card}: {label}: {round_s!r} s, peak "
            f"device memory {peak} B")
    return in_place_launches, refs


# ---------------------------------------------------------------------------
# phase 12: telemetry and checkpoints at full width
# ---------------------------------------------------------------------------

def reference(result, eng) -> dict:
    """A run as phase 12 holds its telemetry twin to it: the result, its
    master moved to the host, its dispatches and its launch counts (read
    just after the run)."""
    master = result.extras["final_master"]
    result.extras["final_master"] = {k: v.cpu() for k, v in master.items()}
    return {"result": result, "dispatches": eng.backend.dispatches,
            "launches": dict(ops.LAUNCHES),
            "variants": dict(kfa.VARIANT_LAUNCHES)}


def bitwise_master(a, b, label: str) -> None:
    """Equal keys, equal shapes and dtypes, equal bits."""
    if list(a) != list(b) or not all(
            a[k].dtype == b[k].dtype
            and torch.equal(a[k].cpu(), b[k].cpu()) for k in a):
        raise AssertionError(f"{label}: masters differ (max abs diff "
                             f"{master_diff(a, b)!r})")


# (label, run config, trace_counts, span paths that must appear).  The
# fused kernel route's local SGD program is the JAX package's pallas
# route's "fused_uploads": Algorithm 3 then runs on K1, outside it
TELEMETRY_RUNS = (
    ("loop (phase 5)", dict(RUN, aggregate_backend="kernel"),
     {"client_update": 1, "evaluator": 1}, ()),
    ("vmap fused, kernel route (phase 11)",
     dict(RUN, backend="vmap", aggregate_backend="kernel"),
     {"fused_uploads": 1, "fused_eval_shared": 1},
     ("fill_train/download", "eval/host_fetch")),
    ("codec path int8:kernel (phase 7)",
     dict(RUN, uplink_codec="int8:kernel", downlink_codec="int8:kernel"),
     {"client_update": 1, "evaluator": 1},
     ("fill_train/codec_decode", "fill_train/codec_encode",
      "eval/codec_decode")),
)


def telemetry_twin(api, clients, label, cfg_kw, telemetry, ref) -> tuple:
    """The run of ``cfg_kw`` again with ``telemetry`` on, launch counts
    zeroed just before and read just after, held to ``ref`` (the same
    configuration off, earlier in this process): keys, CommStats,
    masters bit for bit, dispatches, launches and K1's variants equal.
    Returns (result, engine, [(live_device_bytes, memory_allocated)] at
    each round's end)."""
    eng = FedEngine(api, clients, RunConfig(telemetry=telemetry, **cfg_kw))
    live = []

    def at_round_end(gen, report):
        event = eng.telemetry.ring.events[-1]
        live.append((event.gauges.get("live_device_bytes"),
                     torch.cuda.memory_allocated()))

    zero_launches()
    result = eng.run(callback=at_round_end)
    torch.cuda.synchronize()
    check_run(result, label)
    same_trajectory(ref["result"], result, f"{label}, telemetry on vs off",
                    0.0)
    bitwise_master(ref["result"].extras["final_master"],
                   result.extras["final_master"], f"{label}, telemetry on")
    for what, got, want in (
            ("dispatches", eng.backend.dispatches, ref["dispatches"]),
            ("launches", dict(ops.LAUNCHES), ref["launches"]),
            ("fill_aggregate variants", dict(kfa.VARIANT_LAUNCHES),
             ref["variants"])):
        if got != want:
            raise AssertionError(f"{label}, telemetry on: {what} {got}, off "
                                 f"{want}")
    return result, eng, live


def check_telemetry(api, clients, refs: list, card: str) -> dict:
    """(a) each of ``TELEMETRY_RUNS`` again with a jsonl sink, held to its
    reference in ``refs`` (``telemetry_twin``): the JAX package's
    signature counts, a new signature in generation 1 only, the span
    paths, one jsonl line a generation, ``live_device_bytes`` the
    allocator's count at each round's end, generation 2's ``round_s`` on
    and off logged; (b) the loop and fused vmap runs again under
    ``torch.profiler``, masters still bit for bit, and generation 2 split
    by phase from each Chrome trace (``obs.round_split``), beside the
    unprofiled run's ``round_s`` and host ms by span from (a) and the
    idle share of that ``round_s`` (the profiler slows the host, not the
    device).  Returns the splits by label."""
    gens = RUN["generations"]
    splits, unprofiled = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, ((label, cfg_kw, counts, paths), ref) in enumerate(
                zip(TELEMETRY_RUNS, refs)):
            jsonl = Path(tmp) / f"run{i}.jsonl"
            result, eng, live = telemetry_twin(
                api, clients, label, cfg_kw, {"sink": f"jsonl:{jsonl}"}, ref)
            eng.telemetry.sink.close()
            tel = result.telemetry
            if tel.trace_counts != counts:
                raise AssertionError(f"{label}: trace_counts "
                                     f"{tel.trace_counts}, expected {counts}")
            recompiles = [e.recompiles for e in tel.events]
            if recompiles != [counts] + [{}] * (gens - 1):
                raise AssertionError(f"{label}: recompiles {recompiles}")
            seen = {p for e in tel.events for p in e.spans}
            missing = [p for p in paths if p not in seen]
            if missing:
                raise AssertionError(f"{label}: span paths {missing} missing "
                                     f"from {sorted(seen)}")
            lines = [json.loads(x) for x in jsonl.read_text().splitlines()]
            if [x["gen"] for x in lines] != list(range(1, gens + 1)):
                raise AssertionError(f"{label}: jsonl generations "
                                     f"{[x['gen'] for x in lines]}")
            if any(a != b for a, b in live):
                raise AssertionError(f"{label}: live_device_bytes vs "
                                     f"memory_allocated at round end {live}")
            last = tel.events[-1]
            unprofiled[label] = {
                "round_s": last.round_s,
                "host_ms": {p: t * 1e3 for p, t in last.spans.items()}}
            log(f"{label}, telemetry on: bit for bit the run off; "
                f"trace_counts {tel.trace_counts}; generation {gens} spans "
                f"{last.span_counts}, host ms {unprofiled[label]['host_ms']}"
                f"; live_device_bytes at round end {[a for a, _ in live]}")
            log(f"generation {gens} round_s on {card}: {label}: telemetry "
                f"on {result.reports[-1].round_s!r} s, off "
                f"{ref['result'].reports[-1].round_s!r} s")
            del result, eng
        for i, ((label, cfg_kw, _, _), ref) in enumerate(
                zip(TELEMETRY_RUNS[:2], refs)):
            prof = Path(tmp) / f"prof{i}"
            result, _, _ = telemetry_twin(
                api, clients, f"{label}, profiled", cfg_kw,
                {"profiler_dir": str(prof)}, ref)
            split = round_split(load_trace(str(prof)),
                                result.telemetry.events, gens)
            if not split["device_busy_ms"] > 0.0:
                raise AssertionError(f"{label}: the capture traced no "
                                     "device activity")
            split["unprofiled"] = dict(unprofiled[label], idle_share=(
                1.0 - split["device_busy_ms"]
                / (unprofiled[label]["round_s"] * 1e3)))
            log(f"{label}, profiled: generation {gens} round_s "
                f"{split['round_s']!r} s, device busy "
                f"{split['device_busy_ms']!r} ms of {split['window_ms']!r} "
                f"ms, idle share {split['idle_share']!r} (of the unprofiled "
                f"round_s: {split['unprofiled']['idle_share']!r}); capture "
                f"consistent with the RoundEvent: {split['consistent']}")
            splits[label] = split
            del result
    return splits


def on_off_round_s(api, clients) -> dict:
    """Generation 2's ``round_s`` with telemetry off, on, on, off, in turn,
    for the loop and the fused vmap runs of ``TELEMETRY_RUNS`` (the
    default ``TelemetryConfig``): what telemetry costs a round, measured
    within one phase of one process.  No limit."""
    out = {}
    for label, cfg_kw, _, _ in TELEMETRY_RUNS[:2]:
        times = {"off": [], "on": []}
        for tel in ("off", "on", "on", "off"):
            eng = FedEngine(api, clients, RunConfig(
                telemetry=tel == "on", **cfg_kw))
            times[tel].append(eng.run().reports[-1].round_s)
            del eng
        out[label] = times
        log(f"{label}: generation 2 round_s, telemetry off / on in turn: "
            f"{times}")
    return out


def traced_call_us(master: dict, clients) -> float:
    """Host µs that ``obs.traced`` adds to one call of the loop backend's
    ``client_update`` at full width (the signature of the master, key and
    shard, and one ``record_function``), around a function that does
    nothing; the median of 5 runs of 1000 calls.  It wraps every backend
    program, telemetry on or off."""
    on_card = {k: v.cuda() for k, v in master.items()}
    xb, yb = (torch.as_tensor(a, device="cuda") for a in clients[0].train)
    key = np.zeros(12, np.int32)
    wrapped = traced("client_update", {}, lambda *args: None)
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(1000):
            wrapped(on_card, key, xb, yb, 0.01)
        runs.append((time.perf_counter() - t0) * 1e3)
    return sorted(runs)[2]


def check_checkpoint(master: dict) -> None:
    """The full-width master through ``save_pytree`` and back onto a CUDA
    template with ``restore_latest``: bit for bit, on the card, one npz
    key per leaf."""
    on_card = {k: v.cuda() for k, v in master.items()}
    template = {k: torch.zeros_like(v) for k, v in on_card.items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = save_pytree(tmp, on_card, step=RUN["generations"])
        with np.load(path) as data:
            n_keys = len(data.files)
        restored, step = restore_latest(tmp, template)
    torch.cuda.synchronize()
    if step != RUN["generations"] or n_keys != len(on_card):
        raise AssertionError(f"checkpoint: step {step}, {n_keys} keys for "
                             f"{len(on_card)} leaves")
    if any(v.device.type != "cuda" for v in restored.values()):
        raise AssertionError("checkpoint: restored off the card")
    bitwise_master(on_card, restored, "checkpoint")
    log(f"checkpoint: {len(on_card)} leaves, {n_keys} keys, "
        f"{sum(v.numel() for v in on_card.values())} parameters back bit "
        f"for bit on {next(iter(restored.values())).device}")


# ---------------------------------------------------------------------------
# phases 9-10: flash attention (K3), the SSD chunk scan (K4), serving
# ---------------------------------------------------------------------------

# kernel against plain version, (rtol, atol).  Both compute in float32
# and round the output once to the input's type, so in bfloat16 they may
# differ by one rounding of the output, at most 2^-7 of its magnitude
# (measured: <= 3.9e-3, NVIDIA H100 80GB HBM3, 700 W); atol 1e-3 covers
# the float32 gaps near zero.  The JAX sweep's bfloat16 limits (2e-2 /
# 1e-1) are as wide as a typical output entry at the serving shape.
FLASH_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2 ** -7, 1e-3)}
SSD_TOL = 2e-4
QWEN_ATTN = (4, 1024, 16, 16, 64)       # B, S, H, Kh, D of a qwen prefill
GRANITE_ATTN = (4, 1024, 16, 8, 64)     # granite's prefill: GQA, 2 heads a KV
# the dense shelf's prefills, head dim 128 (the tensor-core kernel's
# second variant): GQA 16, 12 and 8 query heads a KV head
CHATGLM_ATTN = (4, 1024, 32, 2, 128)
STARCODER_ATTN = (4, 1024, 24, 2, 128)
DEEPSEEK_ATTN = (4, 1024, 64, 8, 128)
# starcoder2's long prefill: one request of 8192 tokens at its sliding
# window of 4096, which cuts the context
STARCODER_LONG = ((1, 8192, 24, 2, 128), 4096)
MAMBA_SSD = (4, 8, 128, 48, 64, 128)    # B, NC, Q, H, P, N of a mamba2
#                                         prefill (1000 tokens -> 8 chunks)
# zamba2-2.7b's prefill of 4 x 1000 tokens at head dim 80: its shared
# attention block (32 heads, no GQA; the tensor-core kernel's D = 128
# variant, 80 columns zero-filled to 128) and its SSD scan (64 heads of
# P = 80: two P tiles, the second 16 wide; N 64)
ZAMBA_ATTN = (4, 1000, 32, 32, 80)
ZAMBA_SSD = (4, 8, 128, 64, 80, 64)
# internvl2-1b's prefill: 256 patches before 1024 tokens, 14 query heads
# on 2 KV heads (GQA 7, the first odd group size on a model); whisper's
# encoder, bidirectional over its 1500 frames (a ragged last tile of 92
# keys), and its decoder over its context of 448 tokens, 20 heads, no GQA
INTERNVL_ATTN = (4, 1280, 14, 2, 64)
WHISPER_ENC = (4, 1500, 20, 20, 64)
WHISPER_DEC = (4, 448, 20, 20, 64)
# the sweep's shapes, a ragged tile, a ragged last tile past 128 (the
# TPU kernel asserts S <= 128 or a multiple of 128; zamba2's prompts are
# 1000 tokens), head dims 80 (zamba2), 36 (bf16 with D % 8 != 0: the
# CUDA-core kernel) and 30 (float32 with D % 4 != 0: the CUDA-core
# kernel; TMA needs 16-byte strides), the largest head dim (256), qwen's
# and granite's prefills, the dense shelf's, zamba2's, internvl2's and
# whisper's
FLASH_CASES = [(2, 128, 4, 4, 64), (1, 256, 4, 2, 128), (1, 384, 6, 1, 64),
               (2, 100, 4, 2, 64), (1, 300, 4, 2, 64), (1, 256, 4, 4, 80),
               (1, 256, 4, 2, 36), (1, 256, 4, 2, 30), (1, 200, 2, 1, 256),
               QWEN_ATTN, GRANITE_ATTN, CHATGLM_ATTN, STARCODER_ATTN,
               DEEPSEEK_ATTN, ZAMBA_ATTN, INTERNVL_ATTN, WHISPER_ENC,
               WHISPER_DEC]
# K3 timed at these (shape, window, causal), bf16, each beside sdpa on
# the same shape and mask; the first is the kernels line's own
FLASH_TIMED = [(QWEN_ATTN, 0, True), (GRANITE_ATTN, 0, True),
               (QWEN_ATTN, 256, True), (CHATGLM_ATTN, 0, True),
               (STARCODER_ATTN, 0, True), (DEEPSEEK_ATTN, 0, True),
               (*STARCODER_LONG, True), (ZAMBA_ATTN, 0, True),
               (INTERNVL_ATTN, 0, True), (WHISPER_ENC, 0, False),
               (WHISPER_DEC, 0, True)]
# head dims of the tensor-core kernel's four variants (D <= 64, 128, 192,
# 256), whose registers, local memory and shared memory are reported
TC_HEAD_DIMS = (64, 128, 192, 256)
# and of the TMA-fed float32 kernel's four variants (D <= 64, 96, 128,
# 256)
FP32_HEAD_DIMS = (64, 96, 128, 256)
FLASH_MASKS = [(True, 0), (True, 64), (True, 256), (False, 0)]
# K4's cases as (shape, decay): a = -|normal| x decay.  The sweep's
# shapes, two P tiles, mamba2's and zamba2's prefills; then one chunk (the state pass
# only hands the local state on), 32 chunks (4096 tokens at B = 1), no
# decay (a = 0) and strong decay (a about -50 a step, where exp(-acum)
# overflows float32 within two steps).  Without decay nothing forgets, so
# |y| grows with the tokens and the state size, and with it the float32
# recurrence's own distance from a float64 one (check_ssd logs both the
# plain version's and the kernel's): at 2 chunks and N 64 that stays
# inside SSD_TOL
SSD_CASES = [((2, 4, 64, 3, 32, 16), 0.1), ((1, 2, 128, 2, 64, 64), 0.1),
             ((1, 8, 32, 1, 16, 8), 0.1), ((1, 2, 128, 2, 80, 64), 0.1),
             (MAMBA_SSD, 0.1), (ZAMBA_SSD, 0.1),
             ((2, 1, 128, 48, 64, 128), 0.1),
             ((1, 32, 128, 48, 64, 128), 0.1), ((1, 2, 128, 4, 64, 64), 0.0),
             ((2, 8, 128, 4, 80, 128), 60.0)]
# no decay at 4 chunks and N 128: there |y| reaches the thousands, the
# plain float32 recurrence and the kernel sum in other orders and differ
# by more than SSD_TOL, so the float64 recurrence is the witness that the
# kernel is held to, within SSD_TOL
SSD_NO_DECAY = (1, 4, 128, 4, 64, 128)
# K4 timed at these shapes; the first is the kernels line's own
SSD_TIMED = (MAMBA_SSD, ZAMBA_SSD)
REQUESTS, NEW_TOKENS, GREEDY_PROMPT = 4, 16, 64
# arch -> its phase-10 run: prompt length, windows, kernel launches per
# layer per prefill (the hybrid adds one K3 per application point of its
# shared block, the audio model one per encoder layer,
# ``prefill_launches``; the VLM and audio models' prompts follow a prefix
# of ``num_prefix`` embeddings, ``model_prefix``); "depth", the layers it is cut to
# (deepseek-67b's 95 take about 134 GB in bf16, more than one card
# holds; 8 are 6.38 B parameters); "long", a further prefill as
# (requests, prompt length, window) (starcoder2's 8192 tokens at its
# sliding window of 4096); "supernet", the archs of phase 13 (a), one
# per family; "chunked", the prefills ("prompt", "long") also run on the
# chunked route against the torch route; and "smoke", a change to the
# smoke config of the replay check (zamba2's 4 layers: two application
# points).  Every arch's prefill also runs in float32 at full width (the
# config's widths and depth, float32 weights from the same seed)
SERVE = {"qwen1.5-0.5b": dict(prompt=1024, windows=(0, 256),
                              per_layer={"flash_attention": 1},
                              supernet=True, chunked=("prompt",)),
         "mamba2-780m": dict(prompt=1000, windows=(0,),
                             per_layer={"ssd_scan": 1}, supernet=True),
         "granite-moe-1b-a400m": dict(prompt=1024, windows=(0, 256),
                                      per_layer={"flash_attention": 1,
                                                 "expert_gemm": 3},
                                      supernet=True),
         "chatglm3-6b": dict(prompt=1024, windows=(0,),
                             per_layer={"flash_attention": 1}),
         "starcoder2-3b": dict(prompt=1024, windows=(0,),
                               per_layer={"flash_attention": 1},
                               long=(1, 8192, 4096), chunked=("long",)),
         "deepseek-67b": dict(prompt=1024, windows=(0,),
                              per_layer={"flash_attention": 1}, depth=8),
         "zamba2-2.7b": dict(prompt=1000, windows=(0,),
                             per_layer={"ssd_scan": 1}, supernet=True,
                             chunked=("prompt",), smoke=dict(num_layers=4)),
         "internvl2-1b": dict(prompt=1024, windows=(0,),
                              per_layer={"flash_attention": 1},
                              supernet=True, chunked=("prompt",)),
         "whisper-large-v3": dict(prompt=448, windows=(0,),
                                  per_layer={"flash_attention": 1},
                                  chunked=("prompt",))}
# kernel route against torch route at full width, relative to the
# logits' largest magnitude.  In bf16 the routes sum attention / the scan
# in another order before the bf16 cast, and 24-48 layers of random
# weights carry the flipped roundings to the logits (measured: 1.1 %
# qwen, 4.5 % mamba2, NVIDIA H100 80GB HBM3, 700 W); in float32 only
# float32 roundings differ
LOGIT_TOL = {torch.bfloat16: 0.15, torch.float32: 1e-3}
# the chunked route against the torch route, of the largest logit: in
# bf16 the chunked route rounds the probabilities to bf16 before the
# product with v (the JAX package's), the torch route does not; in
# float32 both compute the same float32 scores, softmax and product,
# summed in another order
CHUNKED_TOL = {torch.bfloat16: LOGIT_TOL[torch.bfloat16],
               torch.float32: 1e-5}
REPLAY_TOL = 1e-3       # smoke size, float32: prefill vs decode replay
# granite's prefill under a one-device mesh against none, of the largest
# logit: the same computation, the expert products on cuBLAS einsums
# instead of K5 (whose bf16 products equal cuBLAS's bit for bit)
MESH_PREFILL_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
# K5 against its plain version, (rtol, atol), both after dividing by the
# output's largest magnitude: in float32 both sum up to 1024 exact
# products in another order; in bfloat16 they may differ by one rounding
# of the output, as K3
GEMM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 1e-3)}
GRANITE_WI = (32, 1280, 1024, 512)      # E, C, D, F: 4 x 1024 tokens, top 8
GRANITE_WO = (32, 1280, 512, 1024)
# (2, 64, 100, 70): w and out rows of 140 bytes (bf16) or 280 (float32),
# which TMA cannot describe, so bf16 takes the mma.sync kernel and
# float32 the CUDA-core one
GEMM_CASES = [(2, 128, 256, 128), (4, 256, 256, 384), (1, 128, 512, 256),
              (2, 8, 200, 72), (2, 100, 200, 72), (2, 1256, 200, 72),
              GRANITE_WI, GRANITE_WO, (32, 8, 1024, 512), (2, 64, 100, 70)]
# a MoE layer on both routes from one input chains three K5 products
# (wi and wg, then wo), each allowed one rounding apart
MOE_DEPTH = 3


def flash_inputs(b, s, h, kh, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, device="cuda", generator=g).to(dtype)
                 for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))


def ssd_inputs(b, nc, q, h, p, n, seed, decay=0.1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.randn((b, nc, q, h, p), device="cuda", generator=g)
    a = -torch.randn((b, nc, q, h), device="cuda", generator=g).abs() * decay
    bm = torch.randn((b, nc, q, n), device="cuda", generator=g)
    cm = torch.randn((b, nc, q, n), device="cuda", generator=g)
    return xs, a, bm, cm


def check_flash_call(q, k, v, causal: bool, window: int, which: str,
                     tol: tuple, label: str) -> tuple:
    """One K3 call against its plain version within ``tol`` (rtol,
    atol); the call must run one ``which`` kernel.  Returns (max |kernel
    - plain|, plain)."""
    before = dict(flash.VARIANT_LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ran = {n: flash.VARIANT_LAUNCHES[n] - before[n] for n in before}
    if ran != {**dict.fromkeys(before, 0), which: 1}:
        raise AssertionError(f"flash_attention {label}: ran {ran}, "
                             f"expected one {which} launch")
    plain = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), plain.float(), rtol=tol[0],
                               atol=tol[1])
    err = float((out.float() - plain.float()).abs().max())
    log(f"check flash_attention {label} causal={causal} window={window} "
        f"({which}): max |kernel - plain| = {err!r}")
    return err, plain


def check_flash() -> dict:
    """K3 against its plain version at every case and mask, in float32
    and bf16; each call must run the one kernel ``flash.variant`` names
    (all inputs here are 16-byte aligned): the tensor-core kernel for
    bf16 with D % 8 == 0, the TMA-fed float32 kernel for float32 with D %
    4 == 0, else the CUDA-core kernel.  Then starcoder2's long prefill at
    its own window, which is longer than any tile, held to the same
    limits; there the plain version without the window (and, in float32,
    with the window one key longer) must fall outside them, so a kernel
    that ignored or misplaced the cut-off would fail.  Returns the
    largest |kernel - plain| by dtype."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[dtype]
        name = str(dtype)[6:]
        worst[dtype] = 0.0
        for i, shape in enumerate(FLASH_CASES):
            q, k, v = flash_inputs(*shape, dtype, seed=200 + i)
            which = flash.variant(dtype, shape[-1])
            for causal, window in FLASH_MASKS:
                err, _ = check_flash_call(q, k, v, causal, window, which,
                                          tol, f"{name} {shape}")
                worst[dtype] = max(worst[dtype], err)
            del q, k, v
        shape, window = STARCODER_LONG
        q, k, v = flash_inputs(*shape, dtype, seed=250)
        which = flash.variant(dtype, shape[-1])
        err, plain = check_flash_call(q, k, v, True, window, which, tol,
                                      f"{name} {shape}")
        worst[dtype] = max(worst[dtype], err)
        witnesses = [("no window", 0)]
        if dtype == torch.float32:
            witnesses.append((f"window {window + 1}", window + 1))
        for what, w in witnesses:
            other = ref.flash_attention(q, k, v, causal=True, window=w)
            gap = float((other.float() - plain.float()).abs().max())
            log(f"check flash_attention {name} {shape}: plain version "
                f"with {what} against window {window}: max gap {gap!r}")
            if torch.allclose(other.float(), plain.float(), rtol=tol[0],
                              atol=tol[1]):
                raise AssertionError(f"flash_attention {shape} {name}: "
                                     f"{what} is within FLASH_TOL of "
                                     f"window {window}; the check cannot "
                                     "see the cut-off")
            del other
        del q, k, v, plain
        torch.cuda.empty_cache()
    return worst


def recurrence64(xs, a, bm, cm):
    """(y, final state) of ``ref.ssd_scan``'s recurrence, in float64."""
    b, nc, q, h, p = xs.shape
    n = bm.shape[-1]
    x = xs.reshape(b, nc * q, h, p).double()
    a_ = a.reshape(b, nc * q, h).double()
    b_ = bm.reshape(b, nc * q, n).double()
    c_ = cm.reshape(b, nc * q, n).double()
    state = torch.zeros((b, h, p, n), dtype=torch.float64, device=xs.device)
    ys = []
    for t in range(nc * q):
        state = (state * torch.exp(a_[:, t])[:, :, None, None]
                 + torch.einsum("bhp,bn->bhpn", x[:, t], b_[:, t]))
        ys.append(torch.einsum("bn,bhpn->bhp", c_[:, t], state))
    return torch.stack(ys, dim=1).reshape(b, nc, q, h, p), state


def gap64(y, st, y64, s64) -> str:
    """Largest |float32 - float64| over y and the final state, and the
    largest share of SSD_TOL's limit (atol + rtol |float64|) it takes."""
    pairs = ((y.double(), y64), (st.double(), s64))
    gap = max(float((u - v).abs().max()) for u, v in pairs)
    share = max(float(((u - v).abs() / (SSD_TOL + SSD_TOL * v.abs())).max())
                for u, v in pairs)
    return f"{gap!r} ({share!r} of the limit)"


def check_ssd() -> float:
    """K4 against its plain version at every case; each call launches
    each of its stage kernels once; two calls give the same bits.
    Without decay, the kernel's and the plain version's distance from
    the float64 recurrence are logged, and at SSD_NO_DECAY the kernel is
    held to the float64 recurrence within SSD_TOL."""
    worst = 0.0
    for i, (shape, decay) in enumerate(SSD_CASES):
        args = ssd_inputs(*shape, seed=300 + i, decay=decay)
        y_p, s_p = ref.ssd_scan(*args)
        y_t, _ = ssd_chunked_torch(*args)      # the torch route, for scale
        drift = (f"; torch route vs plain "
                 f"{float((y_t - y_p).abs().max())!r}")
        del y_t
        before = dict(kssd.STAGE_LAUNCHES)
        y, st = ops.ssd_scan(*args)
        torch.cuda.synchronize()
        ran = {k: kssd.STAGE_LAUNCHES[k] - before[k] for k in before}
        if ran != dict.fromkeys(kssd.STAGES, 1):
            raise AssertionError(f"ssd_scan {shape}: ran {ran}")
        if decay == 0.0:
            y64, s64 = recurrence64(*args)
            drift += (f"; plain vs float64 {gap64(y_p, s_p, y64, s64)}, "
                      f"kernel vs float64 {gap64(y, st, y64, s64)}")
            del y64, s64
        torch.testing.assert_close(y, y_p, rtol=SSD_TOL, atol=SSD_TOL)
        torch.testing.assert_close(st, s_p, rtol=SSD_TOL, atol=SSD_TOL)
        err = max(float((y - y_p).abs().max()),
                  float((st - s_p).abs().max()))
        worst = max(worst, err)
        log(f"check ssd_scan {shape} decay {decay}: max |kernel - plain| = "
            f"{err!r} (max |y| {float(y_p.abs().max())!r}, max |state| "
            f"{float(s_p.abs().max())!r}{drift})")
        y2, st2 = ops.ssd_scan(*args)
        if not (torch.equal(y.view(torch.int32), y2.view(torch.int32))
                and torch.equal(st.view(torch.int32), st2.view(torch.int32))):
            raise AssertionError(f"ssd_scan {shape}: two calls differ")
        del args, y_p, s_p, y, st, y2, st2
    args = ssd_inputs(*SSD_NO_DECAY, seed=300 + len(SSD_CASES), decay=0.0)
    y64, s64 = recurrence64(*args)
    y_p, s_p = ref.ssd_scan(*args)
    y, st = ops.ssd_scan(*args)
    err = max(float((y - y_p).abs().max()), float((st - s_p).abs().max()))
    log(f"check ssd_scan {SSD_NO_DECAY} decay 0.0 against float64: kernel "
        f"{gap64(y, st, y64, s64)}, plain {gap64(y_p, s_p, y64, s64)} (max "
        f"|kernel - plain| {err!r}, max |y| {float(y64.abs().max())!r})")
    torch.testing.assert_close(y.double(), y64, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(st.double(), s64, rtol=SSD_TOL, atol=SSD_TOL)
    del args, y64, s64, y_p, s_p, y, st
    torch.cuda.empty_cache()
    return worst


def cuda_kernels(fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` launches (from
    ``torch.profiler``), for the log."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def time_flash(card: str) -> dict:
    """K3 at the FLASH_TIMED cases, bf16 and float32, causal or
    bidirectional, each beside ``scaled_dot_product_attention`` on the
    same shape, mask and dtype (GQA as ``enable_gqa``, the window as a
    boolean mask; float32 with TF32 off, as ``main`` sets it, and the
    kernels it launched logged).  Bound: q, k, v read and out written
    once; 4 D flops per unmasked (query, key) pair (q.k and p.v) at the
    bf16 tensor-core rate, or the float32 CUDA-core rate (the TPU
    kernel's float32 products).  The plain version is timed at every
    case.  Returns bf16's first case's numbers, with every case under
    ``cases``, and float32's the same way under ``float32``."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for dtype, peak in ((torch.bfloat16, BF16_FLOPS),
                        (torch.float32, FP32_FLOPS)):
        cases = []
        for shape, window, causal in FLASH_TIMED:
            b, s, h, kh, d = shape
            q, k, v = flash_inputs(*shape, dtype, seed=9)
            nbytes, flops = flash_attention_cost(*shape, q.element_size(),
                                                 causal, window)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, S, D)
            qi = torch.arange(s, device="cuda")[:, None]
            ki = torch.arange(s, device="cuda")[None, :]
            mask = (ki <= qi) & (ki > qi - window) if window else None

            def kernel():
                return ops.flash_attention(q, k, v, causal=causal,
                                           window=window)

            def library():      # the nearest single PyTorch call; unused
                if mask is None:
                    return sdpa(qt, kt, vt, is_causal=causal,
                                enable_gqa=kh != h)
                return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=kh != h)

            res = {"shape": list(shape), "window": window, "causal": causal,
                   "variant": flash.variant(dtype, d),
                   "ms": device_ms(kernel, 20),
                   "library_ms": device_ms(library, 20),
                   "plain_ms": device_ms(lambda: ref.flash_attention(
                       q, k, v, causal=causal, window=window), 5),
                   **bound(nbytes, flops, peak)}
            if dtype == torch.float32:
                res["library_kernels"] = cuda_kernels(library)
            call_ms = median_ms(kernel, 20)
            log(f"timing flash_attention {shape} {str(dtype)[6:]} "
                f"{'causal' if causal else 'bidirectional'} window {window} "
                f"on {card}: kernel ({res['variant']}) {res['ms']!r} ms (one "
                f"call with its dispatch {call_ms!r} ms), bound "
                f"{res['bound_ms']!r} ms ({res['bound_by']}, {nbytes} B, "
                f"{flops} flop), plain {res['plain_ms']!r} ms, library "
                f"(sdpa) {res['library_ms']!r} ms"
                + (f" launching {res['library_kernels']}"
                   if dtype == torch.float32 else ""))
            cases.append(res)
            del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
        out[dtype] = {**{key: cases[0][key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "cases": cases}
    return {**out[torch.bfloat16], "float32": out[torch.float32]}


def tensor_core_resources() -> dict:
    """Registers a thread, local memory and shared memory of each variant
    of the tensor-core K3, from the CUDA runtime; raises on any local
    memory (spills): the kernel must keep its accumulators in
    registers."""
    res = {"variant": flash.variant(torch.bfloat16, QWEN_ATTN[-1]),
           "by_head_dim": {d: flash.tensor_core_attributes(d)
                           for d in TC_HEAD_DIMS}}
    log(f"tensor-core flash_attention: {res}")
    if any(a["local_bytes"] for a in res["by_head_dim"].values()):
        raise AssertionError(f"tensor-core flash_attention spills: {res}")
    return res


def fp32_resources() -> dict:
    """Registers a thread, local memory and shared memory of the TMA-fed
    float32 kernels: K3's variant for each of FP32_HEAD_DIMS and K5's,
    from the CUDA runtime; raises on any local memory (spills)."""
    res = {"flash_attention": {d: flash.fp32_attributes(d)
                               for d in FP32_HEAD_DIMS},
           "expert_gemm": egemm.fp32_attributes()}
    log(f"float32 TMA kernels: {res}")
    if any(a["local_bytes"] for a in res["flash_attention"].values()) \
            or res["expert_gemm"]["local_bytes"]:
        raise AssertionError(f"float32 TMA kernels spill: {res}")
    return res


def ssd_resources() -> dict:
    """Registers a thread, local memory and shared memory of each of K4's
    stage kernels, from the CUDA runtime; raises on any local memory
    (spills)."""
    res = kssd.attributes()
    log(f"ssd_scan stage kernels: {res}")
    if any(r["local_bytes"] for r in res.values()):
        raise AssertionError(f"ssd_scan stage kernels spill: {res}")
    return res


def time_ssd(card: str) -> dict:
    """K4 at the SSD_TIMED shapes (mamba2-780m's and zamba2-2.7b's
    prefills), each beside the torch route's chunked scan
    (``ssd_chunked_torch``, several launches, so not a library call) on
    the same inputs.  Bound: inputs read and outputs written once;
    float32 work as this data needs it — C Bᵀ over the causal triangle
    once per (batch, chunk) (it does not depend on the head), and per
    (batch, head, chunk) the triangle of ((C Bᵀ) ∘ L) X, C Sᵀ and the
    state update — at the float32 CUDA-core rate.  Returns the first
    shape's numbers, with every shape under ``cases``."""
    cases = []
    for shape in SSD_TIMED:
        args = ssd_inputs(*shape, seed=10)
        nbytes, flops = ssd_scan_cost(*shape)
        res = {"shape": list(shape),
               "ms": device_ms(lambda: ops.ssd_scan(*args), 20),
               # the plain recurrence is ~5000 small launches: host-bound
               "plain_ms": device_ms(lambda: ref.ssd_scan(*args), 1,
                                     rounds=3),
               "library_ms": None,      # no single PyTorch call computes it
               # ~40 launches a call: a longer spin hides their dispatch
               "torch_route_ms": device_ms(
                   lambda: ssd_chunked_torch(*args), 10, spin=2_000_000),
               **bound(nbytes, flops, FP32_FLOPS)}
        call_ms = median_ms(lambda: ops.ssd_scan(*args), 10)
        log(f"timing ssd_scan {shape} on {card}: kernel {res['ms']!r} ms "
            f"(one call with its dispatch {call_ms!r} ms), bound "
            f"{res['bound_ms']!r} ms ({res['bound_by']}, {nbytes} B, "
            f"{flops} flop), torch route {res['torch_route_ms']!r} ms, "
            f"plain {res['plain_ms']!r} ms")
        cases.append(res)
        del args
    torch.cuda.empty_cache()
    first = {key: cases[0][key] for key in ("ms", "plain_ms", "library_ms",
                                            "torch_route_ms", "bound_ms",
                                            "bound_by")}
    return {**first, "stages": list(kssd.STAGES), "cases": cases}


def gemm_inputs(e, c, d, f, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((e, c, d), device="cuda", generator=g)
    w = torch.randn((e, d, f), device="cuda", generator=g) * 0.05
    return x.to(dtype), w.to(dtype)


def scaled_gap(out, plain, rtol, atol, label) -> float:
    """Hold ``out`` to ``plain`` after dividing both by the largest
    magnitude of ``plain``; return the largest absolute difference."""
    out, plain = out.float(), plain.float()
    scale = float(plain.abs().max()) + 1e-6
    torch.testing.assert_close(out / scale, plain / scale, rtol=rtol,
                               atol=atol, msg=lambda m: f"{label}: {m}")
    err = float((out - plain).abs().max())
    log(f"check {label}: max |kernel - plain| = {err!r} (largest |plain| "
        f"{scale!r})")
    return err


def check_expert_gemm() -> dict:
    """K5 against its plain version at every case, in float32 and bf16;
    each call must run the one kernel ``egemm.variant`` names for its
    dtype and shape (all inputs here are 16-byte aligned).  Returns the
    largest |kernel - plain| by dtype."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = GEMM_TOL[dtype]
        worst[dtype] = 0.0
        for i, shape in enumerate(GEMM_CASES):
            x, w = gemm_inputs(*shape, dtype, seed=400 + i)
            which = egemm.variant(dtype, shape[2], shape[3])
            before = dict(egemm.VARIANT_LAUNCHES)
            out = ops.expert_gemm(x, w)
            torch.cuda.synchronize()
            ran = {n: egemm.VARIANT_LAUNCHES[n] - before[n] for n in before}
            if ran != {**dict.fromkeys(before, 0), which: 1}:
                raise AssertionError(f"expert_gemm {shape} {dtype}: ran "
                                     f"{ran}, expected one {which} launch")
            if out.shape != shape[:2] + shape[3:] or out.dtype != dtype:
                raise AssertionError(f"expert_gemm {shape}: output "
                                     f"{tuple(out.shape)} {out.dtype}")
            worst[dtype] = max(worst[dtype], scaled_gap(
                out, ref.expert_gemm(x, w), rtol, atol,
                f"expert_gemm {str(dtype)[6:]} {shape} ({which})"))
            del x, w, out
    torch.cuda.empty_cache()
    return worst


def check_expert_ffn() -> None:
    """``ops.expert_ffn`` (three K5 launches) against the einsum route at
    granite's prefill shape, with granite's init scales."""
    e, c, d, f = GRANITE_WI
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(500)
        experts = {"wi": torch.rand((e, d, f), device="cuda", generator=g),
                   "wg": torch.rand((e, d, f), device="cuda", generator=g),
                   "wo": torch.rand((e, f, d), device="cuda", generator=g)}
        experts = {k: ((v * 2 - 1) / math.sqrt(v.shape[1])).to(dtype)
                   for k, v in experts.items()}
        x = torch.randn((e, c, d), device="cuda", generator=g).to(dtype)
        out = ops.expert_ffn(experts, x)
        torch.cuda.synchronize()
        rtol, atol = GEMM_TOL[dtype]
        scaled_gap(out, moe.expert_ffn(experts, x), MOE_DEPTH * rtol,
                   MOE_DEPTH * atol,
                   f"expert_ffn {str(dtype)[6:]} {GRANITE_WI[:3]}, kernel "
                   "vs torch route")
        del experts, x, out
    torch.cuda.empty_cache()


def time_expert_gemm(card: str) -> dict:
    """K5 at granite's wi and wo shapes, bf16 and float32, each beside
    ``torch.bmm`` (float32 with TF32 off, as ``main`` sets it).  Bound: x
    and w read and out written once; 2 E C D F operations at the
    tensor-core rate of the inputs' type (bf16), or the float32 CUDA-core
    rate (float32: the TPU kernel's contract has no TF32).  Returns the bf16
    wi shape's numbers, with the wo shape's under ``wo``, and float32's
    the same way under ``float32``."""
    res = {}
    for shape in (GRANITE_WI, GRANITE_WO):
        e, c, d, f = shape
        for dtype, peak in ((torch.bfloat16, BF16_FLOPS),
                            (torch.float32, FP32_FLOPS)):
            x, w = gemm_inputs(*shape, dtype, seed=11)
            nbytes, flops = expert_gemm_cost(*shape, x.element_size())
            which = egemm.variant(dtype, d, f)
            r = {"variant": which,
                 "ms": device_ms(lambda: ops.expert_gemm(x, w), 20),
                 "plain_ms": device_ms(lambda: ref.expert_gemm(x, w), 5),
                 # the nearest single PyTorch call; timed here, never used
                 "library_ms": device_ms(lambda: torch.bmm(x, w), 20),
                 **bound(nbytes, flops, peak)}
            call_ms = median_ms(lambda: ops.expert_gemm(x, w), 20)
            log(f"timing expert_gemm {shape} {str(dtype)[6:]} ({which}) on "
                f"{card}: kernel {r['ms']!r} ms (one call with its dispatch "
                f"{call_ms!r} ms), bound {r['bound_ms']!r} ms "
                f"({r['bound_by']}, {nbytes} B, {flops} flop), plain "
                f"{r['plain_ms']!r} ms, library (torch.bmm) "
                f"{r['library_ms']!r} ms")
            res[shape, dtype] = r
            del x, w
    torch.cuda.empty_cache()
    return {**res[GRANITE_WI, torch.bfloat16],
            "wo": res[GRANITE_WO, torch.bfloat16],
            "float32": {**res[GRANITE_WI, torch.float32],
                        "wo": res[GRANITE_WO, torch.float32]}}


def expert_gemm_resources() -> dict:
    """Registers a thread, local memory and shared memory of the
    tensor-core K5, from the CUDA runtime; raises on any local memory
    (spills)."""
    res = {"variant": egemm.variant(torch.bfloat16, *GRANITE_WI[2:]),
           **egemm.tensor_core_attributes()}
    log(f"tensor-core expert_gemm: {res}")
    if res["local_bytes"]:
        raise AssertionError(f"tensor-core expert_gemm spills: {res}")
    return res


class MoeInputs:
    """Records the input of every ``moe_apply`` call while active (the
    transformer calls it through the module), for the layer checks."""

    def __init__(self):
        self.seen = []
        self._orig = moe.moe_apply

    def __enter__(self):
        def spy(p, x, cfg, **kw):
            self.seen.append(x.clone())
            return self._orig(p, x, cfg, **kw)
        moe.moe_apply = spy
        return self.seen

    def __exit__(self, *exc):
        moe.moe_apply = self._orig


def routing_flips(cfg, params, xs_a, xs_b) -> int:
    """Tokens, summed over the layers, whose top-k expert set differs
    between two prefills' MoE inputs."""
    n = 0
    for p_l, xa, xb in zip(params["layers"], xs_a, xs_b):
        ea, eb = (moe.route(p_l["moe"], x.reshape(-1, cfg.d_model),
                            cfg)["expert"].sort(-1).values
                  for x in (xa, xb))
        n += int((ea != eb).any(-1).sum())
    return n


def check_moe_layers(cfg, params, inputs, label: str) -> None:
    """Every MoE layer's input through ``moe_apply`` on both routes: the
    routing is then the same code on the same input, so aux is equal
    and y differs only by K5 against the einsum products."""
    rtol, atol = GEMM_TOL[cfg.torch_dtype]
    worst = 0.0
    for li, (p_l, x) in enumerate(zip(params["layers"], inputs)):
        before = ops.LAUNCHES["expert_gemm"]
        y_k, aux_k = moe.moe_apply(p_l["moe"], x, cfg, backend="kernel")
        after_k = ops.LAUNCHES["expert_gemm"]
        y_t, aux_t = moe.moe_apply(p_l["moe"], x, cfg, backend="torch")
        torch.cuda.synchronize()
        if (after_k - before, ops.LAUNCHES["expert_gemm"] - after_k) != (3, 0):
            raise AssertionError(f"{label} layer {li}: K5 launches "
                                 f"{after_k - before} (kernel route), "
                                 f"{ops.LAUNCHES['expert_gemm'] - after_k} "
                                 "(torch route)")
        if not torch.equal(aux_k, aux_t):
            raise AssertionError(f"{label} layer {li}: aux {aux_k} vs {aux_t}")
        scale = float(y_t.float().abs().max())
        torch.testing.assert_close(
            y_k.float() / scale, y_t.float() / scale, rtol=MOE_DEPTH * rtol,
            atol=MOE_DEPTH * atol, msg=lambda m: f"{label} layer {li}: {m}")
        worst = max(worst, float((y_k.float() - y_t.float()).abs().max())
                    / scale)
    log(f"{label}: {len(inputs)} MoE layers on shared inputs, kernel vs "
        f"torch route: aux equal, y within {worst!r} of its largest "
        f"magnitude (limit rtol {MOE_DEPTH * rtol!r}, atol "
        f"{MOE_DEPTH * atol!r})")


def prefill_launches(cfg, per_layer: dict) -> dict:
    """Kernel launches of one kernel-route prefill: ``per_layer`` for
    each layer, for the hybrid one K3 per application point of its
    shared block, and for the audio model one (bidirectional) K3 per
    encoder layer."""
    out = {k: n * cfg.num_layers for k, n in per_layer.items()}
    if cfg.family == "hybrid":
        out["flash_attention"] = (out.get("flash_attention", 0)
                                  + cfg.num_layers // cfg.attn_every)
    if cfg.family == "audio":
        out["flash_attention"] = (out.get("flash_attention", 0)
                                  + cfg.encoder_layers)
    return out


def model_prefix(cfg, n: int, gen):
    """The VLM's patches or the audio model's frames for ``n`` requests:
    (n, num_prefix, d) float32, normal x 0.1 from ``gen``; None for the
    other families."""
    if cfg.family not in ("vlm", "audio"):
        return None
    return torch.randn((n, cfg.num_prefix, cfg.d_model), generator=gen,
                       device=gen.device) * 0.1


def compare_chunked(cfg, params, batch, window: int, label: str,
                    card: str) -> dict:
    """One prefill on the chunked route and one on the torch route, each
    with its launch counts zeroed before and read after (none: the
    chunked route is plain PyTorch, and takes the einsums for the SSD
    scan and the experts) and its peak device memory above what was
    allocated before it; last-token logits within CHUNKED_TOL of their
    largest magnitude; both routes timed."""
    out, peak = {}, {}
    steps = {r: make_prefill_step(cfg, window=window, backend=r)
             for r in ("chunked", "torch")}
    for r, step in steps.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_launches()
        out[r] = step(params, batch)
        torch.cuda.synchronize()
        peak[r] = torch.cuda.max_memory_allocated() - base
        expect_launches(f"{label}, {r} route", {})
        expect_variants(f"{label}, {r} route", cfg, {})
    n, s = batch["tokens"].shape
    for r, lg in out.items():
        if lg.shape != (n, 1, cfg.vocab_size) or not torch.isfinite(lg).all():
            raise AssertionError(f"{label}, {r} route: logits "
                                 f"{tuple(lg.shape)} not finite")
    scale = float(out["torch"].float().abs().max())
    diff = float((out["chunked"].float() - out["torch"].float()).abs().max())
    ms = {r: median_ms(lambda: steps[r](params, batch), 3, warmup=0)
          for r in steps}
    tol = CHUNKED_TOL[cfg.torch_dtype]
    log(f"{label}: last-token logits chunked vs torch route max abs diff "
        f"{diff!r} ({diff / scale!r} of the largest |logit| {scale!r}, "
        f"limit {tol!r}); prefill of {n} x {s} tokens {ms['chunked']!r} ms "
        f"(chunked route), {ms['torch']!r} ms (torch route); peak device "
        f"memory above the weights and inputs {peak['chunked']} B "
        f"(chunked), {peak['torch']} B (torch) on {card}")
    if not diff <= tol * scale:
        raise AssertionError(f"{label}: chunked vs torch route differ by "
                             f"{diff} > {tol} x {scale}")
    return {"rel_diff": diff / scale, "ms": ms, "peak_bytes": peak}


def compare_routes(cfg, params, batch, window: int, per_prefill: dict,
                   label: str, card: str) -> dict:
    """One prefill on the kernel route (launch counts zeroed before and
    read after) and one on the torch route; last-token logits within
    LOGIT_TOL of their largest magnitude; both routes timed.  For the
    MoE family, also every layer on both routes from the torch-route
    prefill's inputs, and the top-k decisions that differ between the
    two prefills.  Returns the kernel route's launch counts."""
    steps = {r: make_prefill_step(cfg, window=window, backend=r)
             for r in ("kernel", "torch")}
    torch.cuda.synchronize()
    with MoeInputs() as in_k:
        zero_launches()
        out_k = steps["kernel"](params, batch)
        torch.cuda.synchronize()
        got = expect_launches(f"{label}, kernel route", per_prefill)
        expect_variants(f"{label}, kernel route", cfg, per_prefill)
    with MoeInputs() as in_t:
        zero_launches()
        out_t = steps["torch"](params, batch)
        torch.cuda.synchronize()
        expect_launches(f"{label}, torch route", {})
        expect_variants(f"{label}, torch route", cfg, {})
    if cfg.family == "moe":
        check_moe_layers(cfg, params, in_t, label)
        flips = routing_flips(cfg, params, in_k, in_t)
        log(f"{label}: top-k decisions that differ between the kernel and "
            f"torch route prefills: {flips} of {len(in_t)} layers x "
            f"{in_t[0].shape[0] * in_t[0].shape[1]} tokens")
    del in_k, in_t
    n, s = batch["tokens"].shape
    for nm, out in (("kernel", out_k), ("torch", out_t)):
        if out.shape != (n, 1, cfg.vocab_size) or \
                not torch.isfinite(out).all():
            raise AssertionError(f"{label}, {nm} route: logits "
                                 f"{tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
    scale = float(out_t.float().abs().max())
    diff = float((out_k.float() - out_t.float()).abs().max())
    agree = float((out_k.argmax(-1) == out_t.argmax(-1)).float().mean())
    ms = {r: median_ms(lambda: steps[r](params, batch), 3, warmup=0)
          for r in steps}
    log(f"{label}: last-token logits kernel vs torch route max abs diff "
        f"{diff!r} (largest |logit| {scale!r}, {diff / scale!r} of it; "
        f"argmax agreement {agree!r}); prefill of {n} x {s} tokens "
        f"{ms['kernel']!r} ms (kernel route), {ms['torch']!r} ms (torch "
        f"route) on {card}")
    tol = LOGIT_TOL[cfg.torch_dtype]
    if not diff <= tol * scale:
        raise AssertionError(f"{label}: routes differ by {diff} > {tol} x "
                             f"{scale}")
    return got


def serve_arch(arch: str, card: str) -> tuple:
    """Phase 10 for one arch at full width (and its full depth but where
    its "depth" cuts it).  Returns the kernel launches of one
    kernel-route prefill (window 0), bf16 and float32."""
    run = SERVE[arch]
    cfg = get_config(arch)
    if "depth" in run:
        log(f"{arch}: depth cut to {run['depth']} of its "
            f"{cfg.num_layers} layers (full width; the whole model does "
            "not fit one card)")
        cfg = cfg.replace(num_layers=run["depth"])
    per_prefill = prefill_launches(cfg, run["per_layer"])
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tr.init_params(gen, cfg)
    prompt = torch.randint(0, cfg.vocab_size, (REQUESTS, run["prompt"]),
                           generator=gen, device="cuda")
    batch = {"tokens": prompt}
    prefix = model_prefix(cfg, REQUESTS, gen)
    if prefix is not None:
        batch["prefix"] = prefix
    n_params = sum(t.numel() for t in tr.flat_params(params).values())
    log(f"{arch}: {cfg.num_layers} layers"
        + (f" after {cfg.encoder_layers} encoder layers"
           if cfg.encoder_layers else "")
        + f", {n_params} parameters, {torch.cuda.memory_allocated()} B on "
        "the card" + (f"; prompts after a prefix of {cfg.num_prefix} "
                      "embeddings" if prefix is not None else ""))
    launches = None
    for window in run["windows"]:
        label = f"{arch} prefill, window {window}"
        got = compare_routes(cfg, params, batch, window, per_prefill, label,
                             card)
        launches = got if launches is None else launches
    long_batch = None
    if "long" in run:
        n, s, window = run["long"]
        long_batch = {"tokens": torch.randint(0, cfg.vocab_size, (n, s),
                                              generator=gen, device="cuda")}
        long_label = f"{arch} prefill of {n} x {s} tokens, window {window}"
        compare_routes(cfg, params, long_batch, window, per_prefill,
                       long_label, card)
    peak = torch.cuda.max_memory_allocated()
    # the chunked route (it resets the peak statistics: after it, the
    # peak is that of the float32 prefill and the decode)
    chunked = run.get("chunked", ())
    if "prompt" in chunked:
        compare_chunked(cfg, params, batch, 0, f"{arch} prefill", card)
    if "long" in chunked:
        compare_chunked(cfg, params, long_batch, run["long"][2], long_label,
                        card)
    del long_batch
    # the same prefill at full width in float32 (the config's widths and
    # depth, float32 weights from the same seed)
    cfg32 = cfg.replace(dtype="float32")
    params32 = tr.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg32)
    launches32 = compare_routes(cfg32, params32, batch, 0, per_prefill,
                                f"{arch} prefill in float32", card)
    if "prompt" in chunked:
        compare_chunked(cfg32, params32, batch, 0,
                        f"{arch} prefill in float32", card)
    del params32
    torch.cuda.empty_cache()
    gp = prompt[:, :GREEDY_PROMPT]
    # the audio model's one encoder pass (kernel route) launches K3 once
    # a layer; decode launches nothing
    gen_launches = ({"flash_attention": cfg.encoder_layers}
                    if cfg.family == "audio" else {})
    zero_launches()
    t0 = time.perf_counter()
    toks = greedy_generate(params, cfg, gp, NEW_TOKENS, prefix=prefix)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    expect_launches(f"{arch} greedy_generate", gen_launches)
    expect_variants(f"{arch} greedy_generate", cfg, gen_launches)
    new = toks[:, GREEDY_PROMPT:]
    if (toks.shape != (REQUESTS, GREEDY_PROMPT + NEW_TOKENS)
            or not torch.equal(toks[:, :GREEDY_PROMPT], gp)
            or int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size):
        raise AssertionError(f"{arch} greedy_generate: tokens "
                             f"{tuple(toks.shape)} {new.tolist()}")
    # decode rate: NEW_TOKENS steps against a replayed cache
    enc_out = tr.encode(params, cfg, prefix) if cfg.family == "audio" \
        else None
    cache = tr.prefill_cache(params, cfg, gp, cache_len=GREEDY_PROMPT
                             + NEW_TOKENS + 1, enc_out=enc_out)
    step = make_decode_step(cfg)
    last = toks[:, GREEDY_PROMPT:GREEDY_PROMPT + 1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NEW_TOKENS):
        logits, cache = step(params, cache, {"token": last})
        last = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    log(f"{arch} greedy_generate: {REQUESTS} x {NEW_TOKENS} new tokens after "
        f"a {GREEDY_PROMPT}-token prompt in {gen_s!r} s (replay included); "
        f"decode {REQUESTS * NEW_TOKENS / dec_s!r} tokens/s "
        f"({dec_s / NEW_TOKENS * 1e3!r} ms a step) on {card}; first "
        f"request {new[0].tolist()}")
    log(f"{arch} peak device memory: {peak} B (bf16 prefills), "
        f"{torch.cuda.max_memory_allocated()} B (the float32 prefill and "
        "the decode)")
    del params, cache, enc_out
    torch.cuda.empty_cache()
    return launches, launches32


def check_replay_smoke() -> None:
    """Smoke size, float32, on the card: the kernel route's prefill
    logits == a decode replay (``prefill_cache`` + ``decode_step``).
    The MoE prefill routes all its tokens under a capacity and may drop
    choices, which the replay (2 tokens a step) never does; it is held
    at a capacity that cannot drop (E / k), after the drops at the
    config's own are printed.  The audio model's replay starts from the
    encoder's output (its cross K/V).  The VLM's replay never sees the
    patches, as the JAX package's (ROADMAP queue 3): it is held to the
    text-only prefill of the same weights (a dense model, no prefix),
    and its gap to the VLM's prefill is logged, with no limit."""
    for arch, run in SERVE.items():
        cfg = get_config(arch, smoke=True).replace(**run.get("smoke", {}))
        gen = torch.Generator(device="cuda").manual_seed(1)
        params = tr.init_params(gen, cfg)
        toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen,
                             device="cuda")
        batch = {"tokens": toks}
        prefix = model_prefix(cfg, 2, gen)
        if prefix is not None:
            batch["prefix"] = prefix
        if cfg.family == "moe":
            with MoeInputs() as xs:
                make_prefill_step(cfg)(params, batch)
            drops = [int((r["slot"] == cfg.num_experts * r["cap"]).sum())
                     for r in (moe.route(p_l["moe"], x.reshape(
                         -1, cfg.d_model), cfg) for p_l, x in
                         zip(params["layers"], xs))]
            log(f"{arch} smoke size: choices dropped per layer at capacity "
                f"factor {cfg.capacity_factor}: {drops}; replay held at "
                f"{cfg.num_experts / cfg.top_k}")
            cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
        zero_launches()
        last = make_prefill_step(cfg)(params, batch)
        torch.cuda.synchronize()
        per_prefill = prefill_launches(cfg, run["per_layer"])
        expect_launches(f"{arch} smoke prefill", per_prefill)
        expect_variants(f"{arch} smoke prefill", cfg, per_prefill)
        enc_out = tr.encode(params, cfg, prefix) if cfg.family == "audio" \
            else None
        cache = tr.prefill_cache(params, cfg, toks[:, :-1], cache_len=12,
                                 enc_out=enc_out)
        dec, _ = tr.decode_step(params, cfg, toks[:, -1:], cache)
        if cfg.family == "vlm":
            caveat = float((last - dec).abs().max())
            last = make_prefill_step(cfg.replace(family="dense"))(
                params, {"tokens": toks})
            log(f"{arch} smoke size: the decode replay never sees the "
                f"patches (as the JAX package's): its gap to the VLM "
                f"prefill {caveat!r}; held to the text-only prefill")
        diff = float((last - dec).abs().max())
        log(f"{arch} smoke size ({cfg.num_layers} layers), float32: "
            f"prefill vs decode replay max abs diff {diff!r}")
        if not diff <= REPLAY_TOL:
            raise AssertionError(f"{arch} smoke: prefill vs replay {diff}")



# ---------------------------------------------------------------------------
# phase 13: the LM supernet NAS path
# ---------------------------------------------------------------------------

SUPERNET_TOKENS = 256          # per request, 4 requests (REQUESTS)
# the supernets of (a): one per family
SUPERNET_ARCHS = tuple(a for a, run in SERVE.items() if run.get("supernet"))
# the full-width LM search: 4 clients of make_lm_stream (8 train and 4
# test sequences of 256 tokens, batch 4), population 4, 2 generations.
# K1's route stacks (m, P) float32 client and mask matrices: 34.6 GB at
# m = 4 and P = 1.08 B beside the master, so 4 clients a group at most
LM_ARCH = "qwen1.5-0.5b"
LM_CLIENTS, LM_TRAIN, LM_TEST, LM_SEQ, LM_BATCH = 4, 8, 4, 256, 4
LM_RUN = dict(population=4, generations=2, backend="loop", lr0=0.01,
              aggregate_backend="kernel")
LM_PLAIN_CHUNKS = 8    # K1's plain version over column chunks at the LM master


def supernet_keys(num_layers: int) -> dict:
    """The keys phase 13 runs every supernet on: each branch on every
    layer, and one key that cycles through the four."""
    return {"all 1": np.ones(num_layers, int),
            "all 2": np.full(num_layers, 2),
            "all 3": np.full(num_layers, 3),
            "all 0": np.zeros(num_layers, int),
            "mixed": np.arange(num_layers) % 4}


def supernet_launches(cfg, per_layer: dict, key) -> dict:
    """Kernel launches of one kernel-route forward of a supernet on
    ``key``: ``per_layer`` for each layer that is not an identity,
    except the MoE's K5 on the bottleneck branch (2), which runs three
    einsums on either route, as the JAX package's; and the hybrid's one
    K3 per application point of its shared block, whatever the key (it
    fires by layer index, after an identity layer too)."""
    out: dict = {}
    for b in np.asarray(key).tolist():
        for name, n in per_layer.items():
            if b and not (name == "expert_gemm" and b == 2):
                out[name] = out.get(name, 0) + n
    if cfg.family == "hybrid":
        out["flash_attention"] = (out.get("flash_attention", 0)
                                  + cfg.num_layers // cfg.attn_every)
    return out


def supernet_key_routes(cfg, params, toks, name: str, key, per_layer: dict,
                        arch: str, prefix=None) -> dict:
    """One supernet key on both routes: ``forward(..., choice_key=)`` on
    the kernel route (launch counts zeroed just before and read just
    after: ``supernet_launches``) against the torch route, within
    LOGIT_TOL of the logits' largest magnitude.  Returns the kernel
    route's launches."""
    label = f"{arch} supernet, {cfg.dtype}, key {name}"
    expected = supernet_launches(cfg, per_layer, key)
    zero_launches()
    logits_k = tr.forward(params, cfg, toks, prefix=prefix, choice_key=key)
    torch.cuda.synchronize()
    got = expect_launches(f"{label}, kernel route", expected)
    expect_variants(f"{label}, kernel route", cfg, expected)
    zero_launches()
    logits_t = tr.forward(params, cfg, toks, prefix=prefix, choice_key=key,
                          backend="torch")
    torch.cuda.synchronize()
    expect_launches(f"{label}, torch route", {})
    for nm, lg in (("kernel", logits_k), ("torch", logits_t)):
        if (lg.shape != (REQUESTS, SUPERNET_TOKENS, cfg.vocab_size)
                or not torch.isfinite(lg).all()):
            raise AssertionError(f"{label}, {nm} route: logits "
                                 f"{tuple(lg.shape)} not finite")
    scale = float(logits_t.float().abs().max())
    diff = float((logits_k.float() - logits_t.float()).abs().max())
    tol = LOGIT_TOL[cfg.torch_dtype]
    log(f"{label}: kernel vs torch route logits max abs diff {diff!r} "
        f"({diff / scale!r} of the largest |logit| {scale!r}, limit "
        f"{tol!r}); kernel launches {got}")
    if not diff <= tol * scale:
        raise AssertionError(f"{label}: routes differ by {diff} > {tol} x "
                             f"{scale}")
    return {k: v for k, v in got.items() if v}


def check_supernet_branches(card: str) -> dict:
    """(a) Each supernet at full width, seeded random weights on the card,
    4 requests of 256 tokens: every key of ``supernet_keys`` in bf16, and
    the mixed key again in float32 (weights from the same seed), where
    LOGIT_TOL is 1e-3 and a branch mask missing or wrong on one route
    shows (``supernet_key_routes``); the VLM's with its 256 patches
    before the tokens.  Then an audio supernet's forward raises, as the
    JAX package's.  Returns the bf16 launches by arch and key."""
    out = {}
    for arch in SUPERNET_ARCHS:
        per_layer = SERVE[arch]["per_layer"]
        out[arch] = {}
        for dtype in ("bfloat16", "float32"):
            cfg = get_config(arch).replace(supernet=True, dtype=dtype)
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = tr.init_params(gen, cfg)
            toks = torch.randint(0, cfg.vocab_size,
                                 (REQUESTS, SUPERNET_TOKENS), generator=gen,
                                 device="cuda")
            prefix = model_prefix(cfg, REQUESTS, gen)
            keys = supernet_keys(cfg.num_layers)
            if dtype == "float32":
                keys = {"mixed": keys["mixed"]}
            else:
                n_params = sum(v.numel()
                               for v in tr.flat_params(params).values())
            for name, key in keys.items():
                got = supernet_key_routes(cfg, params, toks, name, key,
                                          per_layer, arch, prefix)
                if dtype == "bfloat16":
                    out[arch][name] = got
            del params
            torch.cuda.empty_cache()
        log(f"{arch} supernet: {n_params} parameters ({cfg.num_layers} "
            f"layers x 3 branches), bf16 launches by key {out[arch]} on "
            f"{card}")
    cfg = get_config("whisper-large-v3", smoke=True).replace(supernet=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tr.init_params(gen, cfg)
    toks = torch.zeros((2, 8), dtype=torch.int64, device="cuda")
    try:
        tr.forward(params, cfg, toks, prefix=model_prefix(cfg, 2, gen),
                   choice_key=np.ones(cfg.num_layers, int))
    except ValueError as e:
        log(f"whisper-large-v3 supernet forward raises, as the JAX "
            f"package's: {e}")
    else:
        raise AssertionError("an audio supernet's forward ran")
    return out


def lm_clients(cfg, n_clients: int, train: int, test: int, seq: int,
               batch: int) -> list:
    """``n_clients`` clients of ``make_lm_stream`` sequences, ``train``
    and ``test`` of ``seq`` tokens each, batch ``batch``."""
    per = train + test
    x, y = make_lm_stream(0, n_clients * per, seq, cfg.vocab_size)
    return [ClientDataset(i, x[i * per:(i + 1) * per],
                          y[i * per:(i + 1) * per], batch=batch,
                          test_batch=batch)
            for i in range(n_clients)]


def ulp_bf16(x: float) -> float:
    """One bfloat16 step (8 significant bits) at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


class FirstFillAgainstTorchRoute:
    """While active, the loop backend's first ``fill_aggregate`` (a
    generation-1 ``train_fill``) also runs the torch route on the same
    uploads, before the run's own kernel-route call, and holds the two
    masters leaf by leaf within one bfloat16 step of the leaf's largest
    magnitude (both round float32 sums to bf16 once; the sums' order
    differs).  The torch route launches no kernel, so the run's counts
    are its own."""

    def __init__(self, label: str):
        self.label = label
        self.done = False
        self._orig = backends.fill_aggregate

    def __enter__(self):
        def spy(master, uploads, backend):
            if self.done:
                return self._orig(master, uploads, backend=backend)
            self.done = True
            plain = self._orig(master, uploads, backend="torch")
            out = self._orig(master, uploads, backend=backend)
            worst, n_diff, n = 0.0, 0, 0
            for k, t in plain.items():
                top = float(t.float().abs().max())
                d = (out[k].float() - t.float()).abs()
                gap = float(d.max())
                if not gap <= ulp_bf16(top):
                    raise AssertionError(
                        f"{self.label}: leaf {k} differs from the torch "
                        f"route by {gap} > one bf16 step {ulp_bf16(top)}")
                worst = max(worst, gap / top if top else 0.0)
                n_diff += int((d > 0).sum())
                n += t.numel()
            log(f"{self.label}: the first train_fill's master on K1 against "
                f"the torch route on the same {len(uploads)} uploads: every "
                f"leaf within one bf16 step of its largest magnitude "
                f"(worst {worst!r} of it, against 2^-8 = {2 ** -8!r}); "
                f"{n_diff} of {n} entries differ ({n_diff / n!r})")
            del plain
            return out
        backends.fill_aggregate = spy
        return self

    def __exit__(self, *exc):
        backends.fill_aggregate = self._orig


def time_fill_aggregate_lm(card: str, p: int) -> dict:
    """K1 at the LM master (m = 4 uploads, P = ``p``, random inputs: its
    work does not depend on them): device time beside its bound, the
    nearest PyTorch expression (lerp + matvec) and the plain version,
    which at this size runs over LM_PLAIN_CHUNKS column chunks (whole,
    its temporaries would not fit beside the inputs); the plain chunks
    also give K1's largest gap."""
    m = LM_CLIENTS
    g = torch.Generator(device="cuda").manual_seed(98)
    cl = torch.randn(m, p, device="cuda", generator=g)
    mk = torch.randint(0, 2, (m, p), device="cuda", generator=g,
                       dtype=torch.float32)
    w = torch.rand(m, device="cuda", generator=g)
    w = w / w.sum()
    prev = torch.randn(p, device="cuda", generator=g)
    nbytes = (2 * m + 1) * p * 4 + m * 4 + p * 4
    step = -(-p // LM_PLAIN_CHUNKS)
    cuts = [(a, min(a + step, p)) for a in range(0, p, step)]

    def plain():
        return [ref.fill_aggregate(cl[:, a:b], mk[:, a:b], w, prev[a:b])
                for a, b in cuts]

    out = ops.fill_aggregate(cl, mk, w, prev)
    err = max(float((out[a:b] - part).abs().max())
              for (a, b), part in zip(cuts, plain()))
    del out
    res = {
        "ms": device_ms(lambda: ops.fill_aggregate(cl, mk, w, prev), 3,
                        rounds=3),
        "plain_ms": device_ms(plain, 1, rounds=3),
        "library_ms": device_ms(
            lambda: w @ torch.lerp(prev.expand_as(cl), cl, mk), 1, rounds=3),
        **bound(nbytes, 6 * m * p, FP32_FLOPS),
        "max_abs_err": err, "m": m, "P": p,
    }
    log(f"timing fill_aggregate at the LM master (m={m}, P={p}) on {card}: "
        f"kernel {res['ms']!r} ms, bound {res['bound_ms']!r} ms "
        f"({res['bound_by']}, {nbytes} B), plain ({len(cuts)} column "
        f"chunks) {res['plain_ms']!r} ms, library {res['library_ms']!r} ms;"
        f" max |kernel - plain| {err!r}")
    if not err <= TOL:
        raise AssertionError(f"fill_aggregate at the LM master: {err} > {TOL}")
    del cl, mk, w, prev
    torch.cuda.empty_cache()
    return res


def check_lm_search(card: str) -> tuple:
    """(b) Real-time NAS on the qwen1.5-0.5b supernet at full width (bf16,
    1,080,574,976 parameters by the JAX package's count) on the loop
    backend with Algorithm 3 on K1: launch counts zeroed just before and
    read just after (3 K1 launches, nothing else), ``round_s`` per
    generation and peak memory logged, the first train_fill held to the
    torch route (``FirstFillAgainstTorchRoute``).  Returns (K1's launches,
    the master's flattened length)."""
    cfg = get_config(LM_ARCH).replace(supernet=True)
    api = lm_supernet_api(cfg)
    if api.master_params() != 1_080_574_976:
        raise AssertionError(f"{LM_ARCH} supernet: {api.master_params()}")
    clients = lm_clients(cfg, LM_CLIENTS, LM_TRAIN, LM_TEST, LM_SEQ,
                         LM_BATCH)
    n_fill = LM_RUN["generations"] + 1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    label = f"{LM_ARCH} supernet search"
    t0 = time.perf_counter()
    eng = FedEngine(api, clients, RunConfig(device="cuda", **LM_RUN))
    with FirstFillAgainstTorchRoute(label) as spy:
        zero_launches()
        result = eng.run()
        torch.cuda.synchronize()
        got = expect_launches(label, {"fill_aggregate": n_fill})
    if not spy.done:
        raise AssertionError(f"{label}: no train_fill was checked")
    check_run(result, label)
    master = result.extras["final_master"]
    p = sum(v.numel() for v in master.values())
    for r in result.reports:
        log(f"{label} generation {r.gen}: round_s {r.round_s!r}, best_err "
            f"{r.best_err!r} (wrong tokens per sequence), parents "
            f"{[k.tolist() for k in r.parent_keys]}")
    log(f"{label}: {len(master)} leaves, {p} parameters flattened (the JAX "
        f"package's count {api.master_params()} leaves out the QKV biases); "
        f"CommStats {dataclasses.asdict(result.stats)}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B; {time.perf_counter() - t0!r}"
        f" s with the set-up on {card}")
    del eng, result, master
    torch.cuda.empty_cache()
    return got["fill_aggregate"], p


def check_lm_search_smoke() -> None:
    """(c) The same search at smoke size (qwen1.5-0.5b's smoke config
    with the supernet, float32) on the card, on the loop and the fused
    vmap backend (3 K1 launches each, in place on vmap), against the
    loop run on the CPU: keys and CommStats equal, masters within
    MASTER_TOL."""
    cfg = get_config(LM_ARCH, smoke=True).replace(supernet=True)
    api = lm_supernet_api(cfg)
    clients = lm_clients(cfg, 4, 16, 8, 32, 8)
    n_fill = LM_RUN["generations"] + 1
    cpu = FedEngine(api, clients, RunConfig(device="cpu", **LM_RUN)).run()
    for backend, in_place in (("loop", 0), ("vmap", n_fill)):
        label = f"LM supernet search, smoke size, {backend}"
        zero_launches()
        gpu = FedEngine(api, clients, RunConfig(**dict(
            LM_RUN, device="cuda", backend=backend))).run()
        torch.cuda.synchronize()
        expect_launches(label, {"fill_aggregate": n_fill})
        expect_fill_variants(label, in_place, n_fill - in_place)
        check_run(gpu, label)
        same_trajectory(gpu, cpu, f"{label}, card vs the CPU's loop",
                        MASTER_TOL)
        gap = max(float(np.abs(a.objs - b.objs).max())
                  for a, b in zip(gpu.reports, cpu.reports))
        log(f"{label}: objectives card vs CPU max abs diff {gap!r}")


def check_examples(card: str) -> None:
    """(c) Both examples on the card at their default sizes, launch counts
    zeroed just before and read just after each: quickstart's fused
    ``vmap`` run on K1 in place (3 launches), federated_nas_cifar's
    search on the loop backend (one K1 launch a train_fill: 6 in 5
    generations; the baselines aggregate with FedAvg)."""
    for label, run, n_fill in (
            ("quickstart", lambda tmp: quickstart.main([]), 3),
            ("federated_nas_cifar",
             lambda tmp: federated_nas_cifar.main(["--out", tmp]), 6)):
        with tempfile.TemporaryDirectory() as tmp:
            zero_launches()
            t0 = time.perf_counter()
            run(tmp)
            torch.cuda.synchronize()
            expect_launches(f"example {label}", {"fill_aggregate": n_fill})
            log(f"example {label}: {time.perf_counter() - t0!r} s on {card}")

# ---------------------------------------------------------------------------
# phase 14: the LM training launcher
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen1.5-0.5b"
# (a) 8 AdamW steps of 4 x 4096 tokens (train_4k's sequence length) in
# two microbatches, remat and the fused cross entropy, torch route
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 4, 4096, 1e-3
TRAIN_MICRO = 2
# (b) the levers at full width, 2 layers, float32: remat and microbatches
# on one SGD step of 4 x 1024 tokens; the fused cross entropy against
# the naive one at 4 x 4096 tokens (two chunks of 8192)
LEVER_LAYERS, LEVER_SEQ = 2, 1024
REMAT_TOL = 0.0         # remat on = off, bit for bit
MICRO_TOL = 1e-6        # microbatch 2 vs 1, of the largest |parameter|
# the chunked route (two blocks of 512 queries) vs the torch route on
# one SGD step, of the largest |parameter|: the same float32 arithmetic
# summed in another order
CHUNKED_STEP_TOL = 1e-5
# (h) zamba2-2.7b at full width, 12 of its 54 layers (two application
# points of the shared block), bf16, AdamW, 4 steps of 2 x 4096 tokens
# on the chunked route (K3 and K4 take no gradient)
HYBRID_ARCH, HYBRID_LAYERS = "zamba2-2.7b", 12
HYBRID_STEPS, HYBRID_BATCH = 4, 2
CE_TOKENS = (4, 4096)
CE_LOSS_RTOL, CE_GRAD_TOL = 1e-6, 1e-5
# h's gradient sums V = 151936 float32 products per entry, in another
# order in each version (fused: 8192 rows a product; naive: 16384): the
# two differ by more than the table gradient (whose sums run over the
# tokens).  Each is held to a float64 recomputation of CE_ROWS rows of it
CE_ROWS, CE_H_TOL = 512, 2e-4
# (d) smoke size, float32, card against the CPU: loss and parameters
# within 1e-5; the supernet's 3 SGD steps with a key each.  An AdamW step
# is m / (sqrt(v) + eps): an entry whose gradient is rounding noise moves
# by up to 2 lr, whichever way the noise falls on each device (the CPU
# tests measured 42 of 394,624 entries past 1e-6 against the JAX
# package), so AdamW's parameters are held within 1e-5 but for at most
# ADAMW_NOISY of the entries, each within 2 lr, and its moments m and v
# within 1e-5 of their largest.  The 2 lr cap is a whole first step and
# cannot see a wrong update of a noisy entry: the moments' limit and the
# noisy share are the checks that bind
CARD_CPU_TOL = 1e-5
ADAMW_NOISY = 1e-3
CARD_CPU_LR = {"sgd": 0.1, "adamw": 1e-3}
TRAIN_KEYS = ([1, 2], [3, 0], [2, 1])


def lm_batch(cfg, seed: int, n: int, seq: int, device="cuda") -> dict:
    """``make_lm_stream`` tokens and labels, and for the VLM and audio
    models a prefix of ``num_prefix`` embeddings (normal x 0.1 from
    ``seed``, numpy)."""
    x, y = make_lm_stream(seed, n, seq, cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(x).to(device),
             "labels": torch.from_numpy(y).to(device)}
    if cfg.family in ("vlm", "audio"):
        batch["prefix"] = torch.from_numpy(np.random.default_rng(seed).normal(
            0.0, 0.1, (n, cfg.num_prefix, cfg.d_model)).astype(
                np.float32)).to(device)
    return batch


def check_train_full_width(card: str, backend: str = "torch") -> dict:
    """(a) qwen1.5-0.5b at full width and depth in bf16 through
    ``make_train_step``: AdamW, 2 microbatches, remat, the fused cross
    entropy, on ``backend`` (the torch route; (f) the chunked route).
    Every loss finite, the last below the first, no kernel launched
    (launch counts zeroed before, read after).  Logs the step time
    (median of steps 2-8), tokens/s, peak memory and the model FLOP/s
    (6 N tokens) against the card's dense bf16 peak."""
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tr.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    n = sum(t.numel() for t in tr.flat_params(params).values())
    mb_rows = TRAIN_BATCH // TRAIN_MICRO
    scores = mb_rows * cfg.num_heads * TRAIN_SEQ ** 2 * 4
    log(f"training {TRAIN_ARCH}: {n} parameters, reckoned: weights "
        f"{2 * n} B, gradients {2 * n} B ({4 * n} B accumulated in "
        f"float32 over {TRAIN_MICRO} microbatches), AdamW m and v "
        f"{8 * n} B; the torch route's float32 scores {scores} B per "
        f"tensor per layer at {mb_rows} x {TRAIN_SEQ} tokens (remat keeps "
        "one layer's)")
    opt = lm_train.init_opt(params, "adamw")
    step = lm_train.make_train_step(
        cfg, optimizer="adamw", lr=TRAIN_LR, microbatch=TRAIN_MICRO,
        remat=True, fused_ce=True, backend=backend)
    data = lm_batch(cfg, 0, TRAIN_STEPS * TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    losses, times = [], []
    torch.cuda.synchronize()
    zero_launches()
    for i in range(TRAIN_STEPS):
        rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, {k: v[rows]
                                               for k, v in data.items()})
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        log(f"training {TRAIN_ARCH} ({backend} route) step {i}: loss "
            f"{losses[-1]!r}, {times[-1]!r} s")
    expect_launches(f"training {TRAIN_ARCH} ({backend} route), "
                    f"{TRAIN_STEPS} steps", {})
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"training {TRAIN_ARCH}: losses {losses}")
    if int(opt["step"]) != TRAIN_STEPS:
        raise AssertionError(f"AdamW step {int(opt['step'])}")
    step_s = float(np.median(times[1:]))
    flop_s = train_flops(cfg, tokens) / step_s
    res = {"arch": TRAIN_ARCH, "backend": backend, "parameters": n,
           "steps": TRAIN_STEPS,
           "tokens_per_step": tokens, "microbatch": TRAIN_MICRO,
           "losses": losses, "step_s": step_s, "step_s_all": times,
           "tokens_per_s": tokens / step_s,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "model_flop_per_s": flop_s, "mfu": flop_s / BF16_FLOPS}
    log(f"training {TRAIN_ARCH} on the {backend} route on {card}: step "
        f"{step_s!r} s (median of "
        f"steps 2-{TRAIN_STEPS}), {res['tokens_per_s']!r} tokens/s, "
        f"{flop_s!r} model FLOP/s ({res['mfu']!r} of {BF16_FLOPS:.0f}), "
        f"peak {res['peak_bytes']} B")
    del params, opt, data
    torch.cuda.empty_cache()
    return res


def param_gap(a: dict, b: dict) -> tuple:
    """Largest |a - b| over the leaves, and the largest |a|."""
    gap = max(float((a[k].float() - b[k].float()).abs().max()) for k in a)
    return gap, max(float(t.float().abs().max()) for t in a.values())


def check_train_levers(card: str) -> dict:
    """(b) At full width, 2 layers, float32 (TF32 off): remat on against
    off and 2 microbatches against 1, and (g) the chunked route against
    the torch route, each on one SGD step of 4 x 1024 tokens; the fused
    cross entropy against ``cross_entropy`` of the full logits at 4 x
    4096 tokens and qwen's vocabulary (two chunks), loss, gradients and
    peak memory."""
    cfg = get_config(TRAIN_ARCH).replace(num_layers=LEVER_LAYERS,
                                         dtype="float32")
    params = tr.init_params(torch.Generator(device="cuda").manual_seed(1),
                            cfg)
    batch = lm_batch(cfg, 1, 4, LEVER_SEQ)

    def one_step(**kw):
        step = lm_train.make_train_step(cfg, **kw)
        new, _, loss = step(params, lm_train.init_opt(params), batch)
        return float(loss), tr.flat_params(new)

    base = one_step(remat=True)
    res = {}
    for name, kw, tol in (("remat off", dict(remat=False), REMAT_TOL),
                          ("microbatch 2", dict(remat=True, microbatch=2),
                           MICRO_TOL),
                          ("chunked route", dict(remat=True,
                                                 backend="chunked"),
                           CHUNKED_STEP_TOL)):
        other = one_step(**kw)
        gap, scale = param_gap(other[1], base[1])
        res[name] = {"loss_gap": abs(other[0] - base[0]),
                     "param_gap": gap, "param_scale": scale}
        log(f"training levers, {name} vs remat on, 1 microbatch: loss "
            f"{other[0]!r} vs {base[0]!r}, parameters max abs diff {gap!r} "
            f"(largest |parameter| {scale!r}; limit {tol!r} of it)")
        if not gap <= tol * scale or \
                not abs(other[0] - base[0]) <= tol * abs(base[0]):
            raise AssertionError(f"training levers, {name}: {res[name]}")
    del base, other
    torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(2)
    h = torch.randn((*CE_TOKENS, cfg.d_model), generator=g, device="cuda")
    labels = lm_batch(cfg, 2, *CE_TOKENS)["labels"]
    table = params["embed"]["table"]
    out = {}
    for fused in (True, False):
        hh, tt = (t.detach().clone().requires_grad_() for t in (h, table))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        loss = fused_cross_entropy(hh, tt, labels) if fused else \
            cross_entropy(unembed({"table": tt}, hh), labels)
        gh, gt = torch.autograd.grad(loss, [hh, tt])
        torch.cuda.synchronize()
        out[fused] = (float(loss.detach()), gh, gt,
                      torch.cuda.max_memory_allocated() - base_bytes)
        del hh, tt, loss
    (lf, ghf, gtf, pf), (ln, ghn, gtn, pn) = out[True], out[False]
    table_gap = float((gtf - gtn).abs().max()) / float(gtn.abs().max())
    h_gap = float((ghf - ghn).abs().max()) / float(ghn.abs().max())
    # float64 h gradient of the first CE_ROWS tokens: (softmax - onehot)
    # @ table / tokens, row by row
    x64 = h.reshape(-1, cfg.d_model)[:CE_ROWS].double()
    y64 = labels.reshape(-1)[:CE_ROWS].long()
    p64 = torch.softmax(x64 @ table.double().t(), dim=-1)
    p64[torch.arange(CE_ROWS, device="cuda"), y64] -= 1.0
    gh64 = (p64 @ table.double()) / labels.numel()
    scale64 = float(gh64.abs().max())
    h64 = {nm: float((g.reshape(-1, cfg.d_model)[:CE_ROWS].double()
                      - gh64).abs().max()) / scale64
           for nm, g in (("fused", ghf), ("naive", ghn))}
    del x64, p64, gh64
    res["fused_ce"] = {"loss": lf, "naive_loss": ln,
                       "loss_rel_gap": abs(lf - ln) / abs(ln),
                       "table_grad_gap": table_gap, "h_grad_gap": h_gap,
                       "h_grad_gap_float64": h64,
                       "peak_bytes": pf, "naive_peak_bytes": pn}
    log(f"fused cross entropy vs naive at {CE_TOKENS} tokens, V "
        f"{cfg.vocab_size}, float32 on {card}: loss {lf!r} vs {ln!r}; "
        f"table gradient within {table_gap!r} of its largest; h gradient "
        f"within {h_gap!r} of each other, and of a float64 one on "
        f"{CE_ROWS} rows fused {h64['fused']!r}, naive {h64['naive']!r}; "
        f"peak memory above the inputs {pf} B fused, {pn} B naive")
    if not (abs(lf - ln) <= CE_LOSS_RTOL * abs(ln)
            and table_gap <= CE_GRAD_TOL and max(h64.values()) <= CE_H_TOL
            and pf < pn):
        raise AssertionError(f"fused cross entropy: {res['fused_ce']}")
    del out, ghf, gtf, ghn, gtn, h, params
    torch.cuda.empty_cache()
    return res


def check_train_hybrid(card: str) -> dict:
    """(h) zamba2-2.7b at full width and HYBRID_LAYERS layers in bf16
    through ``make_train_step`` on the chunked route: AdamW, remat, the
    fused cross entropy, HYBRID_STEPS steps of HYBRID_BATCH x 4096
    tokens.  Every loss finite, the last below the first, no kernel
    launched, and every leaf of the shared block given a gradient (its
    AdamW first moment not all zero)."""
    cfg = get_config(HYBRID_ARCH).replace(num_layers=HYBRID_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tr.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    n = sum(t.numel() for t in tr.flat_params(params).values())
    opt = lm_train.init_opt(params, "adamw")
    step = lm_train.make_train_step(cfg, optimizer="adamw", lr=TRAIN_LR,
                                    remat=True, backend="chunked")
    data = lm_batch(cfg, 6, HYBRID_STEPS * HYBRID_BATCH, TRAIN_SEQ)
    losses, times = [], []
    torch.cuda.synchronize()
    zero_launches()
    for i in range(HYBRID_STEPS):
        rows = slice(i * HYBRID_BATCH, (i + 1) * HYBRID_BATCH)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, {k: v[rows]
                                               for k, v in data.items()})
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    label = (f"training {HYBRID_ARCH} at {HYBRID_LAYERS} layers (chunked "
             "route)")
    expect_launches(label, {})
    no_grad = [k for k, m in opt["m"].items()
               if k.startswith("shared.") and not bool((m != 0).any())]
    shared = [k for k in opt["m"] if k.startswith("shared.")]
    res = {"arch": HYBRID_ARCH, "layers": HYBRID_LAYERS, "parameters": n,
           "losses": losses, "step_s_all": times,
           "step_s": float(np.median(times[1:])),
           "tokens_per_s": HYBRID_BATCH * TRAIN_SEQ
           / float(np.median(times[1:])),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "shared_leaves": len(shared)}
    log(f"{label} on {card}: {n} parameters, losses {losses}, step "
        f"{res['step_s']!r} s (median of steps 2-{HYBRID_STEPS}), "
        f"{res['tokens_per_s']!r} tokens/s, peak {res['peak_bytes']} B; "
        f"{len(shared)} shared-block leaves, without a gradient: {no_grad}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0] or no_grad or not shared:
        raise AssertionError(f"{label}: {res}, no gradient: {no_grad}")
    del params, opt, data
    torch.cuda.empty_cache()
    return res


def check_train_repair() -> None:
    """(c) A train step on ``backend="kernel"`` raises at its first step
    (the kernels are forward-only), with no kernel launched."""
    cfg = get_config(TRAIN_ARCH, smoke=True)
    params = tr.init_params(torch.Generator(device="cuda").manual_seed(3),
                            cfg)
    step = lm_train.make_train_step(cfg, backend="kernel")
    zero_launches()
    try:
        step(params, lm_train.init_opt(params), lm_batch(cfg, 3, 4, 64))
    except RuntimeError as e:
        if "forward-only" not in str(e):
            raise
        log(f"training on the kernel route raises: {e}")
    else:
        raise AssertionError("a train step on the kernel route ran")
    torch.cuda.synchronize()
    expect_launches("training on the kernel route", {})
    expect_variants("training on the kernel route", cfg, {})


def to_device(params, device):
    return tr.nested_params({k: t.to(device) for k, t in
                             tr.flat_params(params).items()})


def check_train_card_vs_cpu() -> dict:
    """(d) Smoke size, float32: one SGD and one AdamW step on the card
    against the same step on the CPU (the path the CPU tests hold to the
    JAX package), loss and parameters within CARD_CPU_TOL; then the
    qwen supernet's 3 SGD steps with a key each; then one SGD step of
    internvl2-1b and of whisper-large-v3, each with its prefix."""
    res = {}
    base = get_config(TRAIN_ARCH, smoke=True)
    for label, cfg, optimizer, keys in (
            ("sgd", base, "sgd", None), ("adamw", base, "adamw", None),
            ("supernet sgd", base.replace(supernet=True), "sgd",
             TRAIN_KEYS),
            ("internvl2-1b sgd", get_config("internvl2-1b", smoke=True),
             "sgd", None),
            ("whisper-large-v3 sgd",
             get_config("whisper-large-v3", smoke=True), "sgd", None)):
        params = {"cpu": tr.init_params(torch.Generator().manual_seed(4),
                                        cfg)}
        params["cuda"] = to_device(params["cpu"], "cuda")
        step = lm_train.make_train_step(cfg, optimizer=optimizer,
                                        lr=CARD_CPU_LR[optimizer])
        opt = {d: lm_train.init_opt(p, optimizer) for d, p in params.items()}
        worst = (0.0, 0.0)
        for i, key in enumerate(keys or [None]):
            losses = {}
            for dev in params:
                batch = lm_batch(cfg, 5 + i, 4, 32, params[dev]["embed"][
                    "table"].device)
                if key is not None:
                    batch["choice_key"] = key
                params[dev], opt[dev], loss = step(params[dev], opt[dev],
                                                   batch)
                losses[dev] = float(loss)
            flat = {d: tr.flat_params(p) for d, p in params.items()}
            gaps = torch.cat([(flat["cuda"][k].cpu() - flat["cpu"][k])
                              .abs().ravel() for k in flat["cpu"]])
            gap = float(gaps.max())
            loss_gap = abs(losses["cuda"] - losses["cpu"])
            worst = (max(worst[0], loss_gap), max(worst[1], gap))
            log(f"training {label} step {i}, smoke size, card vs CPU: loss "
                f"{losses['cuda']!r} vs {losses['cpu']!r}, parameters max "
                f"abs diff {gap!r} ({int((gaps > CARD_CPU_TOL).sum())} of "
                f"{gaps.numel()} entries past {CARD_CPU_TOL})")
        res[label] = {"loss_gap": worst[0], "param_gap": worst[1]}
        if optimizer == "adamw":
            noisy = float((gaps > CARD_CPU_TOL).float().mean())
            moments = max(
                float((opt["cuda"][m][k].cpu() - opt["cpu"][m][k]).abs()
                      .max()) / max(float(opt["cpu"][m][k].abs().max()),
                                    1e-30)
                for m in ("m", "v") for k in opt["cpu"][m])
            res[label].update(noisy_share=noisy, moment_gap=moments)
            ok = (loss_gap <= CARD_CPU_TOL and noisy <= ADAMW_NOISY
                  and gap <= 2 * CARD_CPU_LR["adamw"]
                  and moments <= CARD_CPU_TOL)
        else:
            ok = max(worst) <= CARD_CPU_TOL
        if not ok:
            raise AssertionError(f"training {label}, card vs CPU: "
                                 f"{res[label]}")
    return res


def check_train_clis(card: str) -> None:
    """(e) ``python -m repro_torch.launch.train`` and the train_lm example
    (plain and ``--supernet``) at their defaults on the card, in this
    process; no kernel launched."""
    for label, run in (("launch.train", lambda: lm_train.main([])),
                       ("examples.train_lm", lambda: train_lm.main([])),
                       ("examples.train_lm --supernet",
                        lambda: train_lm.main(["--supernet"]))):
        zero_launches()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        expect_launches(label, {})
        log(f"{label}: {time.perf_counter() - t0!r} s on {card}")


# ---------------------------------------------------------------------------
# phase 15: the mesh
# ---------------------------------------------------------------------------

MESH_WAYS = 3           # (b): a mesh that names cuda:0 this many times
MESH_BF16_SMOKE = "qwen1.5-0.5b"
# (label, run config, phase 11's run it equals bit for bit).  The mesh's
# kernel route is one train_uploads call per shape bucket whether fused
# or not (the JAX package tests the route before ``fused``), so its
# non-fused run equals its fused one; on the torch route a non-fused
# run is one fill_partial call per bucket: with one bucket, the fused
# run's bodies in its order
MESH_RUNS = (
    ("mesh fused, kernel route", dict(aggregate_backend="kernel"), "kernel"),
    ("mesh fused, torch route", dict(aggregate_backend="torch"), "torch"),
    ("mesh fused, kernel route, int8 uplink",
     dict(uplink_codec="int8:kernel"), "int8"),
    ("mesh non-fused, kernel route",
     dict(aggregate_backend="kernel", fused=False), "kernel"),
    ("mesh non-fused, torch route",
     dict(aggregate_backend="torch", fused=False), "torch"),
)


def innermost_backend(eng):
    backend = eng.backend
    while hasattr(backend, "inner"):
        backend = backend.inner
    return backend


def held_to(ref: dict, result, eng, label: str) -> None:
    """``result`` (launch counts read just after its run) against a
    ``reference``: keys and CommStats equal, masters bit for bit,
    dispatches, launches and K1's variants equal."""
    same_trajectory(ref["result"], result, f"{label} vs vmap", 0.0)
    bitwise_master(ref["result"].extras["final_master"],
                   result.extras["final_master"], label)
    for what, got, want in (
            ("dispatches", innermost_backend(eng).dispatches,
             ref["dispatches"]),
            ("launches", dict(ops.LAUNCHES), ref["launches"]),
            ("fill_aggregate variants", dict(kfa.VARIANT_LAUNCHES),
             ref["variants"])):
        if got != want:
            raise AssertionError(f"{label}: {what} {got}, vmap's {want}")


def check_mesh_runs(api, clients, vmap_refs: dict, card: str) -> dict:
    """(a) ``backend="mesh"`` on ``make_host_mesh()``, one device
    (cuda:0), against phase 11's fused ``vmap`` runs bit for bit; (b)
    the kernel route on a mesh that names cuda:0 MESH_WAYS times
    (population 4 padded to 6): keys and CommStats equal to (a)'s, and
    one generation-1 ``train_fill`` on the torch route (where the sum
    order changes) within TOL of ``vmap``'s; (c) (a)'s fused kernel route again with telemetry on, bit
    for bit, with the JAX mesh's program names.  Returns the numbers for
    the JSON line."""
    mesh = make_host_mesh()
    if mesh.size != 1 or mesh.axis_devices("data") != [
            torch.device("cuda:0")]:
        raise AssertionError(f"make_host_mesh() on one card: {mesh}")
    out = {"round_s": {}, "peak": {}}
    for ref_key, ref in vmap_refs.items():
        label = f"vmap fused ({ref_key}, phase 11)"
        out["round_s"][label] = ref["result"].reports[-1].round_s
        out["peak"][label] = ref["peak"]
    mesh_ref = None
    for label, kw, ref_key in MESH_RUNS:
        result, eng, peak = timed_run(api, clients, label,
                                      dict(RUN, backend="mesh", **kw))
        backend = innermost_backend(eng)
        if not isinstance(backend, MeshBackend) or backend.num_devices != 1:
            raise AssertionError(f"{label}: backend {backend}")
        held_to(vmap_refs[ref_key], result, eng, label)
        log(f"{label}: bit for bit phase 11's fused vmap run ({ref_key}); "
            f"dispatches {backend.dispatches}, launches {dict(ops.LAUNCHES)}"
            f", K1 by variant {dict(kfa.VARIANT_LAUNCHES)}; generation 2 "
            f"round_s {result.reports[-1].round_s!r} s (vmap "
            f"{vmap_refs[ref_key]['result'].reports[-1].round_s!r}), peak "
            f"{peak} B (vmap {vmap_refs[ref_key]['peak']}) on {card}")
        out["round_s"][label] = result.reports[-1].round_s
        out["peak"][label] = peak
        if mesh_ref is None:
            mesh_ref = reference(result, eng)
        del result, eng

    # (b) MESH_WAYS devices, all cuda:0
    label = f"mesh fused, kernel route, {MESH_WAYS}-way on cuda:0"
    cfg = RunConfig(**dict(RUN, backend="mesh", aggregate_backend="kernel"))
    ways = make_host_mesh(["cuda:0"] * MESH_WAYS)
    torch.cuda.reset_peak_memory_stats()
    eng = FedEngine(api, clients, cfg,
                    backend=MeshBackend(api, clients, cfg, mesh=ways))
    zero_launches()
    result = eng.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check_run(result, label)
    n_fill = RUN["generations"] + 1
    expect_launches(label, {"fill_aggregate": n_fill})
    expect_fill_variants(label, n_fill, 0)
    if eng.backend.dispatches != mesh_ref["dispatches"]:
        raise AssertionError(f"{label}: {eng.backend.dispatches} dispatches")
    gap = same_trajectory(mesh_ref["result"], result, f"{label} vs 1-way",
                          None)
    out["round_s"][label] = result.reports[-1].round_s
    out["peak"][label] = peak
    out["ways_master_gap"] = gap
    log(f"{label}: generation 2 round_s {result.reports[-1].round_s!r} s, "
        f"peak {peak} B on {card}")
    del result, eng
    out["ways_one_fill"] = check_one_fill_mesh(api, clients, ways, "torch")

    # (c) telemetry on = off on (a)'s fused kernel route
    label = "mesh fused, kernel route, telemetry on"
    counts = {"train_uploads": 1, "fused_eval_shared": 1}
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = Path(tmp) / "mesh.jsonl"
        result, eng, _ = telemetry_twin(
            api, clients, label, dict(RUN, backend="mesh",
                                      aggregate_backend="kernel"),
            {"sink": f"jsonl:{jsonl}"}, mesh_ref)
        eng.telemetry.sink.close()
        lines = jsonl.read_text().splitlines()
    tel = result.telemetry
    recompiles = [e.recompiles for e in tel.events]
    seen = {p for e in tel.events for p in e.spans}
    missing = [p for p in ("fill_train/download", "eval/host_fetch")
               if p not in seen]
    if (tel.trace_counts != counts
            or recompiles != [counts] + [{}] * (RUN["generations"] - 1)
            or missing or len(lines) != RUN["generations"]):
        raise AssertionError(f"{label}: trace_counts {tel.trace_counts}, "
                             f"recompiles {recompiles}, missing spans "
                             f"{missing}, {len(lines)} jsonl lines")
    log(f"{label}: bit for bit the run off; trace_counts "
        f"{tel.trace_counts}; spans {sorted(seen)}")
    out["telemetry_trace_counts"] = tel.trace_counts
    del result, eng
    out["turns"] = mesh_turns(api, clients, card)
    return out


def mesh_turns(api, clients, card: str) -> dict:
    """Fused kernel-route runs of ``vmap`` and ``mesh`` in turns (vmap,
    mesh, mesh, vmap), each with nothing of an earlier run alive:
    generation 2's ``round_s`` and the peak memory above what the card
    held before the run (the runs of (a) are compared with phase 11's,
    which ran while other references were alive)."""
    out = {}
    for backend in ("vmap", "mesh", "mesh", "vmap"):
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        result, eng, peak = timed_run(
            api, clients, f"{backend} fused, kernel route, in turns",
            dict(RUN, backend=backend, aggregate_backend="kernel"))
        row = out.setdefault(backend, {"round_s": [], "peak_above": []})
        row["round_s"].append(result.reports[-1].round_s)
        row["peak_above"].append(peak - before)
        del result, eng
    for backend, row in out.items():
        log(f"{backend} fused, kernel route, in turns on {card}: generation "
            f"2 round_s {row['round_s']!r} s, peak above the held memory "
            f"{row['peak_above']} B")
    return out


def check_one_fill_mesh(api, clients, mesh, route: str) -> float:
    """One ``train_fill`` at full width from the strategies' init, four
    groups of two clients, on ``mesh`` against ``VmapBackend`` on the
    same route within TOL: the uploads are the same, only the float32
    sums of Algorithm 3 are grouped otherwise (per device, then across
    devices; K1 with weight-0 rows)."""
    master = {k: v.cuda() for k, v in
              api.init(torch.Generator().manual_seed(0)).items()}
    rng = np.random.default_rng(1)
    keys = [rng.integers(0, 4, api.num_blocks) for _ in range(4)]
    groups = [np.arange(2 * g, 2 * g + 2) for g in range(4)]
    cfg = RunConfig(**dict(RUN, backend="mesh", aggregate_backend=route))
    want = VmapBackend(api, clients, cfg).train_fill(master, keys, groups,
                                                     0.01)
    got = MeshBackend(api, clients, cfg, mesh=mesh).train_fill(
        master, keys, groups, 0.01)
    torch.cuda.synchronize()
    diff = master_diff(want, got)
    log(f"one train_fill on a {mesh.size}-way mesh, {route} route, against "
        f"vmap's: master max abs diff {diff!r}")
    if not diff <= TOL:
        raise AssertionError(f"{mesh.size}-way mesh, {route} route: one "
                             f"train_fill differs from vmap's by {diff}")
    del master, want, got
    torch.cuda.empty_cache()
    return diff


def under_mesh(mesh, fn):
    """``fn()`` with ``mesh`` registered for the models, reset after."""
    policy.set_mesh(mesh)
    try:
        return fn()
    finally:
        policy.set_mesh(None)


def check_mesh_models(card: str) -> dict:
    """(d) Under ``policy.set_mesh(make_host_mesh())``: granite's prefill
    of 4 x 1024 tokens at full width on the kernel route, bf16 and
    float32, takes the expert-parallel MoE (24 K3, no K5: its products
    are einsums) within MESH_PREFILL_TOL of the same prefill with no
    mesh (24 K3 and 72 K5); qwen's ``greedy_generate`` at smoke size in float32 gives
    the no-mesh tokens, and at full width in bf16 (the pinned decode's
    probabilities in bf16) its decode step time and token agreement are
    logged."""
    mesh = make_host_mesh()
    arch = "granite-moe-1b-a400m"
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = get_config(arch).replace(dtype=dtype)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = tr.init_params(gen, cfg)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (REQUESTS, 1024),
                                         generator=gen, device="cuda")}
        step = make_prefill_step(cfg, backend="kernel")
        label = f"{arch} prefill, {dtype}"
        zero_launches()
        plain = step(params, batch)
        torch.cuda.synchronize()
        expect_launches(f"{label}, no mesh", {"flash_attention": 24,
                                              "expert_gemm": 72})
        zero_launches()
        meshed = under_mesh(mesh, lambda: step(params, batch))
        torch.cuda.synchronize()
        expect_launches(f"{label}, under the mesh", {"flash_attention": 24})
        expect_variants(f"{label}, under the mesh", cfg,
                        {"flash_attention": 24})
        if not torch.isfinite(meshed).all():
            raise AssertionError(f"{label}: non-finite logits under the mesh")
        scale = float(plain.float().abs().max())
        diff = float((meshed.float() - plain.float()).abs().max())
        agree = float((meshed.argmax(-1) == plain.argmax(-1)).float().mean())
        # in turns (none, mesh, mesh, none), each the median of 3: the
        # prefill waits on the host, whose speed drifts
        ms = {"no mesh": [], "mesh": []}
        for name in ("no mesh", "mesh", "mesh", "no mesh"):
            ms[name].append(under_mesh(
                mesh if name == "mesh" else None,
                lambda: median_ms(lambda: step(params, batch), 3, warmup=1)))
        log(f"{label}: under the mesh vs none, last-token logits max abs "
            f"diff {diff!r} ({diff / scale!r} of the largest; argmax "
            f"agreement {agree!r}); prefill in turns {ms['mesh']!r} ms "
            f"under the mesh (einsums), {ms['no mesh']!r} ms without (K5) "
            f"on {card}")
        tol = MESH_PREFILL_TOL[cfg.torch_dtype]
        if not diff <= tol * scale:
            raise AssertionError(f"{label}: mesh vs none {diff} > "
                                 f"{tol} x {scale}")
        out[f"granite_{dtype}"] = {"rel_diff": diff / scale, "ms": ms}
        del params, plain, meshed
        torch.cuda.empty_cache()

    arch = MESH_BF16_SMOKE
    for dtype, smoke in (("float32", True), ("bfloat16", False)):
        cfg = get_config(arch, smoke=smoke).replace(dtype=dtype)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = tr.init_params(gen, cfg)
        prompt = torch.randint(0, cfg.vocab_size, (REQUESTS, GREEDY_PROMPT),
                               generator=gen, device="cuda")
        toks, secs = {}, {}
        for name, m in (("no mesh", None), ("mesh", mesh)):
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks[name] = under_mesh(m, lambda: greedy_generate(
                params, cfg, prompt, NEW_TOKENS))
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            expect_launches(f"{arch} greedy_generate, {dtype}, {name}", {})
        steps = GREEDY_PROMPT - 1 + NEW_TOKENS
        agree = float((toks["mesh"] == toks["no mesh"]).float().mean())
        size = "smoke size" if smoke else "full width"
        log(f"{arch} greedy_generate at {size}, {dtype}: token agreement "
            f"mesh vs none {agree!r}; {steps} decode steps in "
            f"{secs['mesh']!r} s under the mesh "
            f"({secs['mesh'] / steps * 1e3!r} ms a step), "
            f"{secs['no mesh']!r} s without on {card}")
        if dtype == "float32" and not torch.equal(toks["mesh"],
                                                  toks["no mesh"]):
            raise AssertionError(f"{arch} greedy_generate, float32: the "
                                 "mesh changed the tokens")
        out[f"{arch}_{dtype}"] = {"agreement": agree,
                                  "step_ms": {k: v / steps * 1e3
                                              for k, v in secs.items()}}
        del params
        torch.cuda.empty_cache()
    return out


def check_mesh_examples(card: str) -> dict:
    """(e) The serve_batched example at its defaults (smoke config, on
    the card; decode launches nothing), and federated_nas_cifar at its
    default size on ``--engine-backend mesh`` (one K1 launch a
    train_fill, each in place: 6 in 5 generations)."""
    out = {}
    zero_launches()
    t0 = time.perf_counter()
    toks = serve_batched.main([])
    torch.cuda.synchronize()
    out["serve_batched_s"] = time.perf_counter() - t0
    expect_launches("example serve_batched", {})
    if toks.shape != (4, 32 + 24):
        raise AssertionError(f"serve_batched: tokens {tuple(toks.shape)}")
    with tempfile.TemporaryDirectory() as tmp:
        zero_launches()
        t0 = time.perf_counter()
        federated_nas_cifar.main(["--out", tmp, "--engine-backend", "mesh"])
        torch.cuda.synchronize()
        out["federated_nas_cifar_mesh_s"] = time.perf_counter() - t0
    expect_launches("example federated_nas_cifar, mesh",
                    {"fill_aggregate": 6})
    expect_fill_variants("example federated_nas_cifar, mesh", 6, 0)
    log(f"examples on {card}: serve_batched {out['serve_batched_s']!r} s, "
        f"federated_nas_cifar on the mesh "
        f"{out['federated_nas_cifar_mesh_s']!r} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: the dry run
# ---------------------------------------------------------------------------

DRYRUN_JOBS = 7          # worker processes of (a), one thread each
DRYRUN_TIMEOUT = 600     # seconds (a) may take
# (b): each estimate as (label, arch, shape, optimizer, microbatch, peak
# limit, timed steps): qwen's training step at phase 14's setting, and
# the 4 x 1024 bf16 torch-route prefills of qwen and granite (the MoE)
DRYRUN_ESTIMATES = (
    ("qwen1.5-0.5b training step", TRAIN_ARCH,
     InputShape("train_4x4096", "train", TRAIN_SEQ, TRAIN_BATCH), "adamw",
     TRAIN_MICRO, 0.05, 3),
    ("qwen1.5-0.5b prefill", "qwen1.5-0.5b",
     InputShape("prefill_4x1024", "prefill", 1024, REQUESTS), "sgd", 1,
     0.10, 5),
    ("granite-moe-1b-a400m prefill", "granite-moe-1b-a400m",
     InputShape("prefill_4x1024", "prefill", 1024, REQUESTS), "sgd", 1,
     0.10, 5),
)
ARGS_TOL = 1e-3          # arguments against memory_allocated, relative
# (c): the kernel route on meta, at phase 10's prompts
DRYRUN_KERNEL_ARCHS = ("qwen1.5-0.5b", "mamba2-780m", "granite-moe-1b-a400m")


def run_dryrun_matrix(out_dir: str) -> float:
    """``python -m repro_torch.launch.dryrun --arch all --shape all`` on
    the 16 x 16 mesh, torch route, in DRYRUN_JOBS worker processes, its
    records saved under ``out_dir``; returns its seconds.  The command
    runs in a session of its own, killed whole past DRYRUN_TIMEOUT."""
    import os
    import signal
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "all", "--shape", "all", "--jobs", str(DRYRUN_JOBS), "--save",
           "--out", out_dir]
    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    seconds = time.perf_counter() - t0
    for line in text.splitlines():
        log(f"  dryrun: {line}")
    if proc.returncode:
        raise AssertionError(f"dry run matrix exited {proc.returncode}")
    return seconds


def check_dryrun_matrix() -> dict:
    """(a) Every arch but the CIFAR supernet x every shape on the 16 x 16
    mesh: every record made, every number finite, and its
    ``argument_size_in_bytes`` (the counter's held storage, each weighted
    by its share) equal to the per-device sum of the specs
    (``dryrun.argument_bytes_from_specs``)."""
    archs = [a for a in ARCH_ALIASES if a != "cifar-supernet"]
    with tempfile.TemporaryDirectory() as out:
        seconds = run_dryrun_matrix(out)
        recs = [json.loads(p.read_text())
                for p in sorted(Path(out).glob("*.json"))]
    got = {(r["arch"], r["shape"]) for r in recs}
    want = {(a, s) for a in archs for s in SHAPES}
    if got != want or len(recs) != len(want):
        raise AssertionError(f"dry run records: missing {want - got}, "
                             f"extra {got - want}")
    mesh = make_production_mesh()
    rows = []
    for r in recs:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        if bad or r["mesh"] != "16x16":
            raise AssertionError(f"{r['arch']} x {r['shape']}: not finite "
                                 f"{bad}, mesh {r['mesh']}")
        specs_sum = dryrun.argument_bytes_from_specs(
            get_config(r["arch"]), get_shape(r["shape"]), mesh)
        if r["argument_size_in_bytes"] != specs_sum:
            raise AssertionError(f"{r['arch']} x {r['shape']}: arguments "
                                 f"{r['argument_size_in_bytes']} B, specs "
                                 f"{specs_sum} B")
        rows.append({k: r[k] for k in (
            "arch", "shape", "argument_size_in_bytes", "peak_bytes", "fits",
            "flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev",
            "compute_s", "memory_s", "collective_s", "dominant",
            "useful_flops_ratio", "compile_s")})
    log(f"dry run matrix: {len(recs)} records on 16x16, every one finite, "
        f"arguments the specs' sum, in {seconds!r} s "
        f"({sum(r['compile_s'] for r in recs)!r} s of meta runs)")
    return {"seconds": seconds, "records": rows}


def card_args(cfg, shape: InputShape, optimizer: str,
              device: str = "cuda") -> tuple:
    """The step's arguments on ``device`` as ``dryrun.step_args`` lays
    them out: params from a seeded generator, the optimizer state, and
    ``make_lm_stream`` tokens (and labels), int32."""
    params = tr.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg)
    x, y = make_lm_stream(0, shape.global_batch, shape.seq_len,
                          cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(x).to(device)}
    if shape.kind == "train":
        batch["labels"] = torch.from_numpy(y).to(device)
        return params, lm_train.init_opt(params, optimizer), batch
    return params, batch


@contextlib.contextmanager
def blocks_split_to_512():
    """The caching allocator with expandable segments, under which it
    splits a free block whenever 512 B or more would remain, so that
    ``memory_allocated`` grows by a tensor's bytes rounded to 512.  By
    default it hands a tensor of over 1 MB the whole block when no more
    than 1 MB would remain (``default_allocator_args`` logs what that
    adds).  The cache is emptied on the way in and out."""
    settings = getattr(torch._C, "_accelerator_setAllocatorSettings",
                       None) or torch.cuda.memory._set_allocator_settings
    gc.collect()
    torch.cuda.empty_cache()
    settings("expandable_segments:True")
    try:
        yield
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        settings("expandable_segments:False")


def default_allocator_args() -> dict:
    """The arguments of each (b) estimate placed on the card under the
    default allocator: what ``memory_allocated`` grew by, beside the
    tensors' bytes (logged; no limit)."""
    out = {}
    for label, arch, shape, optimizer, *_ in DRYRUN_ESTIMATES:
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        args = card_args(cfg, shape, optimizer)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - base
        seen = {}
        for t in tensor_leaves(args):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        tensors = sum(seen.values())
        log(f"dry run, default allocator, {label}: memory_allocated grew "
            f"by {grown} B for {len(seen)} tensors of {tensors} B "
            f"({grown - tensors:+d} B)")
        out[label] = {"allocated": grown, "tensors": tensors,
                      "count": len(seen)}
        del args
    torch.cuda.empty_cache()
    return out


def check_dryrun_estimate(label, arch, shape, optimizer, microbatch,
                          peak_tol, reps, card, phase14=None) -> dict:
    """(b) One estimate on a (1, 1) host mesh of cuda:0 against the same
    step on the card: the arguments within ARGS_TOL of what
    ``memory_allocated`` grew by once they are placed; the peak within
    ``peak_tol`` of ``max_memory_allocated`` over ``reps`` steps (above
    what the card held before; run it under ``blocks_split_to_512``); the meta FLOPs equal to
    ``FlopCounterMode``'s over the real step; ``compute_s`` and
    ``memory_s`` no larger than the measured step (median of ``reps``)."""
    from torch.utils.flop_counter import FlopCounterMode
    rec = dryrun.dry_run(arch, shape, mesh=make_host_mesh(["cuda:0"]),
                         optimizer=optimizer, microbatch=microbatch,
                         verbose=False)
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = card_args(cfg, shape, optimizer)
    torch.cuda.synchronize()
    args_bytes = torch.cuda.memory_allocated() - base
    call = dryrun.build_step(cfg, shape, microbatch=microbatch,
                             optimizer=optimizer)
    zero_launches()
    with FlopCounterMode(display=False) as fc:
        out = call(args)
    torch.cuda.synchronize()
    del out
    card_flops = fc.get_total_flops()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = call(args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    peak = torch.cuda.max_memory_allocated() - base
    expect_launches(f"dry run estimate {label}", {})
    step_s = float(np.median(times))
    res = {"arch": arch, "shape": dataclasses.asdict(shape),
           "optimizer": optimizer, "microbatch": microbatch,
           "meta_s": rec["compile_s"],
           "arguments": rec["argument_size_in_bytes"],
           "arguments_card": args_bytes,
           "peak_bytes": rec["peak_bytes"], "peak_card": peak,
           "flops": rec["flops_per_dev"], "flops_card": card_flops,
           "bytes": rec["bytes_per_dev"], "compute_s": rec["compute_s"],
           "memory_s": rec["memory_s"], "step_s": step_s,
           "step_s_all": times}
    log(f"dry run estimate {label} on {card}: arguments {res['arguments']} "
        f"B (card {args_bytes} B); peak {res['peak_bytes']} B (card {peak} "
        f"B, {res['peak_bytes'] / peak - 1:+.4%}); FLOPs {res['flops']!r} "
        f"(card {card_flops}); bytes {res['bytes']!r}; compute_s "
        f"{res['compute_s']!r}, memory_s {res['memory_s']!r} against the "
        f"step's {step_s!r} s ({times}); meta run {res['meta_s']!r} s")
    if phase14 is not None:
        log(f"  phase 14's run of the same step: peak "
            f"{phase14['peak_bytes']} B ({res['peak_bytes'] / phase14['peak_bytes'] - 1:+.4%} "
            f"from the estimate), step {phase14['step_s']!r} s")
        res["phase14"] = {k: phase14[k] for k in ("peak_bytes", "step_s")}
    if abs(args_bytes - res["arguments"]) > ARGS_TOL * args_bytes:
        raise AssertionError(f"{label}: arguments {res['arguments']} B, "
                             f"card {args_bytes} B")
    if abs(res["peak_bytes"] - peak) > peak_tol * peak:
        raise AssertionError(f"{label}: peak {res['peak_bytes']} B, card "
                             f"{peak} B, beyond {peak_tol:.0%}")
    if int(res["flops"]) != card_flops:
        raise AssertionError(f"{label}: FLOPs {res['flops']!r}, card "
                             f"{card_flops}")
    if res["compute_s"] > step_s or res["memory_s"] > step_s:
        raise AssertionError(f"{label}: a roofline term above the step: "
                             f"compute {res['compute_s']!r} s, memory "
                             f"{res['memory_s']!r} s, step {step_s!r} s")
    del args
    torch.cuda.empty_cache()
    return res


def check_dryrun_kernel_route(serve_launches: dict) -> dict:
    """(c) The kernel route on meta (a (1, 1) abstract mesh) for qwen's,
    mamba2's and granite's phase-10 prefills: the counted K3, K4 and K5
    launches equal phase 10's of one prefill."""
    one = Mesh((1, 1), ("data", "model"))
    out = {}
    for arch in DRYRUN_KERNEL_ARCHS:
        shape = InputShape(f"prefill_4x{SERVE[arch]['prompt']}", "prefill",
                           SERVE[arch]["prompt"], REQUESTS)
        rec = dryrun.dry_run(arch, shape, mesh=one, backend="kernel",
                             verbose=False)
        want = {k: n for k, n in serve_launches[arch].items() if n}
        log(f"dry run, kernel route, {arch} prefill of 4 x "
            f"{shape.seq_len}: launches {rec['launches']} (phase 10: "
            f"{want}), FLOPs {rec['flops_per_dev']!r}, bytes "
            f"{rec['bytes_per_dev']!r}, compute_s {rec['compute_s']!r}, "
            f"memory_s {rec['memory_s']!r}")
        if rec["launches"] != want:
            raise AssertionError(f"{arch}: meta launches {rec['launches']}, "
                                 f"phase 10 {want}")
        out[arch] = {k: rec[k] for k in ("launches", "flops_per_dev",
                                         "bytes_per_dev", "compute_s",
                                         "memory_s", "peak_bytes")}
    return out


def main() -> int:
    t_start = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    # 2. build
    t0 = time.perf_counter()
    logs = build.build(["fill_aggregate", "quantize_int8", "flash_attention",
                        "ssd_scan", "expert_gemm"])
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    tc_resources = tensor_core_resources()
    gemm_resources = expert_gemm_resources()
    f32_resources = fp32_resources()
    ssd_stage_resources = ssd_resources()

    # 3. each kernel against its plain version (these launches don't count)
    cfg = get_config("cifar-supernet")
    api = cnn_supernet_api(cfg)
    if api.master_params() != MAIN_P:
        raise AssertionError(f"master has {api.master_params()} params")
    max_err, inplace_err = check_fill_aggregate()
    err_q, err_d = check_int8()
    err_tree = check_int8_tree(api)

    # 4. timing
    timing, inplace_timing = time_fill_aggregate(card)
    int8_timing = time_int8(card, LEAF_P)
    time_int8(card, MAIN_P)
    tree_timing = time_tree(card, api)

    # 5. the main path, kernel route, at full width
    clients = full_width_clients()
    torch.cuda.reset_peak_memory_stats()
    main_eng = FedEngine(api, clients, RunConfig(aggregate_backend="kernel",
                                                 **RUN))
    zero_launches()
    kernel_run = main_eng.run()
    torch.cuda.synchronize()
    # 2 train_fill in generation 1, then 1 per generation
    n_fill = RUN["generations"] + 1
    launches = expect_launches("main path", {"fill_aggregate": n_fill})
    expect_fill_variants("main path", 0, n_fill)
    # phase 12 holds its telemetry runs to these (masters on the host)
    refs = {"loop": reference(kernel_run, main_eng)}
    del main_eng
    check_run(kernel_run, "main path")
    for r in kernel_run.reports:
        log(f"main path generation {r.gen}: round_s {r.round_s!r}, best_err "
            f"{r.best_err!r}, parents {[k.tolist() for k in r.parent_keys]}")
    main_peak = torch.cuda.max_memory_allocated()
    log(f"main path peak device memory: {main_peak} B")

    # 6. the plain route, and the card against the CPU at smoke size
    torch_run = FedEngine(api, clients, RunConfig(
        aggregate_backend="torch", **RUN)).run()
    check_run(torch_run, "torch route")
    for r in torch_run.reports:
        log(f"torch route generation {r.gen}: round_s {r.round_s!r}")
    same_trajectory(kernel_run, torch_run, "kernel vs torch route",
                    MASTER_TOL)
    del torch_run
    smoke = cnn_supernet_api(get_config("cifar-supernet", smoke=True))
    x, y = make_classification(0, 480, image=8, signal=1.5, noise=0.5)
    small = make_clients(x, y, partition_iid(0, 480, 8), batch=20,
                         test_batch=20)
    gpu = FedEngine(smoke, small, RunConfig(aggregate_backend="kernel",
                                            **RUN)).run()
    cpu = FedEngine(smoke, small, RunConfig(
        aggregate_backend="torch", **dict(RUN, device="cpu"))).run()
    same_trajectory(gpu, cpu, "smoke size, card vs CPU", MASTER_TOL)

    # 7. the codec path: int8 both ways, kernel route, then torch route.
    # Roundtrips: the downlink before every train_fill and eval_shared,
    # the uplink after every train_fill; one launch of the scale pass, K2a
    # and K2b per roundtrip (the master is one chunk)
    roundtrips = 2 * n_fill + RUN["generations"]
    codec_runs = {}
    for route in ("kernel", "torch"):
        spec = f"int8:{route}"
        torch.cuda.reset_peak_memory_stats()
        eng = FedEngine(api, clients, RunConfig(
            uplink_codec=spec, downlink_codec=spec, **RUN))
        zero_launches()
        run = eng.run()
        torch.cuda.synchronize()
        n_int8 = roundtrips * N_CHUNKS if route == "kernel" else 0
        got = expect_launches(f"codec path {spec}", {
            "fill_aggregate": n_fill, "int8_scale": n_int8,
            "quantize_int8": n_int8, "dequantize_int8": n_int8})
        if route == "kernel":
            refs["int8"] = reference(run, eng)
        del eng
        check_run(run, f"codec path {spec}")
        st = run.stats
        if not (st.up_wire_bytes < st.up_bytes
                and st.down_wire_bytes < st.down_bytes):
            raise AssertionError(f"codec path {spec}: wire bytes not below "
                                 f"logical bytes: {st}")
        for r in run.reports:
            log(f"codec path {spec} generation {r.gen}: round_s "
                f"{r.round_s!r}, best_err {r.best_err!r}")
        log(f"codec path {spec}: wire bytes {st.down_wire_bytes!r} down, "
            f"{st.up_wire_bytes!r} up (logical {st.down_bytes!r}, "
            f"{st.up_bytes!r}); peak device memory "
            f"{torch.cuda.max_memory_allocated()} B")
        codec_runs[route] = (run, got)
    same_trajectory(codec_runs["kernel"][0], codec_runs["torch"][0],
                    "codec path, int8 kernel vs torch route", MASTER_TOL)
    codec_launches = codec_runs["kernel"][1]
    del codec_runs

    # 8. the baselines at full width, int8 uplink on the kernels; the
    # downlink stays fp32, so one roundtrip per FedAvg aggregate
    up = dict(RUN, uplink_codec="int8:kernel")
    rounds = up["generations"]
    zero_launches()
    fedavg = FedEngine(api, clients, RunConfig(**up),
                       strategy=FedAvgBaseline(np.ones(12))).run()
    torch.cuda.synchronize()
    n_int8 = rounds * N_CHUNKS
    expect_launches("FedAvgBaseline", {
        "fill_aggregate": 0, "int8_scale": n_int8, "quantize_int8": n_int8,
        "dequantize_int8": n_int8})
    check_run(fedavg, "FedAvgBaseline")
    log(f"FedAvgBaseline errors {[r.best_err for r in fedavg.reports]}, "
        f"round_s {[r.round_s for r in fedavg.reports]}")
    del fedavg
    off = dict(up, population=2, generations=1)
    # parents, then each generation's offspring: one model per individual
    n_models = off["population"] * (1 + off["generations"])
    zero_launches()
    offline = FedEngine(api, clients, RunConfig(**off),
                        strategy=OfflineNas()).run()
    torch.cuda.synchronize()
    n_int8 = n_models * N_CHUNKS
    expect_launches("OfflineNas", {
        "fill_aggregate": 0, "int8_scale": n_int8, "quantize_int8": n_int8,
        "dequantize_int8": n_int8})
    check_run(offline, "OfflineNas")
    log(f"OfflineNas objectives {offline.reports[0].objs.tolist()}, "
        f"round_s {offline.reports[0].round_s!r}")
    del offline
    torch.cuda.empty_cache()

    # 9. K3, K4 and K5 against their plain versions, then timed
    flash_err = check_flash()
    ssd_err = check_ssd()
    gemm_err = check_expert_gemm()
    check_expert_ffn()
    flash_timing = time_flash(card)
    flash32_timing = flash_timing.pop("float32")
    ssd_timing = time_ssd(card)
    gemm_timing = time_expert_gemm(card)
    gemm32_timing = gemm_timing.pop("float32")

    # 10. the serving path at full width, then the smoke-size replay check
    with torch.inference_mode():
        served = {arch: serve_arch(arch, card) for arch in SERVE}
        serve_launches = {arch: n[0] for arch, n in served.items()}
        serve_launches32 = {arch: n[1] for arch, n in served.items()}
        check_replay_smoke()

    # 11. the batched vmap backend at full width against phase 5's run
    in_place_launches, vmap_refs = check_vmap(api, clients, kernel_run,
                                              main_peak, card)
    refs["vmap"] = vmap_refs["kernel"]
    del kernel_run

    # 12. telemetry on the main path, the traced round, the checkpoint
    splits = check_telemetry(api, clients, [refs["loop"], refs["vmap"],
                                            refs["int8"]], card)
    check_checkpoint(refs["loop"]["result"].extras["final_master"])
    on_off = on_off_round_s(api, clients)
    splits["traced_call_us"] = traced_call_us(
        refs["loop"]["result"].extras["final_master"], clients)
    log(f"obs.traced adds {splits['traced_call_us']!r} µs to a full-width "
        f"client_update call on {card}")
    del refs
    torch.cuda.empty_cache()

    # 13. the LM supernet NAS path: per-branch forwards at full width, the
    # full-width search on K1 and K1 at its master, the smoke-size search
    # on the card against the CPU, the examples
    with torch.inference_mode():
        supernet_launches_by_key = check_supernet_branches(card)
    lm_launches, lm_p = check_lm_search(card)
    lm_timing = time_fill_aggregate_lm(card, lm_p)
    check_lm_search_smoke()
    check_examples(card)

    # 14. the LM training launcher: full width on the card, its levers,
    # the forward-only kernel route, the card against the CPU, the CLIs
    t14 = time.perf_counter()
    training = {"full_width": check_train_full_width(card),
                "full_width_chunked": check_train_full_width(card,
                                                             "chunked"),
                "levers": check_train_levers(card),
                "hybrid_chunked": check_train_hybrid(card)}
    check_train_repair()
    training["card_vs_cpu"] = check_train_card_vs_cpu()
    check_train_clis(card)
    log(f"phase 14: {time.perf_counter() - t14!r} s; the script so far "
        f"{time.perf_counter() - t_start!r} s")

    # 15. the mesh: the mesh backend against phase 11's vmap runs, a
    # 3-way mesh on one card, telemetry; the models under a registered
    # mesh; the examples
    t15 = time.perf_counter()
    mesh_out = check_mesh_runs(api, clients, vmap_refs, card)
    del vmap_refs
    torch.cuda.empty_cache()
    with torch.inference_mode():
        mesh_out["models"] = check_mesh_models(card)
    mesh_out["examples"] = check_mesh_examples(card)
    mesh_out["phase_s"] = time.perf_counter() - t15
    log(f"phase 15: {mesh_out['phase_s']!r} s; the script so far "
        f"{time.perf_counter() - t_start!r} s")

    # 16. the dry run: the matrix on the production mesh, three estimates
    # against the card, the kernel route's launches on meta
    t16 = time.perf_counter()
    dry = {"matrix": check_dryrun_matrix()}
    dry["default_allocator"] = default_allocator_args()
    with blocks_split_to_512():
        dry["estimates"] = [check_dryrun_estimate(
            *case, card, training["full_width"] if case[2].kind == "train"
            else None) for case in DRYRUN_ESTIMATES]
    dry["kernel_route"] = check_dryrun_kernel_route(serve_launches)
    dry["phase_s"] = time.perf_counter() - t16
    log(f"phase 16: {dry['phase_s']!r} s; the script so far "
        f"{time.perf_counter() - t_start!r} s")

    kernels = [{
        "name": "fill_aggregate", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fill_aggregate.cu",
        "replaces": "src/repro/kernels/fill_aggregate.py:29",
        "launches": launches["fill_aggregate"], "max_abs_err": max_err,
        **timing,
    }, {
        # K1's donate_prev variant: the output written over prev, on the
        # vmap backend's stacked route (phase 11's fused kernel-route run)
        "name": "fill_aggregate_inplace", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fill_aggregate.cu",
        "replaces": "src/repro/kernels/fill_aggregate.py:61",
        "launches": in_place_launches, "max_abs_err": inplace_err,
        **inplace_timing,
    }, {
        # K1 at the LM supernet's master (phase 13): 4 uploads of the
        # qwen1.5-0.5b supernet's flattened parameters
        "name": "fill_aggregate_lm_master", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fill_aggregate.cu",
        "replaces": "src/repro/kernels/fill_aggregate.py:29",
        "launches": lm_launches, **lm_timing,
    }, {
        "name": "quantize_int8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize_int8.cu",
        "replaces": "src/repro/kernels/quantize.py:56",
        "launches": codec_launches["quantize_int8"],
        "max_abs_err": max(err_q, err_tree[1]),
        **int8_timing["quantize_int8"], **tree_timing["quantize_int8"],
    }, {
        "name": "dequantize_int8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize_int8.cu",
        "replaces": "src/repro/kernels/quantize.py:61",
        "launches": codec_launches["dequantize_int8"],
        "max_abs_err": max(err_d, err_tree[2]),
        **int8_timing["dequantize_int8"], **tree_timing["dequantize_int8"],
    }, {
        # not a TPU kernel: the per-leaf max|x| / 127 that the JAX
        # package leaves to XLA, over the master as one tree
        "name": "int8_scale", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize_int8.cu",
        "replaces": "src/repro/comm/quantize.py:31",
        "launches": codec_launches["int8_scale"], "max_abs_err": err_tree[0],
        **tree_timing["int8_scale"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86",
        "launches": serve_launches["qwen1.5-0.5b"]["flash_attention"],
        "max_abs_err": flash_err[torch.bfloat16], **flash_timing,
        **tc_resources,
        "serve_launches": {a: n["flash_attention"] for a, n in
                           serve_launches.items() if n["flash_attention"]},
        "supernet_launches": {a: {k: n.get("flash_attention", 0)
                                  for k, n in by_key.items()}
                              for a, by_key in
                              supernet_launches_by_key.items()},
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:66",
        "launches": serve_launches["mamba2-780m"]["ssd_scan"],
        "max_abs_err": ssd_err, **ssd_timing,
        "stage_resources": ssd_stage_resources,
        "serve_launches": {a: n["ssd_scan"] for a, n in
                           serve_launches.items() if n["ssd_scan"]},
        "supernet_launches": {a: {k: n.get("ssd_scan", 0)
                                  for k, n in by_key.items()}
                              for a, by_key in
                              supernet_launches_by_key.items()
                              if any(n.get("ssd_scan")
                                     for n in by_key.values())},
    }, {
        "name": "expert_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/expert_gemm.cu",
        "replaces": "src/repro/kernels/expert_gemm.py:38",
        "launches": serve_launches["granite-moe-1b-a400m"]["expert_gemm"],
        "max_abs_err": gemm_err[torch.bfloat16], **gemm_timing,
        **gemm_resources,
        "supernet_launches": {k: n.get("expert_gemm", 0) for k, n in
                              supernet_launches_by_key[
                                  "granite-moe-1b-a400m"].items()},
    }, {
        # K3 in float32: the TMA-fed FP32-FMA kernel of every float32
        # prefill; launches of qwen's float32 prefill
        "name": "flash_attention_fp32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86",
        "launches": serve_launches32["qwen1.5-0.5b"]["flash_attention"],
        "max_abs_err": flash_err[torch.float32], **flash32_timing,
        "variant": flash.variant(torch.float32, QWEN_ATTN[-1]),
        "resources": f32_resources["flash_attention"],
        "serve_launches": {a: n["flash_attention"] for a, n in
                           serve_launches32.items() if n["flash_attention"]},
    }, {
        # K5 in float32; launches of granite's float32 prefill
        "name": "expert_gemm_fp32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/expert_gemm.cu",
        "replaces": "src/repro/kernels/expert_gemm.py:38",
        "launches": serve_launches32["granite-moe-1b-a400m"]["expert_gemm"],
        "max_abs_err": gemm_err[torch.float32], **gemm32_timing,
        "resources": f32_resources["expert_gemm"],
    }]
    if any(not math.isfinite(k[f]) for k in kernels
           for f in ("ms", "plain_ms", "bound_ms")):
        raise AssertionError(f"non-finite timing: {kernels}")
    print(json.dumps({"traced_round": splits, "on_off_round_s": on_off,
                      "training": training, "mesh": mesh_out,
                      "dryrun": dry, "card": card}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
