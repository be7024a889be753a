"""Where the SSD chunk scan (K4) rounds, without decay, on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.ssd_rounding [--seed 0]

With a = 0 nothing forgets, |y| reaches the thousands at 4 chunks and
state size 128, and the float32 results of the sequential recurrence
(``kernels/ref.py::ssd_scan``) and of K4 sum in other orders.  This
script emulates, in float32 on the CPU, the order in which
``csrc/ssd_scan.cu`` sums (each chunk's local state over its rows, the
state pass over the chunks, C·Bᵀ over the state, and each output's one
accumulator: C S_inᵀ over the state, then the causal triangle over the
rows), and prints the distance of each from a float64 recurrence: the
largest |error| and its largest share of K4's limit, 2e-4 + 2e-4 |y|.
Variants swap one stage for its exact value, or give the output two
accumulators, to show which stage the error comes from.  An FMA is
emulated by a float64 multiply-add rounded once to float32.
"""
from __future__ import annotations

import argparse

import torch

TOL = 2e-4          # K4's rtol and atol against its plain version


def fma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (acc.double() + a.double() * b.double()).float()


def recurrence(xs, bm, cm, dtype):
    """y of the sequential recurrence at a = 0, in ``dtype``."""
    nc, q, h, p = xs.shape
    x, b, c = (t.to(dtype) for t in (xs, bm, cm))
    state = torch.zeros((h, p, bm.shape[-1]), dtype=dtype)
    y = torch.zeros((nc, q, h, p), dtype=dtype)
    for ci in range(nc):
        for t in range(q):
            state = state + torch.einsum("hp,n->hpn", x[ci, t], b[ci, t])
            y[ci, t] = torch.einsum("n,hpn->hp", c[ci, t], state)
    return y


def kernel_order(xs, bm, cm, exact_state=False, exact_cb=False,
                 two_acc=False):
    """y as K4 sums it at a = 0 (exp() of every difference is 1)."""
    nc, q, h, p = xs.shape
    n = bm.shape[-1]
    y = torch.zeros((nc, q, h, p))
    for hh in range(h):
        x = xs[:, :, hh]                                  # (NC, Q, P)
        local = []
        for ci in range(nc):                              # chunk_state
            acc = torch.zeros((n, p))
            for s in range(q):
                acc = fma(acc, bm[ci, s][:, None], x[ci, s][None, :])
            local.append(acc)
        s_in, st = [], torch.zeros((n, p))                # state_pass
        for ci in range(nc):
            s_in.append(st)
            st = fma(st, torch.ones(()), local[ci])
        if exact_state:
            s_in = [torch.einsum("tn,tp->np",
                                 bm[:ci].reshape(-1, n).double(),
                                 x[:ci].reshape(-1, p).double()).float()
                    for ci in range(nc)]
        for ci in range(nc):                              # chunk_out
            g = torch.zeros((q, q))                       # g[j, i] = B_j·C_i
            for k in range(n):
                g = fma(g, bm[ci, :, k][:, None], cm[ci, :, k][None, :])
            if exact_cb:
                g = (bm[ci].double() @ cm[ci].double().T).float()
            g = torch.triu(g)                             # j <= i
            acc = torch.zeros((q, p))
            for k in range(n):
                acc = fma(acc, cm[ci, :, k][:, None], s_in[ci][k][None, :])
            tri = torch.zeros((q, p)) if two_acc else acc
            for j in range(q):
                tri = fma(tri, g[j][:, None], x[ci, j][None, :])
            y[ci, :, hh] = acc + tri if two_acc else tri
    return y


def distance(y: torch.Tensor, y64: torch.Tensor) -> str:
    err = (y.double() - y64).abs()
    share = float((err / (TOL + TOL * y64.abs())).max())
    return f"max |error| {float(err.max())!r}, {share!r} of the limit"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shape", type=int, nargs=5, default=(4, 128, 4, 64, 128),
                    metavar=("NC", "Q", "H", "P", "N"))
    args = ap.parse_args(argv)
    nc, q, h, p, n = args.shape
    g = torch.Generator().manual_seed(args.seed)
    xs = torch.randn((nc, q, h, p), generator=g)
    bm = torch.randn((nc, q, n), generator=g)
    cm = torch.randn((nc, q, n), generator=g)
    y64 = recurrence(xs, bm, cm, torch.float64)
    y_p = recurrence(xs, bm, cm, torch.float32)
    y_k = kernel_order(xs, bm, cm)
    print(f"shape (NC, Q, H, P, N) {tuple(args.shape)}, a = 0, max |y| "
          f"{float(y64.abs().max())!r}")
    print(f"plain recurrence vs float64: {distance(y_p, y64)}")
    print(f"K4's order vs float64: {distance(y_k, y64)}")
    share = float(((y_k - y_p).abs() / (TOL + TOL * y_p.abs())).max())
    print(f"K4's order vs plain: {share!r} of the limit")
    for name, kw in (("exact S_in", {"exact_state": True}),
                     ("exact C·Bᵀ", {"exact_cb": True}),
                     ("two accumulators", {"two_acc": True})):
        print(f"K4's order, {name}, vs float64: "
              f"{distance(kernel_order(xs, bm, cm, **kw), y64)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
