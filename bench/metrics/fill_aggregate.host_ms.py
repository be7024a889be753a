"""Host ms a window generation spends in the engine's ``fill_aggregate``
spans: each Algorithm 3 call inside ``fill_train`` (on the kernel route
the masks, the (m, P) flatten and K1; on the fused torch route each
group's masks and ``fill_partial``).  Summed over the span paths that
end in ``fill_aggregate``, averaged over the window's generations;
nothing where no window generation has such a span (a program that does
not enter it)."""

SPAN = "fill_aggregate"


def read(rec):
    gens = [g for g in rec["gens"] if not g["profiled"]]
    per_gen = [[ms for p, ms in g["host_ms"].items()
                if p.rsplit("/", 1)[-1] == SPAN] for g in gens]
    if not any(per_gen):
        return None
    return sum(sum(ms) for ms in per_gen) / len(gens)
