"""The FLOPs the window's generations need (2 x MACs for
each evaluated image, 6 x for each trained one, counted by the
benchmark from the keys) over their wall time, as a share of the
configuration's dtype's published peak."""


def read(rec):
    gens = [g for g in rec["gens"] if not g["profiled"]]
    secs = sum(g["round_s"] for g in gens)
    if secs <= 0.0:
        return None
    return 100.0 * sum(g["flops"] for g in gens) / secs / rec["peak_flops"]
