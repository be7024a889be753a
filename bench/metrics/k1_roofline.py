"""K1's share of its memory roofline: the bytes Algorithm 3 needs (each
upload's payload read once, the previous master read and the new one
written, float32; counted from the keys by the benchmark) over the HBM
rate, divided by the device time of the kernels named ``fill_aggregate``
in the generations profiled after the window.  None where no such kernel
ran."""

NAME = "fill_aggregate"


def read(rec):
    prof = [g for g in rec["gens"] if g["profiled"]]
    ms = sum(v for g in prof for k, v in g["kernels_ms"].items()
             if NAME in k)
    if ms <= 0.0:
        return None
    need = sum(g["k1_bytes"] for g in prof)
    return 100.0 * need / rec["hbm_bytes_per_s"] / (ms / 1e3)
