"""Share of a profiled generation in which the device runs nothing: 1 -
the device's busy time (the union of kernels, copies and memsets in the
capture) over the same generations' span, from the first host span's
start to the last device activity's end.  The generations are those
profiled right after the window; the profiler's host cost lengthens
their host side, so this reads above the window's own idle share."""


def read(rec):
    prof = [g for g in rec["gens"] if g["profiled"] and g["busy_ms"] > 0]
    if not prof:
        return None
    busy = sum(g["busy_ms"] for g in prof)
    span = sum(g["window_ms"] for g in prof)
    return 100.0 * (1.0 - busy / span)
