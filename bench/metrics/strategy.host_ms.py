"""Host ms a window generation spends in the round loop's own phases:
participant and group sampling, offspring variation (``sample``), the
availability draw (``availability``) and NSGA-II's selection
(``aggregate``), from the engine's host spans, averaged over the
window's generations."""

SPANS = ("sample", "availability", "aggregate")


def read(rec):
    gens = [g for g in rec["gens"] if not g["profiled"]]
    if not gens:
        return None
    return sum(sum(g["host_ms"].get(s, 0.0) for s in SPANS)
               for g in gens) / len(gens)
