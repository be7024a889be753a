"""Host ms a window generation spends in the engine's ``local_sgd``
spans: each group's local SGD inside ``fill_train`` (one client's on the
loop backend), that is velocity set-up, forward, backward, the optimizer
steps and the stacking of the group's uploads.  Summed over the span
paths that end in ``local_sgd`` (children included), averaged over the
window's generations; nothing where no window generation has such a
span (a program that does not enter it)."""

SPAN = "local_sgd"


def read(rec):
    gens = [g for g in rec["gens"] if not g["profiled"]]
    per_gen = [[ms for p, ms in g["host_ms"].items()
                if p.rsplit("/", 1)[-1] == SPAN] for g in gens]
    if not any(per_gen):
        return None
    return sum(sum(ms) for ms in per_gen) / len(gens)
