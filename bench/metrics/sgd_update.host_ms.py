"""Host ms a window generation spends in the engine's ``sgd_update``
spans: the optimizer step of each local SGD batch
(``core/federated.py::client_update_fn``) over the client's trained
leaves.  Summed over the span paths that end in ``sgd_update``, averaged
over the window's generations; nothing where no window generation has
such a span (a program that does not enter it)."""

SPAN = "sgd_update"


def read(rec):
    gens = [g for g in rec["gens"] if not g["profiled"]]
    per_gen = [[ms for p, ms in g["host_ms"].items()
                if p.rsplit("/", 1)[-1] == SPAN] for g in gens]
    if not any(per_gen):
        return None
    return sum(sum(ms) for ms in per_gen) / len(gens)
