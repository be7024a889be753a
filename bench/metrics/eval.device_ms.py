"""Device ms a profiled generation launched inside its ``eval`` span:
the error counts of every key on every participant's test batches,
averaged over the generations profiled after the window."""


def read(rec):
    prof = [g for g in rec["gens"] if g["profiled"] and g["busy_ms"] > 0]
    if not prof:
        return None
    return sum(g["device_ms"].get("eval", 0.0) for g in prof) / len(prof)
