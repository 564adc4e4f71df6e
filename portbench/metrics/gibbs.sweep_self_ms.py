"""gibbs.sweep_self_ms: the device ms a sweep of the traced window that the
program's span `gibbs.sweep` (`core/gibbs.py::GibbsSampler.sweep`) holds
outside its children `gibbs.assemble` and `gibbs.solve`: both hyper draws,
the prediction, and the statistics of each new factor matrix. Each span
times the card's stream between two CUDA events (`repro_torch/spans.py`).
None off the card, in a program without the spans, or where the program's
`gibbs.sweep` count is not the window's sweeps."""

CHILDREN = ("gibbs.assemble", "gibbs.solve")


def read(rec):
    t = rec.trace
    sweeps = t.counts.get("sweeps") if t is not None else None
    if not sweeps:
        return None
    try:
        from repro_torch import spans
    except ImportError:   # a program without spans
        return None
    tot = spans.totals()
    sweep = tot.get("gibbs.sweep", {})
    if sweep.get("calls") != sweeps or sweep.get("device_s") is None:
        return None
    children = [tot.get(c, {}).get("device_s") for c in CHILDREN]
    if None in children:
        return None
    return 1e3 * (sweep["device_s"] - sum(children)) / sweeps
