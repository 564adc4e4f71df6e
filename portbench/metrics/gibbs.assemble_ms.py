"""gibbs.assemble_ms: the device ms a sweep of the traced window spent in
system assembly: the program's span `gibbs.assemble` around
`core/gibbs.py::posterior_systems` in `update_factors` (the prior's copy,
the `gather_syrk_seg` launches and the index adds), both half-sweeps. A
span times the card's stream between two CUDA events
(`repro_torch/spans.py`); their sum over the window's sweeps. None off the
card, in a program without the spans, or where the program's `gibbs.sweep`
count is not the window's sweeps."""

SPAN = "gibbs.assemble"


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
    if tot.get("gibbs.sweep", {}).get("calls") != sweeps:
        return None
    device_s = tot.get(SPAN, {}).get("device_s")
    return None if device_s is None else 1e3 * device_s / sweeps
