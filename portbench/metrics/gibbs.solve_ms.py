"""gibbs.solve_ms: the device ms a sweep of the traced window spent in the
batched solve: the program's span `gibbs.solve` around
`core/gibbs.py::sample_mvn_precision` in `update_factors` (`cholesky_ex`,
the `tril`, the NaN mask and the two `solve_triangular`), both
half-sweeps. A span times the card's stream between two CUDA events
(`repro_torch/spans.py`); their sum over the window's sweeps. None off the
card, in a program without the spans, or where the program's `gibbs.sweep`
count is not the window's sweeps."""

SPAN = "gibbs.solve"


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
