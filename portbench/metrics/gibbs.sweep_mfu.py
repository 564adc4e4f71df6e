"""gibbs.sweep_mfu: the Gibbs sweep's share of the card's float32 peak, in
%: the operations the inputs need for the sweeps of the traced window
(`workcount/bpmf.py::sweep_flops`) over the window's seconds."""
from portbench.workcount import bpmf, peaks


def read(rec):
    t = rec.trace
    if t is None or not t.counts.get("sweeps"):
        return None
    s = rec.sizes
    flops = bpmf.sweep_flops(s["m"], s["n"], s["nnz"], s["n_test"], s["k"])
    return 100.0 * flops * t.counts["sweeps"] / t.window_s / peaks.FP32_FLOPS
