"""dist.sweep_mfu: the distributed sweep's share of the cards' float32
peak, in %: the operations the inputs need for the sweeps of the traced
window (`workcount/bpmf.py::sweep_flops`, with no test prediction: the
distributed sweep makes none) over the window's seconds, against the
peak of every card the shards sit on."""
from portbench.workcount import bpmf, peaks


def read(rec):
    t = rec.trace
    if t is None or not t.counts.get("sweeps"):
        return None
    s = rec.sizes
    flops = bpmf.sweep_flops(s["m"], s["n"], s["nnz"], 0, s["k"])
    return 100.0 * flops * t.counts["sweeps"] / t.window_s / (s["cards"] * peaks.FP32_FLOPS)
