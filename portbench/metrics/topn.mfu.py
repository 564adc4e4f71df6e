"""topn.mfu: batch top-N's share of the card's float32 peak, in %: the
scoring operations of the traced window's lists (2 users N S K) over the
window's seconds."""
from portbench.workcount import bpmf, peaks


def read(rec):
    t = rec.trace
    if t is None or not t.counts.get("users"):
        return None
    s = rec.sizes
    flops = bpmf.topn_flops(t.counts["users"], s["n"], s["draws"] * s["k"])
    return 100.0 * flops / t.window_s / peaks.FP32_FLOPS
