"""topn_roofline: the least time the card needs to score and select the
traced window's lists, over the device time of the kernels of
`src/repro_torch/csrc/topn.cu`, in %. The least time is the larger of the
scoring operations at the float32 peak and the bytes (every batch reads
the items' scoring rows once, its users' once, and writes its lists) at
the memory bandwidth."""
from portbench.workcount import bpmf, peaks

KERNELS = ("topn_score_kernel", "topn_select_kernel")


def read(rec):
    t = rec.trace
    if t is None or not t.counts.get("users") or not t.has_kernels(KERNELS):
        return None
    s = rec.sizes
    width, users, batches = s["draws"] * s["k"], t.counts["users"], t.counts["batches"]
    flops = bpmf.topn_flops(users, s["n"], width)
    nbytes = (batches * bpmf.topn_bytes(0, s["n"], width, s["topk"])
              + bpmf.topn_bytes(users, 0, width, s["topk"]))
    return 100.0 * peaks.least_s(flops, nbytes) / t.kernel_s(KERNELS)
