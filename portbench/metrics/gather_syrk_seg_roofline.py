"""gather_syrk_seg_roofline: the least time the card needs for both
half-sweeps' rating statistics of the traced sweeps, over the device time
of the kernels of `src/repro_torch/csrc/gather_syrk_seg.cu`, in %. Each
half-sweep's least time is the larger of its operations at the float32
peak and its bytes at the memory bandwidth (`workcount/bpmf.py`)."""
from portbench.workcount import bpmf, peaks

KERNELS = ("gather_syrk_narrow_kernel", "gather_syrk_rows_kernel", "segment_reduce_kernel")


def read(rec):
    t = rec.trace
    if t is None or not t.counts.get("sweeps") or not t.has_kernels(KERNELS):
        return None
    s = rec.sizes
    k, nnz = s["k"], s["nnz"]
    flops = bpmf.stats_flops(nnz, k)
    least = (peaks.least_s(flops, bpmf.stats_bytes(nnz, s["m"], s["items_rated"], k))
             + peaks.least_s(flops, bpmf.stats_bytes(nnz, s["n"], s["users_rated"], k)))
    return 100.0 * least * t.counts["sweeps"] / t.kernel_s(KERNELS)
