"""topn.program_idle_share: the share of the traced window in which no
kernel, copy or set ran on the card while the host was inside the
program's span `topn.serve` (`serve/cluster.py::ClusterCoordinator._serve`,
a `user_annotation` of the trace), in %. `device.idle_share.topn` less this
is the idle the caller's own code leaves between batches. None without a
trace or where the trace holds no `topn.serve` span."""
from portbench.harness.trace import union

SPAN = "topn.serve"


def read(rec):
    t = rec.trace
    if t is None:
        return None
    serve = union(h for h in t.host if h[0] == SPAN)
    if not serve:
        return None
    busy = union(t.device)
    # the serve spans' length less the part the device intervals cover;
    # both lists are sorted and disjoint
    covered, j = 0.0, 0
    for s, e in serve:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    inside = sum(e - s for s, e in serve)
    return 100.0 * (inside - covered) / t.window_s
