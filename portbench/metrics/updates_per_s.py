"""updates_per_s: factor rows redrawn (users + items, each sweep) over the
window's seconds, the paper's Fig 4 metric (host clock)."""


def read(rec):
    if rec.window_s is None or "updates" not in rec.counts:
        return None
    return rec.counts["updates"] / rec.window_s
