"""recs_per_s: users given a top-N list over the window's seconds (host
clock)."""


def read(rec):
    if rec.window_s is None or "users" not in rec.counts:
        return None
    return rec.counts["users"] / rec.window_s
