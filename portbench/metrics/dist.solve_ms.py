"""dist.solve_ms: the device ms a sweep of the traced window spent in the
shards' posterior solves on the busiest card: the program's span
`dist.solve` around each shard's half-sweep solve in
`core/distributed.py::_finish_phase` (the prior added, `cholesky_ex` and
`chol_subst_solve`), both half-sweeps, summed per card (`_dist_spans.py`)."""
from portbench.metrics._dist_spans import busiest_card_ms


def read(rec):
    return busiest_card_ms(rec, "dist.solve")
