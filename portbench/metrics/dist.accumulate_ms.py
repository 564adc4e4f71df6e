"""dist.accumulate_ms: the device ms a sweep of the traced window spent in
the ring's block statistics on the busiest card: the program's span
`dist.accumulate` around each `core/distributed.py::_accumulate_block`
(the `gather_syrk_seg` launch and the adds into the shard's systems), both
half-sweeps, summed per card (`_dist_spans.py`)."""
from portbench.metrics._dist_spans import busiest_card_ms


def read(rec):
    return busiest_card_ms(rec, "dist.accumulate")
