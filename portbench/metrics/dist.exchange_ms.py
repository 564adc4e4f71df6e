"""dist.exchange_ms: the device ms a sweep of the traced window that the
ring's forwards took on the busiest card's copy stream: the program's span
`dist.exchange` around each copy of a u or v block to the next shard
(`core/exchange.py`), timed on the sending card's copy stream from the end
of the copy's waits, summed per card (`_dist_spans.py`)."""
from portbench.metrics._dist_spans import busiest_card_ms


def read(rec):
    return busiest_card_ms(rec, "dist.exchange")
