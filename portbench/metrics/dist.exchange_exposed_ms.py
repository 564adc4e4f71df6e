"""dist.exchange_exposed_ms: the device ms a sweep of the traced window in
which the busiest card's compute stream stood still waiting for a ring
copy: the program's span `dist.wait`, two events on the compute stream
just before and just after its wait on the copy's event in
`core/exchange.py::RingExchange.held`, summed per card (`_dist_spans.py`).
The part of the exchange the asynchronous ring failed to hide behind the
accumulates: the paper's claim, read directly."""
from portbench.metrics._dist_spans import busiest_card_ms


def read(rec):
    return busiest_card_ms(rec, "dist.wait")
