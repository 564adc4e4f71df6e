"""What the `dist.*` readers share: a span's device ms a sweep of the
traced window on the card where it is largest, from the program's
per-card span totals (`repro_torch.spans.totals_by_card`). Each span
times one card's stream between two CUDA events; the four cards work at
once, so their sum is no time a sweep took, and the busiest card is the
one that sets the sweep's pace. None off the card, in a program without
per-card spans, or where the program's `dist.sweep` count is not the
window's sweeps."""


def busiest_card_ms(rec, name: str):
    t = rec.trace
    sweeps = t.counts.get("sweeps") if t is not None else None
    if not sweeps:
        return None
    try:
        from repro_torch import spans
    except ImportError:   # a program without spans
        return None
    by_card = getattr(spans, "totals_by_card", None)
    if by_card is None:   # a program whose spans do not say their card
        return None
    tot = by_card()
    if sum(c["calls"] for c in tot.get("dist.sweep", {}).values()) != sweeps:
        return None
    cards = [c["device_s"] for c in tot.get(name, {}).values() if c["device_s"] is not None]
    return 1e3 * max(cards) / sweeps if cards else None
