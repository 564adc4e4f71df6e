"""device.idle_share.train: the share of the traced window in which no
kernel, copy or set ran on the card (one minus the union of device
intervals over the window), in %."""


def read(rec):
    return None if rec.trace is None else 100.0 * rec.trace.idle_share
