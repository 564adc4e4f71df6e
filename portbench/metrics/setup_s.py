"""setup_s: seconds from just after torch's import (`run.py`) to the start
of the window: the card's start, the port's import, making the inputs,
building the program, the checked steps and the warm-up (host clock)."""


def read(rec):
    return rec.setup_s
