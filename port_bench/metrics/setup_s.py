"""Set-up: process start to the first timed call (imports, the card, the
kernel library, weights, inputs, capture and warm-up)."""


def read(run):
    return run.setup_s
