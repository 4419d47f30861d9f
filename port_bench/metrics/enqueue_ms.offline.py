"""The captured program's host side: the median host time a scoring call
takes to return (the harness's span around the call; the card runs on)."""

import numpy as np


def read(run):
    spans = run.window.get("enqueue_s")
    return float(np.median(spans)) * 1e3 if spans else None
