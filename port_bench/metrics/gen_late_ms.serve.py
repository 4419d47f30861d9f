"""The traffic generator: the 95th percentile of how late each
`tick_async` call began after its tick was due."""

import numpy as np


def read(run):
    late = run.window.get("late_s")
    return float(np.percentile(late, 95)) * 1e3 if late else None
