"""The device's idle share of the traced window, in percent."""


def idle(run):
    p = run.profile
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
