"""Batch scoring: every clip scored in the window over the window, which
ends when the last call's work has finished."""


def read(run):
    w = run.window
    return w["clips"] / w["seconds"] if w.get("seconds") else None
