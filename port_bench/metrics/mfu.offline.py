"""The whole scoring program's share of the card's FP32 peak: the
classifier's and the front end's operations (counted from shapes,
port_bench/lib/work.py) times the traced window's clips per second (host
clock: every clip over the window), over 67 TFLOP/s. The card's power limit is printed beside it."""

from port_bench.lib import peaks, work


def read(run):
    w = run.window
    if run.profile is None or not w.get("seconds"):
        return None
    clips = w["clips"]
    ops = work.classifier(run.config["model"]["model_type"], run.config["features"], clips)[0]
    ops += sum(o for o, _ in work.frontend_launches(run.config["features"], clips).values())
    return 100.0 * ops / w["seconds"] / peaks.FP32_FLOPS
