"""device.idle_pct.prove: the share of the traced window of the prove cells
in which nothing ran on the card, from the profiler's device timeline (the
union of every operation's interval)."""

UNIT = "%"
LAYER = "device"
MOVES = "prove_khz"
WRAPS: list = []


def read(run):
    if run.device is None or not run.device.events or not run.device.window_s:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)
