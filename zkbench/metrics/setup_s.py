"""setup_s: seconds from the process's start to the window's start: imports,
loading (or, in a checkout's first run, building) the kernels, the guest's
setup and the warm request."""

UNIT = "s"
LAYER = MOVES = None
WRAPS: list = []


def read(run):
    return run.setup_s
