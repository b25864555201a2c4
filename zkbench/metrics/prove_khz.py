"""prove_khz: MIPS cycles of the core proofs completed in the window, over
the milliseconds from the window's start to the last completion. A request's
cycles are the reference's count for its guest and input, which the check
holds equal to the executor's global_clk."""

UNIT = "kHz"
LAYER = MOVES = None
WRAPS: list = []


def read(run):
    cycles = sum(c for r, c in zip(run.requests, run.cycles) if r.error is None)
    if not cycles:
        return None
    return cycles / ((run.t1 - run.t0) * 1e3)
