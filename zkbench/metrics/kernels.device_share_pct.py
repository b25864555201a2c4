"""kernels.device_share_pct: the share of the card's work in the window that
the port's hand-written kernels (K1-K4) do, against everything else it runs
(PyTorch's own kernels: the NTT, the folders, copies): their device seconds
over the device seconds of every operation in the trace."""

from ..devtrace import seconds_of
from ..frozen import kernel_bounds as kb

UNIT = "%"
LAYER = "kernels"
MOVES = "prove_khz"
WRAPS: list = []


def read(run):
    if run.device is None or not run.device.events:
        return None
    total = sum(run.device.seconds_by_kernel().values())
    return 100.0 * seconds_of(run.device, kb.KERNEL_NAMES) / total
