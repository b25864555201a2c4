"""poseidon2_roofline: the share of their roofline that the port's four
Poseidon2 kernels (csrc/poseidon2.cu: K1 hash_rows, K2 permute, K3
compress_levels, K4 grind) reach over the window: the sum of each launch's
least time (frozen/kernel_bounds.py, from the shapes kernels.SHAPES counted)
over the sum of their device time in the trace. K4's least time needs the
witness it found, which is the pow_witness of each shard proved; where the
grinds counted are not one a shard proved, the reader reads nothing."""

from ..devtrace import seconds_of
from ..frozen import kernel_bounds as kb

UNIT = "%"
LAYER = "kernels"
MOVES = "prove_khz"
WRAPS: list = []


def read(run):
    if run.device is None or run.launches is None or not run.done:
        return None
    shapes = run.launches
    bound = sum(kb.k1_bound(n, w)[0] * c for (n, w), c in shapes["hash_rows"].items())
    bound += sum(kb.k2_bound(m)[0] * c for m, c in shapes["permute"].items())
    bound += sum(kb.k3_bound(h, inj)[0] * c for (h, inj), c in shapes["compress_levels"].items())
    witnesses = [w for r in run.done for w in r.pow_witnesses]
    grinds = shapes["grind"]
    n_ins = {n for n, _bits in grinds}
    if sum(grinds.values()) != len(witnesses) or len(n_ins) > 1:
        return None
    if n_ins:
        n_in = n_ins.pop()
        bound += sum(kb.k4_bound(w, n_in)[0] for w in witnesses)
    seconds = seconds_of(run.device, kb.KERNEL_NAMES)
    if not seconds or not bound:
        return None
    return 100.0 * (bound / 1e3) / seconds
