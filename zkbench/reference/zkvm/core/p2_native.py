"""The reference has no native fast path: `available()` is always False, so
core/poseidon2.py, core/ntt.py and core/septic.py take their numpy paths.
(Stands in for ziren_tpu_torch/core/p2_native.py, which builds
native/hashing.cpp.)"""


def available() -> bool:
    return False
