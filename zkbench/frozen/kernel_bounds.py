"""The least time the card could take for each launch of the port's four
Poseidon2 kernels, copied from ziren_tpu_torch/tools/kernel_bench.py at
commit 88d1ffc (`bound_ms`, `k1_bound` .. `k4_bound`): the larger of 1,960
32-bit multiplies a permutation against 16.7e12 int32 multiply-adds a
second (132 SMs x 64 lanes x 1.98 GHz), and input plus output bytes (int64)
against 3.35e12 bytes a second, the H100 SXM's HBM3. A row of width w is
ceil(w / 8) permutations, a state one; a proof-of-work search (K4) permutes
at least witness + 1 candidates."""

from __future__ import annotations

MULS_PER_PERM = 1960
INT32_MULS_PER_S = 16.7e12
BYTES_PER_S = 3.35e12


def bound_ms(perms: int, nbytes: int) -> tuple:
    ops = perms * MULS_PER_PERM / INT32_MULS_PER_S * 1e3
    mem = nbytes / BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def k1_bound(n: int, w: int) -> tuple:
    return bound_ms(n * -(-w // 8), 8 * n * (w + 8))


def k2_bound(m: int) -> tuple:
    return bound_ms(m, 8 * m * 32)


def k3_bound(h: int, injected) -> tuple:
    inj = sum(injected)
    return bound_ms(h - 1 + inj, 8 * 8 * (h + inj + h - 1))


def k4_bound(witness: int, n_in: int) -> tuple:
    return bound_ms(witness + 1, 8 * (16 + n_in + 1))


# the kernels of csrc/poseidon2.cu that each entry point launches, by the
# function names a device trace shows (kernels.py: zt_hash_rows .. zt_grind)
KERNELS = {
    "hash_rows": ("hash_rows_kernel",),
    "permute": ("permute_kernel", "permute_coop_kernel"),
    "compress_levels": ("compress_levels_kernel",),
    "grind": ("grind_kernel", "grind_stride_kernel"),
}
KERNEL_NAMES = frozenset(k for names in KERNELS.values() for k in names)
