"""BN254 scalar field (Fr) + Poseidon2 width-3 permutation + the outer
commitment/transcript primitives (reference:
crates/recursion/core/src/stark/config.rs KoalaBearPoseidon2Outer).

The outer recursion config keeps all AIR VALUES in KoalaBear but runs the
Merkle tree and the Fiat-Shamir challenger over BN254 so the wrap proof is
cheap to verify inside a BN254 SNARK:

  * `permute` — Poseidon2-BN254 width 3, 8 external + 56 internal rounds,
    x^5 sbox, external layer M = I + J (circ(2,1,1)), internal layer
    diag(1,1,2) + J (reference gnark-ffi/go/zkm/poseidon2/poseidon2.go,
    config.rs outer_perm); round constants in bn254_constants.py.
  * `hash_felts` — MultiField32PaddingFreeSponge<KB, Fr, 3, 16, 1>: chunks
    of 16 KoalaBear values, packed 8-per-Fr base 2^32 (little-endian,
    p3 reduce_32) into state[0..2], permute per chunk, digest = state[0].
  * `compress` — TruncatedPermutation<2, 1, 3>: [left, right, 0] -> perm
    -> state[0].
  * `OuterChallenger` — MultiField32Challenger<KB, Fr, 3, RATE=2>: observes
    KoalaBear values packed 3-per-Fr (base 2^32) into state[0..2), samples
    KoalaBear values by splitting every state element into 3 64-bit digits
    reduced mod the KoalaBear prime (p3 split_32).

Fr elements are Python ints host-side (the outer commitment layer is small:
one wrap proof per program); hot leaf hashing has a C++ path in
native/bn254_poseidon2.cpp when built.
"""

from __future__ import annotations

import numpy as np

from .bn254_constants import RC3

# BN254 (alt_bn128) scalar field modulus
FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

KB_P = 2130706433  # KoalaBear prime (core/field.py)

WIDTH = 3
ROUNDS_F = 8
ROUNDS_P = 56

# hash packing: 8 KoalaBear values per Fr (8*32 = 256 bits folded mod FR)
HASH_RATE = 16
HASH_F_ELMS = 8
# challenger packing: 3 per Fr in, 3 64-bit digits out per state element
CH_RATE = 2
CH_F_ELMS = 3


def permute(state):
    """Poseidon2-BN254 width-3 permutation over python ints (mod FR)."""
    s0, s1, s2 = state
    # initial external linear layer
    t = s0 + s1 + s2
    s0, s1, s2 = (s0 + t) % FR, (s1 + t) % FR, (s2 + t) % FR
    half_f = ROUNDS_F // 2
    for r in range(half_f):
        rc = RC3[r]
        s0 = _sbox((s0 + rc[0]) % FR)
        s1 = _sbox((s1 + rc[1]) % FR)
        s2 = _sbox((s2 + rc[2]) % FR)
        t = s0 + s1 + s2
        s0, s1, s2 = (s0 + t) % FR, (s1 + t) % FR, (s2 + t) % FR
    for r in range(half_f, half_f + ROUNDS_P):
        s0 = _sbox((s0 + RC3[r][0]) % FR)
        t = s0 + s1 + s2
        # internal diffusion: diag(1,1,2) + J
        s0, s1, s2 = (s0 + t) % FR, (s1 + t) % FR, (2 * s2 + t) % FR
    for r in range(half_f + ROUNDS_P, ROUNDS_F + ROUNDS_P):
        rc = RC3[r]
        s0 = _sbox((s0 + rc[0]) % FR)
        s1 = _sbox((s1 + rc[1]) % FR)
        s2 = _sbox((s2 + rc[2]) % FR)
        t = s0 + s1 + s2
        s0, s1, s2 = (s0 + t) % FR, (s1 + t) % FR, (s2 + t) % FR
    return (s0, s1, s2)


def _sbox(x: int) -> int:
    x2 = (x * x) % FR
    x4 = (x2 * x2) % FR
    return (x4 * x) % FR


def reduce_32(vals) -> int:
    """Pack 32-bit KoalaBear canonicals into one Fr, base 2^32 LE
    (p3 reduce_32)."""
    acc = 0
    for v in reversed(list(vals)):
        acc = (acc * (1 << 32) + int(v)) % FR
    return acc


def split_32(val: int, n: int) -> list:
    """Split an Fr canonical into n 64-bit digits, each reduced into
    KoalaBear (p3 split_32 / from_wrapped_u64)."""
    out = []
    for _ in range(n):
        out.append((val & ((1 << 64) - 1)) % KB_P)
        val >>= 64
    return out


def hash_felts(vals) -> int:
    """MultiField32PaddingFreeSponge: KoalaBear values -> one Fr digest."""
    vals = [int(v) for v in np.asarray(vals, dtype=np.uint32).reshape(-1)]
    state = (0, 0, 0)
    for i in range(0, len(vals), HASH_RATE):
        chunk = vals[i : i + HASH_RATE]
        lanes = list(state)
        for j in range(0, len(chunk), HASH_F_ELMS):
            lanes[j // HASH_F_ELMS] = reduce_32(chunk[j : j + HASH_F_ELMS])
        state = permute(tuple(lanes))
    return state[0]


def compress(left: int, right: int) -> int:
    """TruncatedPermutation<2, 1, 3> over single-Fr digests."""
    return permute((left % FR, right % FR, 0))[0]


class OuterChallenger:
    """MultiField32Challenger<KoalaBear, Bn254Fr, perm, 3, 2>.

    API-compatible with core/challenger.DuplexChallenger: observes and
    samples KOALABEAR values; the sponge state is 3 Fr elements. Fr digests
    (Merkle roots) are observed via observe_fr as their split_32 digits —
    3 x 64-bit LE digits reduced into KoalaBear, exactly how p3's
    `CanObserve<Hash<F, PF, N>>` binds outer commitments (192 of the 254
    digest bits enter the transcript).
    """

    def __init__(self):
        self.state = [0] * WIDTH
        self.input_buffer: list = []
        self.output_buffer: list = []

    def clone(self) -> "OuterChallenger":
        c = OuterChallenger()
        c.state = list(self.state)
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def _duplexing(self):
        assert len(self.input_buffer) <= CH_F_ELMS * CH_RATE
        for i in range(0, len(self.input_buffer), CH_F_ELMS):
            self.state[i // CH_F_ELMS] = reduce_32(
                self.input_buffer[i : i + CH_F_ELMS]
            )
        self.input_buffer.clear()
        self.state = list(permute(tuple(self.state)))
        self.output_buffer.clear()
        for s in self.state:
            self.output_buffer.extend(split_32(s, CH_F_ELMS))

    def observe(self, value: int):
        self.output_buffer.clear()
        self.input_buffer.append(int(value) % KB_P)
        if len(self.input_buffer) == CH_F_ELMS * CH_RATE:
            self._duplexing()

    def observe_slice(self, values):
        for v in np.asarray(values, dtype=np.uint32).reshape(-1):
            self.observe(int(v))

    def observe_fr(self, fr: int):
        """Observe an Fr commitment (split_32 digits, p3 convention)."""
        for v in split_32(int(fr), CH_F_ELMS):
            self.observe(v)

    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def sample_ext(self) -> np.ndarray:
        return np.array([self.sample() for _ in range(4)], dtype=np.uint32)

    def sample_bits(self, nb_bits: int) -> int:
        return self.sample() & ((1 << nb_bits) - 1)

    def grind(self, nb_bits: int) -> int:
        w = self._grind_witness(nb_bits)
        self.observe(w)
        assert self.sample_bits(nb_bits) == 0
        return w

    def _grind_witness(self, nb_bits: int) -> int:
        """Smallest witness w with sample_bits(nb_bits)==0 after observe(w).

        Candidates are independent duplexes of the same pre-state, so they
        batch through the native permutation when available (the real outer
        config grinds 16 bits = ~65k candidates)."""
        from . import bn254_native as bnn

        mask = (1 << nb_bits) - 1
        if not bnn.available():
            w = 0
            while True:
                c = self.clone()
                c.observe(w)
                if c.sample_bits(nb_bits) == 0:
                    return w
                w += 1
        # replicate observe(w) + duplexing for a batch of candidates
        base_inputs = list(self.input_buffer)
        k = len(base_inputs)
        assert k < CH_F_ELMS * CH_RATE
        batch = 4096
        start = 0
        while True:
            states = np.zeros((batch, WIDTH, 4), dtype=np.uint64)
            for b in range(batch):
                lanes = list(self.state)
                inputs = base_inputs + [(start + b) % KB_P]
                for i in range(0, len(inputs), CH_F_ELMS):
                    lanes[i // CH_F_ELMS] = reduce_32(inputs[i : i + CH_F_ELMS])
                for lane_i, lane in enumerate(lanes):
                    v = int(lane)
                    for j in range(4):
                        states[b, lane_i, j] = v & 0xFFFFFFFFFFFFFFFF
                        v >>= 64
            out = bnn.permute_batch(states)
            for b in range(batch):
                # output buffer is [split(state0), split(state1), split(state2)];
                # sample() pops from the END -> last digit of state2
                s2 = (
                    int(out[b, 2, 0])
                    | (int(out[b, 2, 1]) << 64)
                    | (int(out[b, 2, 2]) << 128)
                    | (int(out[b, 2, 3]) << 192)
                )
                top = split_32(s2, CH_F_ELMS)[-1]
                if top & mask == 0:
                    return start + b
            start += batch

    def check_witness(self, nb_bits: int, witness: int) -> bool:
        self.observe(witness)
        return self.sample_bits(nb_bits) == 0
