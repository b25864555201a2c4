"""In-circuit outer-config transcript + commitment gadgets: Poseidon2-BN254
permutation, MultiField32 sponge/challenger and single-Fr Merkle opening
checks over the dual-field DSL (snark/circuit.py).

Mirrors the host primitives in core/bn254.py + core/outer_merkle.py
operation for operation (the reference's gnark counterparts:
recursion/circuit/src/challenger.rs MultiField32ChallengerVariable,
gnark-ffi/go/zkm/poseidon2 and the stark verifier's Merkle walk). Each
gadget is differential-tested against the host implementation in
tests/test_circuit_outer.py.
"""

from __future__ import annotations

from ..core.bn254 import (
    CH_F_ELMS,
    CH_RATE,
    FR,
    HASH_F_ELMS,
    HASH_RATE,
    KB_P,
    ROUNDS_F,
    ROUNDS_P,
    WIDTH,
)
from ..core.bn254_constants import RC3
from .circuit import (
    CircuitBuilder,
    Felt,
    Var,
    canon,
    felt_const,
)


def _sbox(bld: CircuitBuilder, x: Var) -> Var:
    x2 = bld.mul(x, x)
    x4 = bld.mul(x2, x2)
    return bld.mul(x4, x)


def c_permute(bld: CircuitBuilder, state):
    """Poseidon2-BN254 width-3 over Vars (240 muls; core/bn254.py permute)."""
    s0, s1, s2 = state
    t = s0 + s1 + s2
    s0, s1, s2 = s0 + t, s1 + t, s2 + t
    half_f = ROUNDS_F // 2
    for r in range(half_f):
        rc = RC3[r]
        s0 = _sbox(bld, s0.add_const(rc[0]))
        s1 = _sbox(bld, s1.add_const(rc[1]))
        s2 = _sbox(bld, s2.add_const(rc[2]))
        t = s0 + s1 + s2
        s0, s1, s2 = s0 + t, s1 + t, s2 + t
    for r in range(half_f, half_f + ROUNDS_P):
        s0 = _sbox(bld, s0.add_const(RC3[r][0]))
        t = s0 + s1 + s2
        s0, s1, s2 = s0 + t, s1 + t, s2.scale(2) + t
    for r in range(half_f + ROUNDS_P, ROUNDS_F + ROUNDS_P):
        rc = RC3[r]
        s0 = _sbox(bld, s0.add_const(rc[0]))
        s1 = _sbox(bld, s1.add_const(rc[1]))
        s2 = _sbox(bld, s2.add_const(rc[2]))
        t = s0 + s1 + s2
        s0, s1, s2 = s0 + t, s1 + t, s2 + t
    return [s0, s1, s2]


def c_reduce_32(bld: CircuitBuilder, felts) -> Var:
    """Pack canonical Felts into one Fr, base 2^32 LE (linear, no
    constraints — callers must pass canonically-reduced Felts)."""
    acc = bld.const(0)
    for i, f in enumerate(felts):
        assert f.bound < (1 << 32), "reduce_32 needs 32-bit-bounded felts"
        acc = acc + f.var.scale((1 << (32 * i)) % FR)
    return acc


def c_split_32(bld: CircuitBuilder, x: Var, n: int = CH_F_ELMS):
    """Split an Fr Var into n 64-bit digits each reduced into KoalaBear
    (core/bn254.py split_32). Returns [(Felt, bits31)] — the canonical KB
    digit plus its bit decomposition (reused by sample_bits)."""
    bits = bld.strict_bits_of(x)
    out = []
    for j in range(n):
        dbits = bits[64 * j : 64 * (j + 1)]
        dval = sum(int(b.val) << i for i, b in enumerate(dbits))
        digit = bld.const(0)
        for i, b in enumerate(dbits):
            digit = digit + b.scale(1 << i)
        # digit (< 2^64) = q*p + r with r canonical
        q_val, r_val = divmod(dval, KB_P)
        q = bld.wit(q_val)
        r = bld.wit(r_val)
        bld.bits_of(q, 34)
        rbits = bld.bits_of(r, 31)
        shifted = r.add_const((1 << 24) - 1)
        bld.bits_of(shifted, 31)  # r < p
        bld.assert_zero_var(digit - q.scale(KB_P) - r)
        out.append((Felt(r, KB_P - 1), rbits))
    return out


def c_hash_felts(bld: CircuitBuilder, felts) -> Var:
    """MultiField32PaddingFreeSponge over canonical Felts -> one Fr Var."""
    state = [bld.const(0)] * WIDTH
    for i in range(0, len(felts), HASH_RATE):
        chunk = felts[i : i + HASH_RATE]
        lanes = list(state)
        for j in range(0, len(chunk), HASH_F_ELMS):
            lanes[j // HASH_F_ELMS] = c_reduce_32(
                bld, chunk[j : j + HASH_F_ELMS]
            )
        state = c_permute(bld, lanes)
    return state[0]


def c_compress(bld: CircuitBuilder, left: Var, right: Var) -> Var:
    return c_permute(bld, [left, right, bld.const(0)])[0]


class CircuitChallenger:
    """MultiField32Challenger over circuit values (core/bn254.py
    OuterChallenger, observe/sample/grind-check parity)."""

    def __init__(self, bld: CircuitBuilder):
        self.bld = bld
        self.state = [bld.const(0)] * WIDTH
        self.input_buffer: list[Felt] = []
        # output: list of (Felt, bits) most-recent-first consumption from END
        self.output_buffer: list = []

    def _duplexing(self):
        bld = self.bld
        assert len(self.input_buffer) <= CH_F_ELMS * CH_RATE
        for i in range(0, len(self.input_buffer), CH_F_ELMS):
            self.state[i // CH_F_ELMS] = c_reduce_32(
                bld, self.input_buffer[i : i + CH_F_ELMS]
            )
        self.input_buffer.clear()
        self.state = c_permute(bld, self.state)
        # lazily split: store lane refs, materialize digits on first pop
        self.output_buffer = [("lane", i) for i in range(WIDTH)]
        self._lane_digits: dict[int, list] = {}

    def observe(self, f: Felt):
        self.output_buffer = []
        f = canon(f)
        self.input_buffer.append(f)
        if len(self.input_buffer) == CH_F_ELMS * CH_RATE:
            self._duplexing()

    def observe_slice(self, felts):
        for f in felts:
            self.observe(f)

    def observe_fr(self, x: Var):
        """Observe an Fr commitment via its split_32 digits."""
        for digit, _bits in c_split_32(self.bld, x, CH_F_ELMS):
            self.observe(digit)

    def _pop(self):
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        tag = self.output_buffer.pop()
        if isinstance(tag, tuple) and tag[0] == "lane":
            lane = tag[1]
            if lane not in self._lane_digits:
                self._lane_digits[lane] = c_split_32(
                    self.bld, self.state[lane], CH_F_ELMS
                )
            # a lane entry stands for its 3 digits; push back the unconsumed
            digits = self._lane_digits[lane]
            for d in digits[:-1]:
                self.output_buffer.append(d)
            return digits[-1]
        return tag

    def sample(self) -> Felt:
        return self._pop()[0]

    def sample_with_bits(self):
        return self._pop()

    def sample_ext(self):
        from .circuit import Ext

        return Ext([self.sample() for _ in range(4)])

    def sample_bits(self, nb_bits: int):
        """Low nb_bits of a sample, as bit Vars (LE)."""
        _felt, bits = self.sample_with_bits()
        return bits[:nb_bits]

    def check_witness(self, nb_bits: int, witness: Felt):
        """PoW check: observing the witness makes the next sample's low
        bits zero."""
        self.observe(witness)
        for b in self.sample_bits(nb_bits):
            self.bld.assert_zero_var(b)


def c_verify_merkle_opening(bld, root: Var, matrix_dims, index_bits,
                            row_felts, path):
    """One batched-matrix Merkle opening against a single-Fr root
    (core/outer_merkle.py verify_opening). `index_bits`: LE bit Vars of the
    leaf index (log_max of them); `row_felts`: per-matrix lists of Felts
    (31-bit bounded); `path`: list of sibling Vars, leaf level first.

    Matrices at height h contribute their row at level log_max - log_h —
    injected digests compress in after each fold, exactly like the host
    walk."""
    heights = sorted({h for h, _ in matrix_dims}, reverse=True)
    max_h = heights[0]
    log_max = max_h.bit_length() - 1
    assert len(path) == log_max
    assert len(index_bits) >= log_max

    def rows_at(h):
        out = []
        for (hh, _), r in zip(matrix_dims, row_felts):
            if hh == h:
                out.extend(r)
        return out

    digest = c_hash_felts(bld, rows_at(max_h))
    h = max_h
    for lvl, sibling in enumerate(path):
        bit = index_bits[lvl]
        left = bld.select(bit, sibling, digest)
        right = bld.select(bit, digest, sibling)
        digest = c_compress(bld, left, right)
        h //= 2
        inj = rows_at(h)
        if inj:
            digest = c_compress(bld, digest, c_hash_felts(bld, inj))
    bld.assert_zero_var(digest - root)


def felts_canon(felts):
    return [canon(f) for f in felts]


def c_observe_vk(bld, ch: CircuitChallenger, vk_commit: Var, extras):
    """vk.observe_into for the bn254 commit kind (stark/machine.py:38-44)."""
    ch.observe_fr(vk_commit)
    for x in extras:
        ch.observe(felt_const(bld, int(x)))
