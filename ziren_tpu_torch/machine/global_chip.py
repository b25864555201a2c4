"""GlobalChip: accumulates all global (cross-shard) lookups of a shard onto
the septic elliptic curve (reference: crates/core/machine/src/global/mod.rs,
stark/src/septic_curve.rs lift_x).

Each row receives one Global-kind message [m0..m6, is_send, is_receive,
kind], maps it to a curve point (x = (m0..m5, m6*256 + offset), y witnessed
with y^2 = x^3 + 3zx - 3 and y7... y[6] in the receive half-range; sends use
-y), and adds it to the running digest. The last row's 14 trailing columns
are the shard's global cumulative sum, bound to the proof's claimed digest
by the permutation constraints (commit_scope = Global).
"""

from __future__ import annotations

import numpy as np

from ..core import field as F
from ..core import septic as S
from ..executor.opcode import ByteOpcode as B
from ..stark.chip import Air
from ..stark.lookup import LookupKind, LookupScope
from ..trace import current
from .byte import count, send_byte
from .layout import Layout, pad_to_pow2, word_decompose_np

P = F.P_INT
HALF = (P - 1) // 2  # receive range: 1 <= y6 <= HALF

COLS = Layout()
COLS.add("message", 7)
COLS.add("kind").add("is_send").add("is_receive")
COLS.add("offset")  # lift_x offset byte
COLS.add("x6")  # m6 * 256 + offset (mod p)
COLS.add("y", 7)  # receive-range y (y6 in [1, HALF])
COLS.add("y6_inv")  # y[6] != 0 witness
COLS.add("range_b", 4)  # byte decomposition of HALF - y[6]
COLS.add("slope", 7)  # addition slope: prev_acc + point -> acc
COLS.add("is_real")
COLS.add("acc", 14)  # running digest after this row (x, y)

# the last 14 columns must be the accumulated digest: enforced by layout
assert COLS.slc("acc").stop == COLS.width


class GlobalChip(Air):
    picus_inputs = ("message", "kind", "is_send", "is_receive", "offset",
                    "is_real")
    picus_outputs = ("x6", "y", "y6_inv", "range_b", "slope", "acc")
    name = "Global"
    width = COLS.width
    commit_scope = LookupScope.Global

    def _events(self, record):
        """The global lookup events in chip-emission order, as arrays:
        messages (n, 7), is_send (n,) and kind (n,), all uint32. Each
        source's values are split into bytes in one call."""
        from ..machine.memory_local import all_local_segments
        from ..machine.syscall_bridge import global_syscall_events

        mem = int(LookupKind.Memory)
        parts = []  # (messages, is_send, kind) of each source, in order

        def memory(heads, values, is_send):
            n = len(heads)
            msgs = np.empty((n, 7), dtype=np.uint32)
            msgs[:, :3] = heads
            msgs[:, 3:] = word_decompose_np(values)
            sends = np.empty(n, dtype=np.uint32)
            sends[:] = is_send
            parts.append((msgs, sends, np.full(n, mem, np.uint32)))

        segs = all_local_segments(record)
        if segs:  # each segment's init (a receive), then its final (a send)
            seg = np.array([(a, *i, *f) for a, i, f in segs], dtype=np.int64).reshape(-1, 7)
            heads = np.empty((2 * len(seg), 3), dtype=np.int64)
            heads[0::2] = seg[:, [1, 2, 0]]
            heads[1::2] = seg[:, [4, 5, 0]]
            values = np.empty(2 * len(seg), dtype=np.int64)
            values[0::2], values[1::2] = seg[:, 3], seg[:, 6]
            memory(heads, values, np.tile(np.array([0, 1], np.uint32), len(seg)))
        sys_events = global_syscall_events(record)
        if sys_events:
            parts.append((np.array([m for m, _, _ in sys_events], dtype=np.uint32),
                          np.array([s for _, s, _ in sys_events], dtype=np.uint32),
                          np.array([k for _, _, k in sys_events], dtype=np.uint32)))
        if record.mem_init:
            init = np.array(record.mem_init, dtype=np.int64).reshape(-1, 2)
            heads = np.zeros((len(init), 3), dtype=np.int64)
            heads[:, 2] = init[:, 0]
            memory(heads, init[:, 1], 1)
        if record.mem_final:
            fin = np.array(record.mem_final, dtype=np.int64).reshape(-1, 4)
            memory(fin[:, [1, 2, 0]], fin[:, 3], 0)
        if not parts:
            return (np.zeros((0, 7), np.uint32), np.zeros(0, np.uint32),
                    np.zeros(0, np.uint32))
        return tuple(np.concatenate(col) for col in zip(*parts))

    def _lifted(self, record):
        """The events (`_events`) and their points (`S.lift_x_batch`): what
        generate_dependencies kept on the record, or made anew."""
        kept = getattr(record, "_global_lifted", None)
        if kept is not None:
            return kept
        msgs, sends, kinds = self._events(record)
        if len(msgs):
            xs, ys, offs = S.lift_x_batch(msgs)
        else:
            xs, ys, offs = msgs, msgs, np.zeros(0, np.uint32)
        return msgs, sends, kinds, xs, np.asarray(ys, np.uint32), offs

    def included(self, record):
        return True

    def generate_dependencies(self, record, output):
        lifted = self._lifted(record)
        try:
            record._global_lifted = lifted  # for generate_trace, which reads it
        except AttributeError:
            pass
        _msgs, _sends, _kinds, _xs, ys, offs = lifted
        if not len(ys):
            return
        count(record, B.U8Range, offs, 0)
        rb = word_decompose_np((HALF - ys[:, 6].astype(np.int64)))
        count(record, B.U8Range, rb[:, 0], rb[:, 1])
        count(record, B.U8Range, rb[:, 2], rb[:, 3])
        count(record, B.MSB, rb[:, 3], 0)

    def num_rows(self, record):
        from ..machine.memory_local import all_local_segments
        from ..machine.syscall_bridge import (
            core_dispatches,
            precompile_entries,
        )

        return (
            2 * len(all_local_segments(record))
            + 2 * len(core_dispatches(record))
            + 2 * len(precompile_entries(record))
            + len(record.mem_init) + len(record.mem_final)
        )

    def generate_trace(self, record, output):
        from ..core import septic_native

        msgs, sends, kinds, xs, ys, offs = self._lifted(record)
        n = len(msgs)
        native = septic_native.available()
        sp = current()
        if getattr(sp, "name", None) == "tracegen.trace":
            sp.set(rows=n, sum="native" if native else "python")
        w = COLS.writer(n)
        if n:
            w.mat[:, COLS.slc("message")] = msgs
            w.mat[:, COLS.idx("kind")] = kinds
            w.mat[:, COLS.idx("is_send")] = sends
            w.mat[:, COLS.idx("is_receive")] = 1 - sends
            w.mat[:, COLS.idx("offset")] = offs
            w.mat[:, COLS.idx("x6")] = xs[:, 6]
            w.mat[:, COLS.slc("y")] = ys
            w.mat[:, COLS.idx("y6_inv")] = F.finv(ys[:, 6])
            w.mat[:, COLS.slc("range_b")] = word_decompose_np(HALF - ys[:, 6].astype(np.int64))
            y_used = np.where(sends[:, None] == 1, S.sneg(ys), ys)
            sums = septic_native.running_sums if native else _running_sums
            slopes, accs = sums(S.digest_zero(), xs, y_used)
            w.mat[:, COLS.slc("slope")] = slopes
            w.mat[:, COLS.slc("acc")] = accs
        w.set("is_real", np.ones(n))
        mat = pad_to_pow2(w.mat)
        # padding rows carry the dummy curve point (reference
        # CURVE_WITNESS_DUMMY_POINT) so the ungated curve equation holds
        dx, dy = S.CURVE_WITNESS_DUMMY_POINT_X, S.CURVE_WITNESS_DUMMY_POINT_Y
        mat[n:, COLS.slc("message")] = np.concatenate([dx[:6], [0]])
        mat[n:, COLS.idx("x6")] = dx[6]
        mat[n:, COLS.slc("y")] = dy
        mat[n:, COLS.idx("y6_inv")] = pow(int(dy[6]), P - 2, P)
        rb = word_decompose_np(np.array([HALF - int(dy[6])], dtype=np.int64))
        mat[n:, COLS.slc("range_b")] = rb[0]
        if n:
            mat[n:, COLS.slc("acc")] = accs[n - 1]
        else:
            z = S.digest_zero()
            mat[:, COLS.slc("acc")] = np.concatenate([z[0], z[1]])
        return mat

    # -- constraint helpers (septic arithmetic over folder values) ---------
    @staticmethod
    def _s_mul(a7, b7):
        """Septic product of two length-7 folder-value vectors."""
        raw = [0] * 13
        for i in range(7):
            for j in range(7):
                raw[i + j] = a7[i] * b7[j] + raw[i + j]
        for k in range(12, 6, -1):
            c = raw[k]
            raw[k - 7] = raw[k - 7] + c * 8
            raw[k - 6] = raw[k - 6] - c * 2
        return raw[:7]

    def eval(self, b):
        L = COLS.view(b.main_local)
        N = COLS.view(b.main_next)
        is_real = L["is_real"]
        b.assert_bool(is_real)
        b.when_first_row().assert_one(is_real)
        b.when_transition().assert_zero(N["is_real"] * (1 - is_real))

        m = L["message"]
        is_send, is_recv = L["is_send"], L["is_receive"]
        b.assert_bool(is_send)
        b.assert_bool(is_recv)
        b.assert_eq(is_send + is_recv, is_real)
        b.receive(
            LookupKind.Global,
            list(m) + [is_send, is_recv, L["kind"]],
            is_real,
        )

        # x-coordinate derivation
        send_byte(b, B.U8Range, L["offset"], 0, 0, is_real)
        b.when(is_real).assert_eq(L["x6"], m[6] * 256 + L["offset"])
        x = [m[0], m[1], m[2], m[3], m[4], m[5], L["x6"]]
        y = L["y"]

        # y is on the curve: y^2 == x^3 + 3z x - 3 (ungated, degree 3;
        # padding rows carry the dummy point so this holds everywhere).
        # 3z*x: coefficients shift up by one with z^7 = 8 - 2z reduction:
        # (3z*x)_0 = 24*x6, (3z*x)_1 = 3*x0 - 6*x6, (3z*x)_k = 3*x_{k-1}
        y2 = self._s_mul(y, y)
        x2 = self._s_mul(x, x)
        x3 = self._s_mul(x2, x)
        rhs = list(x3)
        rhs[0] = rhs[0] + x[6] * 24
        rhs[1] = rhs[1] - x[6] * 6
        for k in range(1, 7):
            rhs[k] = rhs[k] + x[k - 1] * 3
        rhs[0] = rhs[0] - 3
        for k in range(7):
            b.assert_zero(y2[k] - rhs[k])

        # y6 in the receive range [1, HALF] (padding: dummy y, also valid)
        b.assert_zero(y[6] * L["y6_inv"] - 1)
        rb = L["range_b"]
        b.assert_eq(
            HALF - y[6],
            rb[0] + rb[1] * 256 + rb[2] * 65536 + rb[3] * 16777216,
        )
        send_byte(b, B.U8Range, rb[0], rb[1], 0, is_real)
        send_byte(b, B.U8Range, rb[2], rb[3], 0, is_real)
        send_byte(b, B.MSB, rb[3], 0, 0, is_real)

        # the added point: y_used = receive ? y : -y
        y_used = [is_recv * y[k] - is_send * y[k] for k in range(7)]

        # accumulation: first row adds to the digest start, transitions add
        # the next row's point to the local accumulator
        start_x = [int(v) for v in S.CURVE_CUMULATIVE_SUM_START_X]
        start_y = [int(v) for v in S.CURVE_CUMULATIVE_SUM_START_Y]
        acc = L["acc"]
        self._eval_add(
            b, b.when_first_row(), L["slope"],
            start_x, start_y, x, y_used, [acc[k] for k in range(7)],
            [acc[7 + k] for k in range(7)],
        )
        nxt_x = [N["message"][k] for k in range(6)] + [N["x6"]]
        nxt_y_used = [
            N["is_receive"] * N["y"][k] - N["is_send"] * N["y"][k] for k in range(7)
        ]
        nacc = N["acc"]
        self._eval_add(
            b, b.when_transition().when(N["is_real"]), N["slope"],
            [acc[k] for k in range(7)], [acc[7 + k] for k in range(7)],
            nxt_x, nxt_y_used,
            [nacc[k] for k in range(7)], [nacc[7 + k] for k in range(7)],
        )
        # padding keeps the digest constant
        for k in range(14):
            b.when_transition().assert_zero(
                (1 - N["is_real"]) * (nacc[k] - acc[k])
            )

    @staticmethod
    def _eval_add(b, gate, slope, px, py, qx, qy, ox, oy):
        """Curve addition constraints: (px,py) + (qx,qy) == (ox,oy)."""
        s7 = [slope[k] for k in range(7)]
        # slope * (qx - px) == qy - py
        lhs = GlobalChip._s_mul(s7, [qx[k] - px[k] for k in range(7)])
        for k in range(7):
            gate.assert_zero(lhs[k] - (qy[k] - py[k]))
        # ox == slope^2 - px - qx
        s2 = GlobalChip._s_mul(s7, s7)
        for k in range(7):
            gate.assert_zero(ox[k] - (s2[k] - px[k] - qx[k]))
        # oy == slope * (px - ox) - py
        t = GlobalChip._s_mul(s7, [px[k] - ox[k] for k in range(7)])
        for k in range(7):
            gate.assert_zero(t[k] - py[k] - oy[k])


def _running_sums(start, xs, ys):
    """The slopes and running sums of adding the points (xs[i], ys[i]), in
    order, to `start`: row i's slope is that of S.curve_add(acc, point i)
    and its sum that addition's result. The same field arithmetic as
    S.curve_add, on Python ints a row at a time (numpy's per-call cost on
    seven-element vectors made this loop the host's longest trace): a
    septic product is one product of two big ints, each packing its seven
    coefficients in 68-bit slots (a coefficient of the product is a sum of
    at most seven products of two values below 2^31, below 2^65), and a
    Frobenius map is a sum of seven such ints scaled by the coefficients.
    Returns ((n, 7) slopes, (n, 14) sums: x then y)."""
    bits = 68
    mask = (1 << bits) - 1
    shifts = [bits * i for i in range(13)]

    def pack(a):
        return sum(v << sh for v, sh in zip(a, shifts))

    def mul(a, b):
        c = pack(a) * pack(b)
        raw = [(c >> sh) & mask for sh in shifts]
        for k in range(12, 6, -1):  # z^7 = 8 - 2z
            raw[k - 7] += 8 * raw[k]
            raw[k - 6] -= 2 * raw[k]
        return [v % P for v in raw[:7]]

    S.frobenius(S.sone(), 1)  # builds S._FROB_MATS once
    frob = {k: [pack(row) for row in S._FROB_MATS[k].astype(np.int64).tolist()] for k in (1, 2)}

    def frobenius(a, k):  # sum_i a_i * (row i of the map)
        c = sum(v * row for v, row in zip(a, frob[k]))
        return [((c >> sh) & mask) % P for sh in shifts[:7]]

    def inv(a):  # S.sinv: a^(r - 1) / N(a), r = (p^7 - 1) / (p - 1)
        base = mul(frobenius(a, 1), frobenius(a, 2))
        base_p2 = frobenius(base, 2)
        base_p4 = frobenius(base_p2, 2)
        pow_r_1 = mul(mul(base_p4, base_p2), base)
        norm_inv = pow(mul(pow_r_1, a)[0], P - 2, P)
        return [v * norm_inv % P for v in pow_r_1]

    n = len(xs)
    slopes = np.zeros((n, 7), dtype=np.uint32)
    accs = np.zeros((n, 14), dtype=np.uint32)
    x1, y1 = [int(v) for v in start[0]], [int(v) for v in start[1]]
    for i, (x2, y2) in enumerate(zip(np.asarray(xs).tolist(), np.asarray(ys).tolist())):
        slope = mul([(b - a) % P for a, b in zip(y1, y2)],
                    inv([(b - a) % P for a, b in zip(x1, x2)]))
        sq = mul(slope, slope)
        x3 = [(s - a - b) % P for s, a, b in zip(sq, x1, x2)]
        y3 = [(v - a) % P for v, a in zip(mul(slope, [(a - b) % P for a, b in zip(x1, x3)]), y1)]
        slopes[i] = slope
        accs[i, :7] = x3
        accs[i, 7:] = y3
        x1, y1 = x3, y3
    return slopes, accs
