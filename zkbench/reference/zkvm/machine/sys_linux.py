"""SysLinuxChip: one chip for the whole Linux O32 ABI syscall family
(reference: crates/core/machine/src/syscall/precompiles/sys_linux/air.rs —
same decode-and-branch structure, rebuilt on this engine's gadgets).

One row per LinuxEvent. The dispatch message carries the actual Linux
syscall number plus the a0/a1 argument words and the v0 result word:

    [shard, clk, SYS_LINUX, code, a0 word (4), a1 word (4), v0 word (4)]

The chip one-hot decodes `code` over every recognized number (including the
nop'd set), evaluates the per-variant result semantics, and performs the
register accesses: an A3 errno write on every row, plus a shared `io`
access used as BRK read (brk), A2 read (write) or HEAP write (mmap with
a0 == 0). SYS_EXT_GROUP's halt semantics (next_pc = 0, exit code binding)
live in the SyscallChip's `is_linux_exit` flag, not here.
"""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import SyscallCode
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, send_byte
from .layout import Layout, pack_word, trace_height, word_decompose_np
from .memory_access import add_access_cols, eval_access
from .weierstrass import _WeierstrassBase

EBADF = 9

# (flag name, linux code); the first eight have bespoke semantics, the rest nop
VARIANTS = [
    ("brk", 4045),
    ("mmap", 4090),
    ("mmap4210", 4210),
    ("clone", 4120),
    ("exitg", 4246),
    ("read", 4003),
    ("write", 4004),
    ("fcntl", 4055),
    ("nop_open", 4005),
    ("nop_close", 4006),
    ("nop_nanosleep", 4166),
    ("nop_sigaction", 4194),
    ("nop_sigprocmask", 4195),
    ("nop_madvise", 4218),
    ("nop_gettid", 4222),
    ("nop_affinity", 4240),
    ("nop_clockgettime", 4263),
]

COLS = Layout().add("shard").add("clk").add("code").add("is_real")
COLS.word("a0").word("a1").word("v0")
for nm, _ in VARIANTS:
    COLS.add(f"f_{nm}")
add_access_cols(COLS, "err", write=True)  # A3 errno write
add_access_cols(COLS, "io", write=True)  # BRK read / A2 read / HEAP write
# brk compare: one-hot most significant byte where a0 differs from brk
COLS.add("gt").add("gt_df", 4).add("gt_sa").add("gt_sb")
# mmap: a1 byte-1 nibbles, page-offset iszero, heap adder carries
COLS.add("n_lo", 4).add("n_hi", 4)
COLS.add("off_inv").add("off_zero")
COLS.add("a0z_inv").add("a0z")  # a0 == 0
COLS.add("hk", 8)  # heap add carries, 2 bool each per byte
# fcntl / read decoders
COLS.add("a1_1_inv").add("a1_1")
COLS.add("a1_3_inv").add("a1_3")
COLS.add("a0_1_inv").add("a0_1")
COLS.add("a0_2_inv").add("a0_2")
COLS.add("bad")  # composite: this row returns EBADF / v0 = 0xFFFFFFFF
COLS.add("fc_ok1")  # fcntl GETFD ok (a0 in {0,1,2})
COLS.add("io_mult").add("io_addr")  # committed so lookup messages stay deg-1


def _iszero_fill(row, layout, prefix_inv, prefix_z, value, p=2130706433):
    v = int(value) % p
    if v == 0:
        row[layout.idx(prefix_z)] = 1
    else:
        row[layout.idx(prefix_inv)] = pow(v, p - 2, p)


def _iszero_eval(b_, L, inv_nm, z_nm, value_expr, is_real):
    """z = 1 iff value == 0 (gated by is_real; padding rows free)."""
    z = L[z_nm]
    inv = L[inv_nm]
    b_.assert_bool(z)
    b_.assert_zero(is_real * (1 - z - value_expr * inv))
    b_.assert_zero(value_expr * z)
    return z


class SysLinuxChip(_WeierstrassBase):
    picus_inputs = ("shard", "clk", "code", "a0", "a1", "is_real")
    picus_outputs = ("v0",) + tuple(f"f_{nm}" for nm, _ in VARIANTS)
    name = "SysLinux"
    SYSCALL = int(SyscallCode.SYS_LINUX)
    COLS = COLS
    width = COLS.width

    def _events(self, record):
        return record.precompile_events.get(int(SyscallCode.SYS_LINUX), [])

    def generate_dependencies(self, record, output):
        for ev in self._events(record):
            clk = ev["clk"]
            self._deps_accesses(
                record, ev,
                [(clk, a) for a in ev["reads"]] + [(clk, a) for a in ev["writes"]],
            )
            code = ev["syscall_code"]
            if code == 4045:
                a0b = word_decompose_np(np.array([ev["a0"]], dtype=np.int64))[0]
                brkb = word_decompose_np(
                    np.array([ev["reads"][0][1]], dtype=np.int64)
                )[0]
                for k in (3, 2, 1, 0):
                    if a0b[k] != brkb[k]:
                        if ev["a0"] > ev["reads"][0][1]:
                            count(record, B.LTU, np.array([brkb[k]]), a0b[k])
                        else:
                            count(record, B.LTU, np.array([a0b[k]]), brkb[k])
                        break

    def _row_fill(self, row, ev, shard, record=None):
        C = COLS
        code = ev["syscall_code"]
        row[C.idx("shard")] = shard
        row[C.idx("clk")] = ev["clk"]
        row[C.idx("code")] = code
        row[C.idx("is_real")] = 1
        a0, a1, v0 = ev["a0"], ev["a1"], ev["v0"]
        row[C.slc("a0")] = word_decompose_np(np.array([a0], dtype=np.int64))[0]
        row[C.slc("a1")] = word_decompose_np(np.array([a1], dtype=np.int64))[0]
        row[C.slc("v0")] = word_decompose_np(np.array([v0], dtype=np.int64))[0]
        matched = False
        for nm, c in VARIANTS:
            if c == code:
                row[C.idx(f"f_{nm}")] = 1
                matched = True
        assert matched, f"unknown linux syscall {code}"
        # errno is the A3 (addr 7) write
        err = next(w for w in ev["writes"] if w[0] == 7)
        self._fill_access(row, C, "err", err, ev["clk"], shard, True)
        io = None
        if code == 4045:
            io = ("r", ev["reads"][0])
        elif code == 4004:
            io = ("r", ev["reads"][0])
        elif code in (4090, 4210) and a0 == 0:
            io = ("w", next(w for w in ev["writes"] if w[0] == 35))
        if io is not None:
            kind, acc = io
            if kind == "r":
                acc5 = (acc[0], acc[1], acc[2], acc[3], acc[1])
            else:
                acc5 = acc
            self._fill_access(row, C, "io", acc5, ev["clk"], shard, True)
            row[C.idx("io_mult")] = 1
            row[C.idx("io_addr")] = acc5[0]
        # brk compare witness
        if code == 4045:
            brk = ev["reads"][0][1]
            gt = 1 if a0 > brk else 0
            row[C.idx("gt")] = gt
            a0b = word_decompose_np(np.array([a0], dtype=np.int64))[0]
            brkb = word_decompose_np(np.array([brk], dtype=np.int64))[0]
            for k in (3, 2, 1, 0):
                if a0b[k] != brkb[k]:
                    row[C.slc("gt_df")][k] = 1
                    lo, hi = (brkb[k], a0b[k]) if gt else (a0b[k], brkb[k])
                    row[C.idx("gt_sa")] = lo
                    row[C.idx("gt_sb")] = hi
                    break
        # mmap witnesses
        if code in (4090, 4210):
            c1 = (a1 >> 8) & 0xFF
            lo4, hi4 = c1 & 0xF, c1 >> 4
            for k in range(4):
                row[C.slc("n_lo")][k] = (lo4 >> k) & 1
                row[C.slc("n_hi")][k] = (hi4 >> k) & 1
            off = a1 & 0xFFF
            _iszero_fill(row, C, "off_inv", "off_zero", off)
            a0_bytes = sum((a0 >> (8 * k)) & 0xFF for k in range(4))
            _iszero_fill(row, C, "a0z_inv", "a0z", a0_bytes)
            if a0 == 0:
                heap_prev = next(w for w in ev["writes"] if w[0] == 35)[1]
                size = a1 if off == 0 else (a1 + 0x1000 - off) & 0xFFFFFFFF
                heap_new = (heap_prev + size) & 0xFFFFFFFF
                # byte adder carries: new + 2^32 ovf = prev + R
                pb = word_decompose_np(np.array([heap_prev], dtype=np.int64))[0]
                nb = word_decompose_np(np.array([heap_new], dtype=np.int64))[0]
                rb = [0, 16 * hi4 + (16 if off else 0), (a1 >> 16) & 0xFF,
                      (a1 >> 24) & 0xFF]
                k_prev = 0
                for i in range(4):
                    tot = int(pb[i]) + rb[i] + k_prev
                    k = (tot - int(nb[i])) // 256
                    assert 0 <= k <= 2 and int(nb[i]) == tot - 256 * k
                    row[C.slc("hk")][2 * i] = 1 if k >= 1 else 0
                    row[C.slc("hk")][2 * i + 1] = 1 if k >= 2 else 0
                    k_prev = k
        # fcntl / read decoders
        if code in (4055, 4003):
            a0_bytes = sum((a0 >> (8 * k)) & 0xFF for k in range(4))
            _iszero_fill(row, C, "a0z_inv", "a0z", a0_bytes)
        if code == 4055:
            _iszero_fill(row, C, "a1_1_inv", "a1_1", (a1 - 1))
            _iszero_fill(row, C, "a1_3_inv", "a1_3", (a1 - 3))
            _iszero_fill(row, C, "a0_1_inv", "a0_1", (a0 - 1))
            _iszero_fill(row, C, "a0_2_inv", "a0_2", (a0 - 2))
            ok3 = a1 == 3 and a0 in (0, 1, 2)
            ok1 = a1 == 1 and a0 in (0, 1, 2)
            row[C.idx("fc_ok1")] = 1 if ok1 else 0
            row[C.idx("bad")] = 0 if (ok3 or ok1) else 1
        if code == 4003:
            row[C.idx("bad")] = 0 if a0 == 0 else 1
        return row

    def generate_trace(self, record, output):
        events = self._events(record)
        n = len(events)
        height = trace_height(n)
        mat = np.zeros((height, COLS.width), dtype=np.uint32)
        for r_i, ev in enumerate(events):
            self._row_fill(mat[r_i], ev, ev["shard"], record)
        return mat

    def eval(self, b_):
        C = COLS
        L = C.view(b_.main_local)
        is_real = L["is_real"]
        b_.assert_bool(is_real)
        a0w, a1w, v0w = L.word("a0"), L.word("a1"), L.word("v0")
        # canonical dispatch + result linkage from the SyscallPrecompile
        # bridge (reference: sys_linux/air.rs receive_syscall +
        # receive_syscall_result)
        b_.receive(
            LookupKind.Syscall,
            [L["shard"], L["clk"], L["code"], pack_word(a0w), pack_word(a1w)],
            is_real,
        )
        halves = lambda wd: (wd[0] + wd[1] * 256, wd[2] + wd[3] * 256)
        v0_lo, v0_hi = halves(v0w)
        a0_lo, a0_hi = halves(a0w)
        a1_lo, a1_hi = halves(a1w)
        b_.receive(
            LookupKind.SyscallResult,
            [L["shard"], L["clk"], v0_lo, v0_hi, a0_lo, a0_hi, a1_lo, a1_hi],
            is_real,
        )
        flags = {nm: L[f"f_{nm}"] for nm, _ in VARIANTS}
        acc = 0
        code_sum = 0
        for nm, c in VARIANTS:
            b_.assert_bool(flags[nm])
            acc = flags[nm] + acc
            code_sum = flags[nm] * c + code_sum
        b_.assert_eq(acc, is_real)
        b_.assert_eq(L["code"], code_sum)
        is_brk = flags["brk"]
        is_mmap = flags["mmap"] + flags["mmap4210"]
        is_clone = flags["clone"]
        is_exit = flags["exitg"]
        is_read = flags["read"]
        is_write = flags["write"]
        is_fcntl = flags["fcntl"]
        is_nop = is_real - (is_brk + is_mmap + is_clone + is_exit + is_read
                            + is_write + is_fcntl)
        a0 = pack_word(a0w)
        a1 = pack_word(a1w)

        # errno write at A3 (addr 7) on every real row; value = 9 * bad
        bad = L["bad"]
        b_.assert_bool(bad)
        eval_access(b_, L, "err", L["shard"], L["clk"], 7, is_real, write=True)
        errv = L.word("err_value")
        b_.when(is_real).assert_eq(errv[0], EBADF * bad)
        for j in (1, 2, 3):
            b_.when(is_real).assert_zero(errv[j])
        # bad only arises from fcntl/read failures
        b_.assert_zero(bad * (1 - is_fcntl - is_read))

        # shared io access: BRK read (brk) / A2 read (write) / HEAP write
        a0z = _iszero_eval(b_, L, "a0z_inv", "a0z",
                           a0w[0] + a0w[1] + a0w[2] + a0w[3],
                           is_mmap + is_fcntl + is_read)
        # committed io mult/addr keep the memory lookup messages degree-1
        io_mult = L["io_mult"]
        io_addr = L["io_addr"]
        b_.assert_bool(io_mult)
        b_.assert_eq(io_mult, is_brk + is_write + is_mmap * a0z)
        b_.assert_eq(
            io_addr, is_brk * 34 + is_write * 6 + is_mmap * a0z * 35
        )
        eval_access(b_, L, "io", L["shard"], L["clk"], io_addr,
                    io_mult, write=True)
        iov = L.word("io_value")
        iopv = L.word("io_prev_value")
        # reads leave the value unchanged
        for j in range(4):
            b_.assert_zero((is_brk + is_write) * (iov[j] - iopv[j]))

        # ── brk: v0 = max(a0, brk) ─────────────────────────────────────
        gt = L["gt"]
        b_.assert_bool(gt)
        b_.assert_zero((1 - is_brk) * gt)
        df = L["gt_df"]
        dacc = 0
        for k in range(4):
            b_.assert_bool(df[k])
            dacc = df[k] + dacc
        b_.assert_bool(dacc)
        b_.assert_zero((1 - is_brk) * dacc)
        b_.assert_zero(gt * (1 - dacc))  # strict > needs a differing byte
        # bytes above the flagged byte are equal; if no diff, all equal
        for k in range(4):
            for j in range(k + 1, 4):
                b_.assert_zero(df[k] * (a0w[j] - iopv[j]))
        for j in range(4):
            b_.assert_zero(is_brk * (1 - dacc) * (a0w[j] - iopv[j]))
        sa, sb = L["gt_sa"], L["gt_sb"]
        sel_a0 = sum(df[k] * a0w[k] for k in range(4))
        sel_bk = sum(df[k] * iopv[k] for k in range(4))
        b_.assert_zero(gt * (sa - sel_bk) + (dacc - gt) * (sa - sel_a0))
        b_.assert_zero(gt * (sb - sel_a0) + (dacc - gt) * (sb - sel_bk))
        send_byte(b_, B.LTU, sa, sb, 1, dacc)
        for j in range(4):
            b_.assert_zero(
                is_brk * (v0w[j] - (gt * a0w[j] + (1 - gt) * iopv[j]))
            )

        # ── mmap: page-round a1, bump HEAP when a0 == 0 ───────────────
        n_lo, n_hi = L["n_lo"], L["n_hi"]
        lo4 = 0
        hi4 = 0
        for k in range(4):
            b_.assert_bool(n_lo[k])
            b_.assert_bool(n_hi[k])
            lo4 = n_lo[k] * (1 << k) + lo4
            hi4 = n_hi[k] * (1 << k) + hi4
        b_.assert_zero(is_mmap * (a1w[1] - (lo4 + 16 * hi4)))
        page_off = a1w[0] + 256 * lo4
        off0 = _iszero_eval(b_, L, "off_inv", "off_zero", page_off, is_mmap)
        # v0: heap_prev when a0 == 0 else a0
        for j in range(4):
            b_.assert_zero(is_mmap * a0z * (v0w[j] - iopv[j]))
            b_.assert_zero(is_mmap * (1 - a0z) * (v0w[j] - a0w[j]))
        # heap_new = heap_prev + rounded(a1), byte adder with carries
        hk = L["hk"]
        for k in range(8):
            b_.assert_bool(hk[k])
        r_bytes = [0, 16 * hi4 + 16 * (1 - off0), a1w[2], a1w[3]]
        k_prev = 0
        for i in range(4):
            k_cur = hk[2 * i] + hk[2 * i + 1]
            b_.assert_zero(
                is_mmap * a0z
                * (iov[i] + 256 * k_cur - iopv[i] - r_bytes[i] - k_prev)
            )
            k_prev = k_cur

        # ── clone / exit / nop results ────────────────────────────────
        b_.assert_zero(is_clone * (v0w[0] - 1))
        for j in (1, 2, 3):
            b_.assert_zero(is_clone * v0w[j])
        for j in range(4):
            b_.assert_zero((is_exit + is_nop) * v0w[j])

        # ── read: v0 = 0 (stdin) or -1 ────────────────────────────────
        b_.assert_zero(is_read * (bad - (1 - a0z)))
        for j in range(4):
            b_.assert_zero(is_read * (v0w[j] - bad * 255))

        # ── write: v0 = A2 value ──────────────────────────────────────
        for j in range(4):
            b_.assert_zero(is_write * (v0w[j] - iov[j]))

        # ── fcntl ─────────────────────────────────────────────────────
        a1_1 = _iszero_eval(b_, L, "a1_1_inv", "a1_1", a1 - 1, is_fcntl)
        a1_3 = _iszero_eval(b_, L, "a1_3_inv", "a1_3", a1 - 3, is_fcntl)
        a0_1 = _iszero_eval(b_, L, "a0_1_inv", "a0_1", a0 - 1, is_fcntl)
        a0_2 = _iszero_eval(b_, L, "a0_2_inv", "a0_2", a0 - 2, is_fcntl)
        fd_ok = a0z + a0_1 + a0_2  # a0 in {0, 1, 2} (mutually exclusive)
        fc_ok1 = L["fc_ok1"]
        b_.assert_bool(fc_ok1)
        b_.assert_zero(is_fcntl * (fc_ok1 - a1_1 * fd_ok))
        # bad = not ((a1==3 and fd ok) or (a1==1 and fd ok))
        b_.assert_zero(is_fcntl * (1 - bad - a1_3 * fd_ok - fc_ok1))
        # v0: GETFL -> 0/1 by fd; GETFD -> a0; else 0xFFFFFFFF
        b_.assert_zero(
            is_fcntl * (v0w[0] - (a1_3 * (a0_1 + a0_2) + fc_ok1 * a0w[0]
                                  + bad * 255))
        )
        for j in (1, 2, 3):
            b_.assert_zero(is_fcntl * (v0w[j] - bad * 255))