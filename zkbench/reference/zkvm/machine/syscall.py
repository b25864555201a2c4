"""SyscallChip: SYSCALL instruction semantics for the zkVM syscalls
(HALT / WRITE / COMMIT / HINT_LEN / HINT_READ)
(reference: crates/core/machine/src/syscall/instructions).

The syscall id is the V0 value read at operand A (prev_a). Hint values are
deliberately unconstrained witness data; COMMIT binds the public-value
digest word; HALT pins next_pc = 0 and exit code 0.
"""

from __future__ import annotations

import numpy as np

from ..executor.opcode import ByteOpcode as B
from ..executor.opcode import Opcode, SyscallCode
from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .byte import count, send_byte
from .layout import Layout, pad_to_pow2, word_decompose_np
from .messages import PV_DIGEST, PV_DEFERRED, PV_EXIT_CODE, instruction_message
from .synthetic import count_rows

CODES = [
    ("is_halt", int(SyscallCode.HALT)),
    ("is_write", int(SyscallCode.WRITE)),
    ("is_commit", int(SyscallCode.COMMIT)),
    ("is_hintlen", int(SyscallCode.SYSHINTLEN)),
    ("is_hintread", int(SyscallCode.SYSHINTREAD)),
    ("is_poseidon2", int(SyscallCode.POSEIDON2_PERMUTE)),
    ("is_sha_extend", int(SyscallCode.SHA_EXTEND)),
    ("is_sha_compress", int(SyscallCode.SHA_COMPRESS)),
    ("is_commit_deferred", int(SyscallCode.COMMIT_DEFERRED_PROOFS)),
    ("is_uint256_mul", int(SyscallCode.UINT256_MUL)),
    ("is_keccak", int(SyscallCode.KECCAK_SPONGE)),
    ("is_ec_add", int(SyscallCode.SECP256K1_ADD)),
    ("is_ec_double", int(SyscallCode.SECP256K1_DOUBLE)),
    ("is_r1_add", int(SyscallCode.SECP256R1_ADD)),
    ("is_r1_double", int(SyscallCode.SECP256R1_DOUBLE)),
    ("is_bn_add", int(SyscallCode.BN254_ADD)),
    ("is_bn_double", int(SyscallCode.BN254_DOUBLE)),
    ("is_ed_add", int(SyscallCode.ED_ADD)),
    ("is_ed_decompress", int(SyscallCode.ED_DECOMPRESS)),
    ("is_k1_decompress", int(SyscallCode.SECP256K1_DECOMPRESS)),
    ("is_r1_decompress", int(SyscallCode.SECP256R1_DECOMPRESS)),
    ("is_bls_decompress", int(SyscallCode.BLS12381_DECOMPRESS)),
    ("is_bls_add", int(SyscallCode.BLS12381_ADD)),
    ("is_bls_double", int(SyscallCode.BLS12381_DOUBLE)),
    ("is_u256x2048", int(SyscallCode.U256XU2048_MUL)),
    ("is_linux_exit", int(SyscallCode.SYS_EXT_GROUP)),
    ("is_enter_unc", int(SyscallCode.ENTER_UNCONSTRAINED)),
    ("is_exit_unc", int(SyscallCode.EXIT_UNCONSTRAINED)),
    ("is_verify_proof", int(SyscallCode.VERIFY_ZKM_PROOF)),
    ("is_garble", int(SyscallCode.BOOLEAN_CIRCUIT_GARBLE)),
] + [
    (f"is_fp_{int(c):x}", int(c))
    for c in (
        SyscallCode.BLS12381_FP_ADD, SyscallCode.BLS12381_FP_SUB,
        SyscallCode.BLS12381_FP_MUL, SyscallCode.BLS12381_FP2_ADD,
        SyscallCode.BLS12381_FP2_SUB, SyscallCode.BLS12381_FP2_MUL,
        SyscallCode.BN254_FP_ADD, SyscallCode.BN254_FP_SUB,
        SyscallCode.BN254_FP_MUL, SyscallCode.BN254_FP2_ADD,
        SyscallCode.BN254_FP2_SUB, SyscallCode.BN254_FP2_MUL,
    )
]

EC_ADD_FLAGS = [("is_ec_add", SyscallCode.SECP256K1_ADD),
                ("is_r1_add", SyscallCode.SECP256R1_ADD),
                ("is_bn_add", SyscallCode.BN254_ADD),
                ("is_ed_add", SyscallCode.ED_ADD),
                ("is_bls_add", SyscallCode.BLS12381_ADD),
                ("is_u256x2048", SyscallCode.U256XU2048_MUL)] + [
    (nm, code) for nm, code in CODES if nm.startswith("is_fp_")
]
EC_DOUBLE_FLAGS = [("is_ec_double", SyscallCode.SECP256K1_DOUBLE),
                   ("is_r1_double", SyscallCode.SECP256R1_DOUBLE),
                   ("is_bn_double", SyscallCode.BN254_DOUBLE),
                   ("is_bls_double", SyscallCode.BLS12381_DOUBLE)]

COLS = Layout().add("shard").add("clk")
COLS.add("pc").add("next_pc").add("next_next_pc")
COLS.word("a").word("b").word("c").word("prev_a")
for nm, _ in CODES:
    COLS.add(nm)
COLS.add("commit_word", 8)  # one-hot commit word index
COLS.add("deferred_word", 8)  # one-hot deferred-digest word index
# grouped Linux syscalls (codes 4000..4299 except SYS_EXT_GROUP): the id is
# NOT one-hot decoded here — the SysLinux chip decodes it from the dispatch
COLS.add("is_linux")
COLS.add("lx_d0").add("lx_d1")  # (id - 4000) = d0 + 256 d1, range proof
COLS.add("lx_inv")  # witness: id != SYS_EXT_GROUP on is_linux rows
COLS.add("is_real")


class SyscallChip(Air):
    picus_inputs = ("shard", "clk", "pc", "next_pc", "next_next_pc",
                    "a", "b", "c", "prev_a", "is_real")
    picus_outputs = ("commit_word", "deferred_word", "is_linux", "lx_d0",
                     "lx_d1", "lx_inv")
    name = "SyscallInstrs"
    cycle_chip = True
    width = COLS.width

    def _rows(self, record):
        cols = record.freeze()
        instrs = record.program.instructions
        ops = np.array([int(instrs[i].opcode) for i in cols["instr_idx"]], dtype=np.int64)
        mask = ops == int(Opcode.SYSCALL)
        return cols, mask

    def generate_dependencies(self, record, output):
        cols, mask = self._rows(record)
        sid = cols["prev_a"][mask]
        is_linux = (sid >= 4000) & (sid < 4300) & (sid != 4246)
        d = (sid[is_linux] - 4000).astype(np.int64)
        if d.size:
            count(record, B.U8Range, d & 0xFF, 0)
            hi = d >> 8
            count(record, B.LTU, (d & 0xFF)[hi == 1], 44)

    def num_rows(self, record):
        return count_rows(record, (Opcode.SYSCALL,))

    def generate_trace(self, record, output):
        cols, mask = self._rows(record)
        n = int(mask.sum())
        w = COLS.writer(n)
        w.set("shard", np.full(n, record.public_values.shard))
        w.set("clk", cols["clk"][mask])
        for nm in ("pc", "next_pc", "next_next_pc"):
            w.set(nm, cols[nm][mask])
        for nm in ("a", "b", "c", "prev_a"):
            w.set_word(nm, cols[nm][mask])
        sid = cols["prev_a"][mask]
        for nm, code in CODES:
            w.set(nm, (sid == code).astype(np.uint32))
        is_linux = ((sid >= 4000) & (sid < 4300) & (sid != 4246)).astype(np.int64)
        w.set("is_linux", is_linux)
        d = (sid - 4000) * is_linux
        w.set("lx_d0", d & 0xFF)
        w.set("lx_d1", d >> 8)
        P = 2130706433
        from ..core.field import finv

        inv = finv(((sid - 4246) % P).astype(np.uint32)) * is_linux.astype(
            np.uint32
        )
        w.set("lx_inv", inv)
        cw = np.zeros((n, 8), dtype=np.uint32)
        commit_mask = sid == int(SyscallCode.COMMIT)
        widx = cols["b"][mask]
        for r in np.nonzero(commit_mask)[0]:
            cw[r, int(widx[r])] = 1
        w.set("commit_word", cw)
        dw = np.zeros((n, 8), dtype=np.uint32)
        dmask = sid == int(SyscallCode.COMMIT_DEFERRED_PROOFS)
        for r in np.nonzero(dmask)[0]:
            dw[r, int(widx[r])] = 1
        w.set("deferred_word", dw)
        w.set("is_real", np.ones(n))
        return pad_to_pow2(w.mat)

    def eval(self, b):
        L = COLS.view(b.main_local)
        pv = b.public_values
        is_real = L["is_real"]
        b.assert_bool(is_real)
        is_linux = L["is_linux"]
        flags = [L[nm] for nm, _ in CODES] + [is_linux]
        acc = 0
        for f in flags:
            b.assert_bool(f)
            acc = f + acc
        b.assert_eq(acc, is_real)
        # syscall id binding: prev_a = one-hot combination of known codes
        # (relaxed on grouped-Linux rows, which bind via the range proof)
        prev_a = L.word("prev_a")
        for i in range(4):
            byte_i = sum(
                f * ((code >> (8 * i)) & 0xFF)
                for f, (_, code) in zip(flags, CODES)
            )
            b.assert_zero((1 - is_linux) * (prev_a[i] - byte_i))
        # grouped Linux id: value in [4000, 4300), not SYS_EXT_GROUP
        lvalue = prev_a[0] + prev_a[1] * 256
        b.assert_zero(is_linux * prev_a[2])
        b.assert_zero(is_linux * prev_a[3])
        d0, d1 = L["lx_d0"], L["lx_d1"]
        b.assert_bool(d1)
        b.assert_zero(is_linux * (lvalue - 4000 - d0 - 256 * d1))
        send_byte(b, B.U8Range, d0, 0, 0, is_linux)
        # d1 = 1 requires d0 < 44 so the id stays below 4300
        b.send(LookupKind.Byte, [int(B.LTU), d0, 44, 1], is_linux * d1)
        b.assert_zero(is_linux * ((lvalue - 4246) * L["lx_inv"] - 1))

        is_halt = L["is_halt"]
        is_p2 = L["is_poseidon2"]
        is_sha = L["is_sha_extend"]
        is_shac = L["is_sha_compress"]
        is_u256 = L["is_uint256_mul"]
        is_keccak = L["is_keccak"]
        ec_adds = sum(L[nm] for nm, _ in EC_ADD_FLAGS)
        b.receive(
            LookupKind.Instruction,
            instruction_message(
                L["shard"], L["clk"], L["pc"], L["next_pc"], L["next_next_pc"],
                int(Opcode.SYSCALL),
                L.word("a"), L.word("b"), L.word("c"), prev_a,
                0, is_real, is_real, is_halt + L["is_linux_exit"],
                is_real,  # rw_a=1, chk=1, seq=1; halt-like includes exitgroup
                is_p2 + is_sha * 48 + is_shac + is_u256 + is_keccak + ec_adds,
            ),
            is_real,
        )
        # canonical precompile dispatch (reference: builder.rs send_syscall):
        # ONE local Syscall message [shard, clk, id, arg1, arg2] received by
        # the SyscallCore bridge; the precompile chips receive the matching
        # message from SyscallPrecompile in whichever shard holds the events
        # (machine/syscall_bridge.py)
        from .layout import pack_word

        pc_flags = [(nm, code) for nm, code in CODES
                    if (code >> 16) & 0xFF == 1]
        pre_mult = 0
        pre_id = 0
        for nm, code in pc_flags:
            pre_mult = L[nm] + pre_mult
            pre_id = L[nm] * int(code) + pre_id
        arg1 = pack_word(L.word("b"))
        arg2 = pack_word(L.word("c"))
        b.send(
            LookupKind.Syscall,
            [L["shard"], L["clk"], pre_id, arg1, arg2],
            pre_mult,
        )
        # Linux family: same canonical message with the actual Linux id,
        # plus the result linkage carrying the v0 word in half-words
        # (reference: builder.rs send_syscall_result)
        lx_mult = is_linux + L["is_linux_exit"]
        b.send(
            LookupKind.Syscall,
            [L["shard"], L["clk"], lvalue, arg1, arg2],
            lx_mult,
        )
        halves = lambda wd: (wd[0] + wd[1] * 256, wd[2] + wd[3] * 256)
        a_lo, a_hi = halves(L.word("a"))
        b_lo, b_hi = halves(L.word("b"))
        c_lo, c_hi = halves(L.word("c"))
        b.send(
            LookupKind.SyscallResult,
            [L["shard"], L["clk"], a_lo, a_hi, b_lo, b_hi, c_lo, c_hi],
            lx_mult,
        )

        # HALT / SYS_EXT_GROUP: next_pc = 0, exit code (A0 = b) must be 0
        halt_like = is_halt + L["is_linux_exit"]
        b.when(halt_like).assert_zero(L["next_pc"])
        for i in range(4):
            b.when(halt_like).assert_zero(L.word("b")[i])
        b.when(halt_like).assert_zero(pv[PV_EXIT_CODE])

        # COMMIT: bind pv.committed_value_digest[word_idx] to c
        cw = L["commit_word"]
        acc_cw = 0
        for i in range(8):
            b.assert_bool(cw[i])
            acc_cw = cw[i] + acc_cw
        b.assert_eq(acc_cw, L["is_commit"])
        widx = sum(cw[i] * i for i in range(1, 8))
        bw = L.word("b")
        b.when(L["is_commit"]).assert_eq(bw[0], widx)
        for i in range(1, 4):
            b.when(L["is_commit"]).assert_zero(bw[i])
        for i in range(8):
            for j in range(4):
                b.assert_zero(cw[i] * (pv[PV_DIGEST + 4 * i + j] - L.word("c")[j]))

        # COMMIT_DEFERRED_PROOFS: bind pv.deferred_proofs_digest[idx]
        from .layout import pack_word

        dw = L["deferred_word"]
        acc_dw = 0
        for i in range(8):
            b.assert_bool(dw[i])
            acc_dw = dw[i] + acc_dw
        b.assert_eq(acc_dw, L["is_commit_deferred"])
        didx = sum(dw[i] * i for i in range(1, 8))
        b.when(L["is_commit_deferred"]).assert_eq(bw[0], didx)
        for i in range(1, 4):
            b.when(L["is_commit_deferred"]).assert_zero(bw[i])
        for i in range(8):
            b.assert_zero(dw[i] * (pv[PV_DEFERRED + i] - pack_word(L.word("c"))))
