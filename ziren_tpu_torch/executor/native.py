"""ctypes bindings for the native (C++) executor — the sequential hot loop
(SURVEY.md §2.1: the emulator must stay on host; native for speed).

`NativeExecutor.run()` produces the same `ExecutionRecord` as the Python
`Executor` (differentially tested in tests/test_native_executor.py).
Builds native/libziren_executor.so on first use if missing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .record import CPU_FIELDS, POS_FIELDS, POSITIONS, ExecutionRecord

_LIB = None
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = os.path.join(_NATIVE_DIR, "libziren_executor.so")
    src = os.path.join(_NATIVE_DIR, "executor.cpp")
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        subprocess.check_call(
            ["g++", "-O2", "-shared", "-fPIC", "-o", so, src]
        )
    lib = ctypes.CDLL(so)
    lib.ziren_exec_new.restype = ctypes.c_void_p
    lib.ziren_exec_new.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int,
    ]
    lib.ziren_exec_add_hint.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32]
    lib.ziren_exec_run.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ziren_exec_error.restype = ctypes.c_char_p
    lib.ziren_exec_error.argtypes = [ctypes.c_void_p]
    lib.ziren_exec_num_cycles.restype = ctypes.c_uint64
    lib.ziren_exec_global_clk.restype = ctypes.c_uint64
    for f in ("num_cycles", "global_clk", "exit_code", "exited", "pc",
              "num_committed", "stdout_len", "pv_stream_len",
              "num_touched"):
        getattr(lib, f"ziren_exec_{f}").argtypes = [ctypes.c_void_p]
    lib.ziren_exec_peek.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.ziren_exec_peek.restype = ctypes.c_uint32
    for f in ("committed", "stdout", "pv_stream", "events", "touched",
              "p2_events",
              "sha_ext_events", "sha_cmp_events", "u256_events",
              "keccak_events"):
        getattr(lib, f"ziren_exec_{f}").argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ziren_exec_keccak_blob_len.argtypes = [ctypes.c_void_p]
    lib.ziren_exec_report_blob_len.argtypes = [ctypes.c_void_p]
    lib.ziren_exec_report_blob.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ziren_exec_num_p2_events.argtypes = [ctypes.c_void_p]
    lib.ziren_exec_num_sha_ext_events.argtypes = [ctypes.c_void_p]
    lib.ziren_exec_num_sha_cmp_events.argtypes = [ctypes.c_void_p]
    lib.ziren_exec_num_u256_events.argtypes = [ctypes.c_void_p]
    lib.ziren_exec_free.argtypes = [ctypes.c_void_p]
    lib.ziren_exec_set_shard_size.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.ziren_exec_num_shards.argtypes = [ctypes.c_void_p]
    lib.ziren_exec_shard_marks.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ziren_exec_shard_blob_len.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.ziren_exec_shard_blob_len.restype = ctypes.c_uint64
    lib.ziren_exec_shard_blob.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p
    ]
    _LIB = lib
    return lib


class NativeExecutor:
    def __init__(self, program, stdin=None, max_cycles=None, mode="trace"):
        self.program = program
        self.lib = _load()
        instrs = np.zeros((len(program.instructions), 6), dtype=np.uint32)
        for i, ins in enumerate(program.instructions):
            instrs[i] = (
                int(ins.opcode), ins.op_a, ins.op_b & 0xFFFFFFFF,
                ins.op_c & 0xFFFFFFFF, int(ins.imm_b), int(ins.imm_c),
            )
        addrs = np.array(sorted(program.image), dtype=np.uint32)
        vals = np.array([program.image[a] & 0xFFFFFFFF for a in addrs], dtype=np.uint32)
        self.h = self.lib.ziren_exec_new(
            instrs.ctypes.data_as(ctypes.c_void_p), len(instrs),
            program.pc_start, program.pc_base,
            addrs.ctypes.data_as(ctypes.c_void_p),
            vals.ctypes.data_as(ctypes.c_void_p), len(addrs),
            1 if mode == "trace" else 0,
        )
        self._keepalive = (instrs, addrs, vals)
        for buf in stdin or []:
            b = bytes(buf)
            self.lib.ziren_exec_add_hint(self.h, b, len(b))
        self.max_cycles = max_cycles or 0
        self.record = None

    def run(self) -> ExecutionRecord:
        rc = self.lib.ziren_exec_run(self.h, self.max_cycles)
        if rc != 0:
            raise RuntimeError(
                self.lib.ziren_exec_error(self.h).decode(errors="replace")
            )
        lib, h = self.lib, self.h
        n = lib.ziren_exec_num_cycles(h)
        events = np.zeros((n, 46), dtype=np.int64)
        if n:
            lib.ziren_exec_events(h, events.ctypes.data_as(ctypes.c_void_p))
        record = ExecutionRecord(self.program)
        frozen = {}
        for j, f in enumerate(CPU_FIELDS):
            frozen[f] = events[:, j].copy()
        off = len(CPU_FIELDS)
        for p_i, p in enumerate(POSITIONS):
            for f_i, f in enumerate(POS_FIELDS):
                frozen[f"{p}_{f}"] = events[:, off + p_i * 7 + f_i].copy()
        record._frozen = frozen
        # touched addresses -> init/final events, sorted by address
        nt = lib.ziren_exec_num_touched(h)
        touched = np.zeros((nt, 5), dtype=np.uint32)
        if nt:
            lib.ziren_exec_touched(h, touched.ctypes.data_as(ctypes.c_void_p))
            touched = touched[np.argsort(touched[:, 0], kind="stable")]
        # poseidon2 precompile events
        np2 = lib.ziren_exec_num_p2_events(h)
        if np2:
            rows = np.zeros((np2, 163), dtype=np.uint32)
            lib.ziren_exec_p2_events(h, rows.ctypes.data_as(ctypes.c_void_p))
            evs = []
            for r in rows:
                ev = {"shard": int(r[0]), "clk": int(r[1]), "ptr": int(r[2]),
                      "reads": [], "writes": []}
                for k in range(16):
                    f = r[3 + k * 5 : 8 + k * 5]
                    ev["reads"].append((int(f[0]), int(f[1]), int(f[2]), int(f[3])))
                for k in range(16):
                    f = r[83 + k * 5 : 88 + k * 5]
                    ev["writes"].append(
                        (int(f[0]), int(f[1]), int(f[2]), int(f[3]), int(f[4]))
                    )
                evs.append(ev)
            record.precompile_events[0x00010030] = evs
        nsha = lib.ziren_exec_num_sha_ext_events(h)
        if nsha:
            rows = np.zeros((nsha, 29), dtype=np.uint32)
            lib.ziren_exec_sha_ext_events(h, rows.ctypes.data_as(ctypes.c_void_p))
            evs = []
            for r in rows:
                ev = {"shard": int(r[0]), "clk": int(r[1]), "ptr": int(r[2]),
                      "i": int(r[3]), "reads": [], "write": None}
                for k in range(4):
                    f = r[4 + k * 5 : 9 + k * 5]
                    ev["reads"].append((int(f[0]), int(f[1]), int(f[2]), int(f[3])))
                f = r[24:29]
                ev["write"] = (int(f[0]), int(f[1]), int(f[2]), int(f[3]), int(f[4]))
                evs.append(ev)
            record.precompile_events[0x30010005] = evs
        ncmp = lib.ziren_exec_num_sha_cmp_events(h)
        if ncmp:
            rows = np.zeros((ncmp, 404), dtype=np.uint32)
            lib.ziren_exec_sha_cmp_events(h, rows.ctypes.data_as(ctypes.c_void_p))
            evs = []
            for r in rows:
                ev = {"shard": int(r[0]), "clk": int(r[1]), "w_ptr": int(r[2]),
                      "h_ptr": int(r[3]), "h_reads": [], "w_reads": [],
                      "h_writes": []}
                off = 4
                for k in range(8):
                    f = r[off : off + 5]
                    ev["h_reads"].append((int(f[0]), int(f[1]), int(f[2]), int(f[3])))
                    off += 5
                for k in range(64):
                    f = r[off : off + 5]
                    ev["w_reads"].append((int(f[0]), int(f[1]), int(f[2]), int(f[3])))
                    off += 5
                for k in range(8):
                    f = r[off : off + 5]
                    ev["h_writes"].append(
                        (int(f[0]), int(f[1]), int(f[2]), int(f[3]), int(f[4]))
                    )
                    off += 5
                evs.append(ev)
            record.precompile_events[0x01010006] = evs
        kb_len = lib.ziren_exec_keccak_blob_len(h)
        if kb_len:
            blob = np.zeros(kb_len, dtype=np.uint32)
            lib.ziren_exec_keccak_events(h, blob.ctypes.data_as(ctypes.c_void_p))
            from .keccak import keccakf

            evs, off = [], 0
            while off < kb_len:
                shard_, clk_, iptr, rptr, n_u32 = (int(x) for x in blob[off:off + 5])
                off += 5

                def acc5():
                    nonlocal off
                    f = blob[off:off + 5]
                    off += 5
                    return tuple(int(x) for x in f)

                lr = acc5()
                ev = {"shard": shard_, "clk": clk_, "input_ptr": iptr,
                      "result_ptr": rptr, "len_read": lr[:4], "reads": [],
                      "writes": [], "input": [], "xored_states": []}
                for _ in range(n_u32):
                    f = acc5()
                    ev["reads"].append(f[:4])
                    ev["input"].append(f[1])
                for _ in range(16):
                    ev["writes"].append(acc5())
                lanes = [
                    ev["input"][2 * i] | (ev["input"][2 * i + 1] << 32)
                    for i in range(n_u32 // 2)
                ]
                state = [0] * 25
                for blk in range(n_u32 // 36):
                    for i in range(18):
                        state[i] ^= lanes[18 * blk + i]
                    ev["xored_states"].append(list(state))
                    state = keccakf(state)
                evs.append(ev)
            record.precompile_events[0x01010009] = evs
        nu256 = lib.ziren_exec_num_u256_events(h)
        if nu256:
            rows = np.zeros((nu256, 124), dtype=np.uint32)
            lib.ziren_exec_u256_events(h, rows.ctypes.data_as(ctypes.c_void_p))
            evs = []
            for r in rows:
                ev = {"shard": int(r[0]), "clk": int(r[1]), "x_ptr": int(r[2]),
                      "y_ptr": int(r[3]), "reads": [], "writes": []}
                for k in range(16):
                    f = r[4 + k * 5 : 9 + k * 5]
                    ev["reads"].append((int(f[0]), int(f[1]), int(f[2]), int(f[3])))
                for k in range(8):
                    f = r[84 + k * 5 : 89 + k * 5]
                    ev["writes"].append(
                        (int(f[0]), int(f[1]), int(f[2]), int(f[3]), int(f[4]))
                    )
                evs.append(ev)
            record.precompile_events[0x0101001D] = evs
        record.mem_init = [(int(r[0]), int(r[1])) for r in touched]
        record.mem_final = [
            (int(r[0]), int(r[2]), int(r[3]), int(r[4])) for r in touched
        ]
        # single-shard endpoint maps (MemoryLocal chip): first access sees
        # the pre-execution state, the final state comes from the touch export
        record.shard_initial = {int(r[0]): (0, 0, int(r[1])) for r in touched}
        record.shard_final = {
            int(r[0]): (int(r[2]), int(r[3]), int(r[4])) for r in touched
        }
        # report blob: cycle tracker + opcode/syscall histograms
        rb_len = lib.ziren_exec_report_blob_len(h)
        self.cycle_tracker = {}
        self.report = {"opcode_counts": {}, "syscall_counts": {}}
        if rb_len:
            buf = ctypes.create_string_buffer(rb_len)
            lib.ziren_exec_report_blob(h, buf)
            for line in buf.raw.decode().splitlines():
                kind, key, val = line.split(" ")
                if kind == "T":
                    self.cycle_tracker[key] = int(val)
                elif kind == "O":
                    self.report["opcode_counts"][int(key)] = int(val)
                else:
                    self.report["syscall_counts"][int(key)] = int(val)
        # public values
        pv = record.public_values
        pv.start_pc = self.program.pc_start
        pv.next_pc = lib.ziren_exec_pc(h)
        from .split import ensure_zero_address, set_last_memory_bits

        ensure_zero_address(record)
        set_last_memory_bits(record)
        pv.exit_code = lib.ziren_exec_exit_code(h)
        pv.shard = 1
        pv.execution_shard = 1
        nc = lib.ziren_exec_num_committed(h)
        committed = np.zeros(nc, dtype=np.uint32)
        if nc:
            lib.ziren_exec_committed(h, committed.ctypes.data_as(ctypes.c_void_p))
        self.committed_values = [int(x) for x in committed]
        pv.committed_value_digest = (
            self.committed_values[:8] + [0] * max(0, 8 - nc)
        )
        np_len = lib.ziren_exec_pv_stream_len(h)
        pv_stream = np.zeros(max(np_len, 1), dtype=np.uint8)
        if np_len:
            lib.ziren_exec_pv_stream(h, pv_stream.ctypes.data_as(ctypes.c_void_p))
        self.public_values_stream = bytearray(pv_stream.tobytes()[:np_len])
        ns = lib.ziren_exec_stdout_len(h)
        out = np.zeros(ns, dtype=np.uint8)
        if ns:
            lib.ziren_exec_stdout(h, out.ctypes.data_as(ctypes.c_void_p))
        self.stdout = bytes(out.tobytes())
        self.global_clk = lib.ziren_exec_global_clk(h)
        self.exited = bool(lib.ziren_exec_exited(h))
        self.exit_code = pv.exit_code
        self.record = record
        return record

    def run_sharded(self, shard_size: int) -> list:
        """Execute with continuation sharding in C++ (clk reset per shard,
        branch+delay-slot kept together) and split the columnar record into
        per-shard ExecutionRecords — bit-exact vs the python executor's
        run_sharded (differential-tested)."""
        assert shard_size
        lib, h = self.lib, self.h
        lib.ziren_exec_set_shard_size(h, int(shard_size))
        full = self.run()
        n_shards = lib.ziren_exec_num_shards(h)
        marks = np.zeros((n_shards, 3), dtype=np.uint64)
        lib.ziren_exec_shard_marks(h, marks.ctypes.data_as(ctypes.c_void_p))

        frozen = full.freeze()
        records = []
        lo = 0
        for i in range(n_shards):
            end, start_pc, next_pc = (int(v) for v in marks[i])
            rec = ExecutionRecord(self.program)
            rec._frozen = {k: v[lo:end] for k, v in frozen.items()}
            # per-shard precompile events (events carry their shard id)
            for sid, evs in full.precompile_events.items():
                mine = [ev for ev in evs if ev["shard"] == i + 1]
                if mine:
                    rec.precompile_events[sid] = mine
            # per-shard memory endpoints (MemoryLocal / Global chips)
            blen = lib.ziren_exec_shard_blob_len(h, i)
            blob = np.zeros(max(int(blen), 1), dtype=np.uint32)
            if blen:
                lib.ziren_exec_shard_blob(
                    h, i, blob.ctypes.data_as(ctypes.c_void_p)
                )
            blob = blob[: int(blen)].reshape(-1, 7)
            rec.shard_initial = {
                int(r[0]): (int(r[1]), int(r[2]), int(r[3])) for r in blob
            }
            rec.shard_final = {
                int(r[0]): (int(r[4]), int(r[5]), int(r[6])) for r in blob
            }
            pv = rec.public_values
            pv.start_pc = start_pc
            pv.next_pc = next_pc
            pv.shard = i + 1
            pv.execution_shard = i + 1
            pv.exit_code = full.public_values.exit_code
            pv.committed_value_digest = list(
                full.public_values.committed_value_digest
            )
            rec.deferred_proof_claims = (
                list(full.deferred_proof_claims) if i == 0 else []
            )
            records.append(rec)
            lo = end
        # memory init/finalize events land in the last record, then the
        # split pass redistributes them (bit-exact vs the python executor:
        # both run the same post-pass)
        records[-1].mem_init = full.mem_init
        records[-1].mem_final = full.mem_final
        from .split import finalize_memory

        self.records = finalize_memory(records)
        return self.records

    def peek_register(self, reg: int) -> int:
        return int(self.lib.ziren_exec_peek(self.h, reg))

    def peek_word(self, addr: int) -> int:
        return int(self.lib.ziren_exec_peek(self.h, addr))

    def __del__(self):
        try:
            self.lib.ziren_exec_free(self.h)
        except Exception:
            pass
