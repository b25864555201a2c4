"""ProgramChip: preprocessed instruction ROM + execution multiplicities
(reference: crates/core/machine/src/program/)."""

from __future__ import annotations

import numpy as np

from ..stark.chip import Air
from ..stark.lookup import LookupKind
from .layout import Layout, pad_to_pow2, word_decompose_np
from .messages import program_message

PREP = (
    Layout()
    .add("pc")
    .add("opcode")
    .add("op_a")
    .add("op_a_0")
    .word("op_b")
    .word("op_c")
    .add("imm_b")
    .add("imm_c")
)
MAIN = Layout().add("mult")


class ProgramChip(Air):
    COLS = MAIN  # picus layout resolution
    picus_inputs = ("mult",)  # fetch multiplicity is free
    picus_outputs = ()
    name = "Program"
    width = MAIN.width
    preprocessed_width = PREP.width
    local_only = True

    def generate_preprocessed(self, program):
        n = len(program.instructions)
        w = PREP.writer(max(4, 1 << (max(n, 1) - 1).bit_length()))
        pcs = program.pc_base + 4 * np.arange(n, dtype=np.uint32)
        w.mat[:n, PREP.idx("pc")] = pcs
        w.mat[:n, PREP.idx("opcode")] = [int(i.opcode) for i in program.instructions]
        w.mat[:n, PREP.idx("op_a")] = [i.op_a for i in program.instructions]
        w.mat[:n, PREP.idx("op_a_0")] = [int(i.op_a == 0) for i in program.instructions]
        opb = word_decompose_np([i.op_b for i in program.instructions])
        opc = word_decompose_np([i.op_c for i in program.instructions])
        w.mat[:n, PREP.slc("op_b")] = opb
        w.mat[:n, PREP.slc("op_c")] = opc
        w.mat[:n, PREP.idx("imm_b")] = [int(i.imm_b) for i in program.instructions]
        w.mat[:n, PREP.idx("imm_c")] = [int(i.imm_c) for i in program.instructions]
        return w.mat

    def num_rows(self, record):
        return len(record.program.instructions)

    def generate_trace(self, record, output):
        n = len(record.program.instructions)
        height = max(4, 1 << (max(n, 1) - 1).bit_length())
        mat = np.zeros((height, 1), dtype=np.uint32)
        idx = record.freeze()["instr_idx"]
        counts = np.bincount(idx, minlength=n)
        mat[:n, 0] = counts.astype(np.uint32)
        return mat

    def eval(self, b):
        prep = PREP.view(b.prep_local)
        main = MAIN.view(b.main_local)
        b.receive(
            LookupKind.Program,
            program_message(
                prep["pc"],
                prep["opcode"],
                prep["op_a"],
                prep["op_a_0"],
                prep.word("op_b"),
                prep.word("op_c"),
                prep["imm_b"],
                prep["imm_c"],
            ),
            main["mult"],
        )
