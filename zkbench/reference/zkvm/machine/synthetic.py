"""Synthetic ALU sub-operations: chips like MiscInstrs (EXT/INS), DivRem and
MaddSub decompose into SLL/SRL/ROR/ADD/SLTU/MULT sub-operations dispatched
through the same Instruction lookup with the sentinel pc UNUSED_PC = 1
(reference: crates/stark/src/air/builder.rs send_alu/send_alu_with_hi)."""

from __future__ import annotations

import numpy as np

UNUSED_PC = 1


def emit(record, opcode, a, b, c, hi=0):
    record.synthetic.setdefault(int(opcode), []).append(
        (int(a) & 0xFFFFFFFF, int(b) & 0xFFFFFFFF, int(c) & 0xFFFFFFFF, int(hi) & 0xFFFFFFFF)
    )


def op_array(record):
    """Per-cycle opcode array, cached on the record (shared by every
    instruction-family chip's trace gen and row counting)."""
    arr = getattr(record, "_op_array", None)
    if arr is None:
        cols = record.freeze()
        instrs = record.program.instructions
        opmap = np.array([int(i.opcode) for i in instrs], dtype=np.int64)
        arr = opmap[cols["instr_idx"]] if len(opmap) else cols["instr_idx"]
        try:
            record._op_array = arr
        except AttributeError:
            pass
    return arr


def count_rows(record, opcodes) -> int:
    """Row count a family chip's trace will have BEFORE padding: real
    cpu rows of `opcodes` plus emitted synthetic sub-operations (the cost
    model — reference core/executor/src/cost.rs)."""
    ops = op_array(record)
    n = int(np.isin(ops, [int(o) for o in opcodes]).sum())
    for op in opcodes:
        n += len(record.synthetic.get(int(op), []))
    return n


def merged_rows(record, opcodes):
    """Real cpu rows for `opcodes` plus synthetic sub-operations.

    Returns a dict of int64 arrays: pc, next_pc, next_next_pc, a, b, c,
    prev_a (carries hi for synthetic rows), opcode; plus n_real.
    """
    cols = record.freeze()
    ops = op_array(record)
    mask = np.isin(ops, [int(o) for o in opcodes])
    keys = ("pc", "next_pc", "next_next_pc", "a", "b", "c", "prev_a")
    out = {k: cols[k][mask].astype(np.int64) for k in keys}
    out["opcode"] = ops[mask].astype(np.int64)
    n_real = int(mask.sum())
    synth_blocks = [
        (int(op), np.asarray(record.synthetic[int(op)], dtype=np.int64))
        for op in opcodes
        if record.synthetic.get(int(op))
    ]
    if synth_blocks:
        abc = np.concatenate([blk for _op, blk in synth_blocks])  # (m, 4)
        m = abc.shape[0]
        out["pc"] = np.concatenate(
            [out["pc"], np.full(m, UNUSED_PC, np.int64)]
        )
        out["next_pc"] = np.concatenate(
            [out["next_pc"], np.full(m, UNUSED_PC + 4, np.int64)]
        )
        out["next_next_pc"] = np.concatenate(
            [out["next_next_pc"], np.full(m, UNUSED_PC + 8, np.int64)]
        )
        for i, k in enumerate(("a", "b", "c", "prev_a")):
            out[k] = np.concatenate([out[k], abc[:, i]])
        out["opcode"] = np.concatenate(
            [out["opcode"]]
            + [np.full(len(blk), op, np.int64) for op, blk in synth_blocks]
        )
    return out, n_real
