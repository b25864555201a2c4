"""The MIPS machine: chip set assembly + end-to-end prove/verify helpers
(reference: crates/core/machine/src/mips/mod.rs MipsAir).

~50 chips: the CPU/ALU/memory core, the byte table, the multi-shard
global/septic chips, and the full precompile set (sha extend/compress,
poseidon2, keccak sponge, uint256, u256x2048, weierstrass add/double for
secp256k1/r1 + bn254 + bls12-381, ed25519 add/decompress, 12 fp/fp2 tower
ops). Precompile chips enter a shard proof only when they have events.
"""

from __future__ import annotations

import subprocess

from ..executor import Executor
from ..executor.record import PROOF_MAX_NUM_PVS
from ..stark.config import dev_config
from ..stark.machine import StarkMachine
from .alu import AddSubChip, BitwiseChip, LtChip
from .branch import BranchChip
from .byte import ByteChip
from .cpu import CpuChip
from .jump import JumpChip
from .global_chip import GlobalChip
from .memory_global import MemoryFinalChip, MemoryInitChip
from .memory_local import MemoryLocalChip
from .memory_instr import MemoryInstructionsChip
from .divrem import DivRemChip
from .maddsub import MaddSubChip
from .misc import CloClzChip, MiscChip, MovCondChip
from .mul import MulChip
from .sha_compress import ShaCompressChip
from .sha_extend import ShaExtendChip
from .shift import ShiftLeftChip, ShiftRightChip
from .poseidon2_chip import Poseidon2PermuteChip
from .program import ProgramChip
from .syscall import SyscallChip
from .syscall_bridge import SyscallCoreChip, SyscallPrecompileChip
from .keccak_sponge import KeccakSpongeChip
from .uint256 import Uint256MulChip
from .edwards import EdAddChip, EdDecompressChip
from .fptower import fptower_chips
from .garble import BooleanCircuitGarbleChip
from .sys_linux import SysLinuxChip
from .u256x2048 import U256xU2048MulChip
from .weierstrass import curve_chips


def mips_airs():
    return [
        ProgramChip(),
        CpuChip(),
        AddSubChip(),
        BitwiseChip(),
        LtChip(),
        MulChip(),
        DivRemChip(),
        MaddSubChip(),
        CloClzChip(),
        MiscChip(),
        MovCondChip(),
        ShiftLeftChip(),
        ShiftRightChip(),
        BranchChip(),
        JumpChip(),
        MemoryInstructionsChip(),
        SyscallChip(),
        SyscallCoreChip(),
        SyscallPrecompileChip(),
        Poseidon2PermuteChip(),
        ShaExtendChip(),
        ShaCompressChip(),
        Uint256MulChip(),
        KeccakSpongeChip(),
        *curve_chips(),
        EdAddChip(),
        EdDecompressChip(),
        *fptower_chips(),
        U256xU2048MulChip(),
        SysLinuxChip(),
        BooleanCircuitGarbleChip(),
        ByteChip(),
        MemoryLocalChip(),
        MemoryInitChip(),
        MemoryFinalChip(),
        GlobalChip(),
    ]


def mips_machine(config=None) -> StarkMachine:
    return StarkMachine(
        config or dev_config(), mips_airs(), num_public_values=PROOF_MAX_NUM_PVS
    )


def verify_mips_proof(machine, vk, proof, pc_start=None):
    """machine.verify + the cross-shard public-value chaining rules
    (reference: crates/prover/src/verify.rs:60-298). Shards come in two
    kinds: execution shards (contain the Cpu chip) and standalone memory
    shards from deferred-event splitting (no Cpu; carry MemoryInit/Final
    endpoints and chain the addr-bits pv fields)."""
    from ..stark.verifier import VerificationError
    from .messages import (
        PV_EXECUTION_SHARD,
        PV_EXIT_CODE,
        PV_LAST_FIN_ADDR,
        PV_LAST_INIT_ADDR,
        PV_NEXT_PC,
        PV_PREV_FIN_ADDR,
        PV_PREV_INIT_ADDR,
        PV_SHARD,
        PV_START_PC,
    )

    machine.verify(vk, proof)
    shards = proof.shard_proofs
    if len(shards) > 1 << 16:
        raise VerificationError("too many shards")
    # chips a shard proof may never omit (reference verify.rs: omitting an
    # event-driven chip with live events breaks the lookup balance / septic
    # digest, so only the always-on chips need an explicit presence check)
    required = {"Program", "Byte", "MemoryLocal", "Global"}
    for i, sp in enumerate(shards):
        names = set(sp.chip_names)
        missing = required - names
        if missing:
            raise VerificationError(f"shard {i}: missing chips {sorted(missing)}")
        if "Cpu" not in names and not (
            {"MemoryInit", "MemoryFinal", "SyscallPrecompile"} & names
        ):
            raise VerificationError(
                f"shard {i}: no Cpu, no memory endpoints, no precompiles")

    digest0 = shards[0].public_values[:40]
    exec_shard = 0
    prev_last_init = [0] * 32
    prev_last_fin = [0] * 32
    for i, sp in enumerate(shards):
        pv = sp.public_values
        names = set(sp.chip_names)
        has_cpu = "Cpu" in names
        if pv[PV_SHARD] != i + 1:
            raise VerificationError(f"shard {i}: bad shard numbering")
        # execution shard increments exactly on Cpu shards
        if has_cpu:
            exec_shard += 1
            if pv[PV_EXECUTION_SHARD] != exec_shard:
                raise VerificationError(f"shard {i}: bad execution shard")
        if pv[:40] != digest0:
            raise VerificationError(f"shard {i}: committed digest mismatch")
        # pc chaining
        if i > 0 and pv[PV_START_PC] != shards[i - 1].public_values[PV_NEXT_PC]:
            raise VerificationError(f"shard {i}: pc chain broken")
        # (i > 0: synthetic test programs legitimately enter at pc 0)
        if i > 0 and has_cpu and pv[PV_START_PC] == 0:
            raise VerificationError(f"shard {i}: started after halt")
        if not has_cpu and pv[PV_START_PC] != pv[PV_NEXT_PC]:
            raise VerificationError(f"shard {i}: non-cpu shard moved pc")
        if pv[PV_EXIT_CODE] != 0:
            raise VerificationError(f"shard {i}: nonzero exit code")
        # memory init/finalize addr-bits chain (reference verify.rs:188-232)
        pi = pv[PV_PREV_INIT_ADDR : PV_PREV_INIT_ADDR + 32]
        li = pv[PV_LAST_INIT_ADDR : PV_LAST_INIT_ADDR + 32]
        pf = pv[PV_PREV_FIN_ADDR : PV_PREV_FIN_ADDR + 32]
        lf = pv[PV_LAST_FIN_ADDR : PV_LAST_FIN_ADDR + 32]
        for bit in (*pi, *li, *pf, *lf):
            if bit not in (0, 1):
                raise VerificationError(f"shard {i}: non-boolean addr bit")
        if list(pi) != prev_last_init:
            raise VerificationError(f"shard {i}: init addr-bit chain broken")
        if list(pf) != prev_last_fin:
            raise VerificationError(f"shard {i}: finalize addr-bit chain broken")
        if "MemoryInit" not in names and list(li) != list(pi):
            raise VerificationError(f"shard {i}: init bits moved without chip")
        if "MemoryFinal" not in names and list(lf) != list(pf):
            raise VerificationError(f"shard {i}: finalize bits moved without chip")
        prev_last_init, prev_last_fin = list(li), list(lf)
    if pc_start is not None and shards[0].public_values[PV_START_PC] != pc_start:
        raise VerificationError("first shard start_pc != program entry")
    if shards[-1].public_values[PV_NEXT_PC] != 0:
        raise VerificationError("last shard did not halt")
    return True


def execute(program, stdin=None, native=True):
    """Execute with the C++ executor when available (50+ MHz), falling back
    to the Python semantic oracle."""
    if native:
        try:
            from ..executor.native import NativeExecutor

            ex = NativeExecutor(program, stdin=stdin)
            record = ex.run()
            return ex, record
        except (OSError, RuntimeError, subprocess.CalledProcessError):
            pass
    ex = Executor(program, stdin=stdin)
    record = ex.run()
    return ex, record


def execute_sharded(program, shard_size, stdin=None, native=True):
    """Sharded execution, native C++ first (50+ MHz, bit-exact vs the
    python executor's run_sharded — tests/test_native_sharded.py)."""
    if native:
        try:
            from ..executor.native import NativeExecutor

            ex = NativeExecutor(program, stdin=stdin)
            records = ex.run_sharded(shard_size)
            return ex, records
        except (OSError, RuntimeError, subprocess.CalledProcessError):
            pass
    ex = Executor(program, stdin=stdin, shard_size=shard_size)
    records = ex.run_sharded()
    return ex, records


def prove_program(program, stdin=None, config=None, shard_size=None,
                  device=None):
    """Execute + prove; returns (machine, pk, vk, proof, executor).
    `device` as in StarkMachine.prove: None is the GPU."""
    machine = mips_machine(config)
    pk, vk = machine.setup(program, extra_observations=[program.pc_start])
    if shard_size:
        ex = Executor(program, stdin=stdin, shard_size=shard_size)
        records = ex.run_sharded()
    else:
        ex, record = execute(program, stdin)
        records = [record]
    proof = machine.prove(pk, records, device=device)
    return machine, pk, vk, proof, ex


def prove_program_checkpointed(program, stdin=None, config=None,
                               shard_size=4096, workers=None, device=None,
                               shards=None):
    """Memory-bounded pipelined prove (reference: utils/prove.rs —
    checkpoint-exec then parallel trace workers): a fast untraced pass
    collects shard-boundary checkpoints, then worker threads regenerate each
    shard's record and traces from its checkpoint, so only ~`workers`
    shards of trace are ever alive at once.

    `device` as in StarkMachine.prove: None is the GPU (and raises without
    one), a torch device runs the torch shard prover (stark/tprover.py)
    there, the shards proved in order on the calling thread while the
    workers regenerate the next ones; "host" is the numpy prover, whose
    workers regenerate and prove each shard.

    `shards` proves only the first that many shards of the execution (None:
    all of them): a prefix, whose shards verify one by one
    (stark/verifier.py:verify_shard) but not as a whole execution."""
    import os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from ..device import prover_device
    from ..stark import tprover
    from ..stark.prover import prove_shard
    from ..stark.shape import _gen_traces

    device = prover_device(device)
    on_host = device == "host"
    machine = mips_machine(config)
    pk, vk = machine.setup(program, extra_observations=[program.pc_start])

    scout = Executor(program, stdin=stdin, mode="simple",
                     shard_size=shard_size)
    scout.collect_checkpoints = True
    cps = [scout.checkpoint()]
    scout.run_sharded()
    cps += scout.checkpoints[:-1]  # the last bump closes the final shard
    digest = list(scout.committed_values[:8]) + [0] * max(
        0, 8 - len(scout.committed_values)
    )
    exit_code = scout.exit_code

    base = machine.config.challenger()
    pk.vk.observe_into(base)

    def regenerate(k):
        ex = Executor.recover(program, cps[k], shard_size=shard_size)
        rec = ex.run_shard()
        rec.public_values.committed_value_digest = list(digest)
        rec.public_values.exit_code = exit_code
        return rec

    def prove_one(k):
        return prove_shard(machine, pk, regenerate(k), base.clone())

    def traced(k):  # the record with its traces, at their natural heights
        rec = regenerate(k)
        rec._fixed_traces = _gen_traces(machine, rec)
        return rec

    from ..stark.proof import MachineProof

    n = len(cps) if shards is None else min(shards, len(cps))
    workers = workers or min(n, os.cpu_count() or 4)
    if on_host and n == 1:
        proofs = [prove_one(0)]
    elif on_host:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            proofs = list(pool.map(prove_one, range(n)))
    else:
        # one caller of the device prover: K4's scratch, the transcript and
        # the device caches are not written for concurrent callers
        proofs = []
        with ThreadPoolExecutor(max_workers=workers) as pool:
            ahead = deque(pool.submit(traced, k) for k in range(min(workers, n)))
            for k in range(n):
                rec = ahead.popleft().result()
                if k + len(ahead) + 1 < n:
                    ahead.append(pool.submit(traced, k + len(ahead) + 1))
                proofs.append(tprover.prove_shard(machine, pk, rec, base.clone(),
                                                  device))
    return machine, pk, vk, MachineProof(proofs), scout
