"""The MIPS machine: chip set assembly + end-to-end prove/verify helpers
(reference: crates/core/machine/src/mips/mod.rs MipsAir).

~50 chips: the CPU/ALU/memory core, the byte table, the multi-shard
global/septic chips, and the full precompile set (sha extend/compress,
poseidon2, keccak sponge, uint256, u256x2048, weierstrass add/double for
secp256k1/r1 + bn254 + bls12-381, ed25519 add/decompress, 12 fp/fp2 tower
ops). Precompile chips enter a shard proof only when they have events.
"""

from __future__ import annotations

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

