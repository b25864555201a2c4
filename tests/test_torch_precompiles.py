"""The precompile path through the port's shard prover, on the CPU.

Each grouped program of ziren_tpu_torch.tools.precompile_programs is built
from the JAX package's executor/asm.py and from the port's (the same
instruction words), proved at the dev config by the JAX package's host
prover and by the port's torch prover (device="cpu"), and the two proofs are
compared as bytes; each package's verifier takes the other's bytes. This
file holds the hash group (Poseidon2, SHA-256, Keccak, uint256 and
U256xU2048), the widest chip of the machine (KeccakSponge, 6,913 columns)
through the fused path's body under the host-sync trap, and the two hash
chains' builders; tests/test_torch_curves.py, test_torch_fp_tower.py and
test_torch_syscalls.py hold the other groups and a deferred precompile
shard.
"""

import dataclasses
import hashlib
import os

import pytest
import torch

from test_torch_fused import HostSyncTrap

import ziren_tpu.executor.asm as jasm
import ziren_tpu.executor.keccak as jkeccak
import ziren_tpu.machine.mips as jmips
import ziren_tpu.stark.config as jconfig
import ziren_tpu.stark.proof as jproof
import ziren_tpu.stark.serialize as jser
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.machine.mips as tmips
import ziren_tpu_torch.stark.config as tconfig
import ziren_tpu_torch.stark.machine as tmachine
import ziren_tpu_torch.stark.serialize as tser
from ziren_tpu_torch.stark import carry, tprover
from ziren_tpu_torch.tools import precompile_programs as pp

# Under pytest-xdist each worker keeps to one torch thread: the workers
# already fill the cores, and torch's thread pool on top of them slows
# every worker down.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def words(program):
    """A program's instructions as plain tuples, comparable across packages."""
    return [(int(i.opcode), i.op_a, i.op_b, i.op_c, i.imm_b, i.imm_c)
            for i in program.instructions]


def base(machine, pk):
    ch = machine.config.challenger()
    pk.vk.observe_into(ch)
    return ch


@dataclasses.dataclass
class GroupProofs:
    """A grouped program proved on both sides of the package border."""
    name: str
    jax_machine: object
    jax_vk: object
    jax_program: object
    jax_bytes: list
    machine: object
    pk: object
    vk: object
    program: object
    record: object
    port_bytes: list


def prove_group(name: str) -> GroupProofs:
    """The JAX package's host proof and the port's torch proof on the CPU of
    the grouped program `name`, at the dev config, as shard bytes."""
    jprog = pp.group_program(jasm, name)
    jm = jmips.mips_machine(jconfig.dev_config())
    jpk, jvk = jm.setup(jprog)
    _ex, jrec = jmips.execute(jprog)
    jbytes = [jser.serialize_shard_proof(sp) for sp in jm.prove(jpk, [jrec]).shard_proofs]

    prog = pp.group_program(tasm, name)
    assert words(prog) == words(jprog)
    machine = tmips.mips_machine(tconfig.dev_config())
    pk, vk = machine.setup(prog)
    _ex, record = tmips.execute(prog)
    port = tprover.prove_shard(machine, pk, record, base(machine, pk), "cpu")
    return GroupProofs(name, jm, jvk, jprog, jbytes, machine, pk, vk, prog, record,
                       [tser.serialize_shard_proof(port)])


def check_group(g: GroupProofs) -> None:
    """Byte-equal, every chip of the group in the shard, and each package's
    verifier takes the other's bytes."""
    assert g.port_bytes == g.jax_bytes
    names = carry.shard_proof_from_bytes(g.port_bytes[0]).chip_names
    assert set(pp.GROUP_CHIPS[g.name]) <= set(names), set(pp.GROUP_CHIPS[g.name]) - set(names)
    assert tmips.verify_mips_proof(g.machine, g.vk,
                                   carry.machine_proof_from_shard_bytes(g.jax_bytes),
                                   pc_start=g.program.pc_start)
    assert jmips.verify_mips_proof(
        g.jax_machine, g.jax_vk,
        jproof.MachineProof([jser.deserialize_shard_proof(b) for b in g.port_bytes]),
        pc_start=g.jax_program.pc_start)


@pytest.fixture(scope="module")
def hash_group():
    return prove_group("hash")


def test_hash_group_matches_jax(hash_group):
    """SyscallCore, SyscallPrecompile, Poseidon2Permute, ShaExtend,
    ShaCompress, Uint256Mul, KeccakSponge and U256xU2048Mul in one shard."""
    check_group(hash_group)


def test_hash_group_fused_body_reads_nothing_back(hash_group):
    """The hash group's shard through the fused path on the CPU, its body
    under the host-sync trap after the eager proof warmed the shape's
    caches: KeccakSponge's 13,159 constraints and every other chip fold
    without a value read back or a tensor made from host data, as a CUDA
    graph's capture needs; the proof is the JAX package's."""
    g = hash_group
    body = tprover.prove_body

    def trapped(*args, **kw):
        with HostSyncTrap():
            return body(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tprover, "prove_body", trapped)
        mp.setenv("ZIREN_FUSED", "1")
        fused = tmachine.prove(g.machine, g.pk, [g.record], device="cpu")
    assert [tser.serialize_shard_proof(sp) for sp in fused.shard_proofs] == g.jax_bytes


@pytest.mark.parametrize("name", pp.GROUPS)
def test_groups_are_the_same_words_in_both_packages(name):
    jprog, prog = pp.group_program(jasm, name), pp.group_program(tasm, name)
    assert words(prog) == words(jprog)
    _ex, record = tmips.execute(prog)
    machine = tmips.mips_machine(tconfig.dev_config())
    included = {c.name for c in machine.chips if c.air.included(record)}
    assert set(pp.GROUP_CHIPS[name]) <= included


def test_the_groups_cover_the_precompile_chips():
    """The 35 chips of the machine that a fibonacci shard leaves out."""
    machine = tmips.mips_machine(tconfig.dev_config())
    _ex, fib = tmips.execute(tasm.fibonacci_program(30))
    left_out = [c.name for c in machine.chips if not c.air.included(fib)]
    assert sorted(pp.PRECOMPILE_CHIPS) == sorted(left_out) and len(left_out) == 35


def keccak_jax(data: bytes) -> bytes:
    """keccak256 on the JAX package's keccakf, for the port's keccak256."""
    rate = 136
    padded = bytearray(data) + bytes(rate - len(data) % rate)
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    state = [0] * 25
    for off in range(0, len(padded), rate):
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(padded[off + 8 * i : off + 8 * i + 8], "little")
        state = jkeccak.keccakf(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))


def test_keccak256_known_values():
    assert pp.keccak256(b"").hex() == \
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert pp.keccak256(b"abc").hex() == \
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    for n in (0, 32, 135, 136, 300):
        assert pp.keccak256(bytes(range(n % 256)) * (n // 256 + 1)) == \
            keccak_jax(bytes(range(n % 256)) * (n // 256 + 1))


@pytest.mark.parametrize("n", [1, 3])
def test_sha256_chain_digest(n):
    """The chain's program, the same words in both packages, commits
    hashlib's digest after n rounds from 32 zero bytes."""
    prog, digest = pp.sha256_chain_program(tasm, n)
    jprog, jdigest = pp.sha256_chain_program(jasm, n)
    assert words(prog) == words(jprog) and digest == jdigest
    want = bytes(32)
    for _ in range(n):
        want = hashlib.sha256(want).digest()
    assert digest == want
    for mips in (tmips, jmips):
        src = prog if mips is tmips else jprog
        _ex, record = mips.execute(src)
        assert pp.committed_digest(record.public_values.to_list(), "big") == want


@pytest.mark.parametrize("n", [1, 3])
def test_keccak_chain_digest(n):
    """The chain's program commits the port's keccak256 after n rounds,
    which the JAX package's keccakf gives too."""
    prog, digest = pp.keccak_chain_program(tasm, n)
    jprog, jdigest = pp.keccak_chain_program(jasm, n)
    assert words(prog) == words(jprog) and digest == jdigest
    want = bytes(32)
    for _ in range(n):
        want = keccak_jax(want)
    assert digest == want
    for mips in (tmips, jmips):
        src = prog if mips is tmips else jprog
        _ex, record = mips.execute(src)
        assert pp.committed_digest(record.public_values.to_list(), "little") == want


def test_chain_events_per_round():
    """One SHA_EXTEND and one SHA_COMPRESS a SHA round, one one-block
    KECCAK_SPONGE a Keccak round."""
    from ziren_tpu_torch.executor.opcode import SyscallCode as S

    _ex, rec = tmips.execute(pp.sha256_chain_program(tasm, 4)[0])
    assert len(rec.precompile_events[int(S.SHA_COMPRESS)]) == 4
    assert len(rec.precompile_events[int(S.SHA_EXTEND)]) == 4 * 48
    _ex, rec = tmips.execute(pp.keccak_chain_program(tasm, 4)[0])
    evs = rec.precompile_events[int(S.KECCAK_SPONGE)]
    assert len(evs) == 4 and all(len(e["xored_states"]) == 1 for e in evs)
