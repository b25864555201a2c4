"""User-facing SDK: the moral equivalent of the reference's `zkm-sdk`
ProverClient (reference: crates/sdk/src/lib.rs — setup / execute / prove /
verify over guest ELFs with a write-based stdin).

    from ziren_tpu_torch.sdk import ProverClient, ZirenStdin

    client = ProverClient()                 # core config, on the GPU
    client = ProverClient(config="dev", device="cpu")   # the CPU, asked for
    stdin = ZirenStdin(); stdin.write_slice(b"...")
    pv, report = client.execute(elf, stdin)
    pk, vk = client.setup(elf)
    proof = client.prove(pk, stdin)
    client.verify(proof, vk)

Modes: config="core" uses the production FRI parameters (84 queries,
16 PoW bits); config="dev" the fast 8-query test parameters. The full
recursion ladder is wired: compressed_prove (with deferred sub-proofs) ->
shrink_prove -> wrap_prove (BN254 outer config) -> groth16_prove (in-house
Groth16 over the wrap-verifier R1CS) -> export_verifier_contract.
Backends: create_prover() selects cuda / cpu / mock / network
(ZIREN_PROVER).

`device` is where the STARK provers run: None is the GPU (and raises at the
first prove without one), a torch device or "cpu" runs the torch prover
there, "host" the numpy prover. Execution, setup, every verify, the wrap
and the SNARK stages are host work whatever `device` says.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .executor.program import Program, load_elf
from .machine.mips import execute, mips_machine, verify_mips_proof
from .stark.config import core_config, dev_config


class ZirenStdin:
    """Input stream for the guest: a list of byte buffers consumed by the
    HINT_LEN / HINT_READ syscalls (reference ZKMStdin::write_slice)."""

    def __init__(self):
        self.buffers: list[bytes] = []

    def write_slice(self, data: bytes) -> "ZirenStdin":
        self.buffers.append(bytes(data))
        return self

    def write_u32s(self, values) -> "ZirenStdin":
        return self.write_slice(b"".join(struct.pack("<I", v) for v in values))


@dataclass
class ExecutionReport:
    """reference: crates/core/executor/src/report.rs"""

    total_instruction_count: int
    exit_code: int
    stdout: bytes
    opcode_counts: dict = field(default_factory=dict)
    syscall_counts: dict = field(default_factory=dict)
    cycle_tracker: dict = field(default_factory=dict)  # guest markers


@dataclass
class PublicValuesStream:
    """The guest's public outputs: `stream` is the raw byte stream written
    to FD_PUBLIC_VALUES (reference ZKMPublicValues); `words` the values
    committed via SYSCALL COMMIT. Reference-built guests commit the
    sha256(stream) digest words at halt; `digest_words()` is what the
    in-proof committed_value_digest must equal either way."""

    words: list
    stream: bytes = b""

    def as_bytes(self) -> bytes:
        if self.stream:
            return bytes(self.stream)
        return b"".join(struct.pack("<I", w & 0xFFFFFFFF) for w in self.words)

    def digest_words(self) -> list:
        """The 8 words the proof's committed_value_digest must carry."""
        import hashlib

        if self.stream:
            d = hashlib.sha256(bytes(self.stream)).digest()
            return [int.from_bytes(d[i : i + 4], "little") for i in range(0, 32, 4)]
        if len(self.words) > 8:
            raise ValueError(
                "more than 8 committed words without a public-values stream: "
                "words beyond index 7 would be bound to nothing"
            )
        return list(self.words) + [0] * (8 - len(self.words))


@dataclass
class ZirenProvingKey:
    program: Program
    machine: object
    pk: object
    vk: object


@dataclass
class ZirenVerifyingKey:
    program_pc_start: int
    machine: object
    vk: object


@dataclass
class ZirenProofWithPublicValues:
    proof: object  # MachineProof
    public_values: PublicValuesStream


def _load(elf_or_program) -> Program:
    if isinstance(elf_or_program, Program):
        return elf_or_program
    return load_elf(bytes(elf_or_program))


# Groth16 CRS per wrap shape (see ProverClient.groth16_prove)
_GROTH16_PK_CACHE: dict = {}


def create_prover(mode: str | None = None, config: str = "core",
                  endpoint: str | None = None):
    """Backend-selecting factory (reference sdk/src/lib.rs:46-168
    ProverClient::{new,mock,cpu,cuda,network} keyed on ZKM_PROVER):

      mode "cuda"/"local" (default) -> ProverClient in-process on the GPU
        (the reference's ProverClient::cuda; it raises at the first prove
        without one), "cpu" -> ProverClient(device="cpu"), asked for by
        name, "mock" -> MockProver (no real proofs, digest checks only),
        "network" -> network.NetworkProver against `endpoint` (or
        ZIREN_PROVER_ENDPOINT).
    Mode defaults to the ZIREN_PROVER env var."""
    import os

    mode = (mode or os.environ.get("ZIREN_PROVER", "cuda")).lower()
    if mode in ("cuda", "local"):
        return ProverClient(config=config)
    if mode == "cpu":
        return ProverClient(config=config, device="cpu")
    if mode == "mock":
        return MockProver(config=config)
    if mode == "network":
        from .network import NetworkProver

        endpoint = endpoint or os.environ.get("ZIREN_PROVER_ENDPOINT")
        if not endpoint:
            raise ValueError("network prover needs an endpoint "
                             "(ZIREN_PROVER_ENDPOINT)")
        return NetworkProver(endpoint, config=config)
    raise ValueError(f"unknown prover mode {mode!r}")


class ProverClient:
    def __init__(self, config: str = "core", device=None):
        self._device = device
        self._config = core_config() if config == "core" else dev_config()
        # shrink stage config (reference InnerSC::compressed): higher
        # blowup, fewer queries -> smaller proof for the wrap to verify
        from .stark.config import (compressed_config,
                                            compressed_dev_config)

        self._shrink_config = (compressed_config() if config == "core"
                               else compressed_dev_config())

    # -- execute ----------------------------------------------------------
    def execute(self, elf_or_program, stdin: ZirenStdin | None = None):
        program = _load(elf_or_program)
        ex, record = execute(program, stdin=stdin.buffers if stdin else None)
        rep = getattr(ex, "report", {}) or {}
        report = ExecutionReport(
            total_instruction_count=int(ex.global_clk),
            exit_code=int(record.public_values.exit_code),
            stdout=bytes(getattr(ex, "stdout", b"") or b""),
            opcode_counts=dict(rep.get("opcode_counts", {})),
            syscall_counts=dict(rep.get("syscall_counts", {})),
            cycle_tracker=dict(getattr(ex, "cycle_tracker", {}) or {}),
        )
        return (
            PublicValuesStream(
                list(ex.committed_values), bytes(ex.public_values_stream)
            ),
            report,
        )

    # -- prove / verify ---------------------------------------------------
    def setup(self, elf_or_program):
        program = _load(elf_or_program)
        machine = mips_machine(self._config)
        pk, vk = machine.setup(program, extra_observations=[program.pc_start])
        return (
            ZirenProvingKey(program, machine, pk, vk),
            ZirenVerifyingKey(program.pc_start, machine, vk),
        )

    def prove(self, pk: ZirenProvingKey, stdin: ZirenStdin | None = None,
              shard_size: int | None = None, canonical: bool = False):
        from .executor import Executor
        from .machine.mips import execute_sharded
        from .stark.opts import ZirenCoreOpts

        buffers = stdin.buffers if stdin else None
        if shard_size:
            ex = Executor(pk.program, stdin=buffers, shard_size=shard_size)
            records = ex.run_sharded()
        else:
            # RAM-tiered default shard size (reference ZKMCoreOpts::auto);
            # short executions still land in a single shard
            auto = ZirenCoreOpts.auto().shard_size
            ex, records = execute_sharded(pk.program, auto, stdin=buffers)
        shapes = None
        if canonical:
            from .recursion.shape_universe import (
                fix_records_to_clusters,
            )

            shapes = fix_records_to_clusters(pk.machine, records)
        proof = pk.machine.prove(pk.pk, records, device=self._device)
        out = ZirenProofWithPublicValues(
            proof,
            PublicValuesStream(
                list(ex.committed_values), bytes(ex.public_values_stream)
            ),
        )
        out._records = records  # deferred-claim access for compressed_prove
        out._cluster_shapes = shapes
        return out

    def compressed_prove(self, pk: ZirenProvingKey,
                         stdin: ZirenStdin | None = None,
                         shard_size: int | None = None,
                         deferred=None, canonical: bool | None = None):
        """Core prove, then lift every shard and reduce to ONE recursion
        proof with canonical RecursionPublicValues: every tree layer chains
        shard boundaries and accumulates the septic global sum IN-CIRCUIT
        (see recursion/mips_pipeline.py). Returns
        (rec_machine, rec_vk, final_recursion_shard_proof).

        `deferred`: compressed proofs for the guest's VERIFY_ZKM_PROOF
        claims, in claim order — each a (rec_machine, rec_vk, final_sp)
        triple from a previous compressed_prove. Each claim is checked
        against its proof, folded into the reconstruct-digest chain
        (recursion/deferred.py), and discharged in-circuit; the root is
        only COMPLETE when the chain lands on the guest's committed
        deferred_proofs_digest (reference prover/src/lib.rs:595,
        recursion/circuit/src/machine/deferred.rs)."""
        from .recursion import deferred as D
        from .recursion.mips_pipeline import compress
        from .stark.verifier import VerificationError

        # canonical=True (env ZIREN_FIX_CORE_SHAPES=1, reference
        # FIX_CORE_SHAPES): pad core shards to the cluster-shape universe
        # and enumerate the allowed-vk registry from phantom lifts of those
        # clusters, so the registry root is a (guest, shard size) constant
        # rather than a per-run artifact (recursion/shape_universe.py).
        import os as _os

        if canonical is None:
            canonical = _os.environ.get("ZIREN_FIX_CORE_SHAPES") == "1"
        registry = None
        core = self.prove(pk, stdin, shard_size=shard_size,
                          canonical=canonical)
        if canonical:
            from .recursion.shape_universe import (
                build_canonical_registry,
            )

            registry = build_canonical_registry(
                pk.machine, pk.vk, core._cluster_shapes,
                config=self._config,
            )
        claims = []
        for rec in core._records:
            claims.extend(getattr(rec, "deferred_proof_claims", []))
        deferred = list(deferred or [])
        if len(claims) != len(deferred):
            raise VerificationError(
                f"guest deferred {len(claims)} proof claims but "
                f"{len(deferred)} compressed proofs were supplied"
            )
        if not claims:
            return compress(pk.machine, pk.vk, core.proof,
                            config=self._config, registry=registry,
                            device=self._device)

        from .recursion.mips_pipeline import RPV_DIGEST

        folded_claims = []
        for (vkey, pvd_words), side in zip(claims, deferred):
            sub_rpv = [int(v) for v in side[2].public_values]
            pv32 = sub_rpv[RPV_DIGEST : RPV_DIGEST + 32]
            if list(vkey) != D.claim_vk_digest_from_rpv(sub_rpv):
                raise VerificationError(
                    "deferred claim vkey does not match the supplied proof"
                )
            if list(pvd_words) != D.pv_digest_bytes_to_words(pv32):
                raise VerificationError(
                    "deferred claim pv digest does not match the proof"
                )
            folded_claims.append((list(vkey), pv32))
        reconstruct = D.fold_claims(folded_claims)
        core_root = compress(pk.machine, pk.vk, core.proof,
                             config=self._config,
                             reconstruct_digest=reconstruct,
                             registry=registry, device=self._device)
        chain = D.deferred_chain(deferred, config=self._config,
                                 device=self._device)
        return D.attach_deferred(core_root, chain, config=self._config,
                                 device=self._device)

    def shrink_prove(self, compressed):
        """Re-prove a compressed proof with compact 8-felt digest public
        values — the wrap input (reference prover/src/lib.rs:961)."""
        from .recursion.pipeline import shrink

        rm, rvk, final_sp = compressed
        sm, svk, sproof, _ = shrink(rm, rvk, final_sp,
                                    config=self._shrink_config,
                                    device=self._device)
        return sm, svk, sproof.shard_proofs[0]

    def wrap_prove(self, shrunk, outer=None):
        """Re-prove the shrink output under the OUTER config (BN254
        Poseidon2 Merkle + multifield challenger): the artifact a BN254
        SNARK verifies (reference prover/src/lib.rs:1009 wrap_bn254).
        Returns (wrap_machine, wrap_vk, wrap_shard_proof)."""
        from .recursion.pipeline import wrap_bn254

        sm, svk, ssp = shrunk
        wm, wvk, wproof, _ = wrap_bn254(sm, svk, ssp, config=outer)
        return wm, wvk, wproof.shard_proofs[0]

    def verify_wrapped(self, wrapped, shrunk) -> bool:
        """Verify a wrap proof and bind its 8-felt digest public values to
        the shrink artifact it claims to attest."""
        from .recursion.pipeline import lift_digest
        from .stark.proof import MachineProof
        from .stark.verifier import VerificationError

        wm, wvk, wsp = wrapped
        sm, svk, ssp = shrunk
        wm.verify(wvk, MachineProof([wsp]))
        if [int(v) for v in wsp.public_values] != lift_digest(svk, ssp):
            raise VerificationError(
                "wrap public values do not bind the shrink proof"
            )
        return True

    def verify_compressed(self, compressed, vk: ZirenVerifyingKey,
                          vk_root=None, registry=None) -> bytes:
        """Verify a compressed proof at the root: one recursion proof whose
        RPV pins the MIPS vk + program entry with is_complete=1. With the
        full allowed-vk `registry` (shape_universe.build_full_registry, the
        canonical-prove default), the rec vk is checked as a MEMBER and the
        RPV root against the registry root — the root is the whole trust
        anchor. vk_root alone pins just the root field (reference prover
        vk_map root check). Returns the committed_value_digest bytes."""
        from .recursion.mips_pipeline import verify_compressed

        rm, rvk, final_sp = compressed
        return verify_compressed(vk.machine, vk.vk, rm, rvk, final_sp,
                                 pc_start=vk.program_pc_start,
                                 vk_root=vk_root, registry=registry)

    def groth16_prove(self, wrapped, seed: bytes = b"ziren-groth16-dev"):
        """Compile the wrap proof's verifier to a BN254 R1CS
        (snark/wrap_circuit.py) and Groth16-prove it with the in-house
        prover — the reference's gnark stage (prover/src/lib.rs
        wrap_groth16_bn254 + recursion/gnark-ffi), no Go needed.

        wrapped: (wrap_machine, wrap_vk, wrap_shard_proof) from wrap_prove.
        Returns a dict with gnark-layout `proof` bytes, `public_inputs`
        ([vk commit Fr, 8 digest felts]) and `vk_bytes`; verify with
        `groth16_verify`. EXPENSIVE: the dev-config circuit is ~3M
        constraints (one-time setup ~15 min + prove ~10 min on 4 cores);
        the setup is seed-derived dev-grade, like the reference's dummy
        artifacts (prover/src/build.rs)."""
        from .snark.groth16 import prove, setup
        from .snark.wrap_circuit import build_wrap_circuit

        wm, wvk, wsp = wrapped
        bld, publics = build_wrap_circuit(wm, wvk, wsp)
        # the circuit is deterministic per wrap SHAPE (chip set + heights +
        # fri params), so one CRS serves every program whose wrap lands on
        # the same shape — the reference's shape-fixed gnark circuits.
        key = (
            seed,
            tuple(wsp.chip_names),
            tuple(v.log_degree for v in wsp.opened_values),
            wm.config.fri.log_blowup, wm.config.fri.num_queries,
            wm.config.fri.proof_of_work_bits,
            bld.num_constraints,
        )
        pk = _GROTH16_PK_CACHE.get(key)
        if pk is None:
            pk = setup(bld.to_r1cs(), seed=seed)
            _GROTH16_PK_CACHE[key] = pk
        proof = prove(pk, bld.witness)
        return {"proof": proof, "public_inputs": publics,
                "vk_bytes": pk.vk_bytes}

    @staticmethod
    def groth16_verify(artifact) -> bool:
        """Verify a groth16_prove artifact (pure-python pairing check)."""
        from .verifier import Groth16Verifier

        return Groth16Verifier.verify_gnark_proof(
            artifact["proof"], artifact["public_inputs"],
            artifact["vk_bytes"],
        )

    @staticmethod
    def export_verifier_contract(artifact_or_vk_bytes,
                                 name: str = "ZirenGroth16Verifier") -> str:
        """The Solidity verifier contract for a groth16_prove artifact (or
        raw gnark-layout vk bytes) — the reference's gnark ExportSolidity
        stage (snark/contract.py). Deploy it and call verifyRawProof with
        the artifact's public_inputs + 256-byte proof."""
        from .snark.contract import export_solidity

        vk_bytes = (artifact_or_vk_bytes["vk_bytes"]
                    if isinstance(artifact_or_vk_bytes, dict)
                    else artifact_or_vk_bytes)
        return export_solidity(vk_bytes, name=name)


    def plonk_prove(self, wrapped, seed: bytes = b"ziren-plonk-dev"):
        """Compile the wrap proof's verifier to the SAME BN254 R1CS as the
        Groth16 path and prove it with the in-house Plonk+KZG prover
        (snark/plonk.py) — the reference's gnark Plonk stage
        (gnark-ffi/src/plonk_bn254.rs). Returns gnark-layout `proof` bytes
        + `public_inputs` + `vk_bytes` (crates/verifier/src/plonk
        converter layouts); verify with `plonk_verify`. The gate count is
        several times the R1CS constraint count (linear combinations
        materialize into addition-gate chains), so this is the SLOWEST
        wrap backend — use Groth16 unless a Plonk artifact is required."""
        from .snark.plonk import from_r1cs, prove, setup
        from .snark.wrap_circuit import build_wrap_circuit

        wm, wvk, wsp = wrapped
        bld, _publics = build_wrap_circuit(wm, wvk, wsp)
        # NOTE: the Plonk pk wires the WITNESS (PlonkCS carries values), so
        # unlike Groth16 only the SRS could be reused across proofs; the
        # per-proof setup cost is dominated by the fixed-base SRS batch.
        cs, cs_publics = from_r1cs(bld.to_r1cs(), bld.witness)
        pk = setup(cs, seed=seed)
        proof = prove(pk, cs_publics)
        return {"proof": proof, "public_inputs": cs_publics,
                "vk_bytes": pk.vk_bytes}

    @staticmethod
    def plonk_verify(artifact) -> bool:
        """Verify a plonk_prove artifact (ported reference verifier:
        crates/verifier/src/plonk/verify.rs)."""
        from .verifier.plonk import verify_plonk

        return verify_plonk(
            artifact["proof"], artifact["vk_bytes"],
            artifact["public_inputs"],
        )

    def verify(self, proof: ZirenProofWithPublicValues,
               vk: ZirenVerifyingKey) -> bool:
        """Proof verification + binding of the claimed public values to the
        in-proof committed_value_digest (reference sdk provers/mod.rs:144:
        sha256(public values stream) must equal the digest bytes; without a
        stream the committed words themselves are the digest and at most 8
        words are bound). proof.public_values=None skips the binding — the
        caller holds no claim (e.g. verifying a proof file alone) and reads
        the digest from the proof itself."""
        from .stark.verifier import VerificationError

        verify_mips_proof(
            vk.machine, vk.vk, proof.proof, pc_start=vk.program_pc_start
        )
        if proof.public_values is None:
            return True
        pv = proof.proof.shard_proofs[-1].public_values
        # in-proof digest: 32 byte felts -> 8 LE words
        digest_words = [
            int(pv[4 * i])
            | (int(pv[4 * i + 1]) << 8)
            | (int(pv[4 * i + 2]) << 16)
            | (int(pv[4 * i + 3]) << 24)
            for i in range(8)
        ]
        try:
            claimed = proof.public_values.digest_words()
        except ValueError as e:
            raise VerificationError(str(e)) from e
        if digest_words != claimed:
            raise VerificationError(
                "claimed public values do not match the proof's "
                "committed_value_digest"
            )
        return True


class MockProver(ProverClient):
    """No real proofs — executes the guest and fabricates an empty proof
    carrying the real public values; verify checks only the digest binding
    (reference sdk/src/provers/mock.rs:190: MockProver "verifies digests
    only"). For SDK-flow tests and host development loops."""

    def prove(self, pk: ZirenProvingKey, stdin: ZirenStdin | None = None,
              shard_size: int | None = None):
        values, _report = self.execute(pk.program, stdin=stdin)
        out = ZirenProofWithPublicValues(None, values)
        out._records = []
        return out

    def compressed_prove(self, pk, stdin=None, shard_size=None,
                         deferred=None):
        return self.prove(pk, stdin=stdin, shard_size=shard_size)

    def verify(self, proof: ZirenProofWithPublicValues,
               vk: ZirenVerifyingKey) -> bool:
        from .stark.verifier import VerificationError

        if proof.proof is not None:  # a real proof: do the real check
            return super().verify(proof, vk)
        if proof.public_values is None:
            raise VerificationError("mock proof without public values")
        proof.public_values.digest_words()  # raises on unbindable streams
        return True
