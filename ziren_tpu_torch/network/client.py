"""NetworkProver — the remote-backend ProverClient facade (reference:
crates/sdk/src/provers/cuda.rs CudaProver + sdk/src/network/prover.rs
NetworkProver: same Prover trait surface, RPC per stage, results verified
locally)."""

from __future__ import annotations

import urllib.request

from ..network import wire
from ..sdk import ProverClient, ZirenVerifyingKey


class NetworkProverError(RuntimeError):
    pass


class _RemoteProvingKey:
    """Client-side handle: the server keeps the real pk (reference
    api.proto keeps proving keys server-side after Setup)."""

    def __init__(self, program_id: str, vk: ZirenVerifyingKey):
        self.program_id = program_id
        self.vk_handle = vk


class NetworkProver:
    """ProverClient-shaped facade proxying each stage to a ProverServer.

    Verification stays LOCAL (the remote prover is untrusted for
    soundness, exactly like the reference's network prover: the client
    re-verifies every returned proof)."""

    def __init__(self, endpoint: str, timeout: float = 600.0,
                 config: str = "core", key=None):
        from ..network import auth

        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout
        # request-signing identity (reference ZKM_PRIVATE_KEY signed jobs)
        self._key = auth.load_key(key)
        # local vk derivation + re-verification; the FRI config must match
        # the server's proving config
        self._local = ProverClient(config=config)

    def _call(self, method: str, req: dict) -> dict:
        from ..network import auth

        url = f"{self.endpoint}/twirp/ProverService/{method}"
        data = wire.dumps(req)
        headers = {"Content-Type": "application/octet-stream"}
        if self._key is not None:
            headers.update(auth.sign_headers(self._key, method, data))
        http_req = urllib.request.Request(url, data=data, headers=headers)
        with urllib.request.urlopen(http_req, timeout=self.timeout) as resp:
            # allowlisted deserialization: a malicious/MITM'd server must
            # not get code execution on the client either
            envelope = wire.loads(resp.read())
        if not envelope.get("ok"):
            raise NetworkProverError(envelope.get("error", "remote failure"))
        return envelope["result"]

    def ready(self) -> bool:
        return bool(self._call("Ready", {}).get("ready"))

    def setup(self, program):
        """Register the program remotely; derive the vk LOCALLY (the
        remote prover is untrusted — the vk must come from the program)."""
        r = self._call("Setup", {"program": program})
        _local_pk, vk = self._local.setup(program)
        return _RemoteProvingKey(r["program_id"], vk), vk

    def execute(self, pk: _RemoteProvingKey, stdin=None):
        r = self._call("ExecuteProgram", {
            "program_id": pk.program_id,
            "stdin": stdin.buffers if stdin else None,
        })
        return r["public_values"], r["report"]

    def prove(self, pk: _RemoteProvingKey, stdin=None, shard_size=None,
              verify: bool = True):
        r = self._call("ProveCore", {
            "program_id": pk.program_id,
            "stdin": stdin.buffers if stdin else None,
            "shard_size": shard_size,
        })
        proof = r["proof"]
        if verify:
            self._local.verify(proof, pk.vk_handle)
        return proof

    def compressed_prove(self, pk: _RemoteProvingKey, stdin=None,
                         shard_size=None, deferred=None,
                         verify: bool = True, vk_root=None, registry=None):
        """Remote compressed prove with untrusted-remote re-verification.
        Pass the client-pinned allowed-vk `registry` (or just its root) so
        the local check also rejects a remote that substituted its own
        recursion program — the registry root is the full trust anchor
        (recursion/shape_universe.py build_full_registry)."""
        r = self._call("CompressedProve", {
            "program_id": pk.program_id,
            "stdin": stdin.buffers if stdin else None,
            "shard_size": shard_size,
            "deferred": deferred,
        })
        compressed = r["compressed"]
        if verify:
            self._local.verify_compressed(compressed, pk.vk_handle,
                                          vk_root=vk_root,
                                          registry=registry)
        return compressed
