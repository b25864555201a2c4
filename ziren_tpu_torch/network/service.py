"""Prover RPC service (reference: crates/cuda/proto/api.proto ProverService
{Ready, Setup, ProveCore, Compress, ...} + crates/cuda/src/lib.rs twirp
server wiring).

A ThreadingHTTPServer wrapping one in-process ProverClient. Method routes
mirror the reference's twirp layout (`/twirp/ProverService/<Method>`);
payloads are pickled dicts DESERIALIZED THROUGH AN ALLOWLIST
(network/wire.py) so a request body cannot smuggle arbitrary callables —
the data-only posture of the reference's bincode payloads. Binds loopback
by default; intended for the trust domain the reference uses it in (a
local container / a machine-room DCN link), NOT the open internet.

Programs/keys are registered once per Setup and addressed by a program id
(sha256 of the decoded instructions + load base + memory image) so
ProveCore requests stay small — the reference keeps proving keys
server-side the same way (api.proto SetupRequest/ProveCoreRequest)."""

from __future__ import annotations

import hashlib
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..network import wire
from ..sdk import ProverClient, ZirenStdin


def program_id(program) -> str:
    """sha256 over everything the preprocessed commitment binds: entry pc,
    load base, the decoded instruction stream (asm-built programs have no
    raw words, so hash the decoded fields, which are what the Program chip
    commits to), AND the initial memory image — two guests with identical
    code but different data sections must not collide, or Setup would
    silently reuse the first program's proving key."""
    h = hashlib.sha256()
    h.update(struct.pack("<II", program.pc_start, program.pc_base))
    for ins in program.instructions:
        h.update(struct.pack(
            "<IIIIBB", ins.opcode.value & 0xFFFFFFFF,
            ins.op_a & 0xFFFFFFFF, ins.op_b & 0xFFFFFFFF,
            ins.op_c & 0xFFFFFFFF,
            int(ins.imm_b), int(ins.imm_c),
        ))
    for addr in sorted(program.image):
        h.update(struct.pack("<II", addr & 0xFFFFFFFF,
                             program.image[addr] & 0xFFFFFFFF))
    return h.hexdigest()


class ProverService:
    """Method registry; each handler takes/returns a plain dict."""

    def __init__(self, config: str = "core", device=None):
        # device=None is the GPU: the first prove raises without one
        self._client = ProverClient(config=config, device=device)
        self._keys = {}  # program id -> (ZirenProvingKey, ZirenVerifyingKey)
        self._lock = threading.Lock()

    # -- twirp-shaped methods ---------------------------------------------
    def Ready(self, req: dict) -> dict:
        return {"ready": True}

    def Setup(self, req: dict) -> dict:
        program = req["program"]
        pid = program_id(program)
        with self._lock:
            if pid not in self._keys:
                self._keys[pid] = self._client.setup(program)
        # the vk stays client-side: a sound client derives its own vk from
        # the program rather than trusting a server-supplied one (the
        # reference network prover re-verifies against the local vk too)
        return {"program_id": pid}

    def ExecuteProgram(self, req: dict) -> dict:
        pk, _ = self._pk(req)
        values, report = self._client.execute(
            pk.program, stdin=self._stdin(req))
        return {"public_values": values, "report": report}

    def ProveCore(self, req: dict) -> dict:
        pk, _ = self._pk(req)
        proof = self._client.prove(pk, stdin=self._stdin(req),
                                   shard_size=req.get("shard_size"))
        proof._records = None  # strip the server-side execution records
        return {"proof": proof}

    def CompressedProve(self, req: dict) -> dict:
        pk, _ = self._pk(req)
        rm, rvk, final_sp = self._client.compressed_prove(
            pk, stdin=self._stdin(req), shard_size=req.get("shard_size"),
            deferred=req.get("deferred"))
        return {"compressed": (rm, rvk, final_sp)}

    def Verify(self, req: dict) -> dict:
        _, vk = self._pk(req)
        ok = self._client.verify(req["proof"], vk)
        return {"ok": bool(ok)}

    # -- helpers ------------------------------------------------------------
    def _pk(self, req: dict):
        pid = req["program_id"]
        with self._lock:
            keys = self._keys.get(pid)
        if keys is None:
            raise KeyError(f"unknown program id {pid}; call Setup first")
        return keys

    @staticmethod
    def _stdin(req: dict):
        buffers = req.get("stdin")
        if buffers is None:
            return None
        s = ZirenStdin()
        for buf in buffers:
            s.buffers.append(bytes(buf))
        return s


class _Handler(BaseHTTPRequestHandler):
    service: ProverService = None  # set by ProverServer
    verifier = None  # auth.RequestVerifier when a key is configured

    def do_POST(self):
        prefix = "/twirp/ProverService/"
        if not self.path.startswith(prefix):
            self.send_error(404, "unknown route")
            return
        method = self.path[len(prefix):]
        handler = getattr(self.service, method, None)
        if handler is None or method.startswith("_"):
            self.send_error(404, f"unknown method {method}")
            return
        length = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(length) if length else b""
        if self.verifier is not None:
            # signed-request check BEFORE any deserialization (reference
            # sdk/src/network/prover.rs:32-49 signed jobs)
            from ..network import auth

            try:
                self.verifier.verify(method, self.headers, body)
            except auth.AuthError as e:
                self.send_error(401, str(e))
                return
        try:
            req = wire.loads(body) if body else {}
            resp = handler(req)
            body = wire.dumps({"ok": True, "result": resp})
        except Exception as e:  # error envelope, twirp-style
            body = wire.dumps({"ok": False, "error": repr(e)})
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet by default
        pass


class ProverServer:
    """Threaded HTTP prover server; context-manager friendly.

    >>> with ProverServer(config="dev") as srv:
    ...     prover = NetworkProver(srv.endpoint)
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 config: str = "core", key=None, device=None):
        from ..network import auth

        self.service = ProverService(config=config, device=device)
        k = auth.load_key(key)
        verifier = auth.RequestVerifier(k) if k is not None else None
        handler = type(
            "Handler", (_Handler,),
            {"service": self.service, "verifier": verifier},
        )
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.endpoint = "http://%s:%d" % self._httpd.server_address[:2]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
