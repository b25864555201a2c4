"""Whole-shard prover as ONE CUDA graph per (machine, shard shape, device,
mesh member) (counterpart of stark/fused.py).

The eager path (stark/tprover.py:dispatch_shard) issues every operation of
a shard from Python, some 55,000 launches, and the card waits on that
Python most of the time. Here the same device body (tprover.prove_body) is
captured once per (machine, shape, device) into a torch.cuda.CUDAGraph and
replayed for every shard of that shape: a shard is a copy of its traces and
public values into the graph's static input buffers, one replay, and a
clone of the static fetch vector. The grind is K4, so nothing in the body
waits on the host. The proofs come back in one device-to-host copy at the
end and are assembled by tprover.finish: byte-identical to the eager path
and to the host prover on the same records.

Capture follows a warm-up: the body runs once eagerly on the first shard of
a shape (that run is this shard's proof), which fills every cache the body
reads (device_pk, the constant and index tensors, the selectors); the graph
then keeps a reference to each of them. A capture or an instantiation that
fails raises: there is no fallback to the eager path.

On the CPU (device="cpu", which a caller has to name) there is no capture:
the body runs over the same static buffers at each call.

Threads: the table of built graphs is locked only to look up, claim, insert
or evict a key. A build runs outside that lock, so a shape already built
proves while another shape builds, and a second thread that meets a shape
being built waits for that build and does not build it again. Captures run
one at a time. A graph held by a call, or being built, is never evicted,
and an evicted graph's last replay ends before it goes. A replay runs on
the caller's current stream, after the graph's last replay, wherever that
ran. A mesh (stark.machine.prove's `devices`) builds one graph per member:
with _MEM_MAX = 4 the graphs of two members of a fibonacci proof (three
shapes between them) evict most others.

ZIREN_FUSED=1 makes stark.machine.prove's shard loop (and so
StarkMachine.prove's) take each shard through dispatch_fused here, as it
routes the JAX package's StarkMachine.prove to fused.py. A CUDA graph
cannot be written to disk, so fused.py's jax.export cache (aot.py) has no
counterpart.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time

import numpy as np
import torch

from .. import kernels
from ..ops import tfield as tf
from ..ops.tchallenger import TChallenger
from . import tfolder, tprover
from ..trace import span


def enabled() -> bool:
    """Opt-in (ZIREN_FUSED=1); off by default, as in the JAX package."""
    return os.environ.get("ZIREN_FUSED") == "1"


def _machine_key(machine, pk, chips, trace_domains, device, member=None):
    """The key of a _FusedShard. A mesh's member is in it (a device proved
    on without a mesh has the index None): two members on one card never
    share a graph's static buffers."""
    fri = machine.config.fri
    return (
        tuple((c.name, d.log_n) for c, d in zip(chips, trace_domains)),
        machine.num_public_values,
        fri.log_blowup, fri.num_queries, fri.proof_of_work_bits,
        getattr(machine.config, "commit_kind", "kb"),
        np.asarray(pk.vk.commit, np.uint32).tobytes(),
        tuple(int(x) for x in pk.vk.extra_observations),
        str(device),
        None if member is None else member.index,
    )


def _graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a captured, kept graph (cuGraphGetNodes from
    libcuda on its cudaGraph_t)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                               ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed with error {err}")
    return int(n.value)


class _FusedShard:
    """One (machine, shape, device): the static input buffers (the mains in
    chip order, the public values, the post-vk transcript), and on a CUDA
    device the graph that proves the shard in them, its static fetch
    output and the capture's launch histogram. `fill` loads a shard,
    calling the object proves it and returns a fresh fetch vector."""

    def __init__(self, machine, pk, chips, trace_domains, traces, public_values, device):
        self.machine, self.pk = machine, pk
        self.chips, self.trace_domains = chips, trace_domains
        self.device = device
        with span("upload", bytes=sum(4 * t.size for t in traces)):
            self.mains = [tf.from_host(t, device) for t in traces]
            self.pv = tprover.pv_tensor(public_values, device)
            base = machine.config.challenger()
            pk.vk.observe_into(base)
            self.ch = TChallenger.from_host(base, device)
        self.graph = None
        self.fetch = None
        self.meta = None
        self.histogram = None
        self.keep = ()
        self.capture_s = self.instantiate_s = 0.0
        self.nodes = self.pool_bytes = self.replays = 0
        self.lock = threading.Lock()  # one fill and replay at a time
        self.users = 0  # calls between their claim and the end of their replay (_MEM_LOCK)
        self.done = None  # CUDA event after the last replay and its fetch clone

    def _body(self):
        return tprover.prove_body(self.machine, self.pk, self.chips, self.trace_domains,
                                  self.mains, self.pv, self.ch.clone())

    def fill(self, traces, public_values) -> None:
        """Copy a shard's inputs into the static buffers, on the current
        stream (the one the replay runs on), once that stream has waited for
        the last replay, which may have run on another; the host arrays are
        uploaded first by a copy that returns only when it is done."""
        if self.done is not None:
            torch.cuda.current_stream(self.device).wait_event(self.done)
        with span("upload", bytes=sum(4 * t.size for t in traces)):
            for buf, t in zip(self.mains, traces):
                buf.copy_(tf.from_host(t, self.device))
            self.pv.copy_(tprover.pv_tensor(public_values, self.device))

    def warm_and_capture(self) -> torch.Tensor:
        """Prove the shard in the buffers eagerly (the warm-up; its fetch
        vector is returned), then, on a CUDA device, capture the body into
        a graph and instantiate it."""
        fetch, self.meta = self._body()
        if self.device.type != "cuda":
            return fetch
        torch.cuda.synchronize(self.device)
        # what a replay reads outside the graph's pool stays alive with it:
        # the warm-up has just filled the caches with all of it
        self.keep = (list(tf._CONSTS.values()), list(tfolder._SELECTORS.values()),
                     tprover.device_pk(self.machine, self.pk, self.device))
        with span("fused.capture") as sp, _CAPTURE_LOCK:
            torch.cuda.empty_cache()  # as the capture does first: the pool is what it adds
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            before = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            # thread_local: lifts of the recursion tree prove in a thread
            # pool, and another thread's eager work must not break this capture
            with kernels.recording() as hist:
                with torch.cuda.graph(graph, stream=torch.cuda.Stream(self.device),
                                      capture_error_mode="thread_local"):
                    self.fetch, meta = self._body()
            self.capture_s = time.perf_counter() - t0
            assert meta == self.meta, "the captured body differs from the warm-up"
            self.nodes = _graph_nodes(graph)
            t0 = time.perf_counter()
            graph.instantiate()
            torch.cuda.synchronize(self.device)
            self.instantiate_s = time.perf_counter() - t0
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - before
            sp.set(nodes=self.nodes)
        self.graph, self.histogram = graph, hist
        return fetch

    def __call__(self):
        """(the fetch vector, CUDA events around the replay or None)."""
        if self.graph is None:
            return self._body()[0], None
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        with span("fused.replay"):
            events[0].record()
            self.graph.replay()
            events[1].record()
        self.replays += 1
        kernels.credit(self.histogram)
        fetch = self.fetch.clone()  # cloned before the next replay overwrites it
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(self.device))
        return fetch, events

    def release(self) -> None:
        """Wait for the last replay, once this shard is no longer held:
        its graph's pool and buffers are then free to go."""
        if self.done is not None:
            self.done.synchronize()


_MEM: dict = {}  # key -> built _FusedShard, the least recently used first
_MEM_MAX = 4  # graphs kept: each holds its memory pool
_BUILDS: dict = {}  # key -> threading.Event, set when the build of that key ends
# Held only to look up or claim a key, and to insert or evict one: a build
# (warm-up and capture, seconds) runs outside it, so a shape already built
# proves while another builds; a thread that meets a key being built waits
# for that build alone and takes its graph.
_MEM_LOCK = threading.Lock()
# Held by a capture and its instantiation: no two captures run at once.
_CAPTURE_LOCK = threading.Lock()


def _claim(key):
    """(the built _FusedShard of `key`, None), held against eviction until
    its replay is issued; or (None, the Event of the build this thread now
    owns)."""
    while True:
        with _MEM_LOCK:
            fs = _MEM.pop(key, None)
            if fs is not None:
                _MEM[key] = fs  # the newest last
                fs.users += 1
                return fs, None
            pending = _BUILDS.get(key)
            if pending is None:
                pending = _BUILDS[key] = threading.Event()
                return None, pending
        pending.wait()  # built (or failed: then this thread may claim it)


def _evict() -> list:
    """Under _MEM_LOCK: take out the least recently used graphs past
    _MEM_MAX that no call holds (one being built is not in _MEM yet)."""
    out = []
    for key in list(_MEM):
        if len(_MEM) <= _MEM_MAX:
            break
        if _MEM[key].users == 0:
            out.append(_MEM.pop(key))
    return out


def get_fused_fn(machine, pk, chips, trace_domains, traces, public_values, device,
                 member=None):
    """Prove one shard through the _FusedShard of its (machine, shape,
    device, mesh member). Returns (the _FusedShard, whether this call built
    it, the shard's fetch vector, the CUDA events around its replay or
    None). The first shard of a shape builds it: the warm-up proves that
    shard and the capture follows (a CUDA device); later shards are loaded
    into its buffers and replay, on the caller's current stream."""
    key = _machine_key(machine, pk, chips, trace_domains, device, member)
    fs, build = _claim(key)
    evicted = []
    if build is not None:
        try:
            fs = _FusedShard(machine, pk, chips, trace_domains, traces, public_values, device)
            fetch = fs.warm_and_capture()
            with _MEM_LOCK:
                _MEM[key] = fs
                evicted = _evict()
        finally:
            with _MEM_LOCK:
                del _BUILDS[key]
            build.set()
        built, events = True, None
    else:
        try:
            with fs.lock:
                fs.fill(traces, public_values)
                fetch, events = fs()
        finally:
            with _MEM_LOCK:
                fs.users -= 1
                evicted = _evict()
        built = False
    for old in evicted:
        old.release()
    return fs, built, fetch, events


def dispatch_fused(machine, pk, record, member):
    """The fused counterpart of tprover.dispatch_shard: one shard through
    the _FusedShard of its (machine, shape, device, mesh member), issued on
    the current stream without waiting for it. Returns dispatch_shard's
    dict, with "built" (if this call built the graph: its capture and
    instantiate seconds, nodes, pool bytes and launches recorded; else
    None) and "events" (the CUDA events around its replay, or None)."""
    chips, traces, trace_domains, public_values = tprover.shard_layout(machine, record)
    fs, built, fetch, events = get_fused_fn(machine, pk, chips, trace_domains, traces,
                                            public_values, member.device, member)
    summary = None
    if built:
        summary = {"capture_s": fs.capture_s, "instantiate_s": fs.instantiate_s,
                   "nodes": fs.nodes, "pool_bytes": fs.pool_bytes,
                   "launches": {k: sum(v.values()) for k, v in (fs.histogram or {}).items()}}
    return {"fetch": fetch, "meta": fs.meta, "chips": chips, "trace_domains": trace_domains,
            "public_values": public_values, "fri": machine.config.fri,
            "built": summary, "events": events}
