"""Wall clock of the recursion chain through the port: core prove -> lift
every shard -> join tree -> shrink, every proof made by the torch shard
prover on one device (the GPU unless --device names another).

    python3 -m ziren_tpu_torch.tools.compress_bench [--n 58218] [--config core|dev]
        [--shards K] [--registry full|tree|lift] [--workers N] [--device cpu]
        [--no-shrink] [--profile]

--shards K compresses only the first K shard proofs (a partial range: a
valid proof with is_complete = 0, checked by the recursion machine's own
verify instead of verify_compressed). --registry full is compress's default,
the lift + join closure over the shards' shapes (170 joins traced without
proving for two shapes); tree is the registry of exactly the tree that
compress builds over these shards (`tree_registry`); lift is the lift-only
registry, which carries one layer of joins, so at most two shards. --workers
sets ZIREN_RECURSION_WORKERS. --profile runs one more lift under
torch.profiler and prints the device's busy share of it.

Prints the seconds of every lift and join with their split (see
`instrument`), of the registry enumeration and of shrink, the chips and
heights of the lift, join and shrink machines, the kernels' launch counts
and launch shapes, peak device and host memory, and one JSON object as its
last line. chip_smoke.py's recursion and composition phases use
`instrument`, `summary` and `tree_registry` too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import resource
import threading
import time

import numpy as np
import torch

from .. import kernels
from ..recursion import deferred as rd
from ..recursion import mips_pipeline as mp
from ..recursion import pipeline as pl
from ..stark import machine as smachine
from ..stark import tprover
from ..stark.backend import resolve_device
from ..stark.proof import MachineProof

_tl = threading.local()
# the nodes of the composition path that `instrument` times, each a
# recursion proof (deferred_chain is leaves and joins)
DEFERRED_NODES = ("deferred_leaf", "deferred_join", "attach_deferred")


def _part(name, fn):
    """fn, with its seconds added to `name` of the node the calling thread
    is inside of."""
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            cur = getattr(_tl, "cur", None)
            if cur is not None:
                cur[name] = cur.get(name, 0.0) + time.perf_counter() - t0
    return wrapper


def _node(kind, fn, out):
    """fn (a lift, a join, a shrink, a deferred node) as one node of the
    tree: its seconds and those of its parts, appended to out[kind], or to
    out["enum_" + kind] when the call only enumerates a vk (setup_only /
    phantom)."""
    def wrapper(*a, **k):
        enum = k.get("setup_only") or k.get("phantom")
        _tl.cur = cur = {}
        t0 = time.perf_counter()
        try:
            res = fn(*a, **k)
        finally:
            _tl.cur = None
        total = time.perf_counter() - t0
        setup = cur.get("setup", 0.0)
        inner = cur.get("prove_cached", setup)
        prove = cur.get("machine_prove", 0.0)
        gen = cur.get("trace_gen", 0.0)
        pk_s = cur.get("device_pk", 0.0)
        entry = {
            "total_s": total,
            "trace_verifier_s": total - inner,
            "setup_s": setup,
            "witness_s": inner - setup - prove + gen,
            "device_pk_s": pk_s,
            "prove_s": prove - gen - pk_s,
        }
        # (rec_machine, rec_vk, shard proof | machine proof | None, ...)
        sp = getattr(res[2], "shard_proofs", [res[2]])[0]
        if sp is not None:
            entry["machine"] = machine_shape(sp, res[0])
        out.setdefault("enum_" + kind if enum else kind, []).append(entry)
        return res
    return wrapper


@contextlib.contextmanager
def instrument():
    """Times the recursion tree without changing it. Yields a dict that
    fills with one entry a node that ran to its end: {"lift": [...], "join":
    [...], "shrink": [...], "enum_lift": [...], "enum_join": [...]}, and on
    the composition path (recursion/deferred.py) "deferred_leaf",
    "deferred_join" and "attach_deferred". An entry has the node's machine
    (machine_shape) when it proved, and splits its total_s into
    trace_verifier_s (the traced shard verifier: the DSL program), setup_s
    (machine and keys; the preprocessed commit on the host, 0 when the shape
    is cached), witness_s (register values and host trace generation),
    device_pk_s (the preprocessed commit again on the device, once a key)
    and prove_s (the shard prover: dispatch, fetch, assembly)."""
    out: dict = {}
    proved = _part("prove_cached", pl._prove_cached)
    saved = [(mp, "lift_shard", mp.lift_shard), (mp, "join", mp.join), (pl, "lift", pl.lift),
             (mp, "_prove_cached", mp._prove_cached), (pl, "_prove_cached", pl._prove_cached),
             (rd, "_prove_cached", rd._prove_cached),
             *[(rd, name, getattr(rd, name)) for name in DEFERRED_NODES],
             (pl, "_setup_cached", pl._setup_cached),
             (smachine.StarkMachine, "prove", smachine.StarkMachine.prove),
             (tprover, "_named_traces", tprover._named_traces),
             (tprover, "device_pk", tprover.device_pk)]
    mp.lift_shard = _node("lift", mp.lift_shard, out)
    mp.join = _node("join", mp.join, out)
    pl.lift = _node("shrink", pl.lift, out)
    for name in DEFERRED_NODES:
        setattr(rd, name, _node(name, getattr(rd, name), out))
    mp._prove_cached = pl._prove_cached = rd._prove_cached = proved
    pl._setup_cached = _part("setup", pl._setup_cached)
    smachine.StarkMachine.prove = _part("machine_prove", smachine.StarkMachine.prove)
    tprover._named_traces = _part("trace_gen", tprover._named_traces)
    tprover.device_pk = _part("device_pk", tprover.device_pk)
    try:
        yield out
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def machine_shape(shard_proof, rec_machine) -> list:
    """[(chip, log2 height, main width, preprocessed width)] of a recursion
    proof, tallest first as proved."""
    return [(n, v.log_degree, rec_machine.chip_by_name[n].width,
             rec_machine.chip_by_name[n].preprocessed_width)
            for n, v in zip(shard_proof.chip_names, shard_proof.opened_values)]


def summary(entries) -> str:
    """One line a node: total and split, seconds."""
    keys = ("trace_verifier_s", "setup_s", "witness_s", "device_pk_s", "prove_s")
    return "; ".join(
        f"{e['total_s']:.2f} (" + ", ".join(f"{k[:-2]} {e[k]:.2f}" for k in keys) + ")"
        for e in entries)


def tree_registry(machine, vk, shard_proofs, config):
    """The allowed-vk registry of exactly the tree that compress builds over
    these shard proofs: the vk of every lift shape and of every join of that
    tree, bottom-up, each traced without proving over a structural stand-in
    of its children (shape_universe's phantom tracing). A subset of the full
    registry, at its fixed height, so the join programs are the same."""
    from ..recursion import shape_universe as su
    from ..recursion.vk_registry import VkRegistry

    depth = (su.FIXED_REGISTRY_HEIGHT - 1).bit_length()
    nodes: dict = {}

    def node(key, make):
        if key not in nodes:
            rm, rvk = make()
            stand_in = su.phantom_shard_proof(rm, rvk, su.recursion_proof_shape(rm, rvk))
            nodes[key] = (rm, rvk, stand_in)
        return nodes[key]

    layer = []
    for sp in shard_proofs:
        shape = tuple(zip(sp.chip_names, (v.log_degree for v in sp.opened_values)))
        layer.append(node(shape, lambda: su.phantom_lift_vk(machine, vk, shape, config=config)))
    while len(layer) > 1:
        nxt = [node((id(a), id(b)), lambda: mp.join(a, b, config=config, phantom=True,
                                                    registry_depth=depth)[:2])
               for a, b in zip(layer[0::2], layer[1::2])]
        layer = nxt + layer[len(nxt) * 2:]
    commits = {np.asarray(rvk.commit, np.uint32).tobytes() for _rm, rvk, _sp in nodes.values()}
    return VkRegistry([np.frombuffer(c, np.uint32) for c in sorted(commits)],
                      height=su.FIXED_REGISTRY_HEIGHT)


def device_busy_share(fn) -> tuple:
    """Runs fn() under torch.profiler; returns (wall s, device-busy s, kernel
    launches). Busy time is the sum of every kernel's device time on the
    one stream the prover uses."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = launches = 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        busy += t
        launches += e.count
    return wall, busy / 1e6, launches


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=58218)
    ap.add_argument("--shard-size", type=int, default=(1 << 16) - 64)
    ap.add_argument("--config", default="core", choices=["core", "dev"])
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--registry", default="full", choices=["full", "tree", "lift"])
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--no-shrink", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    from ..executor.asm import fibonacci_program
    from ..machine.mips import execute_sharded, mips_machine, verify_mips_proof
    from ..stark import config as sconfig

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if args.workers:
        os.environ["ZIREN_RECURSION_WORKERS"] = str(args.workers)
    core = args.config == "core"
    cfg = sconfig.core_config() if core else sconfig.dev_config()
    shrink_cfg = sconfig.compressed_config() if core else sconfig.compressed_dev_config()
    out = {"workload": f"fibonacci({args.n})", "config": args.config, "device": str(dev),
           "card": torch.cuda.get_device_name(0) if on_card else None}

    program = fibonacci_program(args.n)
    machine = mips_machine(cfg)
    pk, vk = machine.setup(program)
    ex, records = execute_sharded(program, args.shard_size)
    t0 = time.perf_counter()
    proof = machine.prove(pk, records, fix_shapes=True, device=dev)
    out["core_prove_s"] = time.perf_counter() - t0
    assert verify_mips_proof(machine, vk, proof, pc_start=program.pc_start)
    out["cycles"], out["shards"] = int(ex.global_clk), len(proof.shard_proofs)
    print(f"core prove: {out['shards']} shards, {out['core_prove_s']:.2f} s", flush=True)

    part = proof
    if args.shards and args.shards < len(proof.shard_proofs):
        part = MachineProof(proof.shard_proofs[: args.shards])
    out["compressed_shards"] = len(part.shard_proofs)

    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with instrument() as times:
        registry = None
        t0 = time.perf_counter()
        if args.registry == "lift":
            registry = mp.build_lift_registry(machine, vk, part.shard_proofs, config=cfg)
        elif args.registry == "tree":
            registry = tree_registry(machine, vk, part.shard_proofs, cfg)
        t1 = time.perf_counter()
        rm, rvk, root = mp.compress(machine, vk, part, config=cfg, registry=registry,
                                    device=dev)
        out["compress_s"] = time.perf_counter() - t0
        out["registry_s"] = t1 - t0
        if len(part.shard_proofs) == len(proof.shard_proofs):
            # only the lift-only registry lacks the root's vk
            mp.verify_compressed(machine, vk, rm, rvk, root, pc_start=program.pc_start,
                                 registry=registry if args.registry == "tree" else None,
                                 vk_root=registry.root if registry else None)
        else:
            assert rm.verify(rvk, MachineProof([root]))
            assert int(root.public_values[mp.RPV_IS_COMPLETE]) == 0
        if not args.no_shrink:
            t0 = time.perf_counter()
            sm, svk, sproof, _ = pl.shrink(rm, rvk, root, config=shrink_cfg, device=dev)
            out["shrink_s"] = time.perf_counter() - t0
            assert sm.verify(svk, sproof)
    out["times"] = times
    out["enum_s"] = sum(e["total_s"] for k in ("enum_lift", "enum_join")
                        for e in times.get(k, []))
    out["launches"] = dict(kernels.LAUNCHES)
    out["shapes"] = {k: {str(s): c for s, c in v.items()} for k, v in kernels.SHAPES.items()}
    if on_card:
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    out["peak_host_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(f"peak resident host memory {out['peak_host_rss_bytes'] / 2**30:.2f} GiB", flush=True)

    for kind in ("lift", "join", "shrink"):
        print(f"{kind}: " + summary(times.get(kind, [])), flush=True)
    print(f"registry enumeration {out['enum_s']:.2f} s "
          f"({len(times.get('enum_lift', []))} lifts, {len(times.get('enum_join', []))} joins "
          f"traced without proving); compress {out['compress_s']:.2f} s", flush=True)
    for kind in ("lift", "join", "shrink"):
        for e in times.get(kind, [])[-1:]:
            print(f"last {kind}'s machine (chip, log2 height, width, preprocessed width): "
                  f"{e['machine']}", flush=True)

    if args.profile and on_card:
        sp = part.shard_proofs[0]
        wall, busy, n = device_busy_share(
            lambda: mp.lift_shard(machine, vk, sp, config=cfg, device=dev))
        out["profiled_lift"] = {"wall_s": wall, "device_busy_s": busy, "launches": n}
        print(f"one more lift under the profiler: {wall:.2f} s wall, device busy "
              f"{busy:.3f} s ({100 * (1 - busy / wall):.1f}% idle), {n} launches", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
