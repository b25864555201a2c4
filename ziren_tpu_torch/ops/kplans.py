"""The launch plans of K3 and K4 (csrc/poseidon2.cu), in plain Python.

A plan is what a kernel is launched with and what each of its blocks or
warps reads and writes. `kernels.py` launches from these plans, and the
executors below run the same plans with the plain permutation on any
device, so that the index arithmetic the kernels share with them is held
against the plain versions on the CPU (tests/test_torch_kernel_plans.py).

K3 `zt_compress_levels` runs the Merkle levels below h <= 256 digests over a
thread-block cluster of B blocks: block b takes digests [b h/B, (b+1) h/B)
and the rows [b hh/B, (b+1) hh/B) of each injected level of height hh >= B,
and computes its subtree's levels (heights h/2 .. B) in its own shared
memory; block 0 then combines the B subtree roots (heights B/2 .. 1),
applying the injected levels of height below B. The level of height hh lies
at row h - 2 hh of the flat (h - 1, 8) output.

K4 `zt_grind` is an ordered search: its warps claim chunks of consecutive
candidate witnesses from a counter, in increasing order, and a warp stops at
its first claim that starts at or above the best witness found so far.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

P = 2130706433
DIGEST = 8
WIDTH = 16
RATE = 8

# K3: at most this many blocks in a cluster (the portable cluster size), and
# at most this many digests a block (its 16 warps take a pair each on its
# top level). Up to K3_ONE_BLOCK_MAX digests one block takes the whole tree.
K3_CLUSTER_MAX = 8
K3_BLOCK_DIGESTS_MAX = 32
K3_HEIGHT_MAX = K3_CLUSTER_MAX * K3_BLOCK_DIGESTS_MAX
K3_ONE_BLOCK_MAX = 16

# K4: threads a block, candidates a warp claims at once (one a lane), the
# int64 words of its scratch tensor (the best witness, then the counter),
# and the blocks it keeps on each multiprocessor (fewer if fewer fit).
K4_THREADS = 128
K4_CHUNK = 32
K4_SCRATCH = 32  # two 128-byte lines: best at word 0, the counter at word 16
K4_COUNTER = 16
K4_BLOCKS_PER_SM = 2
# Up to this many bits, where a few blocks' first candidates hold the
# witness, K4 runs PR 5's grid-stride form (grind_stride_kernel): on an H100
# it is 0.6-0.9 µs faster there than the ordered search, which wins from 12
# bits (PERF.md, PR 8).
K4_STRIDE_MAX_BITS = 8


@dataclass(frozen=True)
class K3Plan:
    h: int
    blocks: int  # B, the cluster's size
    sub: int  # h // B: the digests, and the leaves of the subtree, of a block
    # (height, output row) of each level a block computes, h/2 down to B
    block_levels: tuple
    # injected height hh >= B -> ((start, stop) of block b's rows, for each b)
    rows: dict
    # (height, output row) of each level block 0 computes from the B roots
    cross_levels: tuple
    cross_injected: tuple  # the injected heights below B, which those apply


def k3_blocks(h: int) -> int:
    """The cluster size for h digests: one block up to K3_ONE_BLOCK_MAX,
    else as many blocks of at least two digests as a cluster takes. (On an
    H100 a wider cluster wins from 32 digests, where a block's top level
    would be a pair for each of 16 or more warps, and one block wins below,
    where the cluster's barrier is all a split adds: PERF.md, PR 8.)"""
    return 1 if h <= K3_ONE_BLOCK_MAX else min(K3_CLUSTER_MAX, h // 2)


def k3_plan(h: int, injected_heights, blocks: int | None = None) -> K3Plan:
    """The plan of one K3 launch over (h, 8) digests with the given injected
    heights, on `blocks` blocks (k3_blocks(h) if None). Raises ValueError
    for a shape the kernel does not take."""
    if h < 2 or h > K3_HEIGHT_MAX or h & (h - 1):
        raise ValueError(f"compress_levels: bad height {h}")
    B = k3_blocks(h) if blocks is None else blocks
    if B < 1 or B > K3_CLUSTER_MAX or B & (B - 1) or 2 * B > h or h // B > K3_BLOCK_DIGESTS_MAX:
        raise ValueError(f"compress_levels: {B} blocks cannot split {h} digests")
    heights = sorted(set(injected_heights), reverse=True)
    for hh in heights:
        if not 1 <= hh < h or hh & (hh - 1):
            raise ValueError(f"compress_levels: bad injected level {hh} below {h}")
    sub = h // B

    def levels(top):
        out, hh = [], top
        while hh >= 1:
            out.append((hh, h - 2 * hh))
            hh //= 2
        return out

    block_levels = tuple((hh, off) for hh, off in levels(h // 2) if hh >= B)
    cross_levels = tuple(levels(B // 2))
    rows = {hh: tuple((b * hh // B, (b + 1) * hh // B) for b in range(B))
            for hh in heights if hh >= B}
    return K3Plan(h, B, sub, block_levels, rows, cross_levels,
                  tuple(hh for hh in heights if hh < B))


def _compress(cur: torch.Tensor, inj, permute) -> torch.Tensor:
    """One level: perm(left || right)[:8], then perm(. || injected)[:8]."""
    cur = permute(cur.reshape(-1, WIDTH))[:, :DIGEST]
    if inj is not None:
        cur = permute(torch.cat([cur, inj], dim=1))[:, :DIGEST]
    return cur


def run_k3_plan(plan: K3Plan, digests: torch.Tensor, injected: dict,
                permute=None) -> torch.Tensor:
    """K3's plan with the plain permutation: each block's subtree from its
    own digests and injected rows, then the cross levels from the B roots.
    Returns the flat (h - 1, 8) output, filled at the plan's rows; its
    split into levels (kernels.split_levels) equals compress_levels_plain."""
    if permute is None:
        from .tposeidon2 import permute_plain as permute
    B, sub = plan.blocks, plan.sub
    out = torch.full((plan.h - 1, DIGEST), -1, dtype=torch.int64, device=digests.device)
    roots = []
    for b in range(B):
        cur = digests[b * sub : (b + 1) * sub]
        for hh, off in plan.block_levels:
            lo, hi = plan.rows[hh][b] if hh in plan.rows else (0, 0)
            cur = _compress(cur, injected[hh][lo:hi] if hh in plan.rows else None, permute)
            out[off + b * (hh // B) : off + (b + 1) * (hh // B)] = cur
        roots.append(cur)
    cur = torch.cat(roots)
    for hh, off in plan.cross_levels:
        cur = _compress(cur, injected.get(hh) if hh in plan.cross_injected else None, permute)
        out[off : off + hh] = cur
    return out


@dataclass(frozen=True)
class K4Plan:
    grid: int  # blocks, all resident at once
    threads: int  # a block
    chunk: int  # consecutive candidates a warp claims
    scratch: int  # int64 words, all p on entry: the best witness, the claim counter
    ordered: bool = True  # the ordered search, or the grid-stride form


def k4_plan(nb_bits: int, occupancy: tuple) -> K4Plan:
    """The plan of one K4 launch. `occupancy` is (blocks a multiprocessor
    holds at once, multiprocessors), from the occupancy calculator. The grid
    is K4_BLOCKS_PER_SM resident blocks on each multiprocessor (all of them
    if fewer fit), or fewer blocks where twice the expected witness,
    2 * 2^nb_bits candidates, fills fewer: a first wave no larger than the
    search needs. Up to K4_STRIDE_MAX_BITS the form is the grid-stride one,
    on as many blocks."""
    if not 0 <= nb_bits <= 31:
        raise ValueError(f"grind: bad nb_bits {nb_bits}")
    per_sm, sms = occupancy
    if per_sm < 1 or sms < 1:
        raise ValueError(f"grind: no block of K4 fits on the card ({occupancy})")
    want = -(-(2 << nb_bits) // K4_THREADS)
    if nb_bits <= K4_STRIDE_MAX_BITS:
        return K4Plan(min(sms * per_sm, want), K4_THREADS, K4_CHUNK, K4_SCRATCH, ordered=False)
    return K4Plan(min(sms * min(per_sm, K4_BLOCKS_PER_SM), want), K4_THREADS, K4_CHUNK,
                  K4_SCRATCH)


def grind_hits(state, inputs, nb_bits: int, count: int, permute=None) -> np.ndarray:
    """hits[w] for w < count: whether witness w passes, through the plain
    permutation (the duplex of [inputs, w, state[n_in + 1:]])."""
    if permute is None:
        from .tposeidon2 import permute_plain as permute
    state = torch.as_tensor(state, dtype=torch.int64)
    inputs = torch.as_tensor(inputs, dtype=torch.int64)
    n_in = int(inputs.numel())
    w = torch.arange(count, dtype=torch.int64)[:, None]
    states = torch.cat([inputs.expand(count, n_in), w,
                        state[n_in + 1 :].expand(count, WIDTH - n_in - 1)], dim=1)
    out = permute(states)
    return ((out[:, RATE - 1] & ((1 << nb_bits) - 1)) == 0).numpy()


def run_k4_plan(plan: K4Plan, hit, order_seed: int) -> tuple:
    """K4's plan as its warps run it, with every step of every lane taken in
    an order drawn from `order_seed`: warp g starts on chunk g (the chunks
    claimed by position) with a claim ahead (the counter's atomicAdd, from
    p) that lands at a step of its own; after each chunk, a read of best,
    the stop tests (best at most the first claimed start, or the next chunk
    at or above best), the claim ahead taken (waiting for it to land) and
    the next one issued; each lane's tests of its candidates below the best
    read (`hit(w)`; a candidate may be dropped once best is at or below it)
    and the atomicMin of a hit, interleaved across warps and lanes. The
    grid-stride form's threads step in the same drawn order. Returns (best,
    the candidates tested)."""
    rng = np.random.default_rng(order_seed)
    if not plan.ordered:
        return _run_k4_stride(plan, hit, rng)
    lanes_per_warp = 32
    warps = plan.grid * plan.threads // lanes_per_warp
    first = warps * plan.chunk
    best, counter = P, P
    tested: set = set()

    def lanes_of(start, below):
        return [("test", start + lane) for lane in range(lanes_per_warp)
                if start + lane < min(start + plan.chunk, below)]

    # a warp: [phase, start, the claim ahead (None while in flight), best as
    # read, lane steps]; phase "lanes" | "read" | None
    state = [["lanes", g * plan.chunk, None, P, lanes_of(g * plan.chunk, P)]
             for g in range(warps)]
    inflight = [True] * warps  # whether a claim ahead was issued and has not landed

    def land(i):
        nonlocal counter
        state[i][2] = counter - P + first
        counter += plan.chunk
        inflight[i] = False

    while True:
        live = [i for i, s in enumerate(state) if s[0] is not None]
        if not live:
            return best, tested
        i = live[int(rng.integers(len(live)))]
        s = state[i]
        if inflight[i] and rng.integers(2):
            land(i)
            continue
        if s[0] == "read":
            s[3] = best
            if s[3] <= first:
                s[0] = None
                continue
            if inflight[i]:  # the shuffle waits for the claim ahead
                land(i)
            s[1], s[2] = s[2], None
            inflight[i] = True  # the next claim ahead
            if s[1] >= s[3]:
                s[0] = None
            else:
                s[0], s[4] = "lanes", lanes_of(s[1], s[3])
            continue
        enabled = [j for j, st in enumerate(s[4]) if st is not None]
        if not enabled:
            s[0] = "read"
            continue
        j = enabled[int(rng.integers(len(enabled)))]
        kind, w = s[4][j]
        if kind == "test" and w >= best and rng.integers(2):
            s[4][j] = None  # dropped between its rounds: a witness below it is known
        elif kind == "test":
            tested.add(w)
            if hit(w):
                s[4][j] = ("min", w)
            else:
                nxt = w + lanes_per_warp
                s[4][j] = ("test", nxt) if nxt < min(s[1] + plan.chunk, s[3]) else None
        else:
            best = min(best, w)
            s[4][j] = None


def _run_k4_stride(plan: K4Plan, hit, rng) -> tuple:
    """The grid-stride form: thread t tests t, t + stride, ... and stops at a
    hit (its atomicMin a step of its own) or at its first candidate above
    the best it reads; the threads' steps in a drawn order."""
    stride = plan.grid * plan.threads
    best = P
    tested: set = set()
    # a thread: ("read", w) | ("test", w) | ("min", w) | None
    threads = [("read", t) for t in range(stride)]
    while True:
        live = [t for t, st in enumerate(threads) if st is not None]
        if not live:
            return best, tested
        t = live[int(rng.integers(len(live)))]
        kind, w = threads[t]
        if kind == "read":
            threads[t] = None if w > best or w >= P else ("test", w)
        elif kind == "test":
            tested.add(w)
            threads[t] = ("min", w) if hit(w) else ("read", w + stride)
        else:
            best = min(best, w)
            threads[t] = None
