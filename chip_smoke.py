"""Chip smoke test of the PyTorch / CUDA port (ziren_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. torch / CUDA versions and the card's name and power limit;
  2. build the hand-written kernels from ziren_tpu_torch/csrc/;
  3. K1 (Poseidon2 row sponge), K2 (Poseidon2 permutation, both variants),
     K3 (the lower levels of a Merkle tree) and K4 (the proof-of-work grind)
     against their plain PyTorch versions on the card, bit-exact, at every
     shape the main path launches them with (K1_SHAPES, K2_SIZES, K3_SHAPES,
     K4_CASES below; phase 5 fails if its prove launches a shape that is not
     among them), and K1-K3 on a subsample and K4 on every case against the
     host numpy Poseidon2 and challenger; K3 on every cluster split
     (K3_SPLITS), K4 at (4, 16) on the seeded transcripts of
     kernel_bench.K4_TRANSCRIPTS (witnesses below 2^10, around 2^16, above
     131,072), and K3 and K4 each replayed three times from a CUDA graph on
     new inputs; kernel and plain times from CUDA events (K1-K3 over inputs
     that exceed the L2), beside the bound (ziren_tpu_torch/tools/
     kernel_bench.py defines it) and, for K3, its latency floor (one
     permutation's latency, from a chain timed on the card);
  4. a dev-config MIPS fibonacci(30) shard proved by the port, byte-equal to
     the host prover's proof, and verified;
  5. the main path: fibonacci(58218) at the core config (log_blowup 1,
     84 queries, 16 PoW bits), shards of 2^16 - 64 cycles, proved through
     ziren_tpu_torch.stark.machine.prove and checked by verify_mips_proof,
     with the kernels' launch counts and launch shapes from that run (one
     prove: the two more that showed the rate's spread went for the time
     of phase 14);
  6. ops/tmerkle.py and ops/tntt.py on the card against the host's
     core/merkle.py and core/ntt.py, bit-exact: leaf hashes and root of a
     seeded (2^17, 83) matrix, a fold of digest levels, a coset LDE;
  7. a small recursion shard: one dev-config lift of the fibonacci(30) shard
     proof, proved by the port on the card, byte-equal to the host prover's
     proof of the same record;
  8. the recursion path at full width: the first RECURSION_SHARDS shard
     proofs of phase 5's core-config proof are compressed on the card
     (mips_pipeline.compress: a lift each, then the join tree, under the
     registry of that tree's own vks in place of the full enumeration, which
     does not fit in this script's time) and the root is checked
     (verify_compressed for the whole execution, the recursion machine's
     verify and is_complete = 0 for a partial range), then shrunk under
     compressed_config() on the card
     (pipeline.shrink) and verified. Reports the seconds of every lift and
     join with their split, of the registry and of shrink, the machines'
     chips and heights, the kernels' launches and launch shapes on this path
     (each must be among those phase 3 held), and peak device memory;
  9. the service path, through the entry points a user calls: a
     ProverServer at the core config in this process (device left at its
     default, the GPU) and a NetworkProver pointed at it serve
     fibonacci(58218) in shards of 2^16 - 64 cycles: ready, setup, execute
     (the cycle count of phase 5), SERVED_IN_TURN proves in turn and two at
     once from two threads, each verified by the client's own ProverClient
     and byte-equal to an in-process machine.mips.prove_program of the same
     program (the SDK's setup observes the entry pc and its prove leaves the
     last shard at its own shape, so phase 5's proof, which does neither, is
     another proof); a second setup builds no second key; an unknown program
     id comes back as an error and the server goes on answering. Then the
     CLI in processes of their own (python3 -m ziren_tpu_torch vkey, prove,
     verify at the dev config on a hand-written guest ELF; the same prove in
     this process gives the file's bytes and that leg's launches), and
     ProverClient(config="dev") up the ladder on fibonacci(30):
     compressed_prove (its default registry, the full enumeration, fits at
     this size only), verify_compressed, shrink_prove, wrap_prove (the host
     prover under outer_dev_config()), verify_wrapped. The registry is
     enumerated on the host by a process of its own, started with the
     script (ladder_registry: host trace generation gives the shard's shape,
     no proof is made), into the cache file that compressed_prove loads;
     phase 9 checks that the file was there first and that the root the
     proof carries is the file's. Then the composition through the SDK
     (ladder_composition): a guest that claims that compressed proof twice
     (ladder_claim_guest; its registry enumerated by the same process, from
     the sub-guest's key and execution) proved with
     compressed_prove(pk, deferred=[root, root]) on the card: one lift, two
     deferred leaves, a deferred join, the attach; the root is complete and
     verify_compressed accepts it; one sub-proof for the two claims is
     refused before any recursion proof. Reports every request's seconds at
     the client and in the server's prove, the bytes of request and reply,
     the client's verify, each composition node's seconds and split, the
     kernels' launches and launch shapes (each among those phase 3 held)
     and peak device memory;
 10. the fused path: phase 5's program, machine and keys proved FUSED_PROVES
     times through ziren_tpu_torch.stark.tfused.prove_shards_fused (one CUDA graph
     per shard shape, captured on the first shard of a shape and replayed
     for the others); the first proof is of phase 5's records and must be
     byte-equal to phase 5's eager proof, shard for shard, and verify; the
     warm proves must make no eager wrapper call, and their launches
     must equal each graph's capture histogram times its replays. Reports
     the rate of each prove, capture, instantiate and replay seconds, graph
     nodes, the graph's memory pool, peak device memory, launches by kernel
     and shape, and the card's busy share of a replay (torch.profiler);
 11. the precompile path (ziren_tpu_torch/tools/precompile_programs.py):
     the four grouped programs, which call every precompile of the machine
     (the 35 chips a fibonacci shard leaves out), each proved on the card
     at the core config through ziren_tpu_torch.stark.machine.prove,
     byte-equal to the host prover's proof of the same records (made by a
     process started with the script, group_host_proofs), and verified; the
     SHA-256 and Keccak-256 chains of CHAIN_N rounds at the core config,
     each executed once and proved once eagerly (which pays the host trace
     generation) and twice through the fused path on the traces the script
     holds from it (held_traces: the first builds the graphs, the second
     replays them and makes no eager wrapper call), every proof byte-equal
     to the eager one and verified,
     the committed digest the expected one, and the SHA chain with a
     standalone precompile shard (no Cpu). Reports the deferral threshold,
     cycles, shards and each shard's chips and heights, the rate, per
     shard the trace-generation wait and the dispatch or replay seconds,
     fetch, assembly, host trace-generation seconds by chip, peak device
     memory, launches by kernel and shape, each graph's nodes, capture,
     instantiate and pool bytes (phase 10 measures a replay's busy share;
     the chains' went for the time of phase 14), and KeccakSponge's share
     of its shard's eager launches;
 12. the multi-device path (ziren_tpu_torch/device.py's Mesh, stark/ici.py,
     stark/sharded.py): a mesh of MESH_MEMBERS members, each a device and a
     stream of its own, all on the one card (one member per card when the
     machine has several). commit_row_sharded and leaf_hash_row_sharded of
     a seeded (2^17, 600) and a (2^17, 108) matrix over 1, 2 and 4
     members, bit-equal to ops/tpcs.merkle_commit on one device (phase 6
     holds that tree against the host), and ntt_mesh of the (2^17, 108)
     matrix, bit-equal to ops/tntt.ntt on one device; then phase 5's
     program over 2 members: prove_shards_sharded twice (the first builds
     each member's graphs, the second replays them) and
     StarkMachine.prove(devices=...) once, each byte-equal to phase 5's
     eager proof shard for shard (fix_shape pads as phase 5's cost model
     does) and verified. Reports the seconds of each commit and NTT against
     one device and K1's bound, each prove's rate, each member's graphs
     (capture, instantiate, nodes, pool), replays, peak device memory, and
     the launches and launch shapes of the path. Members that share a card
     cannot be faster than one: what this phase measures is the cost of the
     gather, the exchanges and the streams;
 13. the drivers (ziren_tpu_torch/tools and ziren_tpu_torch/examples), each
     through its main in this process with the device at its default, the
     GPU, its standard output captured, echoed and checked, its launches
     and launch shapes read after it (K1_DRIVER_SHAPES, K3_DRIVER_SHAPES):
     device_probe and profile_device on fibonacci(58218) at the core config
     in shards of 2^16 - 64 cycles (every stage and leg on a line of its
     own beside the card's name and power limit; both proofs verified, and
     profile_device's serial legs byte-equal to its machine.prove),
     bench_prove (its JSON line printed as is), tools/bench.py's three
     stages on fibonacci(BENCH_N) (in this process, as its child runs them:
     each line's backend cuda, the full stage's proof verified),
     profile_prove, the four
     precompile examples and network_prover at the dev config, prove_guest
     on minimal_elf(); then machine.mips.prove_program_checkpointed of the
     first CHECKPOINTED_SHARDS shards of fibonacci(58218) on the card, each
     shard verified (verify_shard: a prefix does not balance the execution's
     global sum), its main commitment and public values those of phase 9's
     unpadded prove_program. The
     Groth16 and Plonk wrap drivers are not run here (tens of minutes of
     host MSM and NTT each);
 14. the composition path (recursion/deferred.py) at the core config on the
     card, through compose(): fibonacci(COMPOSITION_N) proved and compressed
     to a complete root, verified; a guest that claims it with
     VERIFY_ZKM_PROOF (executor/asm.py:deferred_claim_program) proved,
     verified, and compressed seeded with the fold of its claim, which
     verify_compressed refuses alone (is_complete = 0); the deferred chain
     (one leaf, public values [0]*8 + the fold); the attach, complete,
     which verify_compressed accepts. Each compress is under its own tree's
     registry (compress_bench.tree_registry), as phase 8's. Reports each
     node's seconds and split (compress_bench.instrument), the machines'
     chips and heights, peak device memory, and the launches and launch
     shapes (K1_COMPOSITION_SHAPES, K3_COMPOSITION_SHAPES);
 15. standalone memory shards and unconstrained blocks at the core config
     on the card (phase_memory): tools/memory_programs.py's sweep of the
     card host's own combine_memory_threshold + SWEEP_EXTRA words, in
     shards of 2^16 - 64 cycles, has a memory shard with no Cpu; its eager
     proof is byte-equal, shard for shard, to the host prover's proof of the
     same records (memory_host_proof, a process started with the script),
     verifies, and a tampered address-bit chain is refused; the memory shard
     is lifted under its tree's registry and the lift verified; the
     unconstrained program's hint is read back, and its proof verifies.
     Reports the shards' chips and heights, trace generation by chip (the
     Global chip's), the legs, the lift's split, peak device memory, and the
     launches and launch shapes (K1_MEMORY_SHAPES, K3_MEMORY_SHAPES).

The script needs one CUDA card. The last two lines are the kernels' JSON
record and the result line
{"ok": true, "device": {...}}. Without CUDA the script fails before any
result is printed.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ziren_tpu_torch.device import require_cuda

KERNEL_SOURCE = "ziren_tpu_torch/csrc/poseidon2.cu"

# The shapes one fibonacci(58218) core-config prove launches each kernel
# with (its launch histogram, phase 5), and a few more. K1 (n, w): the trace,
# permutation, quotient and preprocessed matrices by height, the FRI layers
# (w = 8, every height down to 2), and the short chips (8 to 64 rows, up to
# 638 words); then ragged n, w < 8, w % 8 != 0 and a wide row at full height.
K1_SHAPES = [
    (131072, 108), (131072, 80), (131072, 20), (131072, 13),
    (32768, 46), (32768, 20),
    *[(1 << k, 8) for k in range(16, 0, -1)],
    (64, 46), (64, 16), (32, 14), (32, 4), (32, 1),
    (16, 66), (16, 48), (16, 24), (16, 14), (16, 12),
    (8, 638), (8, 300), (8, 104),
    (131072, 1), (131072, 7), (131072, 23), (131072, 83), (131072, 600), (131072 - 977, 83),
]
# The recursion path (phase 8): a lift, join or shrink machine has ten chips,
# all preprocessed, from RecFriFold at 2^18-2^19 rows down to RecOutput at 4;
# K1 hashes the LDEs (twice or four times the rows) of the main, permutation,
# quotient and preprocessed matrices by height (RecPoseidon2: 368 + 34
# columns), and the FRI layers from 2^20 rows down.
K1_RECURSION_SHAPES = [
    (1048576, 56), (1048576, 25), (1048576, 15), (1048576, 8), (524288, 56), (524288, 25),
    (524288, 21), (524288, 20), (524288, 16), (524288, 15), (524288, 8), (524288, 7),
    (262144, 413), (262144, 176), (262144, 90), (262144, 44), (262144, 32), (262144, 26),
    (262144, 16), (262144, 13), (262144, 12), (262144, 8), (262144, 4), (131072, 416),
    (131072, 404), (131072, 184), (131072, 152), (131072, 98), (131072, 85), (131072, 40),
    (131072, 32), (131072, 8), (2048, 24), (2048, 20), (2048, 1), (512, 226), (512, 4),
    (512, 1), (32, 10), (16, 4), (16, 1), (8, 4), (8, 3), (8, 1),
]
# K2 m: a duplex, the Merkle levels from 2^16 digests down to 256, the
# grind's batches of 2^14; 8 and 1,024 take the 16-lane variant, 2^16 the
# other. The recursion path's trees are up to 2^20 leaves tall.
K2_SIZES = [1, 8, *[1 << k for k in range(8, 21)]]
# K3 (h, injected heights): the trees of the traces hand over 256 digests
# and compress the short chips' digests in; a FRI tree of 256 leaves or
# fewer is one call with none.
K3_SHAPES = [(256, ()), (256, (64, 32, 16, 8)), (256, (128, 64, 8, 1)), (256, (32,)),
             *[(1 << k, ()) for k in range(7, 0, -1)], (16, (4,)),
             (256, (32, 16)), (256, (8,)), (256, (32, 16, 8))]
# The service path (phase 9). StarkMachine.prove as the SDK calls it leaves
# every shard at its own shape: the sixth shard of fibonacci(58218) is
# shorter than the five that phase 5 pads it to.
K1_SERVICE_SHAPES = [
    (131072, 28), (131072, 11), (65536, 97), (65536, 52), (65536, 12), (8192, 46), (8192, 20),
    (32, 47), (32, 24), (32, 12),
]
# The dev-config ladder (phase 9): lift, join and shrink machines of 8
# queries, from 2^16 rows down.
K1_LADDER_SHAPES = [
    (131072, 56), (131072, 28), (131072, 25), (131072, 15), (131072, 11), (65536, 100),
    (65536, 44), (65536, 41), (65536, 26), (65536, 24), (65536, 16), (32768, 3),
    (16384, 401), (16384, 144), (16384, 77), (16384, 28), (16384, 24), (16384, 16),
    (16384, 11), (8192, 393), (8192, 124), (8192, 61), (8192, 16), (512, 97), (512, 52),
    (512, 12), (64, 92), (64, 36),
]
# The CLI's guest (phase 9): sixteen words at the dev config, one shard whose
# chips are 8 to 256 rows tall beside the 2^16 rows of the memory and program
# tables; the tree of its traces takes five short chips' digests in.
K1_CLI_SHAPES = [
    (256, 75), (256, 44), (128, 22), (128, 4), (32, 84), (32, 44), (32, 20),
    (8, 601), (8, 284), (8, 96),
]
K3_CLI_SHAPES = [(256, (128, 64, 32, 16, 8))]
# K4 (n_in, nb_bits): every count of values the transcript can hold when it
# grinds, at the bits of every config the paths use (16: core, compressed;
# 4: dev, compressed_dev; 2: outer_dev).
K4_CASES = [(n_in, bits) for bits in (16, 4, 2) for n_in in range(8)]
# K3 on every cluster size (h, injected heights, blocks), with injected
# levels above the split between the blocks and block 0's cross levels, on
# it and below it.
K3_SPLITS = [(256, (128, 64, 8, 4, 1), 8), (128, (64, 4, 2, 1), 4), (64, (32, 2, 1), 2),
             (64, (16, 8, 4, 1), 8), (16, (8, 4, 2, 1), 8), (8, (4, 2, 1), 4), (4, (2, 1), 2),
             (32, (8, 1), 1)]
# The precompile path (phase 11): the grouped programs and the two chains
# at the core config. K1 hashes the traces of one height as one matrix:
# rows up to 6,988 words at 8,192 and 16,384 (KeccakSponge's 6,913 columns
# and the traces beside it) and 15,320 at 8 (the permutation traces of a group's
# 4-row chips); K3 takes new sets of injected heights. Found by one run of
# phase 11 with the check put off; launches_of names any shape left out.
K1_PRECOMPILE_SHAPES = [
    (131072, 57), (131072, 44), (131072, 16), (65536, 46), (65536, 14), (32768, 482), (32768, 244),
    (32768, 209), (32768, 96), (32768, 16), (32768, 14), (32768, 12), (16384, 6988), (16384, 476),
    (16384, 68), (16384, 14), (16384, 12), (8192, 6988), (8192, 476), (8192, 68), (8192, 57),
    (8192, 56), (8192, 24), (4096, 122), (4096, 68), (4096, 46), (4096, 24), (4096, 22),
    (4096, 20), (4096, 16), (4096, 14), (4096, 4), (2048, 90), (2048, 64), (2048, 22), (2048, 14),
    (2048, 12), (2048, 4), (1024, 125), (1024, 95), (1024, 80), (1024, 68), (1024, 46), (1024, 36),
    (1024, 24), (1024, 22), (1024, 16), (1024, 4), (512, 209), (512, 177), (512, 132), (512, 116),
    (512, 90), (512, 64), (512, 57), (512, 56), (512, 48), (512, 40), (512, 20), (512, 16),
    (512, 14), (512, 11), (256, 210), (256, 140), (256, 53), (256, 52), (256, 36), (256, 20),
    (256, 16), (256, 14), (256, 4), (256, 1), (128, 7529), (128, 728), (128, 147), (128, 88),
    (128, 52), (128, 36), (128, 28), (128, 24), (128, 16), (64, 22), (64, 4), (32, 204), (32, 106),
    (32, 56), (32, 32), (16, 106), (16, 56), (8, 15320), (8, 13220), (8, 10686), (8, 9112),
    (8, 3829), (8, 3012), (8, 1632), (8, 429), (8, 416), (8, 204), (8, 192), (8, 168), (8, 88),
    (8, 72),
]
K3_PRECOMPILE_SHAPES = [(256, (128, 32, 8)), (256, (128, 64, 16, 8)), (256, (128, 64, 32, 8)),
                        (256, (128, 8))]
# Phase 12: the members' row blocks of the (2^17, 600) and (2^17, 108)
# matrices over 2 and 4 members (K2 and K3 fold them at shapes held above;
# the gathered caps of 2 or 4 subtree roots are one K3 call of h = 2 or 4).
MESH_MEMBERS, MESH_ROWS = 4, 1 << 17
K1_MESH_SHAPES = [(MESH_ROWS // k, w) for k in (2, 4) for w in (600, 108)]
# The drivers (phase 13) that prove one short shard: bench_prove's
# fibonacci(2000) at the core config, profile_prove's fibonacci(500) and
# network_prover's fibonacci(200) at the dev config, and the four
# precompile examples at the dev config (KeccakSponge's 6,913 columns at 64
# rows). Recorded on the CPU, where the wrappers' plain versions take the
# same shapes; the full-width drivers (device_probe, profile_device, the
# checkpointed prove) launch the main path's and the service path's shapes.
K1_DRIVER_SHAPES = [
    (32768, 97), (32768, 52), (8192, 97), (8192, 52), (8192, 12), (4096, 75), (4096, 44),
    (1024, 20), (512, 46), (256, 90), (256, 64), (256, 46), (128, 692), (128, 348), (128, 177),
    (128, 116), (128, 40), (128, 14), (64, 6913), (64, 432), (64, 66), (64, 48), (64, 24),
    (32, 125), (32, 80), (32, 76), (32, 52), (16, 22), (8, 1840), (8, 1431), (8, 1372),
    (8, 720), (8, 581), (8, 280), (8, 136), (8, 112),
]
K3_DRIVER_SHAPES = [(256, (128, 32, 16, 8)), (256, (128, 16, 8)), (256, (128,))]
# The composition path: phase 14's lifts, deferred leaf and attach at the
# core config (the attach's machine: RecFriFold at 2^19, RecPoseidon2 at 2^17),
# and phase 9's composition leg at the dev config (the claim guest's shard,
# its lift, two leaves, a join, the attach). Recorded on the CPU from the
# plain versions' inputs, and the same in one run on the card with the check
# put off; launches_of names any shape left out.
K1_COMPOSITION_SHAPES = [
    (262144, 21), (262144, 20), (262144, 7), (131072, 413), (131072, 176), (131072, 90),
    (65536, 56), (65536, 25), (65536, 15), (32768, 44), (32768, 26), (16384, 3), (8192, 401),
    (8192, 144), (8192, 77), (1024, 1), (512, 76), (256, 122), (256, 68), (128, 57), (128, 56),
    (64, 156), (64, 145), (64, 112), (64, 80), (64, 44), (32, 152), (32, 40), (32, 19),
    (32, 16), (8, 475), (8, 224), (8, 80),
]
K3_COMPOSITION_SHAPES = [(256, (64, 32, 8)), (256, (32, 8))]
# Phase 15: the memory sweep's two execution shards (MemoryInstructions
# 2^15, MemoryLocal 2^14) and its memory shard (MemoryInit and MemoryFinal
# 2^15, Global 2^16), the memory shard's lift (RecFriFold 2^16) and the
# unconstrained program, at the core config. Found by one run on the card of
# phase 15 and phase 13's bench stages with the check put off (at the card
# host's threshold the sweep is a full-size run, not one for a CPU);
# launches_of names any shape left out.
K1_MEMORY_SHAPES = [
    (131072, 154), (131072, 132), (131072, 96), (131072, 63), (65536, 388), (65536, 120),
    (65536, 68), (65536, 63), (65536, 36), (512, 250), (512, 28), (512, 2), (128, 1),
    (64, 47), (64, 14), (64, 12), (32, 97), (8, 684), (8, 570), (8, 320), (8, 276),
]
K3_MEMORY_SHAPES = [(256, (64,))]
K1_ALL_SHAPES = list(dict.fromkeys(K1_SHAPES + K1_RECURSION_SHAPES + K1_SERVICE_SHAPES
                                   + K1_LADDER_SHAPES + K1_CLI_SHAPES + K1_PRECOMPILE_SHAPES
                                   + K1_MESH_SHAPES + K1_DRIVER_SHAPES
                                   + K1_COMPOSITION_SHAPES + K1_MEMORY_SHAPES))
K3_ALL_SHAPES = list(dict.fromkeys(K3_SHAPES + K3_CLI_SHAPES + K3_PRECOMPILE_SHAPES
                                   + K3_DRIVER_SHAPES + K3_COMPOSITION_SHAPES
                                   + K3_MEMORY_SHAPES))
FIB_N, SHARD_SIZE, FIB_CYCLES = 58218, (1 << 16) - 64, 349318
# How many of phase 5's six shard proofs phase 8 compresses: two make a
# tree of one join over two lifts, in about a fifth of the time all six
# take, so that the script with phases 9 and 11 stays inside its time limit.
# K1_RECURSION_SHAPES goes on holding the shapes of the six-shard tree.
RECURSION_SHARDS = 2
# Phase 9's requests served in turn (before the two at once) and phase 10's
# fused proves (the first builds the graphs, the others replay them): one
# and two, so that the script with phase 13 stays inside its time limit at
# the slowest pace its host-bound phases have shown (three of each before).
SERVED_IN_TURN, FUSED_PROVES = 1, 2
# Phase 13's checkpointed prove: the first two of fibonacci(58218)'s six
# shards (a cut of depth, six before), for the time of phase 14.
CHECKPOINTED_SHARDS = 2
# Phase 11: the rounds of each chain (the reference's sha2-chain and
# sha3-chain workloads, BASELINE.md): the sha2-chain's published 230, and
# the sha3-chain's 460 cut to a quarter (a half before phase 15 was added)
# for the host trace generation of KeccakSponge, so that the script stays
# inside its time limit at the slowest host pace it has shown.
CHAIN_N = {"sha256": 230, "keccak": 115}
# Phase 14: the sub-guest whose compressed proof the claim guest claims,
# fibonacci(2000), one shard of 12,010 cycles (bench_prove's workload).
COMPOSITION_N = 2000
# Phase 13: tools/bench.py's stages on bench_prove's workload, fibonacci(2000).
BENCH_N = 2000
# Phase 15: the memory sweep touches the card host's own
# combine_memory_threshold (SplitOpts.from_env(), read at run time) and
# SWEEP_EXTRA words more, so that its init and finalize events leave the
# execution shards for a memory shard at the production split options.
SWEEP_EXTRA = 4096


def minimal_elf(n: int = 10, vaddr: int = 0x10000) -> bytes:
    """A MIPS32 little-endian ET_EXEC file of one PT_LOAD segment (read and
    execute) holding sixteen hand-encoded words: fibonacci in registers, n
    turns of a loop, the result committed as public word 0, then the halt
    syscall. The guest file of the CLI legs, here and in the tests."""
    assert 0 < n < 0x8000
    words = [
        0x24080000 | n,  # addiu $t0, $zero, n
        0x24090000,      # addiu $t1, $zero, 0      a
        0x240A0001,      # addiu $t2, $zero, 1      b
        0x012A5821,      # loop: addu $t3, $t1, $t2
        0x25490000,      # addiu $t1, $t2, 0
        0x256A0000,      # addiu $t2, $t3, 0
        0x2508FFFF,      # addiu $t0, $t0, -1
        0x1D00FFFB,      # bgtz $t0, loop
        0x00000000,      # nop (the delay slot)
        0x24020010,      # addiu $v0, $zero, 0x10   COMMIT
        0x24040000,      # addiu $a0, $zero, 0      word 0
        0x25450000,      # addiu $a1, $t2, 0
        0x0000000C,      # syscall
        0x24020000,      # addiu $v0, $zero, 0      HALT
        0x24040000,      # addiu $a0, $zero, 0      exit code
        0x0000000C,      # syscall
    ]
    code = b"".join(struct.pack("<I", w) for w in words)
    ehdr = struct.pack("<16sHHIIIIIHHHHHH", b"\x7fELF\x01\x01\x01" + bytes(9), 2, 8, 1,
                       vaddr, 52, 0, 0x1000, 52, 32, 1, 40, 0, 0)
    phdr = struct.pack("<IIIIIIII", 1, 84, vaddr, vaddr, len(code), len(code), 5, 4)
    return ehdr + phdr + code


def phase_kernels(dev) -> dict:
    """Every kernel entry against its plain version, bit-exact, at the main
    path's shapes, with its time, its bound and the plain version's time.
    Returns {entry: {"max_abs_err", "shapes": {shape: (ms, plain_ms, bound_ms,
    bound_by)}}}."""
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.core import poseidon2 as hp2
    from ziren_tpu_torch.core.challenger import DuplexChallenger
    from ziren_tpu_torch.ops import tchallenger as tch
    from ziren_tpu_torch.ops import tfield as tf
    from ziren_tpu_torch.ops import tposeidon2 as tp2
    from ziren_tpu_torch.ops.tchallenger import TChallenger
    from ziren_tpu_torch.tools import kernel_bench as kb

    rng = np.random.default_rng(2026)
    rec = {}

    def note(name, shape, err, ms, plain_ms, bound):
        share = bound[0] / ms if ms else 0.0
        print(f"  {name} {shape}: bit-exact, kernel {ms:.4f} ms, bound {bound[0]:.3g} ms "
              f"({bound[1]}, {100 * share:.1f}% of the kernel's time), "
              f"plain {plain_ms:.3f} ms", flush=True)
        r = rec.setdefault(name, {"max_abs_err": 0, "shapes": {}})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"][shape] = (ms, plain_ms, *bound)

    def check(name, kernel, plain, host, x_np, reps, plain_reps, bound):
        """plain_reps 0: the plain version's time is that of its one call
        here, the comparison's."""
        x = tf.from_host(x_np, dev)
        got = kernel(x)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(x)
        end.record()
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        assert err == 0 and torch.equal(got, want), (name, x_np.shape, err)
        sub = np.r_[0:64, x_np.shape[0] - 64 : x_np.shape[0]]
        sub = np.unique(sub[(sub >= 0) & (sub < x_np.shape[0])])
        host_out = host(x_np[sub])
        assert np.array_equal(tf.to_host(got[torch.as_tensor(sub, device=dev)]), host_out), name
        xs = kb.cold_copies(x)
        note(name, tuple(x_np.shape), err, kb.cuda_ms(kernel, xs, reps),
             kb.cuda_ms(plain, xs[:1], plain_reps) if plain_reps else start.elapsed_time(end),
             bound)

    def rand(n, w):
        return rng.integers(0, 2130706433, (n, w), dtype=np.uint32)

    for n, w in K1_ALL_SHAPES:
        big = n * w >= 1 << 20
        # the plain sponge is timed over two calls at the main path's shapes,
        # else once: the widest rows take it seconds a call
        check("hash_rows", kernels.hash_rows, tp2.hash_rows_plain, hp2.hash_rows,
              rand(n, w), 10 if big else 30, 2 if (n, w) in K1_SHAPES else 0,
              kb.k1_bound(n, w))
    for m in K2_SIZES:
        check("permute", kernels.permute, tp2.permute_plain, hp2.permute,
              rand(m, 16), 50, 5, kb.k2_bound(m))
        x = tf.from_host(rand(m, 16), dev)
        assert torch.equal(kernels.permute_variant(x, True), kernels.permute_variant(x, False)), m
    # K3's second floor: its levels form a chain, each at least one
    # permutation's latency in its form, taken on the card
    launch = kb.launch_ms(dev)
    latency = kb.permute_latency(dev)
    perm_ms = latency[kb.K3_FORM]["ms"]
    print(f"  a launch of the least kernel: {launch:.4f} ms; one permutation's latency "
          "in a chain of dependent ones: "
          + ", ".join(f"{k} {v['cycles']:.0f} cycles, {v['ms']:.5f} ms" for k, v in latency.items())
          + f" (K3 takes {kb.K3_FORM})", flush=True)
    for h, heights in K3_ALL_SHAPES:
        cur = tf.from_host(rand(h, 8), dev)
        inj = {hh: tf.from_host(rand(hh, 8), dev) for hh in heights}
        got = kernels.compress_levels(cur, inj)
        want = tp2.compress_levels_plain(cur, inj)
        torch.cuda.synchronize()
        assert len(got) == len(want) == h.bit_length() - 1
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        assert err == 0 and all(torch.equal(g, w) for g, w in zip(got, want)), (h, heights)
        xs = kb.cold_copies(cur)
        note("compress_levels", (h, heights), err,
             kb.cuda_ms(lambda x: kernels.compress_levels(x, inj), xs, 50),
             kb.cuda_ms(lambda x: tp2.compress_levels_plain(x, inj), xs[:1], 3),
             kb.k3_bound(h, inj))
        floor = kb.k3_latency_floor(h, len(heights), perm_ms, launch)
        rec["compress_levels"].setdefault("latency_floor", {})[(h, heights)] = floor
        ms = rec["compress_levels"]["shapes"][(h, heights)][0]
        print(f"    latency floor {floor:.4f} ms ({h.bit_length() - 1} levels and "
              f"{len(heights)} injected, a launch): {100 * floor / ms:.1f}% of the kernel's time",
              flush=True)
    # every cluster that splits a level, with injected levels on both sides
    for h, heights, blocks in K3_SPLITS:
        cur = tf.from_host(rand(h, 8), dev)
        inj = {hh: tf.from_host(rand(hh, 8), dev) for hh in heights}
        got = kernels.compress_levels_split(cur, inj, blocks)
        want = tp2.compress_levels_plain(cur, inj)
        torch.cuda.synchronize()
        assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want)), \
            (h, heights, blocks)
    print(f"  compress_levels on {len(K3_SPLITS)} cluster splits: bit-exact", flush=True)
    for n_in, bits in K4_CASES:
        host = DuplexChallenger()
        host.observe_slice(rng.integers(0, 2130706433, 24 + n_in, dtype=np.uint32))
        tc = TChallenger.from_host(host.clone(), dev)
        state, inputs = tc.state, tc._concat_buffer().contiguous()
        assert tc._buf_n == n_in
        got = kernels.grind(state, inputs, bits)
        want = tch._grind(state, inputs, bits, n_in)
        torch.cuda.synchronize()
        err = abs(int(got) - int(want))
        assert err == 0 and torch.equal(got, want) and int(got) == host.grind(bits), (n_in, bits)
        print(f"  grind {(n_in, bits)}: witness {int(got)}", flush=True)
        note("grind", (n_in, bits), err,
             kb.cuda_ms(lambda x: kernels.grind(x, inputs, bits), [state], 20),
             kb.cuda_ms(lambda x: tch._grind(x, inputs, bits, n_in), [state], 2),
             kb.k4_bound(int(got), n_in))
    # the main path's grind on transcripts whose witnesses lie below 2^10,
    # around 2^16 and above 131,072
    n_in, bits = kb.K4_MAIN
    for seed in kb.K4_TRANSCRIPTS:
        host = kb.k4_transcript(seed)
        state, inputs = kb.k4_inputs(host, dev)
        got = kernels.grind(state, inputs, bits)
        want = tch._grind(state, inputs, bits, n_in)
        torch.cuda.synchronize()
        witness = host.grind(bits)
        assert torch.equal(got, want) and int(got) == witness, seed
        ms = kb.cuda_ms(lambda x: kernels.grind(x, inputs, bits), [state], 20)
        bound = kb.k4_bound(witness, n_in)
        rec["grind"].setdefault("bands", {})[witness] = (ms, *bound)
        print(f"  grind {kb.K4_MAIN}, transcript {seed}: witness {witness}, bit-exact, "
              f"kernel {ms:.4f} ms, bound {bound[0]:.4f} ms ({100 * bound[0] / ms:.1f}%)",
              flush=True)
    graph_replays(dev, rand)
    return rec


def graph_replays(dev, rand) -> None:
    """K3 and K4 each captured in a CUDA graph and replayed three times with
    new inputs copied into its buffers, each replay bit-exact against the
    plain version: K4 resets its scratch (best witness, counter) inside the
    graph, and a counter kept from the last replay would skip candidates."""
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.ops import tchallenger as tch
    from ziren_tpu_torch.ops import tfield as tf
    from ziren_tpu_torch.ops import tposeidon2 as tp2
    from ziren_tpu_torch.tools import kernel_bench as kb

    def replay3(capture, fill, check):
        capture()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = capture()
        for i in range(3):
            fill(i)
            graph.replay()
            torch.cuda.synchronize()
            check(i, out)

    h, heights = (256, (128, 64, 8, 1))
    cur = tf.from_host(rand(h, 8), dev)
    inj = {hh: tf.from_host(rand(hh, 8), dev) for hh in heights}

    def fill3(_i):
        cur.copy_(tf.from_host(rand(h, 8), dev))
        for hh, x in inj.items():
            x.copy_(tf.from_host(rand(hh, 8), dev))

    def check3(i, levels):
        want = tp2.compress_levels_plain(cur, inj)
        assert all(torch.equal(g, w) for g, w in zip(levels, want)), ("K3 replay", i)

    replay3(lambda: kernels.compress_levels(cur, inj), fill3, check3)
    n_in, bits = kb.K4_MAIN
    hosts = [kb.k4_transcript(s) for s in kb.K4_TRANSCRIPTS[::3]]
    state, inputs = (x.clone() for x in kb.k4_inputs(hosts[-1], dev))
    witnesses = []

    def fill4(i):
        st, inp = kb.k4_inputs(hosts[i], dev)
        state.copy_(st)
        inputs.copy_(inp)

    def check4(i, w):
        witnesses.append(int(w))
        assert int(w) == hosts[i].grind(bits), ("K4 replay", i)
        assert torch.equal(w, tch._grind(state, inputs, bits, n_in)), ("K4 replay", i)

    replay3(lambda: kernels.grind(state, inputs, bits), fill4, check4)
    print(f"  compress_levels {(h, heights)} and grind {kb.K4_MAIN} in CUDA graphs: three "
          f"replays each on new inputs, bit-exact (witnesses {witnesses})", flush=True)


def phase_small_shard(dev) -> tuple:
    from ziren_tpu_torch.executor.asm import fibonacci_program
    from ziren_tpu_torch.machine.mips import execute, mips_machine
    from ziren_tpu_torch.stark.config import dev_config
    from ziren_tpu_torch.stark.proof import MachineProof
    from ziren_tpu_torch.stark.prover import prove_shard
    from ziren_tpu_torch.stark.serialize import serialize_shard_proof
    from ziren_tpu_torch.stark import tprover

    program = fibonacci_program(30)
    machine = mips_machine(dev_config())
    pk, vk = machine.setup(program)
    _ex, record = execute(program)
    base = machine.config.challenger()
    pk.vk.observe_into(base)
    host = prove_shard(machine, pk, record, base.clone())
    t0 = time.perf_counter()
    port = tprover.prove_shard(machine, pk, record, base.clone(), dev)
    dt = time.perf_counter() - t0
    assert serialize_shard_proof(port) == serialize_shard_proof(host), \
        "port proof differs from the host prover's"
    assert machine.verify(vk, MachineProof([port]))
    print(f"  fibonacci(30) dev-config shard: byte-identical to the host proof, "
          f"verified ({dt:.2f} s on the port)", flush=True)
    return machine, vk, port


def launches_of(path: str) -> dict:
    """The kernels' counts since the last reset, read just after `path` ran.
    Fails if a kernel was not launched on it, or was launched at a shape
    that phase 3 did not hold."""
    from ziren_tpu_torch import kernels

    launches = dict(kernels.LAUNCHES)
    shapes = {k: dict(v) for k, v in kernels.SHAPES.items()}
    print(f"  kernel launches on {path}: {launches}", flush=True)
    for name, hist in shapes.items():
        print(f"  {name} launches by shape: "
              + ", ".join(f"{k}: {v}" for k, v in sorted(hist.items(), key=str)), flush=True)
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was not launched on {path}"
    held = {"hash_rows": set(K1_ALL_SHAPES), "permute": set(K2_SIZES),
            "compress_levels": set(K3_ALL_SHAPES), "grind": set(K4_CASES)}
    missed = {name: sorted(set(hist) - held[name], key=str) for name, hist in shapes.items()}
    assert not any(missed.values()), f"launched at shapes phase 3 did not hold: {missed}"
    return launches


def phase_main_path(dev) -> tuple:
    from ziren_tpu_torch.executor.asm import fibonacci_program
    from ziren_tpu_torch.machine.mips import execute_sharded, mips_machine, verify_mips_proof
    from ziren_tpu_torch.stark.config import core_config
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.stark.machine import prove

    n, shard_size = FIB_N, SHARD_SIZE
    program = fibonacci_program(n)
    machine = mips_machine(core_config())
    t0 = time.perf_counter()
    pk, vk = machine.setup(program)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex, records = execute_sharded(program, shard_size)
    exec_s = time.perf_counter() - t0
    cycles = int(ex.global_clk)
    assert cycles == FIB_CYCLES

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    proof = prove(machine, pk, records, fix_shapes=True, stats=stats)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = launches_of("the main path")
    grind_shape = max(kernels.SHAPES["grind"], key=kernels.SHAPES["grind"].get)
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    assert verify_mips_proof(machine, vk, proof, pc_start=program.pc_start)
    verify_s = time.perf_counter() - t0
    assert len(proof.shard_proofs) == len(records)

    print(f"  fibonacci({n}) core config: cycles {cycles}, shards {len(records)}, "
          f"setup {setup_s:.3f} s, execute {exec_s:.3f} s", flush=True)
    print(f"  prove {prove_s:.3f} s -> {cycles / prove_s / 1e3:.3f} kHz "
          f"(execute + prove {cycles / (exec_s + prove_s) / 1e3:.3f} kHz); "
          f"verify_mips_proof ok in {verify_s:.3f} s", flush=True)
    print("  per-shard dispatch s: "
          + ", ".join(f"{s:.3f}" for s in stats["dispatch_s"]), flush=True)
    print("  per-shard trace-gen wait s: "
          + ", ".join(f"{s:.3f}" for s in stats["trace_wait_s"])
          + f"; fetch {stats['fetch_s']:.3f} s, assemble {stats['assemble_s']:.3f} s",
          flush=True)
    print(f"  peak device memory allocated: {peak} bytes ({peak / 2**30:.3f} GiB)",
          flush=True)
    return launches, (program, machine, pk, vk, proof, records, grind_shape)


def phase_merkle_ntt(dev) -> None:
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.core import field as F
    from ziren_tpu_torch.core import merkle as hmerkle
    from ziren_tpu_torch.core import ntt as hntt
    from ziren_tpu_torch.ops import tfield as tf
    from ziren_tpu_torch.ops import tmerkle, tntt

    rng = np.random.default_rng(83)
    m = rng.integers(0, F.P_INT, (1 << 17, 83), dtype=np.uint32)
    tree = hmerkle.commit([m])
    x = tf.from_host(m, dev)
    leaves = tmerkle.leaf_hashes(x)
    assert np.array_equal(tf.to_host(leaves), tree.levels[0])
    kernels.reset_launches()
    root = tmerkle.merkle_root(x)
    root_launches = dict(kernels.LAUNCHES)
    assert np.array_equal(tf.to_host(root), tree.root)
    assert np.array_equal(tf.to_host(tmerkle.compress_levels(leaves, 5)), tree.levels[5])
    assert np.array_equal(tf.to_host(tmerkle.compress_levels(leaves, 17)), tree.levels[17])
    print("  tmerkle: leaf hashes, root and level folds of a (131072, 83) matrix "
          f"equal the host tree's; merkle_root launched {root_launches}", flush=True)
    e = rng.integers(0, F.P_INT, (1 << 14, 16), dtype=np.uint32)
    evals = tntt.ntt(e)  # device=None: the GPU
    assert np.array_equal(evals, hntt.ntt(e))
    assert np.array_equal(tntt.intt(evals), e)
    assert np.array_equal(tntt.coset_lde(e, 1, F.GENERATOR), hntt.coset_lde(e, 1, F.GENERATOR))
    print("  tntt: ntt, intt and coset_lde of a (16384, 16) matrix equal the host's",
          flush=True)


def phase_fused(program, machine, pk, vk, proof, records) -> dict:
    """Phase 10: the fused path, FUSED_PROVES proves of phase 5's program.
    Each is checked against phase 5's eager proof and verified, outside its timed
    span: execution is deterministic, so the records, and the proof bytes,
    are phase 5's every time."""
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.machine.mips import execute_sharded, verify_mips_proof
    from ziren_tpu_torch.stark import tfused
    from ziren_tpu_torch.stark.serialize import serialize_shard_proof

    eager = [serialize_shard_proof(sp) for sp in proof.shard_proofs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    rates, all_stats, proofs = [], [], []
    for i in range(FUSED_PROVES):
        if i == 1:  # from here on the proves are warm: replays only
            first = dict(kernels.LAUNCHES)
            graphs = [fs for fs in tfused._MEM.values() if fs.graph is not None]
            replays = {id(fs): fs.replays for fs in graphs}
            kernels.reset_launches()
        recs = records if i == 0 else execute_sharded(program, SHARD_SIZE)[1]
        stats: dict = {}
        t0 = time.perf_counter()
        proofs.append(tfused.prove_shards_fused(machine, pk, recs, stats=stats))
        torch.cuda.synchronize()
        rates.append(FIB_CYCLES / (time.perf_counter() - t0) / 1e3)
        all_stats.append(stats)
    warm = launches_of("the fused path's warm proves")
    wrapper = {k: kernels.LAUNCHES[k] - kernels.REPLAYED[k] for k in kernels.LAUNCHES}
    assert not any(wrapper.values()), f"a warm fused prove called a kernel's wrapper: {wrapper}"
    want: dict = {k: {} for k in kernels.LAUNCHES}
    for fs in graphs:
        for name, hist in fs.histogram.items():
            for shape, n in hist.items():
                want[name][shape] = want[name].get(shape, 0) + n * (fs.replays - replays[id(fs)])
    assert {k: {s: n for s, n in v.items() if n} for k, v in kernels.SHAPES.items()} == \
        {k: {s: n for s, n in v.items() if n} for k, v in want.items()}, \
        "the warm proves' launches are not the captures' histograms times their replays"
    # the warm proves are checked below, so every graph has a checked replay
    assert all(fs.replays > replays[id(fs)] for fs in graphs), \
        "a graph was not replayed in the warm proves"
    peak = torch.cuda.max_memory_allocated()
    launches = {k: first[k] + warm[k] for k in kernels.LAUNCHES}

    verify_s = []
    for i, fused in enumerate(proofs):
        got = [serialize_shard_proof(sp) for sp in fused.shard_proofs]
        assert len(got) == len(eager) and got == eager, \
            f"fused prove {i + 1} differs from phase 5's eager proof"
        t0 = time.perf_counter()
        assert verify_mips_proof(machine, vk, fused, pc_start=program.pc_start), \
            f"fused prove {i + 1} does not verify"
        verify_s.append(time.perf_counter() - t0)

    print(f"  {len(proofs)} proves of fibonacci({FIB_N}), core config, {len(records)} shards: "
          f"prove-only kHz " + ", ".join(f"{r:.3f}" for r in rates)
          + " (phase 5's eager prove beside them); each byte-equal to phase 5's eager "
          "proof, shard for shard, and verify_mips_proof ok in "
          + ", ".join(f"{s:.3f}" for s in verify_s) + " s", flush=True)
    for b in all_stats[0]["built"]:
        print(f"  a graph built: capture {b['capture_s']:.3f} s, instantiate "
              f"{b['instantiate_s']:.3f} s, {b['nodes']} nodes, memory pool {b['pool_bytes']} "
              f"bytes, launches recorded {b['launches']}", flush=True)
    for i, st in enumerate(all_stats):
        print(f"  prove {i + 1}: call s a shard (warm-up and capture, or load and replay) "
              + ", ".join(f"{s:.3f}" for s in st["call_s"])
              + "; replay ms on the card " + ", ".join(f"{m:.3f}" for m in st["replay_ms"])
              + "; trace-gen wait s " + ", ".join(f"{s:.3f}" for s in st["trace_wait_s"])
              + f"; fetch {st['fetch_s']:.3f} s, assemble {st['assemble_s']:.3f} s", flush=True)
    print(f"  graphs held: {len(graphs)}, replays in the warm proves: "
          f"{sum(fs.replays - replays[id(fs)] for fs in graphs)}; eager wrapper calls in them: "
          f"{wrapper}; peak device memory allocated: {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    print(f"  launches of the first prove (warm-up, capture recorded, replays): {first}",
          flush=True)
    for fs in graphs:
        busy_share(fs)
    return launches


def busy_share(fs) -> None:
    """The card's busy share of one replay: kernel time from torch.profiler
    over the replay's span from CUDA events, and over the span of a replay
    without the profiler, which stretches the span of a graph of many nodes.
    Only a profiler that gives no device time leaves it unmeasured; a replay
    that fails fails the phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _fetch, (start, end) = fs()
    torch.cuda.synchronize()
    unprofiled_ms = start.elapsed_time(end)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _fetch, (start, end) = fs()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end)
    results = getattr(prof.profiler, "kineto_results", None)
    # the raw events: key_averages() takes about a minute over 300,000 kernels
    on_card = [e for e in results.events() if e.device_type() == DeviceType.CUDA] \
        if results is not None else []
    busy_ms = sum(e.duration_ns() for e in on_card) / 1e6
    if not busy_ms:
        print(f"  busy share of a replay: not measured (the profiler gave no device time; "
              f"the replay took {span_ms:.3f} ms)", flush=True)
        return
    print(f"  busy share of a replay of {fs.nodes} nodes: {busy_ms:.3f} ms of device "
          f"time in {len(on_card)} events over {span_ms:.3f} ms, "
          f"{100 * busy_ms / span_ms:.1f}% (torch.profiler); {100 * busy_ms / unprofiled_ms:.1f}% "
          f"of a replay's {unprofiled_ms:.3f} ms without it", flush=True)


class _TraceGenClock:
    """Host seconds inside each chip's generate_dependencies and
    generate_trace while it is installed on a machine's chips (the shards'
    trace generation runs in threads, whose seconds overlap)."""

    def __init__(self, machine):
        self.seconds: dict = {}
        self._lock = threading.Lock()
        self._airs = [c.air for c in machine.chips]
        for c in machine.chips:
            for fn in ("generate_dependencies", "generate_trace"):
                setattr(c.air, fn, self._timed(c.name, getattr(c.air, fn)))

    def _timed(self, name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                with self._lock:
                    self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        return timed

    def take(self) -> dict:
        with self._lock:
            out, self.seconds = self.seconds, {}
        return out

    def remove(self) -> None:
        for air in self._airs:
            for fn in ("generate_dependencies", "generate_trace"):
                air.__dict__.pop(fn, None)


@contextlib.contextmanager
def held_traces():
    """While open, the prover's trace pipeline (stark/tprover.py) makes each
    record's traces once and a later prove of the same records takes them
    again: the script holds them, so that a chain's fused proves measure the
    card and not a second host trace generation of the same shards. The
    prover itself keeps no record's traces: no user proves a record twice."""
    from ziren_tpu_torch.stark import tprover

    generate_fixed, named_traces = tprover.generate_fixed, tprover._named_traces
    held: dict = {}

    def fixed_once(machine, record, targets):
        if id(record) not in held:
            held[id(record)] = generate_fixed(machine, record, targets)
        return held[id(record)]

    def named_once(machine, record):
        if id(record) not in held:
            held[id(record)] = named_traces(machine, record)
        return list(held[id(record)])

    tprover.generate_fixed, tprover._named_traces = fixed_once, named_once
    try:
        yield
    finally:
        tprover.generate_fixed, tprover._named_traces = generate_fixed, named_traces


def fold_nodes(fs, chip_name: str) -> int:
    """The graph nodes of chip_name's two folds (its permutation trace and
    its quotient): one eager run of a _FusedShard's body over its buffers,
    in which those two calls alone are captured, each into a graph of its
    own, counted and replayed for the rest of the run, whose result is
    dropped."""
    from ziren_tpu_torch.stark import tfolder, tfused

    real = {n: getattr(tfolder, n) for n in ("perm_trace", "quotient")}
    graphs = []

    def captured(fn):
        def inner(chip, *args, **kw):
            if chip.name != chip_name:
                return fn(chip, *args, **kw)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(fs.device)):
                out = fn(chip, *args, **kw)
            graphs.append(graph)
            graph.instantiate()
            graph.replay()  # the rest of the body reads its results
            return out
        return inner

    try:
        for n, fn in real.items():
            setattr(tfolder, n, captured(fn))
        fs._body()
        torch.cuda.synchronize()
    finally:
        for n, fn in real.items():
            setattr(tfolder, n, fn)
    assert len(graphs) == 2, f"{chip_name}: {len(graphs)} folds captured"
    return sum(tfused._graph_nodes(g) for g in graphs)


def phase_precompiles(host_proc) -> dict:
    """Phase 11: the precompile path. The host prover's proofs of the
    grouped programs come from group_host_proofs, in the process started
    with the script. Returns the kernels' launches over every prove of the
    phase."""
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.executor import asm
    from ziren_tpu_torch.executor.split import SplitOpts
    from ziren_tpu_torch.machine.mips import execute_sharded, mips_machine, verify_mips_proof
    from ziren_tpu_torch.stark import tfused
    from ziren_tpu_torch.stark.config import core_config
    from ziren_tpu_torch.stark.machine import prove
    from ziren_tpu_torch.stark.serialize import serialize_shard_proof
    from ziren_tpu_torch.tools import precompile_programs as pp

    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    print(f"  deferral threshold in force: SplitOpts.from_env().deferred = "
          f"{SplitOpts.from_env().deferred} rows", flush=True)
    line, waited_s = host_output(host_proc, "the grouped programs' host prover process")
    host_proofs = json.loads(line)
    print(f"  the host prover's proofs of the groups (a process of their own, beside the "
          f"earlier phases; waited {waited_s:.2f} s for it): "
          + ", ".join(f"{k} {v['seconds']:.3f} s" for k, v in host_proofs.items()), flush=True)
    kernels.reset_launches()
    for name in pp.GROUPS:
        program = pp.group_program(asm, name)
        machine = mips_machine(core_config())
        pk, vk = machine.setup(program)
        ex, records = execute_sharded(program, SHARD_SIZE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        proof = prove(machine, pk, records, fix_shapes=True)  # device=None: the GPU
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        host_s = host_proofs[name]["seconds"]
        assert [serialize_shard_proof(sp).hex() for sp in proof.shard_proofs] == \
            host_proofs[name]["shards"], \
            f"the {name} group's card proof differs from the host prover's"
        t0 = time.perf_counter()
        assert verify_mips_proof(machine, vk, proof, pc_start=program.pc_start), name
        verify_s = time.perf_counter() - t0
        chips = [n for sp in proof.shard_proofs for n in sp.chip_names]
        missing = set(pp.GROUP_CHIPS[name]) - set(chips)
        assert not missing, f"the {name} group proved no {sorted(missing)}"
        widest = max((c for c in machine.chips if c.name in chips), key=lambda c: c.width)
        print(f"  group {name} (core config): {int(ex.global_clk)} cycles, "
              f"{len(proof.shard_proofs)} shard(s) of {len(chips)} chips, its chips "
              f"{pp.GROUP_CHIPS[name]}; the widest {widest.name} ({widest.width} columns, "
              f"{widest.num_constraints} constraints); card prove {card_s:.3f} s, host "
              f"prover {host_s:.3f} s, byte-equal; verify_mips_proof ok in {verify_s:.3f} s; "
              f"peak device memory {peak} bytes", flush=True)
    add(launches_of("the precompile groups"))

    for name, order in (("sha256", "big"), ("keccak", "little")):
        n = CHAIN_N[name]
        program, digest = getattr(pp, f"{name}_chain_program")(asm, n)
        machine = mips_machine(core_config())
        pk, vk = machine.setup(program)
        clock = _TraceGenClock(machine)
        proofs, rates, peaks, all_stats, tracegen = [], [], [], [], []
        # one execution: the eager prove pays the host trace generation and
        # the fused proves take its traces (a second generation of the SHA
        # chain's took 160 s, more than the script has)
        ex, records = execute_sharded(program, SHARD_SIZE)
        cycles = int(ex.global_clk)
        try:
            with held_traces():
                for i, how in enumerate(("eager", "fused", "fused")):
                    stats: dict = {}
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    kernels.reset_launches()
                    t0 = time.perf_counter()
                    if how == "eager":
                        proofs.append(prove(machine, pk, records, fix_shapes=True, stats=stats))
                    else:
                        proofs.append(tfused.prove_shards_fused(machine, pk, records,
                                                                stats=stats))
                    torch.cuda.synchronize()
                    rates.append(cycles / (time.perf_counter() - t0) / 1e3)
                    peaks.append(torch.cuda.max_memory_allocated())
                    tracegen.append(clock.take())
                    all_stats.append(stats)
                    add(launches_of(f"the {name} chain, prove {i + 1} ({how})"))
                    wrapper = {k: kernels.LAUNCHES[k] - kernels.REPLAYED[k]
                               for k in kernels.LAUNCHES}
                    print(f"    eager wrapper calls in prove {i + 1}: {wrapper}", flush=True)
            assert not any(wrapper.values()), \
                f"the {name} chain's warm fused prove called a kernel's wrapper: {wrapper}"
        finally:
            clock.remove()

        eager = [serialize_shard_proof(sp) for sp in proofs[0].shard_proofs]
        verify_s = []
        for i, proof in enumerate(proofs):
            got = [serialize_shard_proof(sp) for sp in proof.shard_proofs]
            assert got == eager, f"the {name} chain's prove {i + 1} differs from its eager proof"
            t0 = time.perf_counter()
            assert verify_mips_proof(machine, vk, proof, pc_start=program.pc_start), \
                f"the {name} chain's prove {i + 1} does not verify"
            verify_s.append(time.perf_counter() - t0)
        got = pp.committed_digest(proofs[0].shard_proofs[0].public_values, order)
        assert got == digest, f"the {name} chain committed {got.hex()}, not {digest.hex()}"
        sets = [tuple(sp.chip_names) for sp in proofs[0].shard_proofs]
        standalone = [i + 1 for i, s in enumerate(sets) if "SyscallPrecompile" in s
                      and "Cpu" not in s]
        if name == "sha256":
            assert standalone, "the SHA chain has no standalone precompile shard"
        print(f"  {name} chain, {n} rounds: {cycles} cycles, {len(sets)} shards, digest "
              f"{digest.hex()} committed as expected; every prove byte-equal to the eager one, "
              f"verify_mips_proof ok in " + ", ".join(f"{s:.3f}" for s in verify_s) + " s; "
              f"standalone precompile shards (no Cpu): {standalone}", flush=True)
        for s in dict.fromkeys(sets):
            heights = [ov.log_degree for ov in
                       proofs[0].shard_proofs[sets.index(s)].opened_values]
            print(f"    shards {[i + 1 for i, t in enumerate(sets) if t == s]}: "
                  + ", ".join(f"{c} 2^{h}" for c, h in zip(s, heights)), flush=True)
        for i, (st, r, peak, tg) in enumerate(zip(all_stats, rates, peaks, tracegen)):
            per = st.get("dispatch_s") or st.get("call_s")
            kind = "dispatch" if "dispatch_s" in st else "call (warm-up and capture, or replay)"
            how = "eager" if i == 0 else "fused, on the eager prove's traces"
            print(f"    prove {i + 1} ({how}): {r:.3f} kHz prove-only; trace-gen wait s "
                  + ", ".join(f"{s:.3f}" for s in st["trace_wait_s"])
                  + f"; {kind} s " + ", ".join(f"{s:.3f}" for s in per)
                  + ("; replay ms " + ", ".join(f"{m:.3f}" for m in st["replay_ms"])
                     if st.get("replay_ms") else "")
                  + f"; fetch {st['fetch_s']:.3f} s, assemble {st['assemble_s']:.3f} s; "
                  f"peak device memory {peak} bytes", flush=True)
            top = sorted(tg.items(), key=lambda kv: -kv[1])[:6]
            print("      host trace generation s by chip (threads overlap): "
                  + ", ".join(f"{c} {s:.2f}" for c, s in top), flush=True)
        built = [fs for fs in tfused._MEM.values() if fs.machine is machine]
        for b in all_stats[1]["built"]:
            print(f"    a graph built: capture {b['capture_s']:.3f} s, instantiate "
                  f"{b['instantiate_s']:.3f} s, {b['nodes']} nodes, memory pool "
                  f"{b['pool_bytes']} bytes, launches recorded {b['launches']}", flush=True)
        print(f"    graphs of this chain still held: {len(built)} of the {len(tfused._MEM)} "
              f"held (_MEM_MAX {tfused._MEM_MAX}); replays: {[fs.replays for fs in built]}",
              flush=True)
        if name == "keccak":
            t0 = time.perf_counter()
            fs = next(fs for fs in built if "KeccakSponge" in [c.name for c in fs.chips])
            inside = fold_nodes(fs, "KeccakSponge")
            print(f"    KeccakSponge's two folds are {inside} of the {fs.nodes} nodes of its "
                  f"shard's graph ({100 * inside / fs.nodes:.1f}%; nodes are the eager path's "
                  f"launches and a few memory copies; counted in "
                  f"{time.perf_counter() - t0:.1f} s)", flush=True)
    return total


def mesh_of(dev, members: int, axis: str):
    """A mesh of `members` members: all on `dev` when the machine has one
    card, else in turn over the cards."""
    from ziren_tpu_torch.device import Mesh

    cards = torch.cuda.device_count()
    return Mesh([torch.device("cuda", i % cards) for i in range(members)] if cards > 1
                else [dev] * members, axis)


def phase_mesh(dev, program, machine, pk, vk, proof) -> dict:
    """Phase 12: the multi-device path. Returns the kernels' launches over
    its checked commits and its three proves."""
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.core import field as F
    from ziren_tpu_torch.machine.mips import execute_sharded, verify_mips_proof
    from ziren_tpu_torch.ops import tfield as tf
    from ziren_tpu_torch.ops import tntt, tpcs
    from ziren_tpu_torch.stark import ici, tfused
    from ziren_tpu_torch.stark.sharded import prove_shards_sharded
    from ziren_tpu_torch.stark.serialize import serialize_shard_proof
    from ziren_tpu_torch.tools import kernel_bench as kb

    rng = np.random.default_rng(12)
    mats = {w: rng.integers(0, F.P_INT, (MESH_ROWS, w), dtype=np.uint32) for w in (600, 108)}
    xs = {w: tf.from_host(m, dev) for w, m in mats.items()}
    sizes = sorted({1, 2, MESH_MEMBERS})
    meshes = {k: mesh_of(dev, k, "row") for k in sizes}
    print(f"  meshes: {', '.join(repr(m) for m in meshes.values())}", flush=True)
    ones = {w: tpcs.merkle_commit([x]) for w, x in xs.items()}  # one device, the default stream
    ntt_one = tntt.ntt(mats[108])  # device=None: the GPU
    torch.cuda.synchronize()

    kernels.reset_launches()
    for w, x in xs.items():
        one = ones[w]
        for k, mesh in meshes.items():
            roots, leaves = ici.commit_row_sharded(x, mesh)
            assert len(roots) == len(leaves) == k
            for r in roots:
                assert torch.equal(r.to(dev), one.root), (w, k)
            assert torch.equal(torch.cat([d.to(dev) for d in leaves]), one.levels[0]), (w, k)
        leaves = ici.leaf_hash_row_sharded(x, meshes[MESH_MEMBERS])
        assert torch.equal(torch.cat([d.to(dev) for d in leaves]), one.levels[0]), w
    got = tf.to_host(ici.ntt_mesh(xs[108], meshes[MESH_MEMBERS]))
    assert np.array_equal(got, ntt_one), "ntt_mesh differs from tntt.ntt"
    print(f"  commit_row_sharded over {sizes} members and leaf_hash_row_sharded over "
          f"{MESH_MEMBERS} of ({MESH_ROWS}, 600) and ({MESH_ROWS}, 108): every member's root "
          f"and the leaf digests bit-equal to tpcs.merkle_commit on one device; ntt_mesh of "
          f"({MESH_ROWS}, 108) over {MESH_MEMBERS} members bit-equal to tntt.ntt", flush=True)

    eager = [serialize_shard_proof(sp) for sp in proof.shard_proofs]
    mesh2 = mesh_of(dev, 2, "shard")
    runs = []
    for name in ("prove_shards_sharded, building", "prove_shards_sharded, warm",
                 "StarkMachine.prove(devices=...)"):
        _ex, records = execute_sharded(program, SHARD_SIZE)
        stats: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        replays = {id(fs): fs.replays for fs in tfused._MEM.values()}
        t0 = time.perf_counter()
        if name.startswith("prove_shards_sharded"):
            got = prove_shards_sharded(machine, pk, records, mesh2, stats=stats)
        else:
            got = machine.prove(pk, records, fix_shapes=True, devices=mesh2, stats=stats)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        mine = [fs for key, fs in tfused._MEM.items() if fs.machine is machine
                and key[-1] is not None]
        replayed = sum(fs.replays - replays.get(id(fs), 0) for fs in mine)
        assert [serialize_shard_proof(sp) for sp in got.shard_proofs] == eager, \
            f"{name}: the proof differs from phase 5's eager proof"
        t0 = time.perf_counter()
        assert verify_mips_proof(machine, vk, got, pc_start=program.pc_start), name
        runs.append((name, prove_s, peak, stats, replayed, time.perf_counter() - t0))
    launches = launches_of("the multi-device path")

    for name, prove_s, peak, stats, replayed, verify_s in runs:
        per = stats.get("call_s") or stats["dispatch_s"]
        kind = "call (warm-up and capture, or load and replay)" if "call_s" in stats \
            else "dispatch"
        print(f"  {name} over 2 members: {FIB_CYCLES / prove_s / 1e3:.3f} kHz prove-only "
              f"({prove_s:.3f} s), byte-equal to phase 5's eager proof shard for shard, "
              f"verify_mips_proof ok in {verify_s:.3f} s; {kind} s "
              + ", ".join(f"{s:.3f}" for s in per)
              + (f" on members {stats['member']}" if "member" in stats else "")
              + f"; fetch {stats['fetch_s']:.3f} s, assemble {stats['assemble_s']:.3f} s; "
              f"replays {replayed}; peak device memory {peak} bytes", flush=True)
        for b in stats.get("built", []):
            print(f"    a member's graph built: capture {b['capture_s']:.3f} s, instantiate "
                  f"{b['instantiate_s']:.3f} s, {b['nodes']} nodes, memory pool "
                  f"{b['pool_bytes']} bytes", flush=True)
    print(f"  graphs held: {len(tfused._MEM)} (_MEM_MAX {tfused._MEM_MAX}), of them the "
          f"members': {sum(1 for k in tfused._MEM if k[-1] is not None)}", flush=True)

    # the seconds, after the counts are read: CUDA events on the caller's
    # stream, which waits for the members' streams at the end of each call
    # (on other cards: for the results' copies to `dev`)
    def to_dev(parts):
        return [t.to(dev) for t in parts]

    for w, x in xs.items():
        bound = kb.k1_bound(*x.shape)
        one_ms = kb.cuda_ms(lambda y: tpcs.merkle_commit([y]), [x], 10)
        mesh_ms = {k: kb.cuda_ms(lambda y: to_dev(ici.commit_row_sharded(y, mesh)[0]), [x], 10)
                   for k, mesh in meshes.items()}
        leaf_ms = kb.cuda_ms(
            lambda y: to_dev(ici.leaf_hash_row_sharded(y, meshes[MESH_MEMBERS])), [x], 10)
        print(f"  commit of ({MESH_ROWS}, {w}): one device {one_ms:.4f} ms; commit_row_sharded "
              + ", ".join(f"{k} member(s) {ms:.4f} ms" for k, ms in mesh_ms.items())
              + f"; leaf_hash_row_sharded over {MESH_MEMBERS} {leaf_ms:.4f} ms; K1's bound "
              f"at that shape {bound[0]:.4f} ms ({bound[1]})", flush=True)
    log_n = MESH_ROWS.bit_length() - 1
    br = tpcs.bitrev_idx(log_n, dev)
    one_ms = kb.cuda_ms(lambda y: tpcs.ntt_bitrev_in(y[br], log_n), [xs[108]], 5)
    mesh_ms = kb.cuda_ms(lambda y: ici.ntt_mesh(y, meshes[MESH_MEMBERS]), [xs[108]], 5)
    print(f"  NTT of ({MESH_ROWS}, 108): one device {one_ms:.4f} ms, ntt_mesh over "
          f"{MESH_MEMBERS} members {mesh_ms:.4f} ms (eager PyTorch, no kernel of its own)",
          flush=True)
    return launches


def phase_small_recursion(machine, vk, shard_proof) -> None:
    from ziren_tpu_torch.recursion import mips_pipeline as mp
    from ziren_tpu_torch.stark.proof import MachineProof
    from ziren_tpu_torch.stark.serialize import serialize_shard_proof

    t0 = time.perf_counter()
    rm, rvk, on_card = mp.lift_shard(machine, vk, shard_proof)  # device=None: the GPU
    dt = time.perf_counter() - t0
    _rm, _rvk, on_host = mp.lift_shard(machine, vk, shard_proof, device="host")
    assert serialize_shard_proof(on_card) == serialize_shard_proof(on_host), \
        "the port's recursion proof differs from the host prover's"
    assert rm.verify(rvk, MachineProof([on_card]))
    print(f"  dev-config lift of the fibonacci(30) shard: byte-identical to the host "
          f"proof, verified ({dt:.2f} s on the port)", flush=True)


def phase_recursion(program, machine, vk, proof) -> dict:
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.recursion import mips_pipeline as mp
    from ziren_tpu_torch.recursion import pipeline as pl
    from ziren_tpu_torch.stark.config import compressed_config
    from ziren_tpu_torch.stark.proof import MachineProof
    from ziren_tpu_torch.tools import compress_bench as cb

    shards = proof.shard_proofs[:RECURSION_SHARDS]
    whole = len(shards) == len(proof.shard_proofs)
    config = machine.config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with cb.instrument() as times:
        t0 = time.perf_counter()
        registry = cb.tree_registry(machine, vk, shards, config)
        t1 = time.perf_counter()
        with device_commits() as (keys, commits):
            rm, rvk, root = mp.compress(machine, vk, MachineProof(shards), config=config,
                                        registry=registry)  # device=None: the GPU
        t2 = time.perf_counter()
        sm, svk, sproof, _ = pl.shrink(rm, rvk, root, config=compressed_config())
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    registry_s, compress_s, shrink_s = t1 - t0, t2 - t1, t3 - t2
    launches = launches_of("the recursion path")
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    if whole:  # the root's vk is a member, its RPV carries the registry's root
        mp.verify_compressed(machine, vk, rm, rvk, root, pc_start=program.pc_start,
                             registry=registry)
    else:  # a partial range: a valid proof that does not attest the whole execution
        assert rm.verify(rvk, MachineProof([root]))
        registry.membership(rvk.commit)
        rpv = [int(v) for v in root.public_values]
        assert rpv[mp.RPV_IS_COMPLETE] == 0 and rpv[mp.RPV_START_SHARD] == 1
        assert rpv[mp.RPV_NEXT_SHARD] == 1 + len(shards)
        assert rpv[mp.RPV_VK : mp.RPV_VK + 8] == [int(v) for v in vk.commit]
        assert rpv[mp.RPV_VK_ROOT : mp.RPV_VK_ROOT + 8] == [int(v) for v in registry.root]
    assert sm.verify(svk, sproof)
    assert [int(v) for v in sproof.shard_proofs[0].public_values] == pl.lift_digest(rvk, root)
    verify_s = time.perf_counter() - t0
    assert len(times["lift"]) == len(shards) and len(times["join"]) == len(shards) - 1
    # the bounded table of device keys (stark/tprover.py) commits each key the
    # tree proves under once, as each key's own cache did before it: beside
    # a main, a permutation and a quotient commit a proof
    proofs = len(times["lift"]) + len(times["join"])
    assert len(commits) == 3 * proofs + len(keys), (len(commits), proofs, len(keys))

    print(f"  {len(shards)} of {len(proof.shard_proofs)} core-config shard proofs: the "
          f"tree's registry {registry_s:.2f} s, compress {compress_s:.2f} s "
          f"({len(times['enum_lift'])} lifts and {len(times['enum_join'])} joins traced "
          f"without proving, in both), shrink "
          f"{shrink_s:.2f} s; the root ({'verify_compressed' if whole else 'a partial range'}) "
          f"and the shrink proof verified in {verify_s:.2f} s", flush=True)
    for kind in ("lift", "join", "shrink"):
        print(f"  {kind} s, total (split): " + cb.summary(times[kind]), flush=True)
        print(f"  last {kind}'s machine (chip, log2 height, width, preprocessed width): "
              f"{times[kind][-1]['machine']}", flush=True)
    print(f"  compress made {len(commits)} device commits: one for each of its {len(keys)} "
          f"keys and three for each of its {proofs} proofs", flush=True)
    print(f"  peak device memory allocated: {peak} bytes ({peak / 2**30:.3f} GiB)",
          flush=True)
    return launches


@contextlib.contextmanager
def device_commits():
    """While open, the keys whose device data the torch prover asks for
    (stark/tprover.py:device_pk, each key once) and its device commits
    (ops/tpcs.commit, each call) are listed."""
    from ziren_tpu_torch.ops import tpcs
    from ziren_tpu_torch.stark import tprover

    keys, commits = [], []
    real_pk, real_commit = tprover._device_pk, tpcs.commit

    def spy_pk(machine, pk, device):
        if not any(k is pk for k in keys):
            keys.append(pk)
        return real_pk(machine, pk, device)

    def spy_commit(*args, **kw):
        commits.append(1)
        return real_commit(*args, **kw)

    tprover._device_pk, tpcs.commit = spy_pk, spy_commit
    try:
        yield keys, commits
    finally:
        tprover._device_pk, tpcs.commit = real_pk, real_commit


def compose(config, device=None) -> dict:
    """The composition path (recursion/deferred.py) at `config`: a
    sub-guest, fibonacci(COMPOSITION_N), proved and compressed to a complete
    root; a main guest (executor/asm.py:deferred_claim_program) that claims
    that root with VERIFY_ZKM_PROOF and commits the fold of its claim, proved
    and compressed with the fold as its reconstruct digest, which alone is
    no complete root; the deferred chain of the one claim (one leaf); and
    the root merge (attach_deferred), which verify_compressed accepts. Each
    compress is under the registry of its own tree (compress_bench's
    tree_registry). `device` is where every proof is made: None is the GPU.
    Returns the attached root's digest, the two guests' shard shapes and
    the seconds of each step."""
    from ziren_tpu_torch.executor.asm import deferred_claim_program, fibonacci_program
    from ziren_tpu_torch.machine.mips import execute_sharded, mips_machine, verify_mips_proof
    from ziren_tpu_torch.recursion import deferred as D
    from ziren_tpu_torch.recursion import mips_pipeline as mp
    from ziren_tpu_torch.stark.verifier import VerificationError
    from ziren_tpu_torch.tools import compress_bench as cb

    machine = mips_machine(config)
    seconds, shapes = {}, {}

    def proved(name, program):
        t0 = time.perf_counter()
        pk, vk = machine.setup(program)
        _ex, records = execute_sharded(program, SHARD_SIZE)
        proof = machine.prove(pk, records, device=device)
        seconds[name + " prove"] = time.perf_counter() - t0
        assert verify_mips_proof(machine, vk, proof, pc_start=program.pc_start)
        shapes[name] = [(c, v.log_degree) for sp in proof.shard_proofs
                        for c, v in zip(sp.chip_names, sp.opened_values)]
        return vk, records, proof

    def compressed(name, vk, proof, reconstruct=None):
        t0 = time.perf_counter()
        registry = cb.tree_registry(machine, vk, proof.shard_proofs, config)
        t1 = time.perf_counter()
        side = mp.compress(machine, vk, proof, config=config, reconstruct_digest=reconstruct,
                           registry=registry, device=device)
        seconds[name + " registry"] = t1 - t0
        seconds[name + " compress"] = time.perf_counter() - t1
        return side, registry

    # 1. the sub-proof: one shard, one lift, a complete root
    sub = fibonacci_program(COMPOSITION_N)
    sub_vk, _records, sub_proof = proved("sub-guest", sub)
    sub_side, sub_registry = compressed("sub-guest", sub_vk, sub_proof)
    sub_rpv = [int(v) for v in sub_side[2].public_values]
    assert sub_rpv[mp.RPV_IS_COMPLETE] == 1
    mp.verify_compressed(machine, sub_vk, *sub_side, pc_start=sub.pc_start,
                         registry=sub_registry)

    # 2. the main guest claims it and commits the fold; its own tree is seeded
    # with that fold and does not complete alone
    vkey = D.claim_vk_digest(sub_vk)
    assert vkey == D.claim_vk_digest_from_rpv(sub_rpv)
    pv32 = sub_rpv[mp.RPV_DIGEST : mp.RPV_DIGEST + 32]
    folded = D.fold_claims([(vkey, pv32)])
    words = D.pv_digest_bytes_to_words(pv32)
    main = deferred_claim_program(vkey, words, folded)
    main_vk, records, main_proof = proved("claim guest", main)
    assert records[0].deferred_proof_claims == [(tuple(vkey), tuple(words))]
    assert list(records[-1].public_values.deferred_proofs_digest) == folded
    core, main_registry = compressed("claim guest", main_vk, main_proof, reconstruct=folded)
    core_rpv = [int(v) for v in core[2].public_values]
    assert core_rpv[mp.RPV_IS_COMPLETE] == 0
    assert core_rpv[mp.RPV_START_RECON : mp.RPV_START_RECON + 8] == folded
    try:
        mp.verify_compressed(machine, main_vk, *core, pc_start=main.pc_start)
    except VerificationError as e:
        assert "incomplete" in str(e), e
    else:
        raise AssertionError("verify_compressed took the claim guest's root alone")

    # 3. the deferred chain of the one claim: one leaf
    t0 = time.perf_counter()
    chain = D.deferred_chain([sub_side], config=config, device=device)
    seconds["deferred_chain"] = time.perf_counter() - t0
    assert [int(v) for v in chain[2].public_values] == [0] * 8 + folded

    # 4. the root merge completes it
    t0 = time.perf_counter()
    root = D.attach_deferred(core, chain, config=config, device=device)
    seconds["attach_deferred"] = time.perf_counter() - t0
    root_rpv = [int(v) for v in root[2].public_values]
    assert root_rpv[mp.RPV_IS_COMPLETE] == 1
    digest = mp.verify_compressed(machine, main_vk, *root, pc_start=main.pc_start,
                                  vk_root=main_registry.root)
    assert isinstance(digest, bytes) and len(digest) == 32
    return {"digest": digest, "shapes": shapes, "seconds": seconds}


def phase_composition(card: str) -> dict:
    """Phase 14: compose() at the core config on the card, every node timed
    and split by compress_bench.instrument. Returns the kernels' launches."""
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.stark import tfused, tprover
    from ziren_tpu_torch.stark.config import core_config
    from ziren_tpu_torch.tools import compress_bench as cb

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what the earlier phases left allocated
    keys, keys_bytes = len(tprover.device_keys()), tensor_bytes(list(tprover._DEVICE_KEYS.values()))
    pools = [fs.pool_bytes for fs in tfused._MEM.values()]
    kernels.reset_launches()
    with cb.instrument() as times:
        out = compose(core_config())  # device=None: the GPU
        torch.cuda.synchronize()
    launches = launches_of("the composition path")
    peak = torch.cuda.max_memory_allocated()
    assert len(times["lift"]) == 2 and "join" not in times
    assert [len(times.get(k, [])) for k in cb.DEFERRED_NODES] == [1, 0, 1]

    print(f"  {card}; core config; the sub-guest fibonacci({COMPOSITION_N}) and the claim "
          f"guest, one shard each: " + ", ".join(f"{k} {len(v)} chips" for k, v in
                                                 out["shapes"].items()), flush=True)
    for name, shape in out["shapes"].items():
        print(f"  {name}'s shard (chip, log2 height): {shape}", flush=True)
    print("  seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in out["seconds"].items()),
          flush=True)
    print("  the sub-guest's root complete and verified (verify_compressed under its tree's "
          "registry); the claim guest's root is_complete = 0, refused alone; the chain's "
          "public values [0]*8 + the fold; the attached root complete, verify_compressed "
          f"returned the digest {out['digest'].hex()}", flush=True)
    for kind, what in (("lift", "lifts (the sub-guest's, the claim guest's)"),
                       ("deferred_leaf", "the deferred leaf"),
                       ("attach_deferred", "the attach")):
        print(f"  {what} s, total (split): " + cb.summary(times[kind]), flush=True)
        print(f"  {what}: machine (chip, log2 height, width, preprocessed width): "
              + "; ".join(str(e["machine"]) for e in times[kind]), flush=True)
    print(f"  {len(times['enum_lift'])} lifts traced without proving (the registries and "
          f"compress's membership checks): "
          + ", ".join(f"{e['total_s']:.2f}" for e in times["enum_lift"]) + " s", flush=True)
    print(f"  peak device memory allocated: {peak} bytes ({peak / 2**30:.3f} GiB); {held} "
          f"bytes of them were held when the phase began: the table of device keys "
          f"{keys_bytes} bytes in {keys} entries (stark/tprover.py), the fused graphs' pools "
          f"{sum(pools)} bytes in {len(pools)} graphs (stark/tfused.py), the rest the "
          f"earlier phases' other caches", flush=True)
    return launches


def tensor_bytes(obj) -> int:
    """The bytes of the distinct tensor storages reachable from obj through
    dicts, lists, tuples and objects' attributes."""
    seen, visited, stack, total = set(), set(), [obj], 0
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
            continue
        if id(x) in visited:
            continue
        visited.add(id(x))
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "__dict__") and not callable(x):
            stack.extend(vars(x).values())
    return total


def phase_memory(card: str, host_proc) -> dict:
    """Phase 15: standalone memory shards and unconstrained blocks at the core
    config on the card. The memory sweep (sweep()) in shards of SHARD_SIZE
    cycles has a shard with no Cpu; its eager proof is byte-equal, shard for
    shard, to the host prover's proof that memory_host_proof's process made
    of the same records, verifies, and a tampered address-bit chain is
    refused. Its memory shard is lifted (mips_pipeline.lift_shard under the
    registry of that shard's tree, compress_bench.tree_registry, timed by
    compress_bench.instrument) and the lift verified. Then the unconstrained
    program (tools/memory_programs.py) is executed, its hint checked, proved
    and verified. Returns the kernels' launches over the phase."""
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.executor import Executor, asm
    from ziren_tpu_torch.machine.mips import execute_sharded, mips_machine, verify_mips_proof
    from ziren_tpu_torch.recursion import mips_pipeline as mp
    from ziren_tpu_torch.recursion.shape_universe import record_kind
    from ziren_tpu_torch.stark import carry
    from ziren_tpu_torch.stark.config import core_config
    from ziren_tpu_torch.stark.machine import prove
    from ziren_tpu_torch.stark.proof import MachineProof
    from ziren_tpu_torch.stark.serialize import serialize_shard_proof
    from ziren_tpu_torch.stark.verifier import VerificationError
    from ziren_tpu_torch.tools import compress_bench as cb
    from ziren_tpu_torch.tools.memory_programs import sweep_fold, unconstrained_program

    total: dict = {}

    def counted(path):
        for k, v in launches_of(path).items():
            total[k] = total.get(k, 0) + v

    program, n_words = sweep()
    machine = mips_machine(core_config())
    pk, vk = machine.setup(program)
    t0 = time.perf_counter()
    ex, records = execute_sharded(program, SHARD_SIZE)
    exec_s = time.perf_counter() - t0
    assert ex.peek_register(11) == sweep_fold(n_words), "the sweep's fold"
    last = records[-1].public_values
    assert last.exit_code == 0 and last.committed_value_digest[0] == sweep_fold(n_words)
    kinds = [record_kind(r) for r in records]
    assert "memory" in kinds, f"no memory shard at {n_words} words: {kinds}"

    clock = _TraceGenClock(machine)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        stats: dict = {}
        t0 = time.perf_counter()
        proof = prove(machine, pk, records, fix_shapes=True, stats=stats)  # device=None: the GPU
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        trace_s = clock.take()
    finally:
        clock.remove()
    counted("the memory sweep")
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    assert verify_mips_proof(machine, vk, proof, pc_start=program.pc_start)
    verify_s = time.perf_counter() - t0
    shards = [serialize_shard_proof(sp) for sp in proof.shard_proofs]
    memory = [i for i, sp in enumerate(proof.shard_proofs) if "Cpu" not in sp.chip_names]
    assert memory and len(shards) == len(records)

    line, waited = host_output(host_proc, "the memory sweep's host process")
    host = json.loads(line)
    assert host["n_words"] == n_words
    assert len(host["shards"]) == len(shards)
    for i, (a, b) in enumerate(zip(shards, host["shards"])):
        assert a.hex() == b, f"the memory sweep's shard {i + 1} differs from the host prover's"

    tampered = carry.machine_proof_from_shard_bytes(shards)
    sp = tampered.shard_proofs[memory[0]]
    k = sp.public_values.index(1, 45)  # the first set bit of the address chains
    sp.public_values[k] = 0
    try:
        verify_mips_proof(machine, vk, tampered, pc_start=program.pc_start)
    except VerificationError:
        pass
    else:
        raise AssertionError("verify_mips_proof took a tampered memory chain")

    print(f"  {card}; core config; memory_sweep_program({n_words}) (the host's "
          f"combine_memory_threshold + {SWEEP_EXTRA}): cycles {int(ex.global_clk)}, "
          f"execute {exec_s:.3f} s, shards {len(records)} ({', '.join(kinds)})", flush=True)
    for i, sp in enumerate(proof.shard_proofs):
        print(f"  shard {i + 1} (chip, log2 height): "
              f"{[(c, v.log_degree) for c, v in zip(sp.chip_names, sp.opened_values)]}",
              flush=True)
    print(f"  prove {prove_s:.3f} s on the card ({int(ex.global_clk) / prove_s / 1e3:.3f} kHz), "
          f"verify_mips_proof ok in {verify_s:.3f} s; byte-equal shard for shard to the host "
          f"prover's proof ({host['seconds']:.2f} s in its process, waited {waited:.2f} s); "
          "a tampered address-bit chain refused", flush=True)
    print("  per-shard trace-gen wait s: " + ", ".join(f"{s:.3f}" for s in stats["trace_wait_s"])
          + "; dispatch s: " + ", ".join(f"{s:.3f}" for s in stats["dispatch_s"])
          + f"; fetch {stats['fetch_s']:.3f} s, assemble {stats['assemble_s']:.3f} s", flush=True)
    print("  trace generation, host seconds by chip (threads overlap): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(trace_s.items(), key=lambda kv: -kv[1])),
          flush=True)
    print(f"  the Global chip's trace generation: {trace_s.get('Global', 0.0):.3f} s; peak device "
          f"memory allocated: {peak} bytes ({peak / 2**30:.3f} GiB)", flush=True)

    # the memory shard's lift
    kernels.reset_launches()
    mem_sp = proof.shard_proofs[memory[0]]
    with cb.instrument() as times:
        t0 = time.perf_counter()
        registry = cb.tree_registry(machine, vk, [mem_sp], machine.config)
        t1 = time.perf_counter()
        rm, rvk, lifted = mp.lift_shard(machine, vk, mem_sp, config=machine.config,
                                        vk_root=registry.root)  # device=None: the GPU
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    counted("the memory shard's lift")
    assert rm.verify(rvk, MachineProof([lifted]))
    registry.membership(rvk.commit)
    rpv = [int(v) for v in lifted.public_values]
    assert rpv[mp.RPV_START_SHARD] == memory[0] + 1 and rpv[mp.RPV_VK : mp.RPV_VK + 8] == [
        int(v) for v in vk.commit]
    print(f"  the memory shard's lift: its tree's registry {t1 - t0:.2f} s, lift {t2 - t1:.2f} s, "
          f"verified, its vk a member; s, total (split): " + cb.summary(times["lift"]),
          flush=True)
    print(f"  the lift's machine (chip, log2 height, width, preprocessed width): "
          f"{times['lift'][-1]['machine']}", flush=True)

    # the unconstrained program
    kernels.reset_launches()
    uprog = unconstrained_program(asm)
    upk, uvk = machine.setup(uprog, extra_observations=[uprog.pc_start])
    uex = Executor(uprog)
    urec = uex.run()
    assert uex.peek_register(20) == 42 and uex.peek_register(21) == 4, "the hint round trip"
    assert uex.peek_word(0x2000) == 0, "the block's writes were not reverted"
    t0 = time.perf_counter()
    uproof = prove(machine, upk, [urec], fix_shapes=True)
    torch.cuda.synchronize()
    uprove_s = time.perf_counter() - t0
    counted("the unconstrained program")
    assert verify_mips_proof(machine, uvk, uproof, pc_start=uprog.pc_start)
    print(f"  the unconstrained program: the hint read back (r20 = 42, r21 = 4), the block "
          f"reverted; proved in {uprove_s:.3f} s, verified; its shard (chip, log2 height): "
          f"{[(c, v.log_degree) for c, v in zip(uproof.shard_proofs[0].chip_names, uproof.shard_proofs[0].opened_values)]}",
          flush=True)
    print(f"  kernel launches over phase 15: {total}", flush=True)
    return total


def ladder_claim_guest(sub_pk):
    """The guest of phase 9's composition leg: it claims the compressed
    proof of the ladder's fibonacci(30) twice (tools/claim_programs.py),
    each claim the sub-guest's vk digest and the committed-value digest of
    its execution, and commits their fold. The
    claim values, and so this guest's program and every lift vk of its
    registry, come from the sub-guest's key and execution: no proof."""
    from ziren_tpu_torch.executor import asm
    from ziren_tpu_torch.machine.mips import execute
    from ziren_tpu_torch.recursion import deferred as D
    from ziren_tpu_torch.tools.claim_programs import claims_program, digest_bytes

    _ex, record = execute(sub_pk.program)
    words = [int(w) for w in record.public_values.committed_value_digest]
    claim = (D.claim_vk_digest(sub_pk.vk), words)
    folded = D.fold_claims([(claim[0], digest_bytes(words))] * 2)
    return claims_program(asm, [claim] * 2, folded)


def ladder_registry() -> None:
    """Enumerate the dev-config ladder's lift + join registries on the host
    and write them where ProverClient.compressed_prove in phase 9 loads them
    (recursion/shape_universe.py:_registry_cache_path): fibonacci(30)'s, then
    that of the guest that claims its compressed proof twice
    (ladder_claim_guest). A shard's shape comes from host trace generation,
    as the SDK's prove orders and sizes it; nothing is proved. Prints the
    two files' paths as a JSON list. The script runs this in a process of
    its own, which sees no card."""
    from ziren_tpu_torch.executor.asm import fibonacci_program
    from ziren_tpu_torch.machine.mips import execute_sharded
    from ziren_tpu_torch.recursion import shape_universe as su
    from ziren_tpu_torch.sdk import ProverClient
    from ziren_tpu_torch.stark.opts import ZirenCoreOpts
    from ziren_tpu_torch.stark.shape import _gen_traces

    client = ProverClient(config="dev", device="cpu")

    def enumerate_registry(pk):
        _ex, records = execute_sharded(pk.program, ZirenCoreOpts.auto().shard_size)
        shapes = set()
        for record in records:
            traces = sorted(_gen_traces(pk.machine, record), key=lambda t: -t[1].shape[0])
            shapes.add(tuple((c.name, t.shape[0].bit_length() - 1) for c, t in traces))
        shapes = list(shapes)
        su.build_full_registry(pk.machine, pk.vk, shapes, config=client._config)
        path = su._registry_cache_path(pk.machine, pk.vk, shapes, client._config,
                                       su.FIXED_REGISTRY_HEIGHT)
        assert os.path.exists(path), path
        return path

    pk, _vk = client.setup(fibonacci_program(30))
    paths = [enumerate_registry(pk)]
    guest_pk, _vk = client.setup(ladder_claim_guest(pk))
    paths.append(enumerate_registry(guest_pk))
    print(json.dumps(paths), flush=True)


def group_host_proofs() -> None:
    """The host prover's proofs of phase 11's grouped programs (the same
    programs, config, execution and fixed shapes as the card's), printed as
    one JSON line of hex shard proofs and seconds. The script runs this in a
    process of its own, which sees no card, while the earlier phases run."""
    from ziren_tpu_torch.executor import asm
    from ziren_tpu_torch.machine.mips import execute_sharded, mips_machine
    from ziren_tpu_torch.stark.config import core_config
    from ziren_tpu_torch.stark.serialize import serialize_shard_proof
    from ziren_tpu_torch.tools import precompile_programs as pp

    out = {}
    for name in pp.GROUPS:
        program = pp.group_program(asm, name)
        machine = mips_machine(core_config())
        pk, _vk = machine.setup(program)
        _ex, records = execute_sharded(program, SHARD_SIZE)
        t0 = time.perf_counter()
        proof = machine.prove(pk, records, device="host", fix_shapes=True)
        out[name] = {"seconds": time.perf_counter() - t0,
                     "shards": [serialize_shard_proof(sp).hex() for sp in proof.shard_proofs]}
    print(json.dumps(out), flush=True)


def sweep():
    """Phase 15's memory sweep: (the program, its words)."""
    from ziren_tpu_torch.executor import asm
    from ziren_tpu_torch.executor.split import SplitOpts
    from ziren_tpu_torch.tools.memory_programs import memory_sweep_program

    n_words = SplitOpts.from_env().combine_memory_threshold + SWEEP_EXTRA
    return memory_sweep_program(asm, n_words), n_words


def memory_host_proof() -> None:
    """The host prover's proof of phase 15's memory sweep (the same program,
    config, execution and fixed shapes as the card's), printed as one JSON
    line of hex shard proofs, the words and the seconds. The script runs this
    in a process of its own, which sees no card, while the earlier phases
    run."""
    from ziren_tpu_torch.machine.mips import execute_sharded, mips_machine
    from ziren_tpu_torch.stark.config import core_config
    from ziren_tpu_torch.stark.serialize import serialize_shard_proof

    program, n_words = sweep()
    machine = mips_machine(core_config())
    pk, _vk = machine.setup(program)
    _ex, records = execute_sharded(program, SHARD_SIZE)
    t0 = time.perf_counter()
    proof = machine.prove(pk, records, device="host", fix_shapes=True)
    print(json.dumps({"n_words": n_words, "seconds": time.perf_counter() - t0,
                      "shards": [serialize_shard_proof(sp).hex()
                                 for sp in proof.shard_proofs]}), flush=True)


def start_host_process(call: str):
    """chip_smoke.<call>() in a process of its own, with no card in sight.
    Returns (the process, its output file)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke.{call}()"],
                            cwd=repo, env=env, stdout=out, stderr=subprocess.STDOUT, text=True)
    return proc, out


def host_output(proc_out, what: str) -> tuple:
    """Wait for a process of start_host_process; (its last line, seconds
    waited). Fails if it failed."""
    proc, out = proc_out
    t0 = time.perf_counter()
    rc = proc.wait()
    waited = time.perf_counter() - t0
    out.seek(0)
    log = out.read()
    assert rc == 0, f"{what} failed ({rc}):\n{log[-3000:]}"
    return log.strip().splitlines()[-1], waited


def phase_service(registry_proc) -> tuple:
    """The service path. Returns the kernels' launches: the core-config
    requests', the CLI guest's and the dev-config ladder's, counted apart;
    and the in-process prove_program's proof of fibonacci(FIB_N), unpadded,
    which phase 13 holds the checkpointed prove against."""
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.executor.asm import fibonacci_program
    from ziren_tpu_torch.machine.mips import prove_program
    from ziren_tpu_torch.network import NetworkProver, ProverServer, wire
    from ziren_tpu_torch.network.client import NetworkProverError
    from ziren_tpu_torch.sdk import ProverClient
    from ziren_tpu_torch.stark.config import core_config, outer_dev_config
    from ziren_tpu_torch.stark.serialize import serialize_machine_proof

    program = fibonacci_program(FIB_N)
    t0 = time.perf_counter()
    _m, _pk, _vk, direct, ex = prove_program(program, config=core_config(),
                                             shard_size=SHARD_SIZE)  # device=None: the GPU
    want = serialize_machine_proof(direct)
    print(f"  in-process prove_program (setup, execute, prove): "
          f"{time.perf_counter() - t0:.3f} s, {len(direct.shard_proofs)} shards, "
          f"{len(want)} bytes of proof", flush=True)
    assert int(ex.global_clk) == FIB_CYCLES

    server = ProverServer(host="127.0.0.1", port=0, config="core")  # device=None: the GPU
    served_s, lock = [], threading.Lock()
    inner = server.service._client.prove

    def timed_prove(*args, **kw):  # the server's seconds in ProverClient.prove
        t0 = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            with lock:
                served_s.append(time.perf_counter() - t0)

    server.service._client.prove = timed_prove
    with server:
        prover = NetworkProver(server.endpoint, timeout=600.0, config="core")
        assert prover.ready()
        t0 = time.perf_counter()
        pk, vk = prover.setup(program)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _values, report = prover.execute(pk)
        execute_s = time.perf_counter() - t0
        assert report.total_instruction_count == FIB_CYCLES and report.exit_code == 0
        print(f"  ready; setup {setup_s:.3f} s (the server's key and the client's own vk); "
              f"execute {execute_s:.3f} s, {report.total_instruction_count} cycles", flush=True)

        def request(client):
            t0 = time.perf_counter()
            proof = client.prove(pk, shard_size=SHARD_SIZE, verify=False)
            t1 = time.perf_counter()
            assert client._local.verify(proof, vk)  # the client's own ProverClient
            return proof, t1 - t0, time.perf_counter() - t1

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the earlier phases' cached keys
        kernels.reset_launches()
        singles = [request(prover) for _ in range(SERVED_IN_TURN)]
        for proof, _s, _v in singles:
            assert serialize_machine_proof(proof.proof) == want, \
                "a served proof differs from the in-process prove"
        req_bytes = len(wire.dumps({"program_id": pk.program_id, "stdin": None,
                                    "shard_size": SHARD_SIZE}))
        reply_bytes = len(wire.dumps({"ok": True, "result": {"proof": singles[0][0]}}))
        single_served = list(served_s)
        single_peak = torch.cuda.max_memory_allocated()

        pair: list = [None, None]

        def worker(i):
            pair[i] = request(NetworkProver(server.endpoint, timeout=600.0, config="core"))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        pair_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = launches_of("the service path")
        peak = torch.cuda.max_memory_allocated()
        assert all(pair), "a concurrent request failed"
        for proof, _s, _v in pair:
            assert serialize_machine_proof(proof.proof) == want, \
                "a proof served beside another differs from the in-process prove"

        pk2, _vk2 = prover.setup(program)
        assert pk2.program_id == pk.program_id and len(server.service._keys) == 1
        try:
            prover.prove(type(pk)("feed" * 16, vk), shard_size=SHARD_SIZE)
        except NetworkProverError as e:
            assert "unknown program id" in str(e)
        else:
            raise AssertionError("an unknown program id was served")
        assert prover.ready()

    print(f"  {len(singles)} ProveCore request(s) in turn, client s: "
          + ", ".join(f"{s:.3f}" for _p, s, _v in singles)
          + "; the server's prove s: " + ", ".join(f"{s:.3f}" for s in single_served)
          + "; the client's verify s: " + ", ".join(f"{v:.3f}" for _p, _s, v in singles),
          flush=True)
    print(f"  request {req_bytes} bytes, reply {reply_bytes} bytes on the wire; "
          f"every proof byte-equal to the in-process prove", flush=True)
    print("  two ProveCore requests at once, client s: "
          + ", ".join(f"{s:.3f}" for _p, s, _v in pair)
          + "; the server's prove s: " + ", ".join(f"{s:.3f}" for s in served_s[len(singles):])
          + "; the client's verify s: " + ", ".join(f"{v:.3f}" for _p, _s, v in pair)
          + f"; both proved and verified in {pair_s:.3f} s", flush=True)
    in_turn = sum(s for _p, s, _v in singles) / len(singles)
    print(f"  {FIB_CYCLES / 1e3 / in_turn:.3f} kHz a request in "
          f"turn, {2 * FIB_CYCLES / 1e3 / max(s for _p, s, _v in pair):.3f} kHz with two at "
          f"once (client seconds, verify left out)", flush=True)
    print("  a second setup built no second key; an unknown program id came back as an "
          "error and the server went on answering", flush=True)
    print(f"  peak device memory allocated: {peak} bytes ({peak / 2**30:.3f} GiB) with two "
          f"requests in flight, {single_peak} bytes with one; {held} bytes of them were "
          f"held when the path began (the earlier phases' keys)", flush=True)

    # the CLI, each command a process of its own, at the dev config on the card
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        elf, out = os.path.join(tmp, "fib.elf"), os.path.join(tmp, "proof.bin")
        with open(elf, "wb") as f:
            f.write(minimal_elf(10))

        def cli(*argv):
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m", "ziren_tpu_torch", *argv], cwd=repo,
                                 env=env, capture_output=True, text=True, timeout=300)
            assert res.returncode == 0, (argv, res.stderr[-2000:])
            return res.stdout, time.perf_counter() - t0

        vkey, vkey_s = cli("vkey", elf, "--config", "dev")
        proved, prove_s = cli("prove", elf, "--config", "dev", "-o", out)
        verified, verify_s = cli("verify", elf, out, "--config", "dev")
        assert vkey.startswith("vk: ") and "1 shard(s)" in proved
        assert "committed: " + (89).to_bytes(4, "little").hex() in proved
        assert verified.startswith("verification: ok")
        dev = ProverClient(config="dev")  # device=None: the GPU
        with open(elf, "rb") as f:
            epk, evk = dev.setup(f.read())
        # the same guest and config in this process: the launches and launch
        # shapes of the CLI's prove, which its own process took with it
        kernels.reset_launches()
        in_process = dev.prove(epk)
        torch.cuda.synchronize()
        cli_launches = launches_of("the CLI's guest (ProverClient.prove in this process)")
        with open(out, "rb") as f:
            assert f.read() == serialize_machine_proof(in_process.proof), \
                "the CLI's proof file differs from ProverClient.prove"
    print(f"  python3 -m ziren_tpu_torch on a 16-word guest ELF, dev config, each a process: "
          f"vkey {vkey_s:.2f} s, prove {prove_s:.2f} s (the file byte-equal to "
          f"ProverClient.prove), verify {verify_s:.2f} s", flush=True)

    # the upper rungs of the ladder, dev config, one shard; the registry
    # comes from the process started with the script
    line, waited_s = host_output(registry_proc, "the ladder's registry process")
    registry_file, guest_registry_file = json.loads(line)
    assert os.path.exists(registry_file) and os.path.exists(guest_registry_file), line
    kernels.reset_launches()
    small = fibonacci_program(30)
    spk, svk = dev.setup(small)
    t0 = time.perf_counter()
    compressed = dev.compressed_prove(spk)
    t1 = time.perf_counter()
    from ziren_tpu_torch.recursion import mips_pipeline as mp
    from ziren_tpu_torch.recursion.vk_registry import VkRegistry

    def cached_registry(path):
        return VkRegistry(list(np.fromfile(path, dtype=np.uint32).reshape(-1, 8)), height=64)

    cached = cached_registry(registry_file)
    rpv = [int(v) for v in compressed[2].public_values]
    assert rpv[mp.RPV_VK_ROOT : mp.RPV_VK_ROOT + 8] == [int(v) for v in cached.root], \
        "compressed_prove did not use the registry enumerated beforehand"
    dev.verify_compressed(compressed, svk)
    t2 = time.perf_counter()
    shrunk = dev.shrink_prove(compressed)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    ladder = launches_of("the dev-config ladder")
    wrapped = dev.wrap_prove(shrunk, outer=outer_dev_config())
    t4 = time.perf_counter()
    assert dev.verify_wrapped(wrapped, shrunk)
    t5 = time.perf_counter()
    back = wire.loads(wire.dumps({"ok": True, "result": {"compressed": compressed}}))
    dev.verify_compressed(back["result"]["compressed"], svk)  # a CompressedProve reply
    print(f"  ProverClient(config='dev') on fibonacci(30), one shard: the registry process "
          f"waited for {waited_s:.2f} s (it enumerated the full lift + join registry on the "
          f"host beside the earlier phases; at the core config it does not fit in a call); "
          f"compressed_prove {t1 - t0:.2f} s (core prove, the registry from its file, one "
          f"lift), verify_compressed {t2 - t1:.2f} s, shrink_prove {t3 - t2:.2f} s, "
          f"wrap_prove {t4 - t3:.2f} s (the host prover, outer_dev_config()), "
          f"verify_wrapped {t5 - t4:.2f} s; Groth16 and Plonk are not run here",
          flush=True)
    composition = ladder_composition(dev, spk, compressed, cached_registry(guest_registry_file))
    return {k: (launches[k], cli_launches[k], ladder[k], composition[k])
            for k in launches}, direct


def ladder_composition(dev, sub_pk, sub, registry) -> dict:
    """Phase 9's composition leg, through the SDK at the dev config on the
    card: ProverClient.compressed_prove of the guest that claims the
    ladder's compressed proof `sub` twice (ladder_claim_guest), with
    deferred=[sub, sub]: its core prove and one lift under `registry` (the
    registry process's enumeration, which compressed_prove loads from its
    file), two deferred leaves, a deferred join and the attach; the root is
    complete and verify_compressed accepts it. Then one refusal: one
    sub-proof for the two claims raises VerificationError after the core
    prove and before any recursion proof. Returns the kernels' launches of
    the composed prove."""
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.recursion import mips_pipeline as mp
    from ziren_tpu_torch.stark.verifier import VerificationError
    from ziren_tpu_torch.tools import compress_bench as cb

    guest_pk, guest_vk = dev.setup(ladder_claim_guest(sub_pk))
    torch.cuda.synchronize()
    kernels.reset_launches()
    with cb.instrument() as times:
        t0 = time.perf_counter()
        root = dev.compressed_prove(guest_pk, deferred=[sub, sub])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = launches_of("the SDK's composition (compressed_prove, two sub-proofs)")
    root_rpv = [int(v) for v in root[2].public_values]
    assert root_rpv[mp.RPV_IS_COMPLETE] == 1
    assert root_rpv[mp.RPV_VK_ROOT : mp.RPV_VK_ROOT + 8] == [int(v) for v in registry.root], \
        "compressed_prove did not use the claim guest's registry enumerated beforehand"
    digest = dev.verify_compressed(root, guest_vk)
    assert isinstance(digest, bytes) and len(digest) == 32
    nodes = ("lift",) + cb.DEFERRED_NODES
    assert [len(times.get(k, [])) for k in nodes] == [1, 2, 1, 1], \
        {k: len(v) for k, v in times.items()}
    t2 = time.perf_counter()
    with cb.instrument() as refused:
        try:
            dev.compressed_prove(guest_pk, deferred=[sub])
        except VerificationError as e:
            assert "2 proof claims but 1" in str(e), e
        else:
            raise AssertionError("compressed_prove took one sub-proof for two claims")
    assert not refused, "recursion work before the refusal"
    refusal_s = time.perf_counter() - t2
    print(f"  composition through the SDK (dev config): a guest that claims that compressed "
          f"proof twice, compressed_prove(pk, deferred=[root, root]) {t1 - t0:.2f} s, the "
          f"root complete under the claim guest's registry from its file, verify_compressed "
          f"ok; one sub-proof for two claims refused before any recursion proof "
          f"({refusal_s:.2f} s, its core prove)", flush=True)
    for kind in nodes:
        print(f"  {kind} s, total (split): " + cb.summary(times[kind]), flush=True)
    return launches


@contextlib.contextmanager
def bench_env():
    """While open, tools/bench.py's main runs its stages in this process
    (ZIREN_BENCH_CHILD=1) on fibonacci(BENCH_N) in shards of SHARD_SIZE."""
    want = {"ZIREN_BENCH_CHILD": "1", "ZIREN_BENCH_FIB_N": str(BENCH_N),
            "ZIREN_BENCH_SHARD_SIZE": str(SHARD_SIZE)}
    saved = {k: os.environ.get(k) for k in want}
    os.environ.update(want)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def phase_drivers(card: str, unpadded) -> dict:
    """Phase 13: the drivers of ziren_tpu_torch/tools and
    ziren_tpu_torch/examples, each through its main in this process (the
    device left at its default, the GPU), its standard output captured,
    echoed and checked, the kernels' launches and launch shapes read after
    each; then prove_program_checkpointed against phase 9's unpadded proof
    (`unpadded`). Returns the kernels' launches over the phase."""
    import io

    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.examples import network_prover, precompiles, prove_guest
    from ziren_tpu_torch.executor.asm import fibonacci_program
    from ziren_tpu_torch.machine.mips import prove_program_checkpointed, verify_mips_proof
    from ziren_tpu_torch.stark.verifier import verify_shard
    from ziren_tpu_torch.stark.config import core_config
    from ziren_tpu_torch.stark.serialize import serialize_machine_proof
    from ziren_tpu_torch.tools import (bench, bench_prove, device_probe, profile_device,
                                       profile_prove)

    total: dict = {}
    seconds: dict = {}

    def drive(name, fn, *args, **kw):
        """(fn's result, what it printed); its launches join the phase's."""
        out = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        text = out.getvalue()
        for line in text.splitlines():
            print(f"    | {line}", flush=True)
        for k, v in launches_of(name).items():
            total[k] = total.get(k, 0) + v
        return result, text

    # the per-stage and per-leg splits of a core-config prove at full width
    probe, text = drive("device_probe", device_probe.main, FIB_N, SHARD_SIZE)
    assert "] verified" in text and "warm shard legs:" in text, "device_probe did not finish"
    assert probe["cycles"] == FIB_CYCLES
    assert len(probe["proof"].shard_proofs) == len(unpadded.shard_proofs)
    for stage, s in probe["stages"].items():
        print(f"  device_probe stage {stage}: {s:.4f} s ({card})", flush=True)
    prof, text = drive("profile_device", profile_device.main, FIB_N, SHARD_SIZE,
                       config="core")
    assert "\nverified\n" in text and "machine.prove=" in text, "profile_device did not finish"
    serial, pipelined = prof["proofs"]
    assert serialize_machine_proof(serial) == serialize_machine_proof(pipelined), \
        "profile_device: the serial legs' proof differs from machine.prove's"
    assert verify_mips_proof(prof["machine"], prof["vk"], pipelined,
                             pc_start=prof["program"].pc_start)
    for leg, s in prof["legs"].items():
        print(f"  profile_device leg {leg}: {s:.4f} s ({card})", flush=True)

    _proof, text = drive("bench_prove", bench_prove.main)
    line = text.strip().splitlines()[-1]
    print(line, flush=True)
    out = json.loads(line)
    assert out["config"] == "core" and out["shards"] == 1 and out["cycles"] > 0, out
    # tools/bench.py's stages in this process, as its child runs them
    with bench_env():
        _none, text = drive("bench", bench.main)
    lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    assert [ln["detail"]["staged"] for ln in lines] == ["warmup-incl-loads", "prove-only",
                                                        "full"], text
    assert all(ln["detail"]["backend"] == "cuda" and ln["detail"]["config"] == "core"
               and ln["vs_baseline"] is not None for ln in lines), text
    assert lines[-1]["detail"]["verified"] is True
    _proof, text = drive("profile_prove", profile_prove.main)
    assert text.startswith("cycles=") and "function calls" in text, "profile_prove"
    for which in precompiles.PROGRAMS:
        _proof, text = drive(f"precompiles {which}", precompiles.main, which)
        assert text.strip().endswith("verification: ok"), which
    _proof, text = drive("network_prover", network_prover.main)
    assert "verified locally - ok" in text, "network_prover"
    with tempfile.TemporaryDirectory() as tmp:
        elf = os.path.join(tmp, "fib.elf")
        with open(elf, "wb") as f:
            f.write(minimal_elf())
        _proof, text = drive("prove_guest", prove_guest.main, elf)
    assert "executed: 70 cycles, exit 0" in text and text.strip().endswith("verified"), text

    # the checkpointed prove of a prefix, shard for shard against phase 9's
    # prove_program
    program = fibonacci_program(FIB_N)
    (machine, _pk, vk, proof, _scout), _text = drive(
        "prove_program_checkpointed", prove_program_checkpointed, program,
        config=core_config(), shard_size=SHARD_SIZE,
        shards=CHECKPOINTED_SHARDS)  # device=None: the GPU
    assert len(proof.shard_proofs) == CHECKPOINTED_SHARDS
    base = machine.config.challenger()
    vk.observe_into(base)
    for i, (a, b) in enumerate(zip(proof.shard_proofs, unpadded.shard_proofs)):
        verify_shard(machine, vk, a, base.clone())
        assert np.array_equal(a.commitment.main, b.commitment.main), f"shard {i + 1}: main"
        assert [int(v) for v in a.public_values] == [int(v) for v in b.public_values], \
            f"shard {i + 1}: public values"
    print(f"  prove_program_checkpointed of the first {CHECKPOINTED_SHARDS} of the "
          f"{len(unpadded.shard_proofs)} shards of fibonacci({FIB_N}) on the card: each "
          f"verified, its main commitment and public values those of phase 9's prove_program",
          flush=True)
    print("  seconds by driver: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()),
          flush=True)
    return total


def main() -> None:
    dev = require_cuda()
    procs = {"ladder": start_host_process("ladder_registry"),
             "groups": start_host_process("group_host_proofs"),
             "memory": start_host_process("memory_host_proof")}
    try:
        run(dev, procs)
    finally:
        for proc, out in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()


def run(dev, procs) -> None:
    started = time.perf_counter()
    seconds = {}

    def phase(n, title, fn, *args):
        print(f"phase {n}: {title}", flush=True)
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[n] = time.perf_counter() - t0
        print(f"  phase {n} took {seconds[n]:.1f} s", flush=True)
        return out

    print("phase 1: environment", flush=True)
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)

    from ziren_tpu_torch import kernels

    print("phase 2: build", flush=True)
    print(f"  kernels built and loaded in {kernels.build():.3f} s", flush=True)
    log = kernels.build_log()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip(), flush=True)
    for name in ("compress_levels_kernel", "grind_kernel"):  # redesigned in K3 and K4
        part = log.split(name, 1)[1].split("Compiling entry", 1)[0]
        print(f"  ptxas, {name}: " + "; ".join(
            ln.strip() for ln in part.splitlines()
            if "registers" in ln or "spill" in ln), flush=True)

    rec = phase(3, "kernels vs plain PyTorch on the card", phase_kernels, dev)
    small = phase(4, "small shard, port vs host prover", phase_small_shard, dev)
    launches, main_path = phase(5, "main path", phase_main_path, dev)
    program, machine, pk, vk, proof, records, grind_shape = main_path
    phase(6, "tmerkle and tntt vs the host", phase_merkle_ntt, dev)
    phase(7, "small recursion shard, port vs host prover", phase_small_recursion, *small)
    recursion_launches = phase(8, "the recursion path", phase_recursion, program, machine,
                               vk, proof)
    service_launches, unpadded = phase(9, "the service path", phase_service, procs["ladder"])
    fused_launches = phase(10, "the fused path", phase_fused, program, machine, pk, vk, proof,
                           records)
    precompile_launches = phase(11, "the precompile path", phase_precompiles, procs["groups"])
    mesh_launches = phase(12, "the multi-device path", phase_mesh, dev, program, machine, pk,
                          vk, proof)
    driver_launches = phase(13, "the drivers", phase_drivers, smi, unpadded)
    composition_launches = phase(14, "the composition path", phase_composition, smi)
    memory_launches = phase(15, "standalone memory shards and unconstrained blocks",
                            phase_memory, smi, procs["memory"])
    print("seconds by phase (phase 2 is the build above): "
          + ", ".join(f"{n}: {s:.1f}" for n, s in sorted(seconds.items()))
          + f"; the whole script {time.perf_counter() - started:.1f}", flush=True)

    def entry(name, replaces, shape):
        # library_ms: no PyTorch call computes Poseidon2, a Merkle level or
        # a proof-of-work search
        r = rec[name]
        ms, plain_ms, bound_ms, bound_by = r["shapes"][shape]
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": replaces,
                "launches": launches[name] + recursion_launches[name]
                + sum(service_launches[name]) + fused_launches[name]
                + precompile_launches[name] + mesh_launches[name] + driver_launches[name]
                + composition_launches[name] + memory_launches[name],
                "max_abs_err": r["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                "shape": str(shape), **({"latency_floor_ms": r["latency_floor"][shape]}
                                        if "latency_floor" in r else {})}

    print(json.dumps({"kernels": [
        entry("hash_rows", "ziren_tpu/ops/jposeidon2.py:235", (1 << 17, 108)),
        entry("permute", "ziren_tpu/ops/jposeidon2.py:97", (1 << 16, 16)),
        entry("compress_levels", "ziren_tpu/ops/jpcs.py:173", (256, ())),
        entry("grind", "ziren_tpu/ops/jchallenger.py:51", grind_shape),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
