// Poseidon2-KoalaBear-16 on Hopper (sm_90a): the leaf-hash sponge, the bare
// permutation and the upper levels of a Merkle tree, with a plain C
// interface loaded through ctypes by ziren_tpu_torch/kernels.py.
//
// K1 zt_hash_rows replaces the Pallas TPU kernel hash_rows_pallas
// (ziren_tpu/ops/jposeidon2.py:235): the padding-free sponge over each row
// of an (n, w) matrix, rate 8, squeezing 8 words. It feeds every Merkle
// commit of the prover (main, permutation and quotient traces, the
// preprocessed traces and every FRI layer).
// K2 zt_permute runs the same permutation on (m, 16) states. It takes the
// place of the XLA-lowered jposeidon2.permute (:97) behind compress_pairs,
// the Merkle level compressions, the challenger duplex and the PoW grind.
// K3 zt_compress_levels takes the (h, 8) digests of one Merkle level,
// h <= 256, and writes every level below it down to the root in one
// launch (the loop of ops/tpcs.py:merkle_levels, jpcs._merkle_levels in the
// JAX package), compressing in the digests of shorter matrices where a
// level has them. Its operations bound is far below its time: its log2(h)
// levels (and each injected level) form a chain of dependent permutations,
// so it is bound by the latency of one permutation, not by the int32 pipe.
// It runs over a thread-block cluster of up to 8 blocks, each a subtree of
// at most 32 digests, a warp a pair, with the 16-lane form whose internal
// rounds sum by warp reduction, the shortest chain of the forms measured.
// K4 zt_grind is the proof-of-work grind of the Fiat-Shamir transcript, the
// lax.while_loop of ziren_tpu/ops/jchallenger.py:_grind: the smallest
// witness w whose duplex gives a sample with nb_bits low zero bits, found in
// one launch and left on the device, so a shard's prove holds no host wait
// and can be captured into one CUDA graph. It is bound by the same integer
// pipe: (w + 1) permutations at least. Its warps claim candidates in
// increasing order and stop once the claims pass the best witness, so it
// tests about the witness plus one wave of the blocks the card holds.
//
// What bounds them: 32-bit integer instructions. The permutation is 490
// field products and about 1,200 field additions, all on the int32 pipe;
// a row of width w takes ceil(w / 8) permutations and its bytes are read
// once. What the design does about it:
//   * products are signed Montgomery products (R = 2^32): five
//     instructions, operands and result in (-p, p), no final correction;
//   * the 16 diagonal products of an internal round are not products: the
//     diagonal is (-2, 1, 2, 1/2, 3, 4, -1/2, -3, -4, 1/2^8, 1/8, 1/2^24,
//     -1/2^8, -1/8, -1/16, -1/2^24), and x / 2^k = (x >> k) - (x mod 2^k) *
//     127 * 2^(24-k) mod p because 2^k * 127 * 2^(24-k) = p - 1;
//   * sums are taken wide and reduced once: the linear layers and
//     diag * s + sum(s) accumulate in 64 bits and fold at bit 31 with
//     2^31 = 2^24 - 1 mod p into a word below 2p ("lazy"); a word is brought
//     below p only where an S-box reads it;
//   * M_E is M4 applied to (block + sum of the four blocks), which is the
//     same 72 additions with one 64-bit offset that keeps signed inputs
//     positive;
//   * K1 stages 128-row x 16-word tiles through shared memory with
//     cp.async, double-buffered, so a warp reads whole 128-byte row
//     segments; words enter Montgomery form as they leave shared memory;
//   * K2 has two variants: one thread a state for large m, and 16 lanes a
//     state (one word a lane, the linear layers through warp shuffles) for
//     small m, where the card would stand empty and one permutation would
//     be a chain of 490 dependent products. K3 takes a warp a state, 16
//     lanes of it, and sums an internal round by warp reduction.
//
// Tensors are canonical int64 in [0, p) on both sides.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

// ZT_RC_BIAS[30][16] (__constant__) and ZT_RC_BIAS_G[30][16] (__device__):
// the round constants in Montgomery form minus p, as int32 in (-p, 0];
// ZT_PERMUTE_LANES_MAX, the most states K2 spreads over 16 lanes each, and
// ZT_LEVEL_MAX, the tallest level K3 takes.
#include "poseidon2_constants.h"

namespace {

constexpr uint32_t P = 2130706433u;     // 2^31 - 2^24 + 1
constexpr uint32_t PINV = 2164260865u;  // p^-1 mod 2^32
constexpr uint32_t MU = 2130706431u;    // -p^-1 mod 2^32
constexpr int32_t R2 = 402124772;       // 2^64 mod p
constexpr uint64_t P64 = P;

constexpr int THREADS = 128;  // a block of K1 and of both K2 variants

// The round loops stay rolled: three loop bodies (external, internal,
// external) fit the instruction cache, where 21 unrolled rounds do not, and
// ptxas takes seconds (with all 21 rounds unrolled into one block of 64-bit
// arithmetic it did not finish in ten minutes). The round constants are
// then indexed loads from constant memory at an address the warp shares.
#define ZT_ROUNDS _Pragma("unroll 1")

// Signed Montgomery product: |a * b| < 2^31 p, result in (-p, p).
__device__ __forceinline__ int32_t smont(int32_t a, int32_t b) {
  const int64_t t = static_cast<int64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(t) * PINV;
  return static_cast<int32_t>(t >> 32) -
         __mulhi(static_cast<int32_t>(m), static_cast<int32_t>(P));
}

// [0, 2p) -> [0, p).
__device__ __forceinline__ uint32_t fix(uint32_t w) { return min(w, w - P); }

// v < 124 * 2^31 -> a lazy word congruent to v, below 2^31 + (v >> 31) 2^24.
__device__ __forceinline__ uint32_t red(uint64_t v) {
  return static_cast<uint32_t>(v >> 31) * 16777215u +
         (static_cast<uint32_t>(v) & 0x7fffffffu);
}

// canonical int64 -> lazy Montgomery word in (0, 2p)
__device__ __forceinline__ uint32_t to_mont(int64_t x) {
  return static_cast<uint32_t>(smont(static_cast<int32_t>(x), R2) +
                               static_cast<int32_t>(P));
}

// any 32-bit Montgomery word -> canonical int64
__device__ __forceinline__ int64_t from_mont(uint32_t w) {
  const uint32_t t = __umulhi(w * MU, P) + (w != 0u);  // <= p
  return static_cast<int64_t>(fix(t));
}

// (lazy word + round constant)^3, in (-p, p); rc_bias = rc - p.
__device__ __forceinline__ int32_t sbox_rc(uint32_t w, int32_t rc_bias) {
  const int32_t x = static_cast<int32_t>(fix(w)) + rc_bias;
  return smont(smont(x, x), x);
}

// M_E on 16 words, signed in (-p, p) with offset 5p or unsigned below 2^32
// with offset 0: c = offset + the sum of the four blocks, y = block + c,
// out = M4 y with M4 the circulant (2 3 1 1). Sums stay below 70 * 2^32.
template <typename T>
__device__ __forceinline__ void external_linear(const T x[16], uint32_t s[16],
                                                int64_t offset) {
  int64_t c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[k] = offset + static_cast<int64_t>(x[k]) + static_cast<int64_t>(x[k + 4]) +
           static_cast<int64_t>(x[k + 8]) + static_cast<int64_t>(x[k + 12]);
  }
#pragma unroll
  for (int j = 0; j < 16; j += 4) {
    const int64_t y0 = c[0] + static_cast<int64_t>(x[j]);
    const int64_t y1 = c[1] + static_cast<int64_t>(x[j + 1]);
    const int64_t y2 = c[2] + static_cast<int64_t>(x[j + 2]);
    const int64_t y3 = c[3] + static_cast<int64_t>(x[j + 3]);
    const int64_t t01 = y0 + y1;
    const int64_t t23 = y2 + y3;
    const int64_t t0123 = t01 + t23;
    const int64_t t01123 = t0123 + y1;
    const int64_t t01233 = t0123 + y3;
    s[j + 0] = red(static_cast<uint64_t>(t01123 + t01));
    s[j + 1] = red(static_cast<uint64_t>(t01123 + 2 * y2));
    s[j + 2] = red(static_cast<uint64_t>(t01233 + t23));
    s[j + 3] = red(static_cast<uint64_t>(t01233 + 2 * y0));
  }
}

__device__ __forceinline__ void external_round(uint32_t s[16], int r) {
  int32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = sbox_rc(s[i], ZT_RC_BIAS[r][i]);
  external_linear<int32_t>(x, s, static_cast<int64_t>(5 * P64));
}

// s / 2^K (or its negative) plus t, for a 32-bit s.
template <int K, bool NEG>
__device__ __forceinline__ uint32_t diag_shift(uint64_t t, uint32_t s) {
  const uint64_t hi = s >> K;
  const uint64_t a = static_cast<uint64_t>(s & ((1u << K) - 1u)) * (127u << (24 - K));
  return red(NEG ? t - hi + a : t + hi - a);
}

// S-box on word 0, then s_i <- diag_i s_i + sum(s). Words stay lazy; the
// offset 9p keeps every 64-bit sum positive (4 * 2^32 < 9p).
__device__ __forceinline__ void internal_round(uint32_t s[16], int r) {
  s[0] = static_cast<uint32_t>(sbox_rc(s[0], ZT_RC_BIAS[r][0]) + static_cast<int32_t>(P));
  uint64_t t = 9 * P64;
#pragma unroll
  for (int i = 0; i < 16; ++i) t += s[i];
  const uint64_t s0 = s[0], s2 = s[2], s4 = s[4], s5 = s[5], s7 = s[7], s8 = s[8];
  s[0] = red(t - 2 * s0);
  s[1] = red(t + s[1]);
  s[2] = red(t + 2 * s2);
  s[3] = diag_shift<1, false>(t, s[3]);
  s[4] = red(t + 3 * s4);
  s[5] = red(t + 4 * s5);
  s[6] = diag_shift<1, true>(t, s[6]);
  s[7] = red(t - 3 * s7);
  s[8] = red(t - 4 * s8);
  s[9] = diag_shift<8, false>(t, s[9]);
  s[10] = diag_shift<3, false>(t, s[10]);
  s[11] = diag_shift<24, false>(t, s[11]);
  s[12] = diag_shift<8, true>(t, s[12]);
  s[13] = diag_shift<3, true>(t, s[13]);
  s[14] = diag_shift<4, true>(t, s[14]);
  s[15] = diag_shift<24, true>(t, s[15]);
}

// Lazy words in, lazy words out. Rounds: the initial linear layer, 4
// external, 13 internal, 4 external.
__device__ __forceinline__ void permute16(uint32_t s[16]) {
  {
    uint32_t x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = s[i];
    external_linear<uint32_t>(x, s, 0);
  }
  ZT_ROUNDS
  for (int r = 0; r < 4; ++r) external_round(s, r);
  ZT_ROUNDS
  for (int r = 4; r < 17; ++r) internal_round(s, r);
  ZT_ROUNDS
  for (int r = 17; r < 21; ++r) external_round(s, r);
}

// ---------------------------------------------------------------------------
// 16 lanes a state: lane i of each 16-lane group holds word i.
// ---------------------------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;

// diag_i s = sign_i (A_i (s >> k_i) - (s mod 2^k_i) C_i)
__device__ const uint32_t DIAG_K[16] = {0, 0, 0, 1, 0, 0, 1, 0, 0, 8, 3, 24, 8, 3, 4, 24};
__device__ const uint32_t DIAG_A[16] = {2, 1, 2, 1, 3, 4, 1, 3, 4, 1, 1, 1, 1, 1, 1, 1};
__device__ const int32_t DIAG_SIGN[16] = {-1, 1, 1, 1, 1, 1, -1, -1, -1, 1, 1, 1, -1, -1, -1, -1};

struct Lane {
  int lane;        // 0..15
  int32_t rc[8];   // this lane's biased constants of the 8 external rounds
  uint32_t k, mask, a, c;
  int64_t sign;
};

__device__ __forceinline__ Lane make_lane(int lane) {
  Lane l;
  l.lane = lane;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    l.rc[r] = ZT_RC_BIAS_G[r][lane];
    l.rc[4 + r] = ZT_RC_BIAS_G[17 + r][lane];
  }
  l.k = DIAG_K[lane];
  l.mask = (1u << l.k) - 1u;
  l.a = DIAG_A[lane];
  l.c = l.k ? (127u << (24 - l.k)) : 0u;
  l.sign = DIAG_SIGN[lane];
  return l;
}

// M_E across the 16 lanes of a group; xu is this lane's word, below 2^32.
__device__ __forceinline__ uint32_t coop_linear(uint32_t xu, int lane) {
  const int base = lane & 12, k = lane & 3;
  const uint64_t a = __shfl_sync(FULL, xu, base | ((k + 1) & 3), 16);
  const uint64_t b = __shfl_sync(FULL, xu, base | ((k + 2) & 3), 16);
  const uint64_t c = __shfl_sync(FULL, xu, base | ((k + 3) & 3), 16);
  const uint32_t z = red(2 * static_cast<uint64_t>(xu) + 3 * a + b + c);
  const uint64_t z1 = __shfl_xor_sync(FULL, z, 4, 16);
  const uint64_t z2 = __shfl_xor_sync(FULL, z, 8, 16);
  const uint64_t z3 = __shfl_xor_sync(FULL, z, 12, 16);
  return red(2 * static_cast<uint64_t>(z) + z1 + z2 + z3);
}

// The permutation with one lazy word a lane; every lane of the warp calls it.
__device__ __forceinline__ uint32_t permute_coop(uint32_t s, const Lane& l) {
  s = coop_linear(s, l.lane);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    s = coop_linear(static_cast<uint32_t>(sbox_rc(s, l.rc[r]) + static_cast<int32_t>(P)), l.lane);
  }
#pragma unroll 1
  for (int r = 4; r < 17; ++r) {
    // the sum of words 1..15 does not wait for the S-box of word 0
    uint64_t t = l.lane == 0 ? 0u : s;
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) t += __shfl_xor_sync(FULL, t, d, 16);
    const uint32_t boxed =
        static_cast<uint32_t>(sbox_rc(s, ZT_RC_BIAS[r][0]) + static_cast<int32_t>(P));
    t += __shfl_sync(FULL, boxed, 0, 16);
    if (l.lane == 0) s = boxed;
    const int64_t hi = s >> l.k;
    const int64_t lo = s & l.mask;
    const int64_t term = l.sign * (static_cast<int64_t>(l.a) * hi - lo * static_cast<int64_t>(l.c));
    s = red(static_cast<uint64_t>(static_cast<int64_t>(t + 9 * P64) + term));
  }
#pragma unroll
  for (int r = 4; r < 8; ++r) {
    s = coop_linear(static_cast<uint32_t>(sbox_rc(s, l.rc[r]) + static_cast<int32_t>(P)), l.lane);
  }
  return s;
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

constexpr int TILE_W = 16;         // words a row in one staged tile: 128 bytes
constexpr int PITCH = TILE_W + 1;  // shared-memory row pitch in words: odd, so
                                   // the 8-byte reads of a half-warp hit
                                   // distinct banks

__device__ __forceinline__ void cp_async8(const int64_t* smem, const int64_t* gmem) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sa), "l"(gmem) : "memory");
}

// K1: one thread a row, 128 rows a block. Tiles of 16 words a row are
// copied to shared memory by the whole block (16 lanes a row segment) one
// tile ahead of the permutations that absorb them. Each chunk of up to 8
// words overwrites the state prefix and is followed by a permutation (a
// partial last chunk keeps the state words past its end). A row of width 0
// hashes to zeros.
__global__ void __launch_bounds__(THREADS)
hash_rows_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                 int64_t n, int64_t w) {
  __shared__ int64_t tile[2][THREADS * PITCH];
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * THREADS;
  const int64_t row = row0 + tid;
  const int64_t tiles = (w + TILE_W - 1) / TILE_W;

  auto stage = [&](int64_t t) {
    int64_t* dst = tile[t & 1];
    const int64_t col = t * TILE_W + (tid & (TILE_W - 1));
#pragma unroll
    for (int pass = 0; pass < TILE_W; ++pass) {
      const int r = pass * (THREADS / TILE_W) + (tid / TILE_W);
      if (row0 + r < n && col < w) {
        cp_async8(dst + r * PITCH + (tid & (TILE_W - 1)), in + (row0 + r) * w + col);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  uint32_t s[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0u;
  if (tiles > 0) stage(0);
  for (int64_t t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage(t + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (row < n) {
      const int64_t* src = tile[t & 1] + tid * PITCH;
#pragma unroll 1
      for (int64_t c = t * TILE_W; c < w && c < (t + 1) * TILE_W; c += 8) {
        const int64_t take = w - c < 8 ? w - c : 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i < take) s[i] = to_mont(src[i]);
        }
        src += 8;
        permute16(s);
      }
    }
    __syncthreads();
  }
  if (row < n) {
    int64_t* dst = out + row * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = from_mont(s[i]);
  }
}

// K2, large m: one thread a 16-word state.
__global__ void __launch_bounds__(THREADS)
permute_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
               int64_t m) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= m) return;
  const int64_t* src = in + row * 16;
  uint32_t s[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = to_mont(src[i]);
  permute16(s);
  int64_t* dst = out + row * 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = from_mont(s[i]);
}

// K2, small m: 16 lanes a state, two states a warp. Lanes past the last
// state run on zeros and store nothing.
__global__ void __launch_bounds__(THREADS)
permute_coop_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                    int64_t m) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const bool live = (gid >> 4) < m;
  const Lane l = make_lane(static_cast<int>(gid & 15));
  const uint32_t s = permute_coop(to_mont(live ? in[gid] : 0), l);
  if (live) out[gid] = from_mont(s);
}

// ---------------------------------------------------------------------------
// 4 lanes a state: lane q of each 4-lane group holds words 4q .. 4q+3. M4
// stays in registers; M_E's sum over the four blocks and an internal round's
// sum over the 16 words are two butterfly shuffles each. Every lane keeps a
// copy of word 0 through the internal rounds and computes its S-box itself,
// so the sum waits for no broadcast. Measured against the other forms by
// permute_latency_kernel only: on an H100 its chain is longer than the
// 16-lane forms' (tools/kernel_bench.py, PERF.md), so no kernel uses it.
// ---------------------------------------------------------------------------

struct Quad {
  int q;              // 0..3
  int32_t rc[8][4];   // this lane's biased constants of the 8 external rounds
  uint32_t k[4], mask[4], a[4], c[4];
  int64_t sign[4];
};

__device__ __forceinline__ Quad make_quad(int q) {
  Quad l;
  l.q = q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      l.rc[r][i] = ZT_RC_BIAS_G[r][4 * q + i];
      l.rc[4 + r][i] = ZT_RC_BIAS_G[17 + r][4 * q + i];
    }
    l.k[i] = DIAG_K[4 * q + i];
    l.mask[i] = (1u << l.k[i]) - 1u;
    l.a[i] = DIAG_A[4 * q + i];
    l.c[i] = l.k[i] ? (127u << (24 - l.k[i])) : 0u;
    l.sign[i] = DIAG_SIGN[4 * q + i];
  }
  return l;
}

// M_E: out = M4 x + (the sum of M4 x over the group's four lanes); x below
// 2^32, so the sums stay below 35 * 2^32.
__device__ __forceinline__ void quad_linear(const uint32_t x[4], uint32_t s[4]) {
  const uint64_t x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
  const uint64_t t01 = x0 + x1, t23 = x2 + x3, t0123 = t01 + t23;
  const uint64_t t01123 = t0123 + x1, t01233 = t0123 + x3;
  const uint64_t u[4] = {t01123 + t01, t01123 + 2 * x2, t01233 + t23, t01233 + 2 * x0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint64_t v = u[i] + __shfl_xor_sync(FULL, u[i], 1);
    v += __shfl_xor_sync(FULL, v, 2);
    s[i] = red(u[i] + v);
  }
}

__device__ __forceinline__ void quad_external(uint32_t s[4], const int32_t rc[4]) {
  uint32_t x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = static_cast<uint32_t>(sbox_rc(s[i], rc[i]) + static_cast<int32_t>(P));
  }
  quad_linear(x, s);
}

// w0: word 0, the same in the group's four lanes. The offset 9p keeps the
// signed diagonal terms positive, as in internal_round.
__device__ __forceinline__ void quad_internal(uint32_t s[4], uint32_t& w0, int32_t rc0,
                                              const Quad& l) {
  uint64_t part = (l.q == 0 ? 0ull : static_cast<uint64_t>(s[0])) + s[1] + s[2] + s[3];
  part += __shfl_xor_sync(FULL, part, 1);
  part += __shfl_xor_sync(FULL, part, 2);
  const uint32_t boxed = static_cast<uint32_t>(sbox_rc(w0, rc0) + static_cast<int32_t>(P));
  const uint64_t t = part + boxed + 9 * P64;
  if (l.q == 0) s[0] = boxed;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t hi = s[i] >> l.k[i];
    const int64_t lo = s[i] & l.mask[i];
    const int64_t term = l.sign[i] * (static_cast<int64_t>(l.a[i]) * hi -
                                      lo * static_cast<int64_t>(l.c[i]));
    s[i] = red(static_cast<uint64_t>(static_cast<int64_t>(t) + term));
  }
  w0 = red(t - 2 * static_cast<uint64_t>(boxed));  // lane 0's s[0]
}

// The permutation with four lazy words a lane; every lane of the warp calls it.
__device__ __forceinline__ void permute_quad(uint32_t s[4], const Quad& l) {
  {
    const uint32_t x[4] = {s[0], s[1], s[2], s[3]};
    quad_linear(x, s);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) quad_external(s, l.rc[r]);
  uint32_t w0 = __shfl_sync(FULL, s[0], 0, 4);
#pragma unroll
  for (int r = 4; r < 17; ++r) quad_internal(s, w0, ZT_RC_BIAS[r][0], l);
#pragma unroll
  for (int r = 4; r < 8; ++r) quad_external(s, l.rc[r]);
}

// ---------------------------------------------------------------------------
// 16 lanes a state, one state a warp, the internal rounds' sum by warp
// reduction: lanes 0..15 hold words 0..15 (lanes 16..31 run a state of their
// own that no sum reads), the linear layers go through shuffles as in
// permute_coop, and an internal round's sum over the 16 words is two
// REDUX instructions (the low and the high 16 bits of each word, summed over
// the warp) in place of four dependent shuffle stages. Every lane keeps a
// copy of word 0 through the internal rounds and computes its S-box itself,
// and the diagonal is one Montgomery product by its constant.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t permute_redux(uint32_t s, const Lane& l, int32_t diag) {
  const int warp_lane = static_cast<int>(threadIdx.x & 31);
  const bool summed = warp_lane != 0 && warp_lane < 16;  // words 1..15
  s = coop_linear(s, l.lane);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    s = coop_linear(static_cast<uint32_t>(sbox_rc(s, l.rc[r]) + static_cast<int32_t>(P)), l.lane);
  }
  uint32_t w0 = __shfl_sync(FULL, s, 0);
#pragma unroll
  for (int r = 4; r < 17; ++r) {
    const uint32_t x = summed ? s : 0u;
    const uint32_t lo = __reduce_add_sync(FULL, x & 0xffffu);
    const uint32_t hi = __reduce_add_sync(FULL, x >> 16);
    const uint32_t boxed =
        static_cast<uint32_t>(sbox_rc(w0, ZT_RC_BIAS[r][0]) + static_cast<int32_t>(P));
    const uint64_t t = (static_cast<uint64_t>(hi) << 16) + lo + boxed + 9 * P64;
    const uint32_t in = l.lane == 0 ? boxed : s;
    s = red(static_cast<uint64_t>(static_cast<int64_t>(t) +
                                  smont(static_cast<int32_t>(fix(in)), diag)));
    w0 = red(t - 2 * static_cast<uint64_t>(boxed));  // lane 0's s, up to p
  }
#pragma unroll
  for (int r = 4; r < 8; ++r) {
    s = coop_linear(static_cast<uint32_t>(sbox_rc(s, l.rc[r]) + static_cast<int32_t>(P)), l.lane);
  }
  return s;
}

// K3: the levels below h <= 256 digests over a cluster of B blocks (the
// plan is ops/kplans.py:k3_plan). Block b loads digests [b h/B, (b+1) h/B)
// and its rows [b hh/B, (b+1) hh/B) of each injected level hh >= B, and
// halves its level in shared memory (ping-pong buffers, one barrier a
// level) down to its subtree's root; each warp compresses one pair a level
// (permute_redux), and a level with injected digests takes a second
// permutation of (compressed || injected). The roots go into block 0's
// shared memory (distributed shared memory, one cluster barrier), and block
// 0 runs the last log2(B) levels with the injected levels below B.
// inj.p[k] points to the (2^k, 8) digests injected into the level of height
// 2^k, or is null. `out` receives the levels h/2, h/4, ..., 1 one after the
// other: the level of height hh at row h - 2 hh.
constexpr int LEVEL_WARPS = 16;                  // pairs on a block's top level
constexpr int LEVEL_THREADS = 32 * LEVEL_WARPS;
constexpr int LEVEL_SUB_MAX = 2 * LEVEL_WARPS;   // digests a block: 32
constexpr int CLUSTER_MAX = 8;
constexpr int INJ_LEVELS = 8;  // injected heights 1 .. 128
constexpr int INJ_ROWS_MAX = LEVEL_SUB_MAX / 2;
static_assert(CLUSTER_MAX * LEVEL_SUB_MAX == ZT_LEVEL_MAX, "K3's tallest level");

struct Injected {
  const int64_t* p[INJ_LEVELS];
};

// One level of `pairs` pairs: src holds 2 * pairs digests, dst and out
// receive `pairs`; inj (shared, Montgomery) holds `pairs` injected rows or
// is null. A warp with no pair returns at once.
__device__ __forceinline__ void warp_level(const uint32_t* src, uint32_t* dst, int pairs,
                                           const uint32_t* inj, int64_t* __restrict__ out,
                                           const Lane& l, int32_t diag) {
  const int w = static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31);
  if (w >= pairs) return;
  uint32_t s = lane < 16 ? src[16 * w + lane] : 0u;
  s = permute_redux(s, l, diag);
  if (inj) {
    if (lane >= 8 && lane < 16) s = inj[8 * w + lane - 8];
    s = permute_redux(s, l, diag);
  }
  if (lane < 8) {
    dst[8 * w + lane] = s;
    out[8 * w + lane] = from_mont(s);
  }
}

__global__ void __launch_bounds__(LEVEL_THREADS)
compress_levels_kernel(const int64_t* __restrict__ in, const Injected inj,
                       int64_t* __restrict__ out, int h) {
  __shared__ uint32_t buf[2][LEVEL_SUB_MAX * 8];
  __shared__ uint32_t injs[INJ_LEVELS][INJ_ROWS_MAX * 8];
  __shared__ uint32_t roots[2][CLUSTER_MAX * 8];
  const int nb = static_cast<int>(gridDim.x);  // B, the cluster
  const int b = static_cast<int>(blockIdx.x);
  const int sub = h / nb;
  const int tid = threadIdx.x;
  const Lane l = make_lane(tid & 15);
  const int32_t diag = ZT_DIAG_MONT[tid & 15];
  for (int i = tid; i < sub * 8; i += LEVEL_THREADS) buf[0][i] = to_mont(in[b * sub * 8 + i]);
  unsigned int has = 0;  // bit k: the level of height 2^k has injected digests
#pragma unroll
  for (int k = 0; k < INJ_LEVELS; ++k) {
    const int hh = 1 << k;
    const int64_t* src = inj.p[k];
    int rows = 0;
    if (src && hh >= nb) {
      rows = hh / nb;
      src += b * rows * 8;
    } else if (src && b == 0) {
      rows = hh;
    }
    if (src) has |= 1u << k;
    for (int i = tid; i < rows * 8; i += LEVEL_THREADS) injs[k][i] = to_mont(src[i]);
  }
  __syncthreads();
  int cur = 0;
  for (int lh = sub >> 1; lh >= 1; lh >>= 1) {
    const int hh = lh * nb;
    const int k = __ffs(hh) - 1;
    warp_level(buf[cur], buf[cur ^ 1], lh, (has >> k) & 1u ? injs[k] : nullptr,
               out + static_cast<int64_t>(h - 2 * hh + b * lh) * 8, l, diag);
    __syncthreads();
    cur ^= 1;
  }
  if (nb == 1) return;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  uint32_t* dst = cluster.map_shared_rank(&roots[0][0], 0);
  if (tid < 8) dst[8 * b + tid] = buf[cur][tid];
  cluster.sync();
  if (b != 0) return;
  cur = 0;
  for (int hh = nb >> 1; hh >= 1; hh >>= 1) {
    const int k = __ffs(hh) - 1;
    warp_level(roots[cur], roots[cur ^ 1], hh, (has >> k) & 1u ? injs[k] : nullptr,
               out + static_cast<int64_t>(h - 2 * hh) * 8, l, diag);
    __syncthreads();
    cur ^= 1;
  }
}

// K4: the ordered search (ops/kplans.py:k4_plan). scratch[0] is the best
// witness, scratch[GRIND_COUNTER] the claim counter, a cache line apart so
// that a read of the best waits for no queue of atomics on the counter; the
// wrapper fills the scratch with p on the launch's stream, and the counter
// counts claims from p. The first chunks are claimed by position: warp g of
// the grid takes [g chunk, (g + 1) chunk), so the first wave waits for no
// atomic and reads no best; every later chunk is claimed with one
// atomicAdd, issued one chunk ahead so that its latency hides behind the
// permutations. After each chunk a warp reads the best witness (before it
// issues the next atomic, which would hold the read up) and stops if no
// claimed chunk can lie below it (it is at most the first claimed start) or
// its next chunk starts at or above it; else each lane tests its candidates
// of the chunk (lane, lane + 32, ...) below it, and a hit lowers it with
// atomicMin. A lane also drops a candidate between its rounds once the best
// is at or below it: the warps that finish a wave just before the witness's
// warp do not run a whole second wave. Claims go out in increasing order, so
// every candidate below the final best lies in a claimed chunk and was
// tested: the final best is the smallest witness.
//
// A candidate w enters the state as word n_in. The initial linear layer is
// linear, so each thread applies it once to the 15 fixed words (w = 0) and
// a candidate adds w times column n_in of M_E; of the last M_E only word 7,
// the sample, is computed.

constexpr int GRIND_COUNTER = 16;  // ops/kplans.py:K4_COUNTER

// M_E's entry (j, n): M4[j % 4][n % 4], twice within the diagonal block;
// M4 row r is (2, 3, 1, 1) turned right r times.
__device__ __forceinline__ uint32_t me_entry(int j, int n) {
  const int d = (n - j) & 3;
  const uint32_t m4 = d == 0 ? 2u : d == 1 ? 3u : 1u;
  return (j >> 2) == (n >> 2) ? 2u * m4 : m4;
}

// Word 7 of M_E over the S-boxes of the last round, signed in (-p, p):
// M4 row 3 (3, 1, 1, 2) of block 1 plus the sum of the four blocks, offset 5p.
__device__ __forceinline__ uint32_t external_word7(const int32_t x[16]) {
  int64_t y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    y[k] = static_cast<int64_t>(5 * P64) + x[k] + x[k + 4] + x[k + 8] + x[k + 12] + x[4 + k];
  }
  return red(static_cast<uint64_t>(3 * y[0] + y[1] + y[2] + 2 * y[3]));
}

__global__ void __launch_bounds__(THREADS)
grind_kernel(const int64_t* __restrict__ state, const int64_t* __restrict__ inputs,
             int n_in, uint32_t mask, unsigned long long* scratch, unsigned int chunk) {
  uint32_t fixed[16], col[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) col[j] = me_entry(j, n_in);
  {
    uint32_t x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      x[i] = i == n_in ? 0u : to_mont(i < n_in ? inputs[i] : state[i]);
    }
    external_linear<uint32_t>(x, fixed, 0);
  }
  volatile unsigned long long* best = scratch;
  const int lane = threadIdx.x & 31;
  const unsigned long long warps = static_cast<unsigned long long>(gridDim.x) * (THREADS / 32);
  const unsigned long long first = warps * chunk;  // the chunks claimed by position
  unsigned long long start = (blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5)) *
                             static_cast<unsigned long long>(chunk);
  unsigned long long* counter = scratch + GRIND_COUNTER;
  unsigned long long next = 0, claim = 0, below = P64;
  if (lane == 0) next = atomicAdd(counter, static_cast<unsigned long long>(chunk));
  for (;;) {
    if (start >= below) return;  // best <= p: every candidate tested is below p
    for (unsigned long long w = start + lane; w < start + chunk && w < below; w += 32) {
      // a candidate at or above a witness found meanwhile is dropped between
      // its rounds; each read of the best is issued a stretch of rounds
      // before its test, so that its latency hides behind them
      unsigned long long seen = *best;
      const uint64_t wm = to_mont(static_cast<int64_t>(w));
      uint32_t s[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) s[j] = red(fixed[j] + static_cast<uint64_t>(col[j]) * wm);
      ZT_ROUNDS
      for (int r = 0; r < 4; ++r) external_round(s, r);
      if (w >= seen) break;
      seen = *best;
      ZT_ROUNDS
      for (int r = 4; r < 17; ++r) internal_round(s, r);
      if (w >= seen) break;
      ZT_ROUNDS
      for (int r = 17; r < 20; ++r) external_round(s, r);
      int32_t x[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = sbox_rc(s[i], ZT_RC_BIAS[20][i]);
      if ((static_cast<uint32_t>(from_mont(external_word7(x))) & mask) == 0u) {
        atomicMin(scratch, w);
        break;
      }
    }
    // the best first, then the claim ahead: the read waits for no atomic
    if (lane == 0) {
      below = *best;
      if (below > first) {
        claim = next;
        next = atomicAdd(counter, static_cast<unsigned long long>(chunk));
      }
    }
    below = __shfl_sync(FULL, below, 0);
    if (below <= first) return;  // every claimed chunk starts at first or above
    start = __shfl_sync(FULL, claim, 0) - P64 + first;
  }
}

// K4 for a few bits (ops/kplans.py:K4_STRIDE_MAX_BITS), PR 5's form: one
// thread a candidate, a grid-stride loop over w = 0, 1, ... below p. A
// thread builds [inputs, w, state past n_in] in Montgomery form, permutes
// it, and tests the low bits of the canonical word 7. On a hit it lowers
// *best with atomicMin and stops; it also stops at its first candidate
// above *best, so every candidate below the final *best was tested. Where
// a few blocks' first candidates hold the witness it is the faster form:
// it spends nothing on the fixed words' layer, on claims or on reads of
// the best between rounds.
__global__ void __launch_bounds__(THREADS)
grind_stride_kernel(const int64_t* __restrict__ state, const int64_t* __restrict__ inputs,
                    int n_in, uint32_t mask, unsigned long long* best) {
  uint32_t base[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) base[i] = to_mont(i < n_in ? inputs[i] : state[i]);
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * THREADS;
  for (unsigned long long w = static_cast<unsigned long long>(blockIdx.x) * THREADS + threadIdx.x;
       w < P64; w += stride) {
    if (w > *reinterpret_cast<volatile unsigned long long*>(best)) return;
    uint32_t s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = i == n_in ? to_mont(static_cast<int64_t>(w)) : base[i];
    permute16(s);
    if ((static_cast<uint32_t>(from_mont(s[7])) & mask) == 0u) {
      atomicMin(best, w);
      return;
    }
  }
}

// The latency of one permutation in each form: one warp runs `n` dependent
// permutations, lane 0 times them with clock64. form 0: one thread a state
// (permute16); 1: 4 lanes a state (permute_quad); 2: 16 lanes a state with
// shuffles (permute_coop, K2's for small m); 3: 16 lanes a state with warp
// reductions (permute_redux, K3's). out[lane] keeps the result live.
__global__ void __launch_bounds__(32)
permute_latency_kernel(int form, int n, long long* cycles, int64_t* out) {
  const int lane = threadIdx.x;
  uint32_t s[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = static_cast<uint32_t>(lane * 16 + i + 1);
  const Quad q = make_quad(lane & 3);
  const Lane c = make_lane(lane & 15);
  const int32_t diag = ZT_DIAG_MONT[lane & 15];
  __syncwarp();
  const long long t0 = clock64();
  if (form == 0) {
    for (int i = 0; i < n; ++i) permute16(s);
  } else if (form == 1) {
    for (int i = 0; i < n; ++i) permute_quad(s, q);
  } else if (form == 2) {
    for (int i = 0; i < n; ++i) s[0] = permute_coop(s[0], c);
  } else {
    for (int i = 0; i < n; ++i) s[0] = permute_redux(s[0], c, diag);
  }
  const long long t1 = clock64();
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc += s[i];
  out[lane] = from_mont(acc);
  if (lane == 0) *cycles = t1 - t0;
}

unsigned int grid_for(long long threads) {
  return static_cast<unsigned int>((threads + THREADS - 1) / THREADS);
}

}  // namespace

// Every entry point launches on `stream`, does not synchronise, and returns
// the cudaGetLastError() code of the launch (0 on success).
extern "C" int zt_hash_rows(const void* in, void* out, long long n,
                            long long w, void* stream) {
  if (n <= 0) return 0;
  hash_rows_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out), n, w);
  return static_cast<int>(cudaGetLastError());
}

// The two variants of K2 by name, for holding one against the other; the
// prover calls zt_permute.
extern "C" int zt_permute_lanes(const void* in, void* out, long long m, void* stream) {
  if (m <= 0) return 0;
  permute_coop_kernel<<<grid_for(16 * m), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zt_permute_thread(const void* in, void* out, long long m, void* stream) {
  if (m <= 0) return 0;
  permute_kernel<<<grid_for(m), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

// 16 lanes a state up to ZT_PERMUTE_LANES_MAX states, one thread a state
// above. (Measured on an H100: the 16-lane variant wins up to 8,192 states
// and loses from 16,384.)
extern "C" int zt_permute(const void* in, void* out, long long m, void* stream) {
  return m <= ZT_PERMUTE_LANES_MAX ? zt_permute_lanes(in, out, m, stream)
                                   : zt_permute_thread(in, out, m, stream);
}

// h a power of two, 2 <= h <= ZT_LEVEL_MAX, over `blocks` blocks of one
// cluster (ops/kplans.py:k3_plan chooses them): a power of two up to 8 with
// 2 * blocks <= h and h / blocks <= 32; returns -1 for any other h or
// blocks. `inj` is a host array of INJ_LEVELS device pointers: inj[k] the
// digests injected at height 2^k, or null. A cluster launch that is refused
// returns its error; nothing takes another path.
extern "C" int zt_compress_levels(const void* in, const void* const* inj, void* out,
                                  int h, int blocks, void* stream) {
  if (h < 2 || h > ZT_LEVEL_MAX || (h & (h - 1))) return -1;
  if (blocks < 1 || blocks > CLUSTER_MAX || (blocks & (blocks - 1)) || 2 * blocks > h ||
      h / blocks > LEVEL_SUB_MAX) {
    return -1;
  }
  Injected levels;
  for (int k = 0; k < INJ_LEVELS; ++k) levels.p[k] = static_cast<const int64_t*>(inj[k]);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks));
  cfg.blockDim = dim3(LEVEL_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, compress_levels_kernel,
                                             static_cast<const int64_t*>(in), levels,
                                             static_cast<int64_t*>(out), h);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4's occupancy on the current device: the blocks a multiprocessor holds
// at once (the occupancy calculator) and the multiprocessors.
extern "C" int zt_grind_occupancy(int* per_sm, int* sms) {
  int dev = 0;
  *per_sm = 0;
  *sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, grind_kernel, THREADS, 0);
  }
  return static_cast<int>(err);
}

// state: 16 canonical words; inputs: n_in < 8 canonical words (may be null
// for n_in = 0); scratch: GRIND_COUNTER + 1 int64 words or more, all p, the
// smallest witness in scratch[0] on return; grid, chunk and the form from
// ops/kplans.py:k4_plan: ordered (grind_kernel, chunk a multiple of 32) or
// not (grind_stride_kernel, chunk unused). Returns -1 for an argument out of
// range.
extern "C" int zt_grind(const void* state, const void* inputs, int n_in, int nb_bits,
                        void* scratch, int grid, int chunk, int ordered, void* stream) {
  if (n_in < 0 || n_in >= 8 || nb_bits < 0 || nb_bits > 31 || grid < 1 ||
      (ordered && (chunk < 32 || chunk % 32))) {
    return -1;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t mask = static_cast<uint32_t>((1ull << nb_bits) - 1ull);
  if (ordered) {
    grind_kernel<<<static_cast<unsigned int>(grid), THREADS, 0, st>>>(
        static_cast<const int64_t*>(state), static_cast<const int64_t*>(inputs), n_in, mask,
        static_cast<unsigned long long*>(scratch), static_cast<unsigned int>(chunk));
  } else {
    grind_stride_kernel<<<static_cast<unsigned int>(grid), THREADS, 0, st>>>(
        static_cast<const int64_t*>(state), static_cast<const int64_t*>(inputs), n_in, mask,
        static_cast<unsigned long long*>(scratch));
  }
  return static_cast<int>(cudaGetLastError());
}

// The chain of `n` permutations of permute_latency_kernel in `form` (0 to
// 3): its clock64 cycles in cycles[0]; out receives 32 words.
extern "C" int zt_permute_latency(int form, int n, void* cycles, void* out, void* stream) {
  if (form < 0 || form > 3 || n < 0) return -1;
  permute_latency_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      form, n, static_cast<long long*>(cycles), static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
