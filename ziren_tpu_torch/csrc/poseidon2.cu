// Poseidon2-KoalaBear-16 on Hopper (sm_90a): the leaf-hash sponge and the
// bare permutation, with a plain C interface loaded through ctypes by
// ziren_tpu_torch/kernels.py.
//
// K1 zt_hash_rows replaces the Pallas TPU kernel hash_rows_pallas
// (ziren_tpu/ops/jposeidon2.py:235): the padding-free sponge over each row
// of an (n, w) matrix, rate 8, squeezing 8 words. It feeds every Merkle
// commit of the prover (main, permutation and quotient traces, the
// preprocessed traces and every FRI layer).
// K2 zt_permute runs the same permutation on (m, 16) states. It takes the
// place of the XLA-lowered jposeidon2.permute (:97) behind compress_pairs,
// the Merkle level compressions, the challenger duplex and the PoW grind.
//
// What bounds it: integer multiplies. One permutation is 490 Montgomery
// products (8 external rounds x 16 S-boxes x 2, 13 internal rounds x
// (2 + 16 diagonal terms)), each about four 32-bit multiply instructions,
// and a row of width w takes ceil(w / 8) permutations; the row's bytes are
// read once. Design: one thread per row (K1) or per state (K2); the 16-word
// state stays in registers, every round is unrolled so the round constants
// are constant-bank operands, and arithmetic is Montgomery form (R = 2^32)
// with __umulhi, entered and left once per absorbed word. Row-major loads
// are strided across the threads of a warp; staging tiles through shared
// memory for coalesced loads is left for later work.
//
// Tensors are canonical int64 in [0, p) on both sides.

#include <cstdint>
#include <cuda_runtime.h>

#include "poseidon2_constants.h"  // ZT_RC_MONT[30][16], ZT_DIAG_MONT[16]

namespace {

constexpr uint32_t P = 2130706433u;   // 2^31 - 2^24 + 1
constexpr uint32_t MU = 2130706431u;  // -p^-1 mod 2^32
constexpr uint32_t R2 = 402124772u;   // 2^64 mod p
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  const uint64_t prod = static_cast<uint64_t>(a) * b;
  const uint32_t lo = static_cast<uint32_t>(prod);
  const uint32_t hi = static_cast<uint32_t>(prod >> 32);
  const uint32_t m = lo * MU;
  const uint32_t t = hi + __umulhi(m, P) + (lo != 0u);  // < 2p < 2^32
  return t >= P ? t - P : t;
}

__device__ __forceinline__ uint32_t madd(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t to_mont(int64_t x) {
  return mont_mul(static_cast<uint32_t>(x), R2);
}

__device__ __forceinline__ int64_t from_mont(uint32_t x) {
  return static_cast<int64_t>(mont_mul(x, 1u));
}

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  return mont_mul(mont_mul(x, x), x);
}

// M_E: the M4 circulant [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] on each
// block of four, then each position adds the sum of that position over the
// four blocks.
__device__ __forceinline__ void external_linear_layer(uint32_t s[16]) {
#pragma unroll
  for (int j = 0; j < 16; j += 4) {
    const uint32_t x0 = s[j], x1 = s[j + 1], x2 = s[j + 2], x3 = s[j + 3];
    const uint32_t t01 = madd(x0, x1);
    const uint32_t t23 = madd(x2, x3);
    const uint32_t t0123 = madd(t01, t23);
    const uint32_t t01123 = madd(t0123, x1);
    const uint32_t t01233 = madd(t0123, x3);
    s[j + 0] = madd(t01123, t01);
    s[j + 1] = madd(t01123, madd(x2, x2));
    s[j + 2] = madd(t01233, t23);
    s[j + 3] = madd(t01233, madd(x0, x0));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t sum = madd(madd(s[k], s[k + 4]), madd(s[k + 8], s[k + 12]));
    s[k] = madd(s[k], sum);
    s[k + 4] = madd(s[k + 4], sum);
    s[k + 8] = madd(s[k + 8], sum);
    s[k + 12] = madd(s[k + 12], sum);
  }
}

__device__ __forceinline__ void external_round(uint32_t s[16], int r) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = sbox(madd(s[i], ZT_RC_MONT[r][i]));
  external_linear_layer(s);
}

// Rounds: the initial linear layer, 4 external, 13 internal (S-box on word
// 0, then s_i <- diag_i * s_i + sum(s)), 4 external.
__device__ __forceinline__ void permute16(uint32_t s[16]) {
  external_linear_layer(s);
#pragma unroll
  for (int r = 0; r < 4; ++r) external_round(s, r);
#pragma unroll
  for (int r = 4; r < 17; ++r) {
    s[0] = sbox(madd(s[0], ZT_RC_MONT[r][0]));
    uint32_t total = s[0];
#pragma unroll
    for (int i = 1; i < 16; ++i) total = madd(total, s[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = madd(mont_mul(s[i], ZT_DIAG_MONT[i]), total);
  }
#pragma unroll
  for (int r = 17; r < 21; ++r) external_round(s, r);
}

// K1: one thread per row. Each chunk of up to 8 words overwrites the state
// prefix and is followed by a permutation (a partial last chunk keeps the
// state words past its end). A row of width 0 hashes to zeros.
__global__ void __launch_bounds__(THREADS)
hash_rows_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                 int64_t n, int64_t w) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= n) return;
  const int64_t* src = in + row * w;
  uint32_t s[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0u;
  for (int64_t c = 0; c < w; c += 8) {
    const int64_t take = w - c < 8 ? w - c : 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < take) s[i] = to_mont(src[c + i]);
    }
    permute16(s);
  }
  int64_t* dst = out + row * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = from_mont(s[i]);
}

// K2: one thread per 16-word state.
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

unsigned int grid_for(long long rows) {
  return static_cast<unsigned int>((rows + THREADS - 1) / THREADS);
}

}  // namespace

// Both entry points launch on `stream`, do not synchronise, and return the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int zt_hash_rows(const void* in, void* out, long long n,
                            long long w, void* stream) {
  if (n <= 0) return 0;
  hash_rows_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out), n, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zt_permute(const void* in, void* out, long long m, void* stream) {
  if (m <= 0) return 0;
  permute_kernel<<<grid_for(m), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}
