// The running sum of the Global chip's trace on the host: the points
// (xs[i], ys[i]) added in order to a start point on the septic curve
// y^2 = x^3 + 3z*x - 3 over F_p[z]/(z^7 + 2z - 8), p = 2^31 - 2^24 + 1.
//
// The same formulas as machine/global_chip.py:_running_sums and
// core/septic.py:curve_add: affine chord addition, the inverse a^(r-1)/N(a)
// with r = (p^7 - 1)/(p - 1) through the Frobenius maps z -> z^p and
// z -> z^(p^2), whose matrices the caller passes in (core/septic.py's
// _FROB_MATS[1] and [2]). An inverse of 0 is 0, as there. Inputs are
// reduced mod p as they are read and every result is canonical, so the
// results are bit-equal to the Python form's. No state outside the call:
// callers run it on several threads at once.
//
// Built with g++ by core/septic_native.py into ziren_tpu_torch/_build/.

#include <cstdint>

namespace {

constexpr uint64_t P = 2130706433u;

inline uint64_t sub(uint64_t a, uint64_t b) { return a >= b ? a - b : a + P - b; }

// c = a * b, schoolbook, then z^7 = 8 - 2z for the degrees 12 down to 7
void smul(const uint64_t* a, const uint64_t* b, uint64_t* c) {
  uint64_t raw[13] = {0};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 7; ++j) raw[i + j] += a[i] * b[j] % P;  // < 7 * 2^31
  for (int k = 0; k < 13; ++k) raw[k] %= P;
  for (int k = 12; k >= 7; --k) {
    raw[k - 7] = (raw[k - 7] + 8 * raw[k]) % P;
    raw[k - 6] = sub(raw[k - 6], 2 * raw[k] % P);
  }
  for (int k = 0; k < 7; ++k) c[k] = raw[k];
}

// out_j = sum_i a_i * m[i][j]: row i of m is the image of z^i
void frobenius(const uint64_t* a, const uint64_t* m, uint64_t* out) {
  uint64_t acc[7] = {0};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 7; ++j) acc[j] += a[i] * m[7 * i + j] % P;
  for (int j = 0; j < 7; ++j) out[j] = acc[j] % P;
}

uint64_t pow_mod(uint64_t b, uint64_t e) {
  uint64_t r = 1;
  for (; e; e >>= 1, b = b * b % P)
    if (e & 1) r = r * b % P;
  return r;
}

void sinv(const uint64_t* a, const uint64_t* f1, const uint64_t* f2, uint64_t* out) {
  uint64_t t1[7], t2[7], base[7], base_p2[7], base_p4[7], pow_r_1[7], norm[7];
  frobenius(a, f1, t1);
  frobenius(a, f2, t2);
  smul(t1, t2, base);
  frobenius(base, f2, base_p2);
  frobenius(base_p2, f2, base_p4);
  smul(base_p4, base_p2, t1);
  smul(t1, base, pow_r_1);
  smul(pow_r_1, a, norm);  // in F_p: coefficients 1..6 are 0
  uint64_t norm_inv = pow_mod(norm[0], P - 2);  // 0 for 0
  for (int k = 0; k < 7; ++k) out[k] = pow_r_1[k] * norm_inv % P;
}

}  // namespace

// start: 14 words (x then y); xs, ys: (n, 7); frob: (2, 7, 7), the maps of
// p and p^2; slopes: (n, 7) out; sums: (n, 14) out, x then y.
extern "C" void zt_septic_running_sums(const uint32_t* start, const uint32_t* xs,
                                       const uint32_t* ys, uint64_t n,
                                       const uint32_t* frob, uint32_t* slopes,
                                       uint32_t* sums) {
  uint64_t f1[49], f2[49];
  for (int i = 0; i < 49; ++i) {
    f1[i] = frob[i];
    f2[i] = frob[49 + i];
  }
  uint64_t x1[7], y1[7];
  for (int k = 0; k < 7; ++k) {
    x1[k] = start[k] % P;
    y1[k] = start[7 + k] % P;
  }
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t x2[7], y2[7], dx[7], dy[7], inv[7], slope[7], sq[7], x3[7], t[7], y3[7];
    for (int k = 0; k < 7; ++k) {
      x2[k] = xs[7 * i + k] % P;
      y2[k] = ys[7 * i + k] % P;
      dx[k] = sub(x2[k], x1[k]);
      dy[k] = sub(y2[k], y1[k]);
    }
    sinv(dx, f1, f2, inv);
    smul(dy, inv, slope);
    smul(slope, slope, sq);
    for (int k = 0; k < 7; ++k) x3[k] = sub(sub(sq[k], x1[k]), x2[k]);
    for (int k = 0; k < 7; ++k) t[k] = sub(x1[k], x3[k]);
    smul(slope, t, y3);
    for (int k = 0; k < 7; ++k) y3[k] = sub(y3[k], y1[k]);
    for (int k = 0; k < 7; ++k) {
      slopes[7 * i + k] = (uint32_t)slope[k];
      sums[14 * i + k] = (uint32_t)x3[k];
      sums[14 * i + 7 + k] = (uint32_t)y3[k];
      x1[k] = x3[k];
      y1[k] = y3[k];
    }
  }
}
