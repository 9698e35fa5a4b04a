// Device helpers of the tiled back-projection kernel in
// backproject_subline.cu (K1-K6). The per-line scalars are computed in the
// order of the plain PyTorch versions with round-to-nearest intrinsics, so
// FMA contraction cannot move floor(x), floor(y) or the validity masks
// across an edge relative to them.

#pragma once

#include <cuda_runtime.h>

namespace bp {

constexpr int kWarp = 32;

// n / d for a divisor d fixed at launch, by a multiply-high and a shift
// (Granlund and Montgomery) instead of the some 25 instructions of an
// integer division: exact for 0 <= n < 2^31 and 1 <= d < 2^31.
struct FastDiv {
  unsigned mul, shift;
  FastDiv() = default;
  explicit FastDiv(int d) : mul(1), shift(0) {
    while ((1ull << shift) < (unsigned long long)d) ++shift;
    mul = (unsigned)(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((unsigned)n, mul) + (unsigned)n) >> shift);
  }
};

// k-invariant scalars of one voxel line for one projection (O2). Returns
// whether the line is valid (z > 0 and 0 <= floor(x) <= nw-2).
__device__ __forceinline__ bool line_scalars(const float* m, float fi, float fj,
                                             int nw, float& f, int& ixc,
                                             float& dx) {
  const float z = __fadd_rn(__fadd_rn(__fmul_rn(m[8], fi), __fmul_rn(m[9], fj)),
                            m[11]);
  f = __fdiv_rn(1.0f, z);
  const float x = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(m[0], fi), __fmul_rn(m[1], fj)), m[3]), f);
  const float x0 = floorf(x);
  dx = __fsub_rn(x, x0);
  const bool ok = (z > 0.0f) && (x0 >= 0.0f) && (x0 <= (float)(nw - 2));
  ixc = ok ? (int)x0 : 0;
  return ok;
}

// The y-affine coefficients of a valid line: y(k) = a + bk * k, and the
// line's weight w = f^2.
__device__ __forceinline__ void y_affine(const float* m, float fi, float fj,
                                         float f, float& a, float& bk,
                                         float& w) {
  w = __fmul_rn(f, f);
  a = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(m[4], fi), __fmul_rn(m[5], fj)), m[7]), f);
  bk = __fmul_rn(m[6], f);
}

// The roundings of the blend of two detector columns, written out with
// intrinsics: nvcc may contract the same expression into an FMA
// differently in two kernels or instances (found on the card), so every
// instance that must give the same bits takes these.
__device__ __forceinline__ float blend_rn(float v0, float v1, float dx) {
  return __fmaf_rn(v0, 1.0f - dx, __fmul_rn(v1, dx));
}

// Stage 2 of the tiled kernel at row coordinate y, in two forms that read
// the same two rows under the same range rule. interp_rn is the linear
// interpolation (K1/K2, K5/K6). twohot_rn is K3/K4's two-hot contraction
// sum_n A[n] * row[n] (A zero but for 1 - dy at iy and dy at iy + 1) with
// its zero terms dropped: in the dense sum taken in row order, the first
// nonzero term is fma(1 - dy, row[iy], 0), the second fma(dy, row[iy+1], v),
// and a term 0 * row[n] leaves a finite partial sum as it is, so the two
// agree bit for bit on finite rows, up to the sign of a zero sum. (A
// non-finite row value the dense form spreads to every plane, 0 * inf =
// NaN; this form, like the oracle, keeps it to the planes that sample it.)
// Each returns 0 when floor(y) misses [0, nh-2], NaN included, so a row
// index is never taken from such a y; the *_inside forms are for samples
// known to lie on the detector: the same bits without the check.
__device__ __forceinline__ float interp_inside(const float* row, float y) {
  const float y0 = floorf(y);
  const int iy = (int)y0;
  const float dy = y - y0;
  return __fmaf_rn(row[iy], 1.0f - dy, __fmul_rn(row[iy + 1], dy));
}

__device__ __forceinline__ float twohot_inside(const float* row, float y) {
  const float y0 = floorf(y);
  const int iy = (int)y0;
  const float dy = y - y0;
  return __fmaf_rn(dy, row[iy + 1], __fmul_rn(1.0f - dy, row[iy]));
}

__device__ __forceinline__ float interp_rn(const float* row, float y,
                                           float ylast) {
  const float y0 = floorf(y);
  if (!(y0 >= 0.0f && y0 <= ylast)) return 0.0f;
  const int iy = (int)y0;
  const float dy = y - y0;
  return __fmaf_rn(row[iy], 1.0f - dy, __fmul_rn(row[iy + 1], dy));
}

__device__ __forceinline__ float twohot_rn(const float* row, float y,
                                           float ylast) {
  const float y0 = floorf(y);
  if (!(y0 >= 0.0f && y0 <= ylast)) return 0.0f;
  const int iy = (int)y0;
  const float dy = y - y0;
  return __fmaf_rn(dy, row[iy + 1], __fmul_rn(1.0f - dy, row[iy]));
}

__device__ __forceinline__ float accumulate_rn(float acc, float v, float w) {
  return __fmaf_rn(v, w, acc);
}

}  // namespace bp
