// Device helpers of the back-projection kernels in backproject_subline.cu
// (the tiled K1-K4 and the banded K5/K6). The per-line scalars are
// computed in the order of the plain PyTorch versions with round-to-nearest
// intrinsics, so FMA contraction cannot move floor(x), floor(y) or the
// validity masks across an edge relative to them.

#pragma once

#include <cuda_runtime.h>

namespace bp {

constexpr int kLines = 8;                 // voxel lines per block
constexpr int kWarp = 32;
constexpr int kThreads = kLines * kWarp;  // one warp per line

// Floats of the staged matrices at the head of shared memory, rounded up
// to a multiple of 4 so the buffers after them stay 16-byte aligned.
__host__ __device__ inline int mat_floats(int stage) {
  return (stage * 12 + 3) & ~3;
}

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

// Linear interpolation inside one sub-line at row coordinate y; 0 when
// floor(y) falls outside [0, nh-2].
__device__ __forceinline__ float interp(const float* row, float y,
                                        float ylast) {
  const float y0 = floorf(y);
  if (!(y0 >= 0.0f && y0 <= ylast)) return 0.0f;
  const int iy = (int)y0;
  const float dy = y - y0;
  return row[iy] * (1.0f - dy) + row[iy + 1] * dy;
}

// Stage 1 (Fig. 3a) for one warp: blend detector columns c0 and c0 + nh
// (nh contiguous floats each, read coalesced) into the sub-line row.
__device__ __forceinline__ void blend_columns(const float* __restrict__ c0,
                                              float dx, int nh, int lane,
                                              float* row) {
  const float* c1 = c0 + nh;
  const float wx = 1.0f - dx;
#pragma unroll 4
  for (int y = lane; y < nh; y += kWarp)
    row[y] = __ldg(c0 + y) * wx + __ldg(c1 + y) * dx;
}

// The roundings that blend_columns, interp and the accumulation
// `acc += interp(...) * w` get in the banded kernel, where nvcc contracts
// each into one FMA fusing the first product (found on the card: nvcc
// fused the other product of the same blend expression in the tiled
// K1/K2's batched stage 1). Written out with intrinsics, so a kernel
// built around them gives the banded kernel's bits wherever it is.
__device__ __forceinline__ float blend_rn(float v0, float v1, float dx) {
  return __fmaf_rn(v0, 1.0f - dx, __fmul_rn(v1, dx));
}

// Stage 2 of the tiled kernel at row coordinate y, in two forms that read
// the same two rows under the same range rule. interp_rn is K1/K2's linear
// interpolation. twohot_rn is K3/K4's two-hot contraction
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
