// Device helpers shared by the back-projection kernels of this directory
// (backproject_subline.cu: the tiled K1/K2 and the banded K5/K6;
// backproject_onehot.cu: K3/K4). The per-line scalars are computed in the order of the plain
// PyTorch versions with round-to-nearest intrinsics, so FMA contraction
// cannot move floor(x), floor(y) or the validity masks across an edge
// relative to them.

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

__device__ __forceinline__ float interp_rn(const float* row, float y,
                                           float ylast) {
  const float y0 = floorf(y);
  if (!(y0 >= 0.0f && y0 <= ylast)) return 0.0f;
  const int iy = (int)y0;
  const float dy = y - y0;
  return __fmaf_rn(row[iy], 1.0f - dy, __fmul_rn(row[iy + 1], dy));
}

__device__ __forceinline__ float accumulate_rn(float acc, float v, float w) {
  return __fmaf_rn(v, w, acc);
}

}  // namespace bp
