// F1: the ray-driven cone-beam forward projector for Hopper (sm_90a).
// It has no Pallas counterpart: it replaces the XLA program of the JAX
// package's src/repro/core/forward.py, _project_views (l.97), a
// jit(vmap(scan)) over the views of a chunk and the march steps of
// _project_view_impl. ../forward_project.py wraps it.
//
// Inputs, all float32 and contiguous:
//   vol         (nz, ny, nx)   the volume, x fastest
//   src, org, ust, vst (k, 3)  per view: source, detector origin, and the
//                              world steps of one pixel along U and V
//   vol_origin, inv_pitch (3)  world position of voxel (0, 0, 0) and the
//                              inverse voxel pitch, per axis
// Output:
//   out         (k, nh, nw)    the line integrals, written exactly once
//
// What bounds it on an H100. A valid sample (one inside the volume's box)
// costs 50 float32 operations (the step position, the world point, the
// fractional index and its floor, seven linear blends, the add), so the
// function is bound by operations: what this run's rays need is counted
// from their chords through the box (chip_smoke.py, phase [solve]). The
// compulsory bytes are the volume read once and the images written once
// (0.3 ms at P5); the eight gathers of a sample hit L1 and L2, since
// neighbouring rays of a block sample neighbouring voxels.
//
// The design: one thread per detector pixel of one view, blocks of 16 x 16
// pixels, a grid of (ceil(nw/16), ceil(nh/16), k). Each thread sets up its
// ray as the plain version does (pixel position from the view's frame, the
// unit direction from the source), marches every step t_s = t_near +
// (s + 0.5) * step of the sphere around the volume, samples trilinearly
// with the plain version's rule (floor of each fractional index in
// [0, n-2], else zero), adds the samples in step order in a register and
// multiplies by step once at the end. Every rounding of the plain version
// (torch ops, one rounding each; numpy's float32 step times) is written out
// with _rn intrinsics, so nvcc contracts nothing into an FMA that the plain
// version rounds twice. Steps outside the volume's box are marched too
// (skipping them is a follow-up).

#include <cuda_runtime.h>

namespace fp {

constexpr int kBu = 16;  // pixels of a block along U (threadIdx.x)
constexpr int kBv = 16;  // pixels of a block along V (threadIdx.y)

// a * (1 - w) + b * w, each operation rounded on its own.
__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(b, w));
}

// The fractional voxel index of world coordinate p along one axis.
__device__ __forceinline__ float frac_index(float s, float d, float t,
                                            float origin, float inv) {
  return __fmul_rn(__fsub_rn(__fadd_rn(s, __fmul_rn(d, t)), origin), inv);
}

__global__ void __launch_bounds__(kBu * kBv)
march_kernel(const float* __restrict__ vol, const float* __restrict__ src,
             const float* __restrict__ org, const float* __restrict__ ust,
             const float* __restrict__ vst,
             const float* __restrict__ vol_origin,
             const float* __restrict__ inv_pitch, float* __restrict__ out,
             int nh, int nw, int nx, int ny, int nz, int n_steps, float step,
             float t_near) {
  const int u = blockIdx.x * kBu + threadIdx.x;
  const int v = blockIdx.y * kBv + threadIdx.y;
  const int view = blockIdx.z;
  if (u >= nw || v >= nh) return;
  const float fu = (float)u;
  const float fv = (float)v;
  const int f = 3 * view;
  float s[3], d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // pixel = org + u * ustep + v * vstep; direction = pixel - source
    const float p = __fadd_rn(
        __fadd_rn(__ldg(org + f + c), __fmul_rn(fu, __ldg(ust + f + c))),
        __fmul_rn(fv, __ldg(vst + f + c)));
    s[c] = __ldg(src + f + c);
    d[c] = __fsub_rn(p, s[c]);
  }
  const float norm = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
      __fmul_rn(d[2], d[2])));
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = __fdiv_rn(d[c], norm);
  const float ox = __ldg(vol_origin), oy = __ldg(vol_origin + 1),
              oz = __ldg(vol_origin + 2);
  const float ix = __ldg(inv_pitch), iy = __ldg(inv_pitch + 1),
              iz = __ldg(inv_pitch + 2);
  const float xmax = (float)(nx - 2), ymax = (float)(ny - 2),
              zmax = (float)(nz - 2);
  const long long row = nx;
  const long long plane = (long long)nx * ny;

  float acc = 0.0f;
  for (int i = 0; i < n_steps; ++i) {
    const float t = __fadd_rn(t_near, __fmul_rn(__fadd_rn((float)i, 0.5f),
                                                step));
    const float fx = frac_index(s[0], d[0], t, ox, ix);
    const float fy = frac_index(s[1], d[1], t, oy, iy);
    const float fz = frac_index(s[2], d[2], t, oz, iz);
    const float x0 = floorf(fx), y0 = floorf(fy), z0 = floorf(fz);
    // NaN fails every comparison: such a sample is zero, as in the plain
    // version
    if (x0 >= 0.0f && x0 <= xmax && y0 >= 0.0f && y0 <= ymax &&
        z0 >= 0.0f && z0 <= zmax) {
      const float wx = __fsub_rn(fx, x0);
      const float wy = __fsub_rn(fy, y0);
      const float wz = __fsub_rn(fz, z0);
      const float* p = vol + (long long)z0 * plane + (long long)y0 * row +
                       (long long)x0;
      const float c00 = lerp_rn(__ldg(p), __ldg(p + 1), wx);
      const float c01 = lerp_rn(__ldg(p + row), __ldg(p + row + 1), wx);
      const float c10 = lerp_rn(__ldg(p + plane), __ldg(p + plane + 1), wx);
      const float c11 = lerp_rn(__ldg(p + plane + row),
                                __ldg(p + plane + row + 1), wx);
      const float c0 = lerp_rn(c00, c01, wy);
      const float c1 = lerp_rn(c10, c11, wy);
      acc = __fadd_rn(acc, lerp_rn(c0, c1, wz));
    }
  }
  out[((long long)view * nh + v) * nw + u] = __fmul_rn(acc, step);
}

}  // namespace fp

extern "C" {

const char* fp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One launch over k views on `stream`; returns the launch's CUDA error
// (0 on success). The wrapper validates shapes; this refuses what the grid
// cannot hold.
int fp_launch(const float* vol, const float* src, const float* org,
              const float* ust, const float* vst, const float* vol_origin,
              const float* inv_pitch, float* out, int k, int nh, int nw,
              int nx, int ny, int nz, int n_steps, float step, float t_near,
              void* stream) {
  if (k < 1 || k > 65535 || nh < 1 || nw < 1 || nx < 1 || ny < 1 ||
      nz < 1 || n_steps < 0 || (nh + fp::kBv - 1) / fp::kBv > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(fp::kBu, fp::kBv);
  const dim3 grid((nw + fp::kBu - 1) / fp::kBu, (nh + fp::kBv - 1) / fp::kBv,
                  k);
  fp::march_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      vol, src, org, ust, vst, vol_origin, inv_pitch, out, nh, nw, nx, ny, nz,
      n_steps, step, t_near);
  return (int)cudaGetLastError();
}

}  // extern "C"
