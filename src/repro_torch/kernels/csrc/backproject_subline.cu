// Sub-line cone-beam back-projection for Hopper (sm_90a): the paper's
// Algorithm 1 (hoisting O2, O3 mirror, sub-line buffer O4, nb staging O5).
// Replaces the Pallas kernels backproject_subline_pallas (K1) and
// backproject_subline_fused (K2) of src/repro/kernels/backproject_subline.py;
// ../backproject_subline.py wraps it and says what bounds it on an H100.
//
// Inputs, all float32 and contiguous:
//   img_t (n_proj, nw, nh)  filtered projections, detector columns contiguous
//   mat   (n_proj, 3, 4)    index-space projection matrices
// Output:
//   out   (ni, nj, nz)      vol_t[i][j][k], written exactly once
//
// Work split. A block of 8 warps owns 8 consecutive voxel lines (flat line
// id i*nj + j) and the whole k range; warp w owns line w. The block walks
// over ALL projections itself, so each voxel's sum stays in the registers
// of one lane (acc_lo / acc_hi below), is added in projection order, and
// is written to the volume once: no atomics and a fixed summation order.
//
// One step of the projection loop stages `stage` projections: their
// matrices into shared memory, then, per warp, the sub-line of each staged
// projection (Fig. 3a: the blend of detector columns floor(x) and
// floor(x)+1, nh contiguous floats each, coalesced) into the warp's own
// shared-memory rows. Stage 2 (Fig. 3b) then strides the lanes over
// k < khp = nz - nz/2 and interpolates at y = a + b*k for the direct half
// and at (nh-1) - y for the mirrored plane nz-1-k when k < nz/2 (O3).
// The per-line scalars are computed in the order of the plain version with
// round-to-nearest intrinsics, so FMA contraction cannot move floor(x),
// floor(y) or the validity masks across an edge relative to it.

#include <cuda_runtime.h>

namespace {

constexpr int kLines = 8;                 // voxel lines per block
constexpr int kWarp = 32;
constexpr int kThreads = kLines * kWarp;  // one warp per line

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

template <int KPT>
__global__ void __launch_bounds__(kThreads)
subline_kernel(const float* __restrict__ img_t, const float* __restrict__ mat,
               float* __restrict__ out, int n_proj, int nw, int nh, int ni,
               int nj, int nz, int stage) {
  extern __shared__ float smem[];
  float* smat = smem;                                  // stage * 12
  float* sbuf = smem + ((stage * 12 + 3) & ~3);        // kLines * stage * nh

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long line = (long long)blockIdx.x * kLines + warp;
  const bool active = line < (long long)ni * nj;       // ragged last block
  const float fi = active ? (float)(line / nj) : 0.0f;
  const float fj = active ? (float)(line % nj) : 0.0f;
  const int kh = nz / 2;          // mirrored half
  const int khp = nz - kh;        // direct half (kh + 1 when nz is odd)
  const float ylast = (float)(nh - 2);
  const float ytop = (float)(nh - 1);
  float* buf = sbuf + (size_t)warp * stage * nh;

  float acc_lo[KPT];
  float acc_hi[KPT];
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    acc_lo[r] = 0.0f;
    acc_hi[r] = 0.0f;
  }

  for (int s0 = 0; s0 < n_proj; s0 += stage) {
    const int nbs = min(stage, n_proj - s0);
    __syncthreads();  // the previous step is done with smat and buf
    for (int t = threadIdx.x; t < nbs * 12; t += kThreads)
      smat[t] = mat[(size_t)s0 * 12 + t];
    __syncthreads();
    if (!active) continue;

    // stage 1: one blended sub-line per staged projection
    for (int b = 0; b < nbs; ++b) {
      float f, dx;
      int ixc;
      if (!line_scalars(smat + b * 12, fi, fj, nw, f, ixc, dx)) continue;
      const float* c0 = img_t + ((size_t)(s0 + b) * nw + ixc) * nh;
      const float* c1 = c0 + nh;
      float* row = buf + (size_t)b * nh;
      const float wx = 1.0f - dx;
#pragma unroll 4
      for (int y = lane; y < nh; y += kWarp)
        row[y] = __ldg(c0 + y) * wx + __ldg(c1 + y) * dx;
    }
    __syncwarp();

    // stage 2: y-affine interpolation, direct half + O3 mirror
    for (int b = 0; b < nbs; ++b) {
      const float* m = smat + b * 12;
      float f, dx;
      int ixc;
      if (!line_scalars(m, fi, fj, nw, f, ixc, dx)) continue;
      const float w = __fmul_rn(f, f);
      const float a = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(m[4], fi), __fmul_rn(m[5], fj)), m[7]),
          f);
      const float bk = __fmul_rn(m[6], f);
      const float* row = buf + (size_t)b * nh;
#pragma unroll
      for (int r = 0; r < KPT; ++r) {
        const int k = lane + r * kWarp;
        if (k < khp) {
          const float y = __fadd_rn(a, __fmul_rn(bk, (float)k));
          acc_lo[r] += interp(row, y, ylast) * w;
          if (k < kh) acc_hi[r] += interp(row, __fsub_rn(ytop, y), ylast) * w;
        }
      }
    }
  }

  if (!active) return;
  float* o = out + (size_t)line * nz;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int k = lane + r * kWarp;
    if (k < khp) o[k] = acc_lo[r];
    if (k < kh) o[nz - 1 - k] = acc_hi[r];
  }
}

template <int KPT>
int launch(const float* img_t, const float* mat, float* out, int n_proj,
           int nw, int nh, int ni, int nj, int nz, int stage, size_t smem,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      subline_kernel<KPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_lines = (long long)ni * nj;
  const unsigned blocks = (unsigned)((n_lines + kLines - 1) / kLines);
  subline_kernel<KPT><<<blocks, kThreads, smem, stream>>>(
      img_t, mat, out, n_proj, nw, nh, ni, nj, nz, stage);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for a staging depth and detector
// height; the wrapper checks it against the card's per-block limit.
size_t bp_subline_smem_bytes(int nh, int stage) {
  return sizeof(float) * ((size_t)((stage * 12 + 3) & ~3) +
                          (size_t)kLines * stage * nh);
}

// Largest k extent of the direct half (nz - nz/2) the kernel takes.
int bp_subline_max_khp() { return 32 * kWarp; }

const char* bp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`. Returns cudaGetLastError() after the launch (0 on
// success). Does not synchronise and allocates nothing.
int bp_subline_launch(const float* img_t, const float* mat, float* out,
                      int n_proj, int nw, int nh, int ni, int nj, int nz,
                      int stage, void* stream) {
  if (n_proj < 0 || nw < 2 || nh < 2 || ni < 1 || nj < 1 || nz < 1 ||
      stage < 1)
    return (int)cudaErrorInvalidValue;
  const int khp = nz - nz / 2;
  const size_t smem = bp_subline_smem_bytes(nh, stage);
  cudaStream_t st = (cudaStream_t)stream;
  const int need = (khp + kWarp - 1) / kWarp;
  if (need <= 1)
    return launch<1>(img_t, mat, out, n_proj, nw, nh, ni, nj, nz, stage, smem, st);
  if (need <= 2)
    return launch<2>(img_t, mat, out, n_proj, nw, nh, ni, nj, nz, stage, smem, st);
  if (need <= 4)
    return launch<4>(img_t, mat, out, n_proj, nw, nh, ni, nj, nz, stage, smem, st);
  if (need <= 8)
    return launch<8>(img_t, mat, out, n_proj, nw, nh, ni, nj, nz, stage, smem, st);
  if (need <= 16)
    return launch<16>(img_t, mat, out, n_proj, nw, nh, ni, nj, nz, stage, smem, st);
  if (need <= 32)
    return launch<32>(img_t, mat, out, n_proj, nw, nh, ni, nj, nz, stage, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
