// One-hot (two-hot) interpolation back-projection for Hopper (sm_90a).
// Replaces the Pallas kernels backproject_onehot_pallas (K3) and
// backproject_onehot_fused (K4) of src/repro/kernels/backproject_onehot.py;
// ../backproject_onehot.py wraps it and says what bounds it on an H100.
//
// Inputs, all float32 and contiguous:
//   img_t (n_proj, nw, nh)  filtered projections, detector columns contiguous
//   mat   (n_proj, 3, 4)    index-space projection matrices
// Output:
//   out   (ni, nj, nz)      vol_t[i][j][k], written exactly once
//
// The schedule, hoisting, symmetry and stage 1 are those of the sub-line
// kernel (backproject_subline.cu): a block of 8 warps owns 8 voxel lines and
// the whole k range, walks over all projections in order, and stages
// `stage` projections per step; stage 1 blends each line's two detector
// columns into the warp's shared-memory sub-line row.
//
// Stage 2 is the reference's contraction, not a gather: for every plane k
//     val[k] = sum_{n < nh} A[k, n] * row[n],
//     A[k, n] = ok_k * ((n == iyc_k) * (1 - dy_k) + (n == iyc_k + 1) * dy_k),
// with iyc = clip(floor(y), 0, nh-2) and ok = floor(y) in [0, nh-2], A built
// from compares as in the reference, contracted in FP32 FMA on the CUDA
// cores (no TF32), n in order. The k range of the direct half is tiled in
// chunks of k_chunk planes; within a chunk the lanes take 32*V planes per
// pass, each lane V of them, and every pass reads the row once per n (a
// shared-memory broadcast) for all its planes, direct and mirrored. The
// mirrored plane nz-1-k is contracted at (nh-1) - y for k < nz/2 only, so
// the middle plane of odd nz comes from the direct half. Each plane's sum
// over projections lives in shared memory (8 lines x nz floats), owned by
// one lane for the whole run: sums are added in projection order, and the
// volume is written once.

#include "backproject_common.cuh"

namespace {

using bp::kLines;
using bp::kThreads;
using bp::kWarp;

// Two-hot row of A for row coordinate y: columns i and i+1, weights w0, w1
// (both 0 when floor(y) misses [0, nh-2]).
__device__ __forceinline__ void two_hot(float y, float ylast, int& i,
                                        float& w0, float& w1) {
  const float y0 = floorf(y);
  const bool ok = y0 >= 0.0f && y0 <= ylast;
  const float dy = y - y0;
  i = ok ? (int)y0 : 0;
  w0 = ok ? 1.0f - dy : 0.0f;
  w1 = ok ? dy : 0.0f;
}

__device__ __forceinline__ float a_at(int n, int i, float w0, float w1) {
  return n == i ? w0 : (n == i + 1 ? w1 : 0.0f);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
onehot_kernel(const float* __restrict__ img_t, const float* __restrict__ mat,
              float* __restrict__ out, int n_proj, int nw, int nh, int ni,
              int nj, int nz, int stage, int k_chunk) {
  extern __shared__ float smem[];
  float* smat = smem;                                  // stage * 12
  float* sacc = smem + bp::mat_floats(stage);          // kLines * nz
  float* sbuf = sacc + (size_t)kLines * nz;            // kLines * stage * nh

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
  float* acc = sacc + (size_t)warp * nz;

  for (int k = lane; k < nz; k += kWarp) acc[k] = 0.0f;

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
      if (!bp::line_scalars(smat + b * 12, fi, fj, nw, f, ixc, dx)) continue;
      bp::blend_columns(img_t + ((size_t)(s0 + b) * nw + ixc) * nh, dx, nh,
                        lane, buf + (size_t)b * nh);
    }
    __syncwarp();

    // stage 2: the two-hot contraction over n, k_chunk planes at a time
    for (int b = 0; b < nbs; ++b) {
      const float* m = smat + b * 12;
      float f, dx;
      int ixc;
      if (!bp::line_scalars(m, fi, fj, nw, f, ixc, dx)) continue;
      float a, bk, w;
      bp::y_affine(m, fi, fj, f, a, bk, w);
      const float* row = buf + (size_t)b * nh;
      for (int c0 = 0; c0 < khp; c0 += k_chunk) {
        const int c1 = min(c0 + k_chunk, khp);
        for (int p0 = c0; p0 < c1; p0 += V * kWarp) {
          int i_lo[V], i_hi[V];
          float w0_lo[V], w1_lo[V], w0_hi[V], w1_hi[V], v_lo[V], v_hi[V];
#pragma unroll
          for (int r = 0; r < V; ++r) {
            const int k = p0 + lane + r * kWarp;
            const float y = __fadd_rn(a, __fmul_rn(bk, (float)k));
            two_hot(y, ylast, i_lo[r], w0_lo[r], w1_lo[r]);
            two_hot(__fsub_rn(ytop, y), ylast, i_hi[r], w0_hi[r], w1_hi[r]);
            if (k >= c1) w0_lo[r] = w1_lo[r] = 0.0f;
            if (k >= c1 || k >= kh) w0_hi[r] = w1_hi[r] = 0.0f;
            v_lo[r] = 0.0f;
            v_hi[r] = 0.0f;
          }
#pragma unroll 4
          for (int n = 0; n < nh; ++n) {
            const float rn = row[n];
#pragma unroll
            for (int r = 0; r < V; ++r) {
              v_lo[r] = fmaf(a_at(n, i_lo[r], w0_lo[r], w1_lo[r]), rn, v_lo[r]);
              v_hi[r] = fmaf(a_at(n, i_hi[r], w0_hi[r], w1_hi[r]), rn, v_hi[r]);
            }
          }
#pragma unroll
          for (int r = 0; r < V; ++r) {
            const int k = p0 + lane + r * kWarp;
            if (k < c1) acc[k] += v_lo[r] * w;
            if (k < c1 && k < kh) acc[nz - 1 - k] += v_hi[r] * w;
          }
        }
      }
    }
  }

  if (!active) return;
  __syncwarp();
  float* o = out + (size_t)line * nz;
  for (int k = lane; k < nz; k += kWarp) o[k] = acc[k];
}

template <int V>
int launch_one(const float* img_t, const float* mat, float* out, int n_proj,
               int nw, int nh, int ni, int nj, int nz, int stage, int k_chunk,
               size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      onehot_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_lines = (long long)ni * nj;
  const unsigned blocks = (unsigned)((n_lines + kLines - 1) / kLines);
  onehot_kernel<V><<<blocks, kThreads, smem, stream>>>(
      img_t, mat, out, n_proj, nw, nh, ni, nj, nz, stage, k_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs: staged matrices, the 8 lines'
// plane sums, and `stage` sub-line rows per line.
size_t bp_onehot_smem_bytes(int nh, int nz, int stage) {
  return sizeof(float) * ((size_t)bp::mat_floats(stage) +
                          (size_t)kLines * nz + (size_t)kLines * stage * nh);
}

const char* bp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`; k_chunk must already be clipped to [1, nz - nz/2].
// Returns cudaGetLastError() after the launch (0 on success). Does not
// synchronise and allocates nothing.
int bp_onehot_launch(const float* img_t, const float* mat, float* out,
                     int n_proj, int nw, int nh, int ni, int nj, int nz,
                     int stage, int k_chunk, void* stream) {
  if (n_proj < 0 || nw < 2 || nh < 2 || ni < 1 || nj < 1 || nz < 1 ||
      stage < 1 || k_chunk < 1 || k_chunk > nz - nz / 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bp_onehot_smem_bytes(nh, nz, stage);
  cudaStream_t st = (cudaStream_t)stream;
  // planes per lane and pass: enough for one chunk, at most 4 (a chunk
  // wider than 128 planes takes several passes)
  if (k_chunk <= kWarp)
    return launch_one<1>(img_t, mat, out, n_proj, nw, nh, ni, nj, nz, stage,
                         k_chunk, smem, st);
  if (k_chunk <= 2 * kWarp)
    return launch_one<2>(img_t, mat, out, n_proj, nw, nh, ni, nj, nz, stage,
                         k_chunk, smem, st);
  return launch_one<4>(img_t, mat, out, n_proj, nw, nh, ni, nj, nz, stage,
                       k_chunk, smem, st);
}

}  // extern "C"
