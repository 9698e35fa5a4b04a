// Sub-line cone-beam back-projection for Hopper (sm_90a): the paper's
// Algorithm 1 (hoisting O2, O3 mirror, sub-line buffer O4, nb staging O5).
// Replaces four Pallas kernels of the JAX package:
//   K1 backproject_subline_pallas, K2 backproject_subline_fused
//      (src/repro/kernels/backproject_subline.py), kBanded = false;
//   K5 _banded_call, K6 _banded_call_fused
//      (src/repro/kernels/backproject_banded.py), kBanded = true.
// ../backproject_subline.py and ../backproject_banded.py wrap it and say
// what bounds it on an H100.
//
// Inputs, all float32 and contiguous:
//   img   (n_proj, nw, nh)              filtered projections, detector
//                                       columns contiguous (K1/K2), or
//         (n_proj, n_bands, 2*bw, nh)   the same in overlapping bands (K5/K6)
//   mat   (n_proj, 3, 4)                index-space projection matrices
//   band  (n_proj / group, ni/bi, nj/bj) int32 band of each (projection
//                                       group, tile); K5/K6 only
// Output:
//   out   (ni, nj, nz)                  vol_t[i][j][k], written exactly once
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
//
// Banded (K5/K6): the only change is where stage 1 reads its two columns.
// Projection s of tile (i/bi, j/bj) reads band b = band[s/group][ti][tj],
// the 2*bw detector columns from b*bw, at rel = floor(x) - b*bw; a line
// whose rel misses [0, 2*bw-2] is dropped for that projection. The band
// comes from the projection's group (group = nb for K6, 1 for K5), never
// from the staging step, whose depth shared memory may cap below nb. The
// line's validity is still decided against the TRUE detector width nw.

#include "backproject_common.cuh"

namespace {

using bp::kLines;
using bp::kThreads;
using bp::kWarp;

struct BandArgs {
  const int* band;   // (n_proj / group, n_ti, n_tj); null for K1/K2
  int bw, n_bands, bi, bj, n_ti, n_tj, group;
};

// First detector column of a valid line's sub-line in projection s, or
// null when the line is dropped for it (K5/K6: the band misses floor(x)).
template <bool kBanded>
__device__ __forceinline__ const float* columns(const float* img,
                                                const BandArgs& B, int s,
                                                int ti, int tj, int ixc,
                                                int nw, int nh) {
  if constexpr (!kBanded) {
    return img + ((size_t)s * nw + ixc) * nh;
  } else {
    const int b = __ldg(B.band + ((size_t)(s / B.group) * B.n_ti + ti) * B.n_tj
                        + tj);
    const int rel = ixc - b * B.bw;
    if (rel < 0 || rel > 2 * B.bw - 2) return nullptr;
    return img + (((size_t)s * B.n_bands + b) * (2 * B.bw) + rel) * nh;
  }
}

template <int KPT, bool kBanded>
__global__ void __launch_bounds__(kThreads)
subline_kernel(const float* __restrict__ img, const float* __restrict__ mat,
               float* __restrict__ out, int n_proj, int nw, int nh, int ni,
               int nj, int nz, int stage, BandArgs band) {
  extern __shared__ float smem[];
  float* smat = smem;                                  // stage * 12
  float* sbuf = smem + bp::mat_floats(stage);          // kLines * stage * nh

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long line = (long long)blockIdx.x * kLines + warp;
  const bool active = line < (long long)ni * nj;       // ragged last block
  const int li = active ? (int)(line / nj) : 0;
  const int lj = active ? (int)(line % nj) : 0;
  const float fi = (float)li;
  const float fj = (float)lj;
  const int ti = kBanded ? li / band.bi : 0;
  const int tj = kBanded ? lj / band.bj : 0;
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
      if (!bp::line_scalars(smat + b * 12, fi, fj, nw, f, ixc, dx)) continue;
      const float* c0 =
          columns<kBanded>(img, band, s0 + b, ti, tj, ixc, nw, nh);
      if (c0 == nullptr) continue;
      bp::blend_columns(c0, dx, nh, lane, buf + (size_t)b * nh);
    }
    __syncwarp();

    // stage 2: y-affine interpolation, direct half + O3 mirror
    for (int b = 0; b < nbs; ++b) {
      const float* m = smat + b * 12;
      float f, dx;
      int ixc;
      if (!bp::line_scalars(m, fi, fj, nw, f, ixc, dx)) continue;
      if (kBanded && columns<kBanded>(img, band, s0 + b, ti, tj, ixc, nw,
                                      nh) == nullptr)
        continue;
      float a, bk, w;
      bp::y_affine(m, fi, fj, f, a, bk, w);
      const float* row = buf + (size_t)b * nh;
#pragma unroll
      for (int r = 0; r < KPT; ++r) {
        const int k = lane + r * kWarp;
        if (k < khp) {
          const float y = __fadd_rn(a, __fmul_rn(bk, (float)k));
          acc_lo[r] += bp::interp(row, y, ylast) * w;
          if (k < kh)
            acc_hi[r] += bp::interp(row, __fsub_rn(ytop, y), ylast) * w;
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

template <int KPT, bool kBanded>
int launch_one(const float* img, const float* mat, float* out, int n_proj,
               int nw, int nh, int ni, int nj, int nz, int stage,
               const BandArgs& band, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)bp::mat_floats(stage) +
                                       (size_t)kLines * stage * nh);
  cudaError_t e = cudaFuncSetAttribute(
      subline_kernel<KPT, kBanded>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_lines = (long long)ni * nj;
  const unsigned blocks = (unsigned)((n_lines + kLines - 1) / kLines);
  subline_kernel<KPT, kBanded><<<blocks, kThreads, smem, stream>>>(
      img, mat, out, n_proj, nw, nh, ni, nj, nz, stage, band);
  return (int)cudaGetLastError();
}

// One instance per k-per-lane count: the direct half's khp k values are
// spread over the 32 lanes, KPT a lane.
template <bool kBanded>
int launch(const float* img, const float* mat, float* out, int n_proj,
           int nw, int nh, int ni, int nj, int nz, int stage,
           const BandArgs& band, cudaStream_t st) {
  if (n_proj < 0 || nw < 2 || nh < 2 || ni < 1 || nj < 1 || nz < 1 ||
      stage < 1)
    return (int)cudaErrorInvalidValue;
  const int need = (nz - nz / 2 + kWarp - 1) / kWarp;
#define BP_LAUNCH(K)                                                       \
  return launch_one<K, kBanded>(img, mat, out, n_proj, nw, nh, ni, nj, nz, \
                                stage, band, st)
  if (need <= 1) BP_LAUNCH(1);
  if (need <= 2) BP_LAUNCH(2);
  if (need <= 4) BP_LAUNCH(4);
  if (need <= 8) BP_LAUNCH(8);
  if (need <= 16) BP_LAUNCH(16);
  if (need <= 32) BP_LAUNCH(32);
#undef BP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for a staging depth and detector
// height; the wrapper checks it against the card's per-block limit.
size_t bp_subline_smem_bytes(int nh, int stage) {
  return sizeof(float) * ((size_t)bp::mat_floats(stage) +
                          (size_t)kLines * stage * nh);
}

// Largest k extent of the direct half (nz - nz/2) the kernel takes.
int bp_subline_max_khp() { return 32 * kWarp; }

const char* bp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1/K2: launch on `stream`. Returns cudaGetLastError() after the launch
// (0 on success). Does not synchronise and allocates nothing.
int bp_subline_launch(const float* img_t, const float* mat, float* out,
                      int n_proj, int nw, int nh, int ni, int nj, int nz,
                      int stage, void* stream) {
  const BandArgs none{nullptr, 0, 0, 1, 1, 1, 1, 1};
  return launch<false>(img_t, mat, out, n_proj, nw, nh, ni, nj, nz, stage,
                       none, (cudaStream_t)stream);
}

// K5/K6: img_b (n_proj, n_bands, 2*bw, nh), band (n_proj/group, ni/bi,
// nj/bj) int32 with values in [0, n_bands). nw is the TRUE detector width.
// The tiles must divide the volume and bj be a multiple of 8, so a block's
// 8 lines share one tile.
int bp_banded_launch(const float* img_b, const float* mat, const int* band,
                     float* out, int n_proj, int nw, int nh, int ni, int nj,
                     int nz, int stage, int bw, int n_bands, int bi, int bj,
                     int group, void* stream) {
  if (band == nullptr || bw < 1 || n_bands < 1 || bi < 1 || bj < 8 ||
      bj % 8 || ni % bi || nj % bj || group < 1 || n_proj % group)
    return (int)cudaErrorInvalidValue;
  const BandArgs args{band, bw, n_bands, bi, bj, ni / bi, nj / bj, group};
  return launch<true>(img_b, mat, out, n_proj, nw, nh, ni, nj, nz, stage,
                      args, (cudaStream_t)stream);
}

}  // extern "C"
