// Sub-line cone-beam back-projection for Hopper (sm_90a): the paper's
// Algorithm 1 (hoisting O2, O3 mirror, sub-line buffer O4, nb staging O5).
// Replaces the six Pallas kernels of the JAX package:
//   K1 backproject_subline_pallas (l.204), K2 backproject_subline_fused
//      (l.240) of src/repro/kernels/backproject_subline.py: tile_kernel in
//      its linear form;
//   K3 backproject_onehot_pallas (l.144), K4 backproject_onehot_fused
//      (l.175) of src/repro/kernels/backproject_onehot.py: tile_kernel in
//      its two-hot form;
//   K5 _banded_call, K6 _banded_call_fused
//      (src/repro/kernels/backproject_banded.py): subline_kernel<KPT>.
// ../backproject_subline.py, ../backproject_onehot.py and
// ../backproject_banded.py wrap them.
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
// ---- K1-K4: tile_kernel -----------------------------------------------------
// What bounds it on an H100. By the repo's cost model (8 FLOP per
// voxel-view update) the function is bound by operations: 8.2 ms at P5
// against 0.32 ms of compulsory bytes. The kernel it replaced (one warp per
// voxel line, reading the line's two detector columns from L2 for every
// view, 8 lines a block) moved about 550 GB through L2 at P5 and staged nb
// views' sub-lines per block, so nb=8 left one block per SM; its time went
// to issued instructions and their latency more than to that traffic.
// What bounds this design is instruction issue: about 20 instructions a
// sample in stage 1 and stage 2, at 2 blocks of 8 warps per SM at P5.
//
// The design:
//  * A block of 8 warps owns a tile of 8 x 8 voxel lines (warp w: line row
//    i0 + w, lines j0..j0+7) and a mirror-paired k chunk: the direct planes
//    [k0, k0 + 32*KPT) below khp = nz - nz/2 and their O3 mirrors nz-1-k
//    below nz/2 (the odd-nz middle plane is direct). Each voxel's sum stays
//    in one lane's register, is added in view order, and is written once:
//    no atomics, any nz. Fewer, larger chunks repeat less per-view work;
//    KPT = 4 (64 sums a lane) is the largest that fits the registers. The
//    wrapper's plan halves KPT where a chunk's samples would span more
//    rows than a window slot holds (detectors finer than the voxels).
//  * Per view, the tile's detector window goes into shared memory once: the
//    columns [min floor(x), max floor(x) + 1] over the tile's valid lines,
//    and only the rows the chunk's direct and mirrored samples touch (y is
//    monotone in k, so the chunk's end planes bound them exactly). All 64
//    lines blend their sub-lines from it, where the replaced kernel read 2
//    columns per line from L2 (at P5, with KPT = 4, a window is at most 12
//    columns by 264 rows of a 16 x 272 slot).
//  * The copies run ahead: a ring of two windows filled with cp.async
//    (16 bytes a copy where nh % 4 == 0); the window of view s + 1 is
//    issued while view s is computed (a deeper ring bought nothing on the
//    card, and at KPT = 4 a third window leaves one block per SM). The
//    work around the copies is spread over the 8 warps, so the one
//    __syncthreads a view waits for no single warp: lanes 0-7 of each warp
//    compute its 8 lines' scalars and their share of the window bounds one
//    view ahead of the copies; after the next barrier every warp combines
//    the bounds and issues the copies of one or two columns.
//  * Each warp first blends the window rows of all 8 of its lines into
//    their buffers (stage 1), then runs stage 2 over the 8 lines, so each
//    lane has 8 independent lines of loads in flight and a view costs two
//    __syncwarp, not sixteen.
//  * A window wider than kWinCols columns (oblique geometries, detectors
//    finer than the voxels) is not copied: stage 1 reads the same rows of
//    the two columns from global memory. A window taller than a slot runs
//    line by line on a full-height sub-line, as the replaced kernel did;
//    the plan keeps that off the paper's problems P1-P10.
//  * Stage 1 is bp::blend_rn, stage 2 y = a + b*k, bp::interp_rn and
//    bp::accumulate_rn in view order: the roundings the banded instance's
//    helpers compile to, written out, so K1/K2 give the banded kernel's
//    volume bit for bit.
//  * K3/K4 are the same kernel with stage 2's interpolation in the two-hot
//    form (the kForm template parameter: bp::twohot_rn, the nonzero terms
//    of the TPU kernel's contraction over all nh rows, in the dense sum's
//    roundings). It reads the same two rows under the same range rule, so
//    the windows, the copies and the plan are K1's. The kernel it replaced
//    ran that contraction densely, 2*nh FMAs a sample (7.0e13 FLOP at P5),
//    where this form does 2.
// Only issue_window and stage1_lines<true> know where a column lies in the
// image: a later change can give K5/K6 their window from the band layout
// there.
//
// ---- K5/K6: subline_kernel<KPT> ---------------------------------------------
// A block of 8 warps owns 8 consecutive voxel lines (flat line id
// i*nj + j) and the whole k range; warp w owns line w and walks over ALL
// projections, each voxel's sum in the registers of one lane. One step of
// the projection loop stages `stage` projections: their matrices into
// shared memory, then, per warp, the sub-line of each staged projection
// (Fig. 3a: the blend of detector columns floor(x) and floor(x)+1) into the
// warp's own shared-memory rows. Stage 2 (Fig. 3b) then strides the lanes
// over k < khp and interpolates at y = a + b*k for the direct half and at
// (nh-1) - y for the mirrored plane nz-1-k when k < nz/2 (O3).
// Projection s of tile (i/bi, j/bj) reads band b = band[s/group][ti][tj],
// the 2*bw detector columns from b*bw, at rel = floor(x) - b*bw; a line
// whose rel misses [0, 2*bw-2] is dropped for that projection. The band
// comes from the projection's group (group = nb for K6, 1 for K5), never
// from the staging step, whose depth shared memory may cap below nb. The
// line's validity is still decided against the TRUE detector width nw.

#include <climits>

#include "backproject_common.cuh"

namespace {

using bp::kLines;
using bp::kThreads;
using bp::kWarp;

struct BandArgs {
  const int* band;   // (n_proj / group, n_ti, n_tj)
  int bw, n_bands, bi, bj, n_ti, n_tj, group;
};

// First detector column of a valid line's sub-line in projection s, or
// null when the line is dropped for it (the band misses floor(x)).
__device__ __forceinline__ const float* columns(const float* img,
                                                const BandArgs& B, int s,
                                                int ti, int tj, int ixc,
                                                int nh) {
  const int b = __ldg(B.band + ((size_t)(s / B.group) * B.n_ti + ti) * B.n_tj
                      + tj);
  const int rel = ixc - b * B.bw;
  if (rel < 0 || rel > 2 * B.bw - 2) return nullptr;
  return img + (((size_t)s * B.n_bands + b) * (2 * B.bw) + rel) * nh;
}

template <int KPT>
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
  const int ti = li / band.bi;
  const int tj = lj / band.bj;
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
      const float* c0 = columns(img, band, s0 + b, ti, tj, ixc, nh);
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
      if (columns(img, band, s0 + b, ti, tj, ixc, nh) == nullptr) continue;
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

template <int KPT>
int launch_one(const float* img, const float* mat, float* out, int n_proj,
               int nw, int nh, int ni, int nj, int nz, int stage,
               const BandArgs& band, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)bp::mat_floats(stage) +
                                       (size_t)kLines * stage * nh);
  cudaError_t e = cudaFuncSetAttribute(
      subline_kernel<KPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_lines = (long long)ni * nj;
  const unsigned blocks = (unsigned)((n_lines + kLines - 1) / kLines);
  subline_kernel<KPT><<<blocks, kThreads, smem, stream>>>(
      img, mat, out, n_proj, nw, nh, ni, nj, nz, stage, band);
  return (int)cudaGetLastError();
}

// One instance per k-per-lane count: the direct half's khp k values are
// spread over the 32 lanes, KPT a lane.
int launch(const float* img, const float* mat, float* out, int n_proj,
           int nw, int nh, int ni, int nj, int nz, int stage,
           const BandArgs& band, cudaStream_t st) {
  if (n_proj < 0 || nw < 2 || nh < 2 || ni < 1 || nj < 1 || nz < 1 ||
      stage < 1)
    return (int)cudaErrorInvalidValue;
  const int need = (nz - nz / 2 + kWarp - 1) / kWarp;
#define BP_LAUNCH(K)                                                       \
  return launch_one<K>(img, mat, out, n_proj, nw, nh, ni, nj, nz, stage, \
                       band, st)
  if (need <= 1) BP_LAUNCH(1);
  if (need <= 2) BP_LAUNCH(2);
  if (need <= 4) BP_LAUNCH(4);
  if (need <= 8) BP_LAUNCH(8);
  if (need <= 16) BP_LAUNCH(16);
  if (need <= 32) BP_LAUNCH(32);
#undef BP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K1-K4: the tiled kernel (see the note at the top of this file)
// ---------------------------------------------------------------------------

namespace tiled {

constexpr int kTi = 8;                    // line rows of a tile, one per warp
constexpr int kTj = 8;                    // lines of a warp
constexpr int kWarps = kTi;
constexpr int kTileLines = kTi * kTj;
constexpr int kWinCols = 16;              // detector columns a window holds
constexpr int kRing = 2;                  // windows in the ring of copies
constexpr int kParSlots = kRing + 1;      // line scalars run one view ahead
constexpr int kBounds = 6;                // clo, chi, dlo, dhi, mlo, mhi

// Blocks per SM that __launch_bounds__ asks of the KPT instance: 3 leave
// 80 registers a thread; the 64 sums of KPT = 4 need 2 (128 registers).
__host__ __device__ constexpr int min_blocks(int kpt) {
  return kpt >= 4 ? 2 : 3;
}

// Stage 2's interpolation form, tile_kernel's kForm: K1/K2 interpolate
// linearly, K3/K4 take the two-hot contraction's nonzero terms. The values
// are those of the launch's `form` argument.
enum { kLinear = 0, kTwoHot = 1 };

template <int kForm>
__device__ __forceinline__ float sample_rn(const float* row, float y,
                                           float ylast) {
  return kForm == kTwoHot ? bp::twohot_rn(row, y, ylast)
                          : bp::interp_rn(row, y, ylast);
}

template <int kForm>
__device__ __forceinline__ float sample_inside(const float* row, float y) {
  return kForm == kTwoHot ? bp::twohot_inside(row, y)
                          : bp::interp_inside(row, y);
}

// Window descriptor of one view: columns [c_lo, c_lo + nc), rows
// [d0, d0 + nd) then [m0, m0 + nm) of each, stored column after column
// with stride nd + nm, and the path stage 1 takes for the view.
enum { kCLo, kNc, kD0, kNd, kM0, kNm, kPath, kDesc = 8 };
enum {
  kPathWindow,       // the window is in shared memory
  kPathGlobalCols,   // too many columns: the same rows, from global memory
  kPathGlobalRows    // too many rows: line by line, full height, global
};

// Floats of one warp's sub-line buffers: kTj rows of win_rows (the window
// rows of each of its lines), or one detector column for the full-height
// path, whichever is larger.
__host__ __device__ inline int warp_floats(int nh, int win_rows) {
  return max(kTj * win_rows, (nh + 3) & ~3);
}

// Shared memory of one block, in this order: the warps' sub-line buffers,
// the window ring (kRing x kWinCols x win_rows floats), the line scalars
// (kParSlots x kTileLines x (dx, a, bk, w)), the line columns (as many
// slots, -1 for an invalid line), the warps' "inside" flags (as many slots
// x kWarps ints), the warps' window bounds (2 slots x kWarps x kBounds
// ints) and the window descriptors (kRing x kDesc ints).
__host__ __device__ inline size_t smem_bytes(int nh, int win_rows) {
  return sizeof(float) *
         ((size_t)kWarps * warp_floats(nh, win_rows) +
          (size_t)kRing * kWinCols * win_rows +
          (size_t)kParSlots * (kTileLines * 5 + kWarps) +
          2 * kWarps * kBounds + kRing * kDesc);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until every copy group of this thread has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The rows [lo, hi + 1] that the valid samples of y over the monotone
// run y_first..y_last touch (floor(y) in [0, nh-2]); widens [rlo, rhi].
// Returns whether every sample of the run is valid.
__device__ __forceinline__ bool touch_rows(float y_first, float y_last,
                                           float ylast, int& rlo, int& rhi) {
  const float fl = floorf(fminf(y_first, y_last));
  const float fh = floorf(fmaxf(y_first, y_last));
  const float lo = fmaxf(fl, 0.0f);
  const float hi = fminf(fh, ylast);
  if (lo <= hi) {
    rlo = min(rlo, (int)lo);
    rhi = max(rhi, (int)hi + 1);
  }
  return fl >= 0.0f && fh <= ylast;
}

// Min/max of the bounds over the warp (redux.sync: one instruction each).
__device__ __forceinline__ void reduce_bounds(int (&b)[kBounds]) {
#pragma unroll
  for (int i = 0; i < kBounds; ++i)
    b[i] = (i % 2) ? __reduce_max_sync(0xffffffffu, b[i])
                   : __reduce_min_sync(0xffffffffu, b[i]);
}

// A row segment [r0, r1) widened to whole 16-byte copies when vec.
__device__ __forceinline__ int seg_len(int& r0, int r1, int nh, bool vec) {
  if (r1 <= r0) return 0;
  if (vec) {
    r0 &= ~3;
    r1 = min((r1 + 3) & ~3, nh);
  }
  return r1 - r0;
}

struct Args {
  const float* img;
  const float* mat;
  float* out;
  int n_proj, nw, nh, ni, nj, nz, win_rows, n_tj;
  bool vec;
};

struct Smem {
  float* lines;   // this warp's sub-line buffers
  float* win;     // window ring
  float* par;     // line scalars
  int* pcol;      // line columns
  int* inside;    // per warp: every sample of its 8 lines on the detector
  int* part;      // warps' window bounds
  int* desc;      // window descriptors
};

// Lanes 0..7 of each warp: the scalars of the warp's 8 lines for view v
// into slot v % kParSlots with the flag whether every sample of the
// lines lies on the detector, and the warp's bounds of the view's window
// (columns, and the rows of the k chunk's direct and mirrored samples)
// into slot v % 2.
__device__ __forceinline__ void line_params(const Args& A, const Smem& S,
                                           int v, int li, int j0, int k0,
                                           int kd1, int km1, int warp,
                                           int lane) {
  int b[kBounds] = {INT_MAX, -1, INT_MAX, -1, INT_MAX, -1};
  bool in = true;     // every sample of this lane's line on the detector
  if (lane < kTj) {
    const float* m = A.mat + (size_t)v * 12;
    float mv[12];
#pragma unroll
    for (int t = 0; t < 12; ++t) mv[t] = __ldg(m + t);
    const float ylast = (float)(A.nh - 2);
    const float ytop = (float)(A.nh - 1);
    const int lj = j0 + lane;
    const float fi = (float)li;
    const float fj = (float)lj;
    float f = 0.0f, dx = 0.0f, a = 0.0f, bk = 0.0f, w = 0.0f;
    int ixc = 0;
    const bool ok = li < A.ni && lj < A.nj &&
                    bp::line_scalars(mv, fi, fj, A.nw, f, ixc, dx);
    if (ok) {
      bp::y_affine(mv, fi, fj, f, a, bk, w);
      b[0] = ixc;
      b[1] = ixc + 1;
      if (kd1 > k0)
        in &= touch_rows(__fadd_rn(a, __fmul_rn(bk, (float)k0)),
                         __fadd_rn(a, __fmul_rn(bk, (float)(kd1 - 1))),
                         ylast, b[2], b[3]);
      if (km1 > k0)
        in &= touch_rows(
            __fsub_rn(ytop, __fadd_rn(a, __fmul_rn(bk, (float)k0))),
            __fsub_rn(ytop, __fadd_rn(a, __fmul_rn(bk, (float)(km1 - 1)))),
            ylast, b[4], b[5]);
    }
    in &= ok;
    const int slot = (v % kParSlots) * kTileLines + warp * kTj + lane;
    float* p = S.par + (size_t)slot * 4;
    p[0] = dx;
    // an invalid line samples y = NaN, which interp_rn takes as outside
    // the detector: it adds 0 * 0 to sums that are never -0, no bit
    p[1] = ok ? a : __int_as_float(0x7fffffff);
    p[2] = bk;
    p[3] = w;
    S.pcol[slot] = ok ? ixc : -1;
  }
  in = __all_sync(0xffffffffu, in);
  if (lane == 0) S.inside[(v % kParSlots) * kWarps + warp] = in;
  reduce_bounds(b);
  if (lane < kBounds) {
    int x = b[0];
#pragma unroll
    for (int i = 1; i < kBounds; ++i) x = lane == i ? b[i] : x;
    S.part[((v & 1) * kWarps + warp) * kBounds + lane] = x;
  }
}

// Every warp: the window of view v from the warps' bounds, its descriptor
// (stored by warp 0) and this warp's share of its copies (columns
// warp, warp + 8), committed as one group (empty where nothing is copied).
__device__ __forceinline__ void issue_window(const Args& A, const Smem& S,
                                            int v, int warp, int lane) {
  int b[kBounds] = {INT_MAX, -1, INT_MAX, -1, INT_MAX, -1};
  if (lane < kWarps) {
#pragma unroll
    for (int i = 0; i < kBounds; ++i)
      b[i] = S.part[((v & 1) * kWarps + lane) * kBounds + i];
  }
  reduce_bounds(b);
  const int clo = b[0];
  const int nc = b[1] >= 0 ? b[1] - clo + 1 : 0;
  int d0 = b[2], m0 = b[4];
  int nd = seg_len(d0, b[3] + 1, A.nh, A.vec);
  int nm = seg_len(m0, b[5] + 1, A.nh, A.vec);
  if (nd && nm && m0 <= d0 + nd && d0 <= m0 + nm) {   // overlapping: merge
    const int r1 = max(d0 + nd, m0 + nm);
    d0 = min(d0, m0);
    nd = r1 - d0;
    nm = 0;
  }
  const int n_rows = nd + nm;
  const int path = n_rows > A.win_rows ? kPathGlobalRows
                   : nc > kWinCols     ? kPathGlobalCols
                                       : kPathWindow;
  if (warp == 0 && lane == 0) {
    int* d = S.desc + (v % kRing) * kDesc;
    d[kCLo] = clo;
    d[kNc] = nc;
    d[kD0] = d0;
    d[kNd] = nd;
    d[kM0] = m0;
    d[kNm] = nm;
    d[kPath] = path;
  }
  if (path == kPathWindow) {
    const int unit = A.vec ? 4 : 1;
    float* dst = S.win + (size_t)(v % kRing) * kWinCols * A.win_rows;
    const float* src = A.img + ((size_t)v * A.nw + clo) * A.nh;
    for (int c = warp; c < nc; c += kWarps)
      for (int r = lane * unit; r < n_rows; r += kWarp * unit)
        cp_async(dst + c * n_rows + r,
                 src + (size_t)c * A.nh + (r < nd ? d0 + r : m0 + (r - nd)),
                 A.vec);
  }
  cp_async_commit();
}

// Stage 1 for the warp's 8 lines, four at a time: rows [0, n_rows) of the
// window (or the same detector rows of global memory) of columns ixc and
// ixc + 1 blended into each line's buffer. An invalid line reads column
// 0 and is never read back.
template <bool kGlobal>
__device__ __forceinline__ void stage1_lines(const float* src, int cstride,
                                             int c_lo, const int* pcol,
                                             const float* par, int n_rows,
                                             int d0, int nd, int m0,
                                             int win_rows, float* lines,
                                             int lane) {
#pragma unroll
  for (int h = 0; h < kTj; h += 4) {
    int off[4];
    float dx[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ixc = pcol[h + q];
      off[q] = ixc < 0 ? 0 : (ixc - c_lo) * cstride;
      dx[q] = par[(h + q) * 4];
    }
    for (int r = lane; r < n_rows; r += kWarp) {
      const int y = kGlobal ? (r < nd ? d0 + r : m0 + (r - nd)) : r;
      float v0[4], v1[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* c0 = src + off[q] + y;
        v0[q] = kGlobal ? __ldg(c0) : c0[0];
        v1[q] = kGlobal ? __ldg(c0 + cstride) : c0[cstride];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        lines[(h + q) * win_rows + r] = bp::blend_rn(v0[q], v1[q], dx[q]);
    }
  }
}

// Stage 2 for the warp's 8 lines from their buffers: y = a + b*k over the
// lane's direct planes and (nh-1) - y for their mirrors, in view order.
// kInside: every plane of the chunk is full and every sample on the
// detector, so neither the k bounds nor the range are checked. An invalid
// line has y = NaN (checked path only): sample_rn gives 0 and the sums,
// never -0, keep their bits. No branch on the line, so the 8 lines' loads
// can overlap.
template <int KPT, bool kInside, int kForm>
__device__ __forceinline__ void stage2_lines(float (&acc_lo)[kTj][KPT],
                                             float (&acc_hi)[kTj][KPT],
                                             const float* par,
                                             const float* lines,
                                             int win_rows, int d0, int nd,
                                             int m0, int nm, int k0, int kd1,
                                             int kh, float ylast, float ytop,
                                             int lane) {
#pragma unroll
  for (int l = 0; l < kTj; ++l) {
    const float a = par[l * 4 + 1], bk = par[l * 4 + 2], w = par[l * 4 + 3];
    // this line's buffer, addressed by detector row
    const float* row_d = lines + l * win_rows - d0;
    const float* row_m = nm ? lines + l * win_rows + nd - m0 : row_d;
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      const int k = k0 + lane + r * kWarp;
      const float y = __fadd_rn(a, __fmul_rn(bk, (float)k));
      if (kInside) {
        acc_lo[l][r] = bp::accumulate_rn(acc_lo[l][r],
                                         sample_inside<kForm>(row_d, y), w);
        acc_hi[l][r] = bp::accumulate_rn(
            acc_hi[l][r], sample_inside<kForm>(row_m, __fsub_rn(ytop, y)),
            w);
      } else if (k < kd1) {
        acc_lo[l][r] = bp::accumulate_rn(
            acc_lo[l][r], sample_rn<kForm>(row_d, y, ylast), w);
        if (k < kh)
          acc_hi[l][r] = bp::accumulate_rn(
              acc_hi[l][r],
              sample_rn<kForm>(row_m, __fsub_rn(ytop, y), ylast), w);
      }
    }
  }
}

template <int KPT, int kForm>
__global__ void __launch_bounds__(kThreads, min_blocks(KPT))
tile_kernel(Args A) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int wf = warp_floats(A.nh, A.win_rows);
  Smem S;
  S.lines = smem + (size_t)warp * wf;
  S.win = smem + (size_t)kWarps * wf;
  S.par = S.win + (size_t)kRing * kWinCols * A.win_rows;
  S.pcol = (int*)(S.par + (size_t)kParSlots * kTileLines * 4);
  S.inside = S.pcol + kParSlots * kTileLines;
  S.part = S.inside + kParSlots * kWarps;
  S.desc = S.part + 2 * kWarps * kBounds;

  const int i0 = (blockIdx.x / A.n_tj) * kTi;
  const int j0 = (blockIdx.x % A.n_tj) * kTj;
  const int li = i0 + warp;
  const int kh = A.nz / 2;          // mirrored half
  const int khp = A.nz - kh;        // direct half (kh + 1 when nz is odd)
  const int k0 = blockIdx.y * (KPT * kWarp);
  const int kd1 = min(k0 + KPT * kWarp, khp);
  const int km1 = min(k0 + KPT * kWarp, kh);
  const bool full = k0 + KPT * kWarp <= kh;   // every lane's planes exist
  const float ylast = (float)(A.nh - 2);
  const float ytop = (float)(A.nh - 1);

  float acc_lo[kTj][KPT];
  float acc_hi[kTj][KPT];
#pragma unroll
  for (int l = 0; l < kTj; ++l)
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      acc_lo[l][r] = 0.0f;
      acc_hi[l][r] = 0.0f;
    }

  // prologue: window 0 in flight, view 1's scalars ready
  if (A.n_proj > 0) {
    line_params(A, S, 0, li, j0, k0, kd1, km1, warp, lane);
    __syncthreads();
    issue_window(A, S, 0, warp, lane);
  }
  if (A.n_proj > 1) line_params(A, S, 1, li, j0, k0, kd1, km1, warp, lane);

  for (int s = 0; s < A.n_proj; ++s) {
    cp_async_wait_all();   // this thread's copies of window s landed
    __syncthreads();   // all of window s, its scalars and descriptor are
    //                    visible; every warp is done with view s - 1
    if (s + 1 < A.n_proj) issue_window(A, S, s + 1, warp, lane);
    if (s + 2 < A.n_proj)
      line_params(A, S, s + 2, li, j0, k0, kd1, km1, warp, lane);

    const int* d = S.desc + (s % kRing) * kDesc;
    const int c_lo = d[kCLo], d0 = d[kD0], nd = d[kNd], m0 = d[kM0];
    const int nm = d[kNm], path = d[kPath];
    const int n_rows = nd + nm;
    const int ps = (s % kParSlots) * kTileLines + warp * kTj;
    const float* gimg = A.img + (size_t)s * A.nw * A.nh;
    if (path != kPathGlobalRows) {
      // stage 1: each line's window rows of columns ixc, ixc + 1
      if (path == kPathWindow)
        stage1_lines<false>(
            S.win + (size_t)(s % kRing) * kWinCols * A.win_rows, n_rows,
            c_lo, S.pcol + ps, S.par + (size_t)ps * 4, n_rows, d0, nd, m0,
            A.win_rows, S.lines, lane);
      else
        stage1_lines<true>(gimg, A.nh, 0, S.pcol + ps, S.par + (size_t)ps * 4,
                           n_rows, d0, nd, m0, A.win_rows, S.lines, lane);
      __syncwarp();
      // stage 2
      const float* par = S.par + (size_t)ps * 4;
      if (full && S.inside[(s % kParSlots) * kWarps + warp])
        stage2_lines<KPT, true, kForm>(acc_lo, acc_hi, par, S.lines,
                                       A.win_rows, d0, nd, m0, nm, k0, kd1,
                                       kh, ylast, ytop, lane);
      else
        stage2_lines<KPT, false, kForm>(acc_lo, acc_hi, par, S.lines,
                                        A.win_rows, d0, nd, m0, nm, k0, kd1,
                                        kh, ylast, ytop, lane);
    } else {
      // too many rows for the buffers: line by line, a full-height
      // sub-line in the warp's buffer, its rows read from global memory
      float* row = S.lines;
#pragma unroll
      for (int l = 0; l < kTj; ++l) {
        const int ixc = S.pcol[ps + l];
        if (ixc < 0) continue;                   // warp-uniform
        const float* p = S.par + (size_t)(ps + l) * 4;
        const float dx = p[0], a = p[1], bk = p[2], w = p[3];
        const float* c0 = gimg + (size_t)ixc * A.nh;
        for (int r = lane; r < n_rows; r += kWarp) {
          const int y = r < nd ? d0 + r : m0 + (r - nd);
          row[y] = bp::blend_rn(__ldg(c0 + y), __ldg(c0 + A.nh + y), dx);
        }
        __syncwarp();
#pragma unroll
        for (int r = 0; r < KPT; ++r) {
          const int k = k0 + lane + r * kWarp;
          if (k < kd1) {
            const float y = __fadd_rn(a, __fmul_rn(bk, (float)k));
            acc_lo[l][r] = bp::accumulate_rn(
                acc_lo[l][r], sample_rn<kForm>(row, y, ylast), w);
            if (k < kh)
              acc_hi[l][r] = bp::accumulate_rn(
                  acc_hi[l][r],
                  sample_rn<kForm>(row, __fsub_rn(ytop, y), ylast), w);
          }
        }
        __syncwarp();
      }
    }
  }

  if (li >= A.ni) return;
#pragma unroll
  for (int l = 0; l < kTj; ++l) {
    const int lj = j0 + l;
    if (lj >= A.nj) break;
    float* o = A.out + ((size_t)li * A.nj + lj) * A.nz;
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      const int k = k0 + lane + r * kWarp;
      if (k < kd1) o[k] = acc_lo[l][r];
      if (k < km1) o[A.nz - 1 - k] = acc_hi[l][r];
    }
  }
}

// Lets tile_kernel<KPT, kForm> take `bytes` of dynamic shared memory. A
// refusal (more than the card has) is returned and cleared, so that it
// does not stay behind as the last error of a later launch.
template <int KPT, int kForm>
int set_smem(int bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      tile_kernel<KPT, kForm>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

}  // namespace tiled

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

// K1-K4: the tiled kernel's shared memory per block for a detector height
// and window slots of win_rows rows (either form).
size_t bp_tile_smem_bytes(int nh, int win_rows) {
  return tiled::smem_bytes(nh, win_rows);
}

// Blocks of the tiled kernel an SM holds at this plan, its registers per
// thread and its local (spill) bytes per thread, for the instance of kpt
// and form (0 linear, 1 two-hot); returns a CUDA error.
int bp_tile_occupancy(int kpt, int form, int nh, int win_rows, int* blocks,
                      int* regs, int* local_bytes) {
  const int smem = (int)tiled::smem_bytes(nh, win_rows);
  cudaFuncAttributes fa;
  cudaError_t e;
#define BP_OCCUPANCY(K, F)                                                 \
  e = (cudaError_t)tiled::set_smem<K, F>(smem);                            \
  if (e == cudaSuccess)                                                    \
    e = cudaFuncGetAttributes(&fa, tiled::tile_kernel<K, F>);              \
  if (e == cudaSuccess)                                                    \
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                     \
        blocks, tiled::tile_kernel<K, F>, kThreads, smem)
#define BP_OCCUPANCY_FORM(K)                                               \
  if (form == tiled::kLinear) {                                            \
    BP_OCCUPANCY(K, tiled::kLinear);                                       \
  } else if (form == tiled::kTwoHot) {                                     \
    BP_OCCUPANCY(K, tiled::kTwoHot);                                       \
  } else {                                                                 \
    return (int)cudaErrorInvalidValue;                                     \
  }
  if (kpt == 1) {
    BP_OCCUPANCY_FORM(1)
  } else if (kpt == 2) {
    BP_OCCUPANCY_FORM(2)
  } else if (kpt == 4) {
    BP_OCCUPANCY_FORM(4)
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef BP_OCCUPANCY_FORM
#undef BP_OCCUPANCY
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return 0;
}

// K1-K4: launch the tiled kernel on `stream` with k chunks of 32*kpt planes
// (kpt 1, 2 or 4), window slots of win_rows rows (a multiple of 4) and
// stage 2 in `form` (0 linear: K1/K2; 1 two-hot: K3/K4); the grid and the
// shared memory follow from them.
// Returns cudaGetLastError() after the launch (0 on success), or the error
// of a block that asks more shared memory than the card has. Does not
// synchronise and allocates nothing.
int bp_tile_launch(const float* img_t, const float* mat, float* out,
                   int n_proj, int nw, int nh, int ni, int nj, int nz,
                   int kpt, int win_rows, int form, void* stream) {
  if (n_proj < 0 || nw < 2 || nh < 2 || ni < 1 || nj < 1 || nz < 1 ||
      (kpt != 1 && kpt != 2 && kpt != 4) || win_rows < 4 || win_rows % 4 ||
      (form != tiled::kLinear && form != tiled::kTwoHot))
    return (int)cudaErrorInvalidValue;
  const int khp = nz - nz / 2;
  const long long n_chunks = (khp + kpt * kWarp - 1) / (kpt * kWarp);
  const int n_ti = (ni + tiled::kTi - 1) / tiled::kTi;
  const int n_tj = (nj + tiled::kTj - 1) / tiled::kTj;
  if (n_chunks > 65535 || (long long)n_ti * n_tj > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const bool vec = nh % 4 == 0 && ((size_t)img_t & 15) == 0;
  const tiled::Args args{img_t, mat, out, n_proj, nw, nh, ni, nj, nz,
                         win_rows, n_tj, vec};
  const int smem = (int)tiled::smem_bytes(nh, win_rows);
  const dim3 grid((unsigned)(n_ti * n_tj), (unsigned)n_chunks);
  const cudaStream_t st = (cudaStream_t)stream;
#define BP_TILE_LAUNCH(K, F)                                               \
  {                                                                        \
    const cudaError_t e = (cudaError_t)tiled::set_smem<K, F>(smem);        \
    if (e != cudaSuccess) return (int)e;                                   \
    tiled::tile_kernel<K, F><<<grid, kThreads, smem, st>>>(args);          \
  }
#define BP_TILE_LAUNCH_FORM(K)                                             \
  if (form == tiled::kLinear)                                              \
    BP_TILE_LAUNCH(K, tiled::kLinear)                                      \
  else                                                                     \
    BP_TILE_LAUNCH(K, tiled::kTwoHot)
  if (kpt == 1) {
    BP_TILE_LAUNCH_FORM(1)
  } else if (kpt == 2) {
    BP_TILE_LAUNCH_FORM(2)
  } else {
    BP_TILE_LAUNCH_FORM(4)
  }
#undef BP_TILE_LAUNCH_FORM
#undef BP_TILE_LAUNCH
  return (int)cudaGetLastError();
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
  return launch(img_b, mat, out, n_proj, nw, nh, ni, nj, nz, stage, args,
                (cudaStream_t)stream);
}

}  // extern "C"
