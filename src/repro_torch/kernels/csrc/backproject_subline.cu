// Sub-line cone-beam back-projection for Hopper (sm_90a): the paper's
// Algorithm 1 (hoisting O2, O3 mirror, sub-line buffer O4), on tiles of
// voxel lines whose detector windows are staged in shared memory.
// Replaces the six Pallas kernels of the JAX package, each an instance of
// tile_kernel:
//   K1 backproject_subline_pallas (l.204), K2 backproject_subline_fused
//      (l.240) of src/repro/kernels/backproject_subline.py: the linear
//      form;
//   K3 backproject_onehot_pallas (l.144), K4 backproject_onehot_fused
//      (l.175) of src/repro/kernels/backproject_onehot.py: the two-hot
//      form;
//   K5 _banded_call (l.148), K6 _banded_call_fused (l.186) of
//      src/repro/kernels/backproject_banded.py: the linear form reading
//      the band layout.
// ../backproject_subline.py, ../backproject_onehot.py and
// ../backproject_banded.py wrap them.
//
// Inputs, all float32 and contiguous:
//   img   (n_proj, nw, nh)              filtered projections, detector
//                                       columns contiguous (K1-K4), or
//         (n_proj, n_bands, 2*bw, nh)   the same in overlapping bands (K5/K6)
//   mat   (n_proj, 3, 4)                index-space projection matrices
//   band  (n_proj / group, ni/bi, nj/bj) int32 band of each (projection
//                                       group, tile); K5/K6 only
// Output:
//   out   (ni, nj, nz)                  vol_t[i][j][k], written exactly once
// An rb-lane launch (bp_tile_launch_lanes, bp_tile_launch_banded_lanes)
// takes rb lanes of img and out at strides of their own, with one mat and
// band: the grid's z is the lane, and a lane's blocks do what a launch of
// that lane alone does, in the same order, so every lane is equal bit for
// bit to its own launch. This is how rb same-geometry requests (or the
// same view chunk of rb scan sessions) share one launch.
//
// ---- tile_kernel ------------------------------------------------------------
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
//    line by line on a full-height sub-line; the plan keeps that off the
//    paper's problems P1-P10.
//  * Stage 1 is bp::blend_rn, stage 2 y = a + b*k, bp::interp_rn and
//    bp::accumulate_rn in view order: roundings written out, since nvcc
//    may contract one expression differently in two instances, so that
//    every instance of the linear form gives the same volume bit for bit.
//  * K3/K4 are the same kernel with stage 2's interpolation in the two-hot
//    form (the kForm template parameter: bp::twohot_rn, the nonzero terms
//    of the TPU kernel's contraction over all nh rows, in the dense sum's
//    roundings). It reads the same two rows under the same range rule, so
//    the windows, the copies and the plan are K1's. The kernel it replaced
//    ran that contraction densely, 2*nh FMAs a sample (7.0e13 FLOP at P5),
//    where this form does 2.
// K5/K6 are the linear form with the band layout as the column source (the
// kBanded template parameter). Only three places know where a column lies:
//  * line_params: tile (i/bi, j/bj) of view v reads band
//    b = band[v/group][i/bi][j/bj] (group = nb for K6, 1 for K5), and a
//    line whose rel = floor(x) - b*bw misses [0, 2*bw-2] is dropped for the
//    view, exactly as a line off the detector is. Validity is still decided
//    against the TRUE detector width nw. The band is loaded beside the
//    view's matrix, and the divisions by bi, bj, group and bw are
//    multiply-shifts (bp::FastDiv), not integer divisions of some 25
//    instructions each: together these took K5 from 87.2 to 80.8 ms at P5
//    on an H100 (K1 79.8 ms in the same run).
//  * issue_window and the two global-read paths (src_col): image column c
//    is read from band c / bw at c mod bw. A valid line reads columns
//    floor(x), floor(x) + 1 <= nw - 1, which that band holds (with c + 1
//    beside it) with the values of the image itself, so a window may span
//    several bands (an 8 x 8 tile covers two (4, 8) band tiles), and no
//    address depends on the band array's values.
// Everything else is K1's: the plan, the windows' rows, the ring, stage 2
// and the accumulation in view order. So where no line is dropped (the band
// search guarantees it) K5 = K6 = K1 = K2 bit for bit, at any nz, and K6
// walks every view one window ahead whatever nb is.

#include <climits>
#include <type_traits>

#include "backproject_common.cuh"

namespace {

using bp::kWarp;

// ---------------------------------------------------------------------------
// K1-K4: the tiled kernel (see the note at the top of this file)
// ---------------------------------------------------------------------------

namespace tiled {

constexpr int kTi = 8;                    // line rows of a tile, one per warp
constexpr int kTj = 8;                    // lines of a warp
constexpr int kWarps = kTi;
constexpr int kThreads = kWarps * kWarp;
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
  const float* img;   // (n_proj, view_cols, nh), per lane
  const float* mat;
  float* out;         // (ni, nj, nz), per lane
  // the lanes (blockIdx.z) of an rb-lane launch: lane l reads img +
  // l * img_lane and writes out + l * out_lane (elements); every lane
  // reads the same mat and band
  long long img_lane, out_lane;
  const int* band;    // kBanded: (n_proj / group, n_bti, n_btj)
  int n_proj, nw, nh, ni, nj, nz, win_rows, n_tj;
  int view_cols;      // nw, or n_bands * 2*bw for the band layout
  // kBanded only: the band width, the band tiles of the volume and the
  // divisors bw, bi, bj (a band tile's lines) and group (its views)
  int bw, n_bti, n_btj;
  bp::FastDiv div_bw, div_bi, div_bj, div_group;
  bool vec;
};

// The base of this block's lane of a lane-strided tensor (64-bit offsets:
// one lane of P10's volume alone is 2.2e9 elements).
template <class T>
__device__ __forceinline__ T* lane_base(T* p, long long stride) {
  return p + (size_t)blockIdx.z * (size_t)stride;
}

// The column of img (within a view) that holds image column c and, beside
// it, c + 1: c itself, or in the band layout band c / bw at c mod bw (c mod
// bw + 1 < 2*bw).
template <bool kBanded>
__device__ __forceinline__ int src_col(const Args& A, int c) {
  return kBanded ? c + A.div_bw.div(c) * A.bw : c;
}

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
template <bool kBanded>
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
    bool ok = li < A.ni && lj < A.nj;
    // the line's band of view v, loaded beside the matrix rather than
    // after the line is known valid, so that the two latencies overlap
    const int band =
        kBanded && ok
            ? __ldg(A.band + ((size_t)A.div_group.div(v) * A.n_bti +
                              A.div_bi.div(li)) * A.n_btj + A.div_bj.div(lj))
            : 0;
    ok = ok && bp::line_scalars(mv, fi, fj, A.nw, f, ixc, dx);
    if (kBanded && ok) {   // dropped where its tile's band misses ixc
      const int rel = ixc - band * A.bw;
      ok = rel >= 0 && rel <= 2 * A.bw - 2;
    }
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
template <bool kBanded>
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
    if (!kBanded) {
      // column c at a step of nh from the window's first: the card runs K1
      // up to 1.5% slower with the banded form's address arithmetic here
      const float* src =
          lane_base(A.img, A.img_lane) + ((size_t)v * A.nw + clo) * A.nh;
      for (int c = warp; c < nc; c += kWarps)
        for (int r = lane * unit; r < n_rows; r += kWarp * unit)
          cp_async(dst + c * n_rows + r,
                   src + (size_t)c * A.nh + (r < nd ? d0 + r : m0 + (r - nd)),
                   A.vec);
    } else {
      const float* view =
          lane_base(A.img, A.img_lane) + (size_t)v * A.view_cols * A.nh;
      for (int c = warp; c < nc; c += kWarps) {
        const float* src = view + (size_t)src_col<kBanded>(A, clo + c) * A.nh;
        for (int r = lane * unit; r < n_rows; r += kWarp * unit)
          cp_async(dst + c * n_rows + r,
                   src + (r < nd ? d0 + r : m0 + (r - nd)), A.vec);
      }
    }
  }
  cp_async_commit();
}

// Stage 1 for the warp's 8 lines, four at a time: rows [0, n_rows) of the
// window (or the same detector rows of global memory, column c at
// src_col(c)) of columns ixc and ixc + 1 blended into each line's buffer.
// An invalid line reads column 0 and is never read back.
template <bool kGlobal, bool kBanded>
__device__ __forceinline__ void stage1_lines(const Args& A, const float* src,
                                             int cstride, int c_lo,
                                             const int* pcol,
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
      off[q] = ixc < 0     ? 0
               : kGlobal ? src_col<kBanded>(A, ixc) * cstride
                         : (ixc - c_lo) * cstride;
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

template <int KPT, int kForm, bool kBanded>
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
    line_params<kBanded>(A, S, 0, li, j0, k0, kd1, km1, warp, lane);
    __syncthreads();
    issue_window<kBanded>(A, S, 0, warp, lane);
  }
  if (A.n_proj > 1)
    line_params<kBanded>(A, S, 1, li, j0, k0, kd1, km1, warp, lane);

  for (int s = 0; s < A.n_proj; ++s) {
    cp_async_wait_all();   // this thread's copies of window s landed
    __syncthreads();   // all of window s, its scalars and descriptor are
    //                    visible; every warp is done with view s - 1
    if (s + 1 < A.n_proj) issue_window<kBanded>(A, S, s + 1, warp, lane);
    if (s + 2 < A.n_proj)
      line_params<kBanded>(A, S, s + 2, li, j0, k0, kd1, km1, warp, lane);

    const int* d = S.desc + (s % kRing) * kDesc;
    const int c_lo = d[kCLo], d0 = d[kD0], nd = d[kNd], m0 = d[kM0];
    const int nm = d[kNm], path = d[kPath];
    const int n_rows = nd + nm;
    const int ps = (s % kParSlots) * kTileLines + warp * kTj;
    const float* gimg =
        lane_base(A.img, A.img_lane) + (size_t)s * A.view_cols * A.nh;
    if (path != kPathGlobalRows) {
      // stage 1: each line's window rows of columns ixc, ixc + 1
      if (path == kPathWindow)
        stage1_lines<false, kBanded>(
            A, S.win + (size_t)(s % kRing) * kWinCols * A.win_rows, n_rows,
            c_lo, S.pcol + ps, S.par + (size_t)ps * 4, n_rows, d0, nd, m0,
            A.win_rows, S.lines, lane);
      else
        stage1_lines<true, kBanded>(A, gimg, A.nh, 0, S.pcol + ps,
                                    S.par + (size_t)ps * 4, n_rows, d0, nd,
                                    m0, A.win_rows, S.lines, lane);
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
        const float* c0 = gimg + (size_t)src_col<kBanded>(A, ixc) * A.nh;
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
    float* o =
        lane_base(A.out, A.out_lane) + ((size_t)li * A.nj + lj) * A.nz;
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      const int k = k0 + lane + r * kWarp;
      if (k < kd1) o[k] = acc_lo[l][r];
      if (k < km1) o[A.nz - 1 - k] = acc_hi[l][r];
    }
  }
}

// Lets tile_kernel<KPT, kForm, kBanded> take `bytes` of dynamic shared
// memory. A refusal (more than the card has) is returned and cleared, so
// that it does not stay behind as the last error of a later launch.
template <int KPT, int kForm, bool kBanded>
int set_smem(int bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      tile_kernel<KPT, kForm, kBanded>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

template <int V>
using Int = std::integral_constant<int, V>;

// fn(Int<KPT>(), Int<kForm>(), std::bool_constant<kBanded>()) for the
// instance of kpt (1, 2, 4), form (kLinear, kTwoHot) and source (banded:
// the linear form only); cudaErrorInvalidValue where there is none.
template <class Fn>
int with_instance(int kpt, int form, bool banded, Fn fn) {
  const auto by_form = [&](auto k) -> int {
    if (banded)
      return form == kLinear ? fn(k, Int<kLinear>(), std::true_type())
                             : (int)cudaErrorInvalidValue;
    if (form == kLinear) return fn(k, Int<kLinear>(), std::false_type());
    if (form == kTwoHot) return fn(k, Int<kTwoHot>(), std::false_type());
    return (int)cudaErrorInvalidValue;
  };
  switch (kpt) {
    case 1: return by_form(Int<1>());
    case 2: return by_form(Int<2>());
    case 4: return by_form(Int<4>());
  }
  return (int)cudaErrorInvalidValue;
}

// One launch on `stream` of rb lanes with k chunks of 32*kpt planes and
// window slots of win_rows rows; the grid (tiles, k chunks, lanes) and the
// shared memory follow from them. A lane's blocks do what the blocks of a
// launch of that lane alone do, in the same order, so each lane's volume
// is that launch's bit for bit. Returns cudaGetLastError() after the
// launch (0 on success), or the error of a block that asks more shared
// memory than the card has. Does not synchronise and allocates nothing.
int launch(Args a, int rb, int kpt, int form, bool banded, void* stream) {
  if (a.n_proj < 0 || a.nw < 2 || a.nh < 2 || a.ni < 1 || a.nj < 1 ||
      a.nz < 1 || (kpt != 1 && kpt != 2 && kpt != 4) || a.win_rows < 4 ||
      a.win_rows % 4 || (long long)a.view_cols * a.nh > INT_MAX)
    return (int)cudaErrorInvalidValue;
  // lanes: at most gridDim.z's 65535, each lane's tensors apart
  if (rb < 1 || rb > 65535 ||
      (rb > 1 && (a.img_lane < (long long)a.n_proj * a.view_cols * a.nh ||
                  a.out_lane < (long long)a.ni * a.nj * a.nz)))
    return (int)cudaErrorInvalidValue;
  const int khp = a.nz - a.nz / 2;
  const long long n_chunks = (khp + kpt * kWarp - 1) / (kpt * kWarp);
  const int n_ti = (a.ni + kTi - 1) / kTi;
  a.n_tj = (a.nj + kTj - 1) / kTj;
  if (n_chunks > 65535 || (long long)n_ti * a.n_tj > INT_MAX)
    return (int)cudaErrorInvalidValue;
  a.vec = a.nh % 4 == 0 && ((size_t)a.img & 15) == 0 && a.img_lane % 4 == 0;
  const int smem = (int)smem_bytes(a.nh, a.win_rows);
  const dim3 grid((unsigned)(n_ti * a.n_tj), (unsigned)n_chunks,
                  (unsigned)rb);
  const cudaStream_t st = (cudaStream_t)stream;
  return with_instance(kpt, form, banded, [&](auto k, auto f, auto b) {
    constexpr int K = decltype(k)::value;
    constexpr int F = decltype(f)::value;
    constexpr bool B = decltype(b)::value;
    const int e = set_smem<K, F, B>(smem);
    if (e != 0) return e;
    tile_kernel<K, F, B><<<grid, kThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  });
}

}  // namespace tiled

}  // namespace

extern "C" {

const char* bp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The tiled kernel's shared memory per block for a detector height and
// window slots of win_rows rows (every instance).
size_t bp_tile_smem_bytes(int nh, int win_rows) {
  return tiled::smem_bytes(nh, win_rows);
}

// Blocks of the tiled kernel an SM holds at this plan, its registers per
// thread and its local (spill) bytes per thread, for the instance of kpt,
// form (0 linear, 1 two-hot) and source (banded 1: K5/K6, the linear
// form); returns a CUDA error.
int bp_tile_occupancy(int kpt, int form, int banded, int nh, int win_rows,
                      int* blocks, int* regs, int* local_bytes) {
  const int smem = (int)tiled::smem_bytes(nh, win_rows);
  cudaFuncAttributes fa;
  const int e = tiled::with_instance(
      kpt, form, banded != 0, [&](auto k, auto f, auto b) {
        constexpr int K = decltype(k)::value;
        constexpr int F = decltype(f)::value;
        constexpr bool B = decltype(b)::value;
        cudaError_t err = (cudaError_t)tiled::set_smem<K, F, B>(smem);
        if (err == cudaSuccess)
          err = cudaFuncGetAttributes(&fa, tiled::tile_kernel<K, F, B>);
        if (err == cudaSuccess)
          err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              blocks, tiled::tile_kernel<K, F, B>, tiled::kThreads, smem);
        return (int)err;
      });
  if (e != 0) return e;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return 0;
}

// K1-K4 on rb lanes: lane l of img_t (rb, n_proj, nw, nh) at l * img_lane
// elements, of out (rb, ni, nj, nz) at l * out_lane, one shared mat; k
// chunks of 32*kpt planes (kpt 1, 2 or 4), window slots of win_rows rows
// (a multiple of 4) and stage 2 in `form` (0 linear: K1/K2; 1 two-hot:
// K3/K4). 1 <= rb <= 65535. See tiled::launch.
int bp_tile_launch_lanes(const float* img_t, const float* mat, float* out,
                         int rb, long long img_lane, long long out_lane,
                         int n_proj, int nw, int nh, int ni, int nj, int nz,
                         int kpt, int win_rows, int form, void* stream) {
  tiled::Args a{};
  a.img = img_t;
  a.mat = mat;
  a.out = out;
  a.img_lane = img_lane;
  a.out_lane = out_lane;
  a.n_proj = n_proj;
  a.nw = nw;
  a.nh = nh;
  a.ni = ni;
  a.nj = nj;
  a.nz = nz;
  a.win_rows = win_rows;
  a.view_cols = nw;
  return tiled::launch(a, rb, kpt, form, false, stream);
}

// K1-K4 on one lane: img_t (n_proj, nw, nh) -> out (ni, nj, nz).
int bp_tile_launch(const float* img_t, const float* mat, float* out,
                   int n_proj, int nw, int nh, int ni, int nj, int nz,
                   int kpt, int win_rows, int form, void* stream) {
  return bp_tile_launch_lanes(img_t, mat, out, 1, 0, 0, n_proj, nw, nh, ni,
                              nj, nz, kpt, win_rows, form, stream);
}

// K5/K6 on rb lanes: the linear form reading lane l of img_b (rb, n_proj,
// n_bands, 2*bw, nh) at l * img_lane elements, writing out (rb, ni, nj,
// nz) at l * out_lane, with one shared band (n_proj/group, ni/bi, nj/bj)
// int32 with values in [0, n_bands); nw is the TRUE detector width. The
// band tiles must divide the volume and bj be a multiple of 8, so the 8
// lines of a warp share one band tile; the bands must hold every image
// column. Plan and return as bp_tile_launch_lanes.
int bp_tile_launch_banded_lanes(const float* img_b, const float* mat,
                                const int* band, float* out, int rb,
                                long long img_lane, long long out_lane,
                                int n_proj, int nw, int nh, int ni, int nj,
                                int nz, int kpt, int win_rows, int bw,
                                int n_bands, int bi, int bj, int group,
                                void* stream) {
  if (band == nullptr || bw < 1 || n_bands < 1 || nw < 2 ||
      (nw - 1) / bw >= n_bands || bi < 1 || bj < 8 || bj % 8 || ni < 1 ||
      nj < 1 || ni % bi || nj % bj || group < 1 || n_proj % group ||
      (long long)n_bands * 2 * bw * nh > INT_MAX)
    return (int)cudaErrorInvalidValue;
  tiled::Args a{};
  a.img = img_b;
  a.mat = mat;
  a.out = out;
  a.band = band;
  a.img_lane = img_lane;
  a.out_lane = out_lane;
  a.n_proj = n_proj;
  a.nw = nw;
  a.nh = nh;
  a.ni = ni;
  a.nj = nj;
  a.nz = nz;
  a.win_rows = win_rows;
  a.view_cols = n_bands * 2 * bw;
  a.bw = bw;
  a.n_bti = ni / bi;
  a.n_btj = nj / bj;
  a.div_bw = bp::FastDiv(bw);
  a.div_bi = bp::FastDiv(bi);
  a.div_bj = bp::FastDiv(bj);
  a.div_group = bp::FastDiv(group);
  return tiled::launch(a, rb, kpt, tiled::kLinear, true, stream);
}

// K5/K6 on one lane: img_b (n_proj, n_bands, 2*bw, nh) -> out (ni, nj, nz).
int bp_tile_launch_banded(const float* img_b, const float* mat,
                          const int* band, float* out, int n_proj, int nw,
                          int nh, int ni, int nj, int nz, int kpt,
                          int win_rows, int bw, int n_bands, int bi, int bj,
                          int group, void* stream) {
  return bp_tile_launch_banded_lanes(img_b, mat, band, out, 1, 0, 0, n_proj,
                                     nw, nh, ni, nj, nz, kpt, win_rows, bw,
                                     n_bands, bi, bj, group, stream);
}

}  // extern "C"
