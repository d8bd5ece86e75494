// lk_level: one pyramid level of Lucas-Kanade for N points on Hopper.
//
// Replaces five TPU (Pallas) kernels and one XLA path:
//   - hackathonopticalflow_tpu/ops/lk_pallas3.py::lk_iterate_grid_lanes_packed
//     (grid top level, anchor-centred crop of margin iter_margin_top);
//   - hackathonopticalflow_tpu/ops/lk_pallas3.py::lk_iterate_grid_lanes
//     (grid lower levels and the tracker's points, crop centred at the
//     point's init; and its phase A, crops cut from grid-anchored slabs);
//   - hackathonopticalflow_tpu/ops/lk_pallas2.py::lk_iterate_grid (the
//     blocked grid kernel: grid-anchored slabs at every level);
//   - hackathonopticalflow_tpu/ops/lk_pallas.py::lk_iterate (the v1
//     per-point kernel: square slab, offsets from the clamped slab origin);
//   - hackathonopticalflow_tpu/ops/carve_pallas.py::gather_rects_panels
//     (the per-point crop carve): here a crop is only an origin rule;
//   - the exact path of hackathonopticalflow_tpu/ops/lk.py::_level_lk,
//     which reads each iteration's window straight from the plane.
// The TPU layouts (128-point lane blocks, 32-point sublane blocks,
// masked-roll ladders, int8 bias, u8-in-int32 packing, 8-px DMA origins)
// are Mosaic workarounds and are not carried over. The grid kernels'
// phase A (roll each slab to the crop at the point's coarse init, or
// freeze the point where the crop does not fit) is the caller's crop
// origin and `active0` mask.
//
// Design: a team of WARPS warps per point, K window pixels per lane,
// chosen by the wrapper from the window (ops/lk_level.py launch_shape): an
// iteration's latency grows with the pixels per lane, so up to 512 px take
// 2 per lane on up to 8 warps (the tracker's 15 x 15: 4 warps), larger
// windows 4 or 8 on 8 warps (the grid's 45 x 45: 8 x 8), where fewer
// reductions per pixel pay. One-warp teams are packed four to a block and
// never meet a block barrier. The team
//   1. loads the point's (3, win_h, win_w) template (every lane's loads in
//      flight at once, evict-first), keeps its gradients in registers as
//      integers on the 1/32 grid, and reduces the structure tensor and the
//      template's own share of b;
//   2. unless the point is inactive (bad template, or active0 false), runs
//      the Gauss-Newton iterations, each reading its (win_h+1, win_w+1)
//      window straight from the padded level plane (<= 9 MB at 1080p, it
//      stays in the 50 MB L2; L1 serves the overlap of neighbouring lanes
//      and iterations), and exits as soon as the point is inactive.
// Stream-batched calls (ops/lk_level.py): the planes are (nb, hp, wp) and
// the points stream-major, so point pt reads plane pt / (n / nb): one
// base-pointer offset per point, in every geometry; clamps and origins stay
// per plane. One launch serves every stream.
// Nothing is staged in shared memory. The crop geometries' window origin
// in the plane is the clamped crop origin plus the window's clamped offset
// in the crop, clamp(floor(tl) - crop base, 0, 2m), which names the very
// pixels the crop would hold; "exact" places its window at floor(tl + pad)
// as dynamic_slice does. Each geometry keeps its blend: value-first with
// the fraction tl - floor(tl) in the crop geometries, weights-first in
// "exact". A lane's pixels are tid, tid + 32*WARPS, ...: one division gives
// the first one's row and column, and a pointer steps from pixel to pixel.
//
// Sums: the callers' templates and window values lie on the 1/32 grid
// (|32 Ix|, |32 Iy| <= 4080 from Scharr's 1/32 scale on u8 frames, 32 x
// window and template values in [0, 8160]), so each product of the A and b
// sums, times 1024, is an integer below 2^25. b = sum(fix(v) g) - sum(iw g):
// the second sum is the template's, taken once, so the image template
// leaves the registers. A lane sums its <= 8 products in int32, a warp sums
// them exactly with redux.sync on their 16-bit halves, the team in int64;
// the total S becomes the float S / 1024 with one rounding. That is the
// float64 sum of the plain version, bit for bit, in any order. A window
// past the largest team's 2048 slots (46 x 46 and up) runs a walking team
// (WALK, 8 warps x 8 px): it covers the window in passes of 2048 pixels,
// reads each pass's template gradients again from global memory in every
// iteration, sums a pass's <= 8 products per lane in int32 and the passes
// in int64, so any window runs, exactly and slowly. Per warp the
// partial sums go to shared slots that alternate with the iteration's
// parity, so an iteration costs one barrier (none in a one-warp team).
// Build with -fmad=false: an FMA would round the bilinear blend differently
// from the plain version before the floor(v*32+0.5)/32 quantization.
//
// What bounds it on an H100: latency and instruction rate, not bytes. Per
// point: one round trip for the template (the byte bound: 24 KB of the
// 1080p grid's 56 MB per level), then <= 10 iterations of 4 L1 reads and
// ~30 instructions per window pixel and one team reduction. Every
// instantiation is held to 64 registers (a few spilled words at 8 px per
// lane), so 32 warps reside on an SM.
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700.00 W; device time
// per call, graph replay): the 1080p grid's levels (2304 points, 45 x 45,
// every geometry) 0.034-0.044 ms against byte bounds of 0.017-0.020 ms;
// the previous design (a 256-thread block per point, its crop staged in
// shared memory) took 0.067-0.118 ms in the same run. The tracker's
// levels (256 points, 15 x 15): 0.0048-0.0062 ms against 0.0004-0.0005
// ms; the previous design 0.0079-0.0099 ms. ptxas: 50-54 registers at 2
// px per lane on <= 4 warps, 62 on 8 warps, 64 at 4 and 8 px per lane (8
// x 8: 16-40 bytes spilled); resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): 4 blocks of 8 warps
// (32 warps), 9 of 4 warps or 18 of 2 (36).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float CV_SCALE = 1.0f / 1024.0f;
constexpr float FLT_EPS = 1.1920929e-07f;
constexpr float MAX_ORIGIN = 1073741824.0f;  // 2^30: exact origins saturate there
constexpr unsigned FULL = 0xffffffffu;

// geometry codes (ops/lk_level.py GEOMETRIES; "anchored" is CENTRED with
// active0)
constexpr int CENTRED = 0, V1 = 1, EXACT = 2;

// Threads per block: one team of WARPS warps, or four one-warp teams; and
// the blocks that must fit on an SM: 32 warps, so at most 64 registers per
// thread (ptxas spills a few words at 8 px per lane rather than halve the
// resident warps, which costs more).
template <int WARPS>
struct Block {
  static constexpr int threads = WARPS == 1 ? 128 : 32 * WARPS;
  static constexpr int min_blocks = 1024 / threads;
};

// Exact sum over the warp of int32 values whose total may pass 2^31: the
// low and high 16 bits are summed apart. Every lane receives the total.
__device__ __forceinline__ long long warp_sum(int v) {
  const unsigned lo = __reduce_add_sync(FULL, (unsigned)v & 0xffffu);
  const int hi = __reduce_add_sync(FULL, v >> 16);
  return ((long long)hi << 16) + (long long)lo;
}

// The same for int64 values below 2^57 in magnitude (a walking team's lane
// sums): two 16-bit pieces and the high word are summed apart.
__device__ __forceinline__ long long warp_sum(long long v) {
  const unsigned lo = __reduce_add_sync(FULL, (unsigned)v & 0xffffu);
  const unsigned mid = __reduce_add_sync(FULL, (unsigned)(v >> 16) & 0xffffu);
  const int hi = __reduce_add_sync(FULL, (int)(v >> 32));
  return ((long long)hi << 32) + ((long long)mid << 16) + (long long)lo;
}

// A lane's partial sums: int32 in a team whose slots hold the window, int64
// in a walking one.
template <bool WALK>
using LaneSum = typename std::conditional<WALK, long long, int>::type;

// Sums v[0..NV) over the team; every thread receives the totals. Teams of
// several warps pass one barrier: the warps' partial sums go to the shared
// slots of `parity`, which the team's next reduction does not write.
template <int WARPS, int NV, class T>
__device__ __forceinline__ void team_sum(const T (&v)[NV], long long (&s)[NV],
                                         long long (*red)[5][WARPS], int parity,
                                         int warp, int lane) {
#pragma unroll
  for (int q = 0; q < NV; ++q) s[q] = warp_sum(v[q]);
  if (WARPS > 1) {
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < NV; ++q) red[parity][q][warp] = s[q];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      long long t = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += red[parity][q][w];
      s[q] = t;
    }
  }
}

// An exact sum of products of 1/32-grid values, S / 1024, rounded to f32:
// S rounded once (scaling by 2^-10 is exact), as the plain version rounds
// its float64 sum.
__device__ __forceinline__ float grid_sum_f32(long long s) {
  return __fmul_rn(__ll2float_rn(s), 1.0f / 1024.0f);
}

__device__ __forceinline__ int to_grid(float v) {
  return __float2int_rn(__fmul_rn(v, 32.0f));
}

// floor(v * 32 + 0.5): the W_BITS-quantized window value, times 32.
__device__ __forceinline__ int fix32(float v) {
  return __float2int_rd(__fadd_rn(__fmul_rn(v, 32.0f), 0.5f));
}

// A lane's pixels in the window, tid + k * TEAM for k < K: the first one's
// offset from the window's origin in a plane of row stride wp, the step to
// the next one (step_wrap where it starts a new row: bit k of `wrap`), and
// how many lie inside the window.
struct Slots {
  int off0, step, step_wrap, nvalid;
  unsigned wrap;
};

template <int K>
__device__ __forceinline__ Slots lane_slots(int tid, int team, int win_w, int win_h, int wp) {
  const int r0 = tid / win_w, c0 = tid - r0 * win_w;  // the one division
  const int dr = team / win_w, dc = team - dr * win_w;
  Slots sl;
  // a lane past the window starts on its last row (and adds zeros)
  sl.off0 = min(r0, win_h - 1) * wp + c0;
  sl.step = dr * wp + dc;
  sl.step_wrap = sl.step + wp - win_w;
  sl.wrap = 0;
  sl.nvalid = 0;
  int r = r0, c = c0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (r < win_h) sl.nvalid = k + 1;
    r += dr;
    c += dc;
    if (c >= win_w) {
      c -= win_w;
      ++r;
      sl.wrap |= 1u << k;
    }
  }
  return sl;
}

// sb += sum over the lane's pixels of fix32(blend(s)) * (gx, gy), s the
// pixel's place in the window at `base`. With few pixels per lane
// (CLAMP_ROWS) the slots past the window are not skipped: they repeat the
// last pixel, whose product with their zero gradients adds nothing, and
// the loop has no branch; with 8 the branch costs fewer registers.
template <int K, class Blend>
__device__ __forceinline__ void window_sums(const float* base, const Slots& sl,
                                            const int (&gx)[K], const int (&gy)[K],
                                            Blend blend, int (&sb)[2]) {
  constexpr bool CLAMP_ROWS = K <= 4;
  const float* s = base + sl.off0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (CLAMP_ROWS || k < sl.nvalid) {
      const int q = fix32(blend(s));
      sb[0] += q * gx[k];
      sb[1] += q * gy[k];
    }
    if (k + 1 < sl.nvalid) s += (sl.wrap >> k & 1u) ? sl.step_wrap : sl.step;
  }
}

// A walking team (a window past the slots' 32 * WARPS * K pixels) covers the
// window in passes of TEAM * K pixels, the lane's pixels of a pass starting
// at p0 = pass origin + tid. Its template gradients do not fit in registers:
// each pass reads its own again (x32, 0 past the window), from L1 or L2.
template <int K, int TEAM>
__device__ __forceinline__ void pass_gradients(const float* t, int npix, int p0,
                                               int (&gx)[K], int (&gy)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = p0 + k * TEAM, pc = min(p, npix - 1);
    const float tx = __ldg(t + npix + pc), ty = __ldg(t + 2 * npix + pc);
    gx[k] = p < npix ? to_grid(tx) : 0;
    gy[k] = p < npix ? to_grid(ty) : 0;
  }
}

// sb += the lane's share of the b sums: window_sums over the lane's slots,
// or, in a walking team, over each pass in turn (each pass's <= K products
// summed in int32, the passes added in int64).
template <int K, int TEAM, bool WALK, class Blend>
__device__ __forceinline__ void b_sums(const float* base, const Slots& sl,
                                       const int (&gx)[K], const int (&gy)[K],
                                       const float* t, int tid, int win_w,
                                       int win_h, int wp, Blend blend,
                                       LaneSum<WALK> (&sb)[2]) {
  if constexpr (WALK) {
    const int npix = win_w * win_h;
    for (int c0 = 0; c0 < npix; c0 += TEAM * K) {
      int pgx[K], pgy[K];
      pass_gradients<K, TEAM>(t, npix, c0 + tid, pgx, pgy);
      const Slots ps = lane_slots<K>(c0 + tid, TEAM, win_w, win_h, wp);
      int s[2] = {0, 0};
      window_sums<K>(base, ps, pgx, pgy, blend, s);
      sb[0] += s[0];
      sb[1] += s[1];
    }
  } else {
    window_sums<K>(base, sl, gx, gy, blend, sb);
  }
}

template <int WARPS, int K, bool WALK, bool EXACT_BLEND>
__global__ void __launch_bounds__(Block<WARPS>::threads, Block<WARPS>::min_blocks)
lk_level_kernel(
    const float* __restrict__ tmpl,      // (N, 3, win_h, win_w)
    const float* __restrict__ plane,     // (nb, hp, wp) padded level planes
    int nb, int hp, int wp, int pad,
    const float* __restrict__ tl0,       // (N, 2) initial window top-left
    const int* __restrict__ crop_org,    // (N, 2) unpadded crop origin [x, y]
    const unsigned char* __restrict__ status0,  // (N,)
    const unsigned char* __restrict__ active0,  // (N,) or null: all active
    float* __restrict__ tl_out,          // (N, 2)
    unsigned char* __restrict__ status_out,     // (N,)
    int n, int geometry, int m, int win_w, int win_h, int level_w,
    int level_h, int max_iters, float eps2, int is_level0,
    float min_eig_threshold) {
  constexpr int TEAM = 32 * WARPS;
  __shared__ long long red[2][5][WARPS];

  const int pt = blockIdx.x * (Block<WARPS>::threads / TEAM) + threadIdx.x / TEAM;
  if (pt >= n) return;  // a whole one-warp team: no barrier follows
  const int tid = threadIdx.x % TEAM, lane = threadIdx.x & 31, warp = tid >> 5;
  const int npix = win_w * win_h;
  const Slots sl = lane_slots<K>(tid, TEAM, win_w, win_h, wp);
  // the point's stream: its plane (points are stream-major, n / nb each)
  const float* pl = plane + (size_t)(pt / (n / nb)) * hp * wp;

  // ---- 0. where the window lies at an estimate that passed the oob gate:
  // the crop's clamped origin in the plane (the gather_rects_panels carve,
  // as XLA's dynamic_slice clamps it) plus the window's clamped offset in
  // the crop, counted from the unclamped origin, or in v1 from the clamped
  // one (lk_pallas.py:106-107); in "exact" floor(tl + pad), placed as
  // dynamic_slice places it. Also the blend fractions.
  int ox0 = 0, oy0 = 0, cbx = 0, cby = 0;
  if (!EXACT_BLEND) {
    const int side = max(win_w, win_h) + 2 * m + 2;  // the v1 slab
    const int cw = geometry == V1 ? side : win_w + 1 + 2 * m;
    const int ch = geometry == V1 ? side : win_h + 1 + 2 * m;
    ox0 = min(max(crop_org[2 * pt] + pad, 0), wp - cw);
    oy0 = min(max(crop_org[2 * pt + 1] + pad, 0), hp - ch);
    cbx = geometry == V1 ? ox0 - pad : crop_org[2 * pt];
    cby = geometry == V1 ? oy0 - pad : crop_org[2 * pt + 1];
  }
  auto locate = [&](float x, float y, float& ax, float& ay) -> const float* {
    if (EXACT_BLEND) {
      const float px = __fadd_rn(x, (float)pad), py = __fadd_rn(y, (float)pad);
      const float fx = floorf(px), fy = floorf(py);
      ax = __fsub_rn(px, fx);
      ay = __fsub_rn(py, fy);
      int ix = (int)fminf(fmaxf(fx, -MAX_ORIGIN), MAX_ORIGIN);
      int iy = (int)fminf(fmaxf(fy, -MAX_ORIGIN), MAX_ORIGIN);
      if (ix < 0) ix += wp;
      if (iy < 0) iy += hp;
      ix = min(max(ix, 0), wp - win_w - 1);
      iy = min(max(iy, 0), hp - win_h - 1);
      return pl + (size_t)iy * wp + ix;
    }
    const float fx = floorf(x), fy = floorf(y);
    ax = __fsub_rn(x, fx);
    ay = __fsub_rn(y, fy);
    const int ox = min(max((int)fx - cbx, 0), 2 * m);  // fx passed the oob gate
    const int oy = min(max((int)fy - cby, 0), 2 * m);
    return pl + (size_t)(oy0 + oy) * wp + ox0 + ox;
  };

  // ---- 1. template gradients (registers, x32) + structure tensor ----
  // b = sum (fix(v) - iw) g = sum fix(v) g - sum iw g: the second sum is
  // the point's constant (a[3], a[4]), so the image template stays out of
  // the registers
  int gx[K], gy[K];
  long long a[5];
  const float* t = tmpl + (size_t)pt * 3 * npix;
  if constexpr (WALK) {
    // pass by pass, each pass's sums in int32, added in int64; the
    // gradients are read again in every iteration (b_sums)
    long long la[5] = {0, 0, 0, 0, 0};
    for (int c0 = 0; c0 < npix; c0 += TEAM * K) {
      int sa[5] = {0, 0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int p = c0 + tid + k * TEAM, pc = min(p, npix - 1);
        const float tw = __ldg(t + pc), tx = __ldg(t + npix + pc), ty = __ldg(t + 2 * npix + pc);
        const bool in = p < npix;
        const int iwk = in ? to_grid(tw) : 0;
        const int gxk = in ? to_grid(tx) : 0;
        const int gyk = in ? to_grid(ty) : 0;
        sa[0] += gxk * gxk;
        sa[1] += gxk * gyk;
        sa[2] += gyk * gyk;
        sa[3] += iwk * gxk;
        sa[4] += iwk * gyk;
      }
#pragma unroll
      for (int q = 0; q < 5; ++q) la[q] += sa[q];
    }
    team_sum<WARPS, 5>(la, a, red, 1, warp, lane);
  } else {
    int sa[5] = {0, 0, 0, 0, 0};  // Ix Ix, Ix Iy, Iy Iy, iw Ix, iw Iy (x 1024)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // every slot loads (a slot past the window its last pixel, then drops
      // it), so that all of a lane's loads are in flight at once
      const int p = tid + k * TEAM, pc = min(p, npix - 1);
      // (read once: evict-first, so the plane stays in L2)
      const float tw = __ldcs(t + pc), tx = __ldcs(t + npix + pc), ty = __ldcs(t + 2 * npix + pc);
      const bool in = p < npix;
      const int iwk = in ? to_grid(tw) : 0;
      const int gxk = in ? to_grid(tx) : 0;
      const int gyk = in ? to_grid(ty) : 0;
      gx[k] = gxk;
      gy[k] = gyk;
      sa[0] += gxk * gxk;
      sa[1] += gxk * gyk;
      sa[2] += gyk * gyk;
      sa[3] += iwk * gxk;
      sa[4] += iwk * gyk;
    }
    team_sum<WARPS, 5>(sa, a, red, 1, warp, lane);
  }
  const float a11 = __fmul_rn(grid_sum_f32(a[0]), CV_SCALE);
  const float a12 = __fmul_rn(grid_sum_f32(a[1]), CV_SCALE);
  const float a22 = __fmul_rn(grid_sum_f32(a[2]), CV_SCALE);
  const float det = a11 * a22 - a12 * a12;
  const float dd = a11 - a22;
  const float min_eig =
      (a22 + a11 - sqrtf(dd * dd + 4.0f * a12 * a12)) / (2.0f * win_w * win_h);
  const bool bad = (min_eig < min_eig_threshold) || (det < FLT_EPS);
  const float inv_det = det > 0.0f ? 1.0f / det : 0.0f;

  // a bad template kills status at level 0; an inactive point (active0
  // false: its crop does not fit in its slab) keeps both its status and
  // tl0 (lk_pallas2.py:221-227, lk_pallas3.py:290-293)
  bool status = status0[pt] != 0;
  if (is_level0 && bad) status = false;
  float tlx = tl0[2 * pt], tly = tl0[2 * pt + 1];
  const bool live = !bad && (active0 == nullptr || active0[pt] != 0);

  if (live) {
    // ---- 3. Gauss-Newton iterations ----
    float pdx = 0.0f, pdy = 0.0f;
    for (int j = 0; j < max_iters; ++j) {
      const float ixf = floorf(tlx), iyf = floorf(tly);
      if (ixf < (float)-win_w || ixf >= (float)level_w ||
          iyf < (float)-win_h || iyf >= (float)level_h) {
        if (is_level0) status = false;
        break;
      }
      LaneSum<WALK> sb[2] = {0, 0};
      float ax, ay;
      const float* base = locate(tlx, tly, ax, ay);
      const float bx = __fsub_rn(1.0f, ax), by = __fsub_rn(1.0f, ay);
      if (EXACT_BLEND) {
        // weights formed first (JAX blend_bilinear), as csrc/patch_bilinear.cu
        const float w00 = __fmul_rn(bx, by), w10 = __fmul_rn(ax, by);
        const float w01 = __fmul_rn(bx, ay), w11 = __fmul_rn(ax, ay);
        b_sums<K, TEAM, WALK>(base, sl, gx, gy, t, tid, win_w, win_h, wp,
                              [&](const float* p) {
                                float v = __fmul_rn(__ldg(p), w00);
                                v = __fadd_rn(v, __fmul_rn(__ldg(p + 1), w10));
                                v = __fadd_rn(v, __fmul_rn(__ldg(p + wp), w01));
                                return __fadd_rn(v, __fmul_rn(__ldg(p + wp + 1), w11));
                              },
                              sb);
      } else {
        // value first (the Pallas kernels' _blend)
        b_sums<K, TEAM, WALK>(base, sl, gx, gy, t, tid, win_w, win_h, wp,
                              [&](const float* p) {
                                float v = __fmul_rn(__fmul_rn(__ldg(p), bx), by);
                                v = __fadd_rn(v, __fmul_rn(__fmul_rn(__ldg(p + 1), ax), by));
                                v = __fadd_rn(v, __fmul_rn(__fmul_rn(__ldg(p + wp), bx), ay));
                                return __fadd_rn(v, __fmul_rn(__fmul_rn(__ldg(p + wp + 1), ax), ay));
                              },
                              sb);
      }
      long long b[2];
      team_sum<WARPS, 2>(sb, b, red, j & 1, warp, lane);
      const float b1 = __fmul_rn(grid_sum_f32(b[0] - a[3]), CV_SCALE);
      const float b2 = __fmul_rn(grid_sum_f32(b[1] - a[4]), CV_SCALE);
      const float dx = (a12 * b2 - a22 * b1) * inv_det;
      const float dy = (a12 * b1 - a11 * b2) * inv_det;
      tlx += dx;
      tly += dy;
      const bool converged = dx * dx + dy * dy <= eps2;
      // converged wins over oscillation (OpenCV checks eps first)
      const bool osc = j > 0 && !converged && fabsf(dx + pdx) < 0.01f &&
                       fabsf(dy + pdy) < 0.01f;
      if (osc) {
        tlx -= dx * 0.5f;
        tly -= dy * 0.5f;
      }
      if (converged || osc) break;
      pdx = dx;
      pdy = dy;
    }
  }
  if (tid == 0) {
    tl_out[2 * pt] = tlx;
    tl_out[2 * pt + 1] = tly;
    status_out[pt] = status ? 1 : 0;
  }
}

using KernelFn = decltype(&lk_level_kernel<1, 2, false, false>);

// The instantiation for (warps, k, walk) and the blend, and its threads per
// block; null for a shape ops/lk_level.py does not name (LAUNCH_SHAPES, and
// WALK_SHAPE with walk).
KernelFn pick(int warps, int k, bool walk, bool exact, int* threads) {
#define LK_PICK(W, KK, WALK)                                                  \
  if (warps == W && k == KK && walk == WALK) {                                \
    *threads = Block<W>::threads;                                             \
    return exact ? lk_level_kernel<W, KK, WALK, true> : lk_level_kernel<W, KK, WALK, false>; \
  }
#define LK_SHAPE(W, KK) LK_PICK(W, KK, false)
#define LK_WALK(W, KK) LK_PICK(W, KK, true)
  LK_SHAPE(1, 2)
  LK_SHAPE(2, 2)
  LK_SHAPE(4, 2)
  LK_SHAPE(8, 2)
  LK_SHAPE(8, 4)
  LK_SHAPE(8, 8)
  LK_WALK(8, 8)
#undef LK_WALK
#undef LK_SHAPE
#undef LK_PICK
  return nullptr;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// geometry: CENTRED (0), V1 (1) or EXACT (2); active0 may be null; plane
// holds nb planes of hp x wp, and nb divides n (n / nb points each);
// (warps, k): the team shape, one of ops/lk_level.py::LAUNCH_SHAPES with
// 32 * warps * k >= win_w * win_h, or with walk its WALK_SHAPE, which takes
// any window.
extern "C" int lk_level_launch(
    const float* tmpl, const float* plane, int nb, int hp, int wp, int pad,
    const float* tl0, const int* crop_org, const unsigned char* status0,
    const unsigned char* active0, float* tl_out, unsigned char* status_out,
    int n, int m, int win_w, int win_h, int level_w, int level_h,
    int max_iters, float eps2, int is_level0, float min_eig_threshold,
    int geometry, int warps, int k, int walk, void* stream) {
  if (geometry < CENTRED || geometry > EXACT || nb < 1 || n % nb != 0)
    return (int)cudaErrorInvalidValue;
  int threads = 0;
  const KernelFn fn = pick(warps, k, walk != 0, geometry == EXACT, &threads);
  if (fn == nullptr || (!walk && 32 * warps * k < win_w * win_h)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int teams = threads / (32 * warps);
  fn<<<(n + teams - 1) / teams, threads, 0, (cudaStream_t)stream>>>(
      tmpl, plane, nb, hp, wp, pad, tl0, crop_org, status0, active0, tl_out,
      status_out, n, geometry, m, win_w, win_h, level_w, level_h, max_iters,
      eps2, is_level0, min_eig_threshold);
  return (int)cudaGetLastError();
}

// The instantiation's registers and local bytes per thread, threads per
// block and resident blocks per SM.
extern "C" int lk_level_occupancy(int warps, int k, int walk, int exact, int* threads,
                                  int* blocks_per_sm, int* regs,
                                  int* local_bytes) {
  const KernelFn fn = pick(warps, k, walk != 0, exact != 0, threads);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                            *threads, 0);
}
