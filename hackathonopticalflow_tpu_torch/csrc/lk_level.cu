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
//     (the per-point crop carve): here each block loads its own crop;
//   - the exact path of hackathonopticalflow_tpu/ops/lk.py::_level_lk,
//     which reads each iteration's window straight from the plane.
// The TPU layouts (128-point lane blocks, 32-point sublane blocks,
// masked-roll ladders, int8 bias, u8-in-int32 packing, 8-px DMA origins)
// are Mosaic workarounds and are not carried over. The grid kernels'
// phase A (roll each slab to the crop at the point's coarse init, or
// freeze the point where the crop does not fit) is the caller's crop
// origin and `active0` mask: the crop is loaded from the plane directly.
//
// Design: one thread block per point. The block
//   1. keeps the point's (3, win_h, win_w) template in registers (each
//      thread owns at most MAXK pixels) and reduces the structure tensor;
//   2. unless the point is inactive (bad template, or active0 false),
//      loads its crop of the padded level plane into shared memory,
//      (win_h+1+2m, win_w+1+2m), or a square of max(win)+2m+2 in the v1
//      geometry, its origin clamped into the plane as XLA's dynamic_slice
//      clamps it (a dead point never faults); the exact geometry stages
//      nothing and reads each window from the plane (L2-resident);
//   3. runs the Gauss-Newton iterations and stops as soon as the point is
//      inactive.
// Every window value and template value lies on the 1/32 grid, so the
// products in the A and b sums are exact in double precision, and so are
// the sums: they are accumulated in double, which makes the result
// independent of the summation order (deterministic, and bit-identical to
// the plain PyTorch version, which sums in float64 too). Build with
// -fmad=false: an FMA would round the bilinear blend differently from the
// plain version before the floor(v*32+0.5)/32 quantization.
//
// What bounds it on an H100: per point a crop of 19.6 KB (m=12), 29.6 KB
// (m=20) or 48.4 KB (m=32) of float32 read through L2 (the level plane,
// <= 9 MB at 1080p, stays resident in the 50 MB L2), then <= 10
// iterations of 4 loads and ~20 flops per window pixel plus two block
// reductions. At 2304 points the grid is ~17 waves of blocks over 132 SMs;
// the block reductions' latency and the crop load dominate, not bandwidth.
// The exact geometry trades the crop load for 4 L2 reads per window pixel
// and iteration.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;   // threads per block
constexpr int NW = NT / 32;
constexpr int MAXK = 8;   // window pixels per thread: win_w*win_h <= NT*MAXK
constexpr float CV_SCALE = 1.0f / 1024.0f;
constexpr float FLT_EPS = 1.1920929e-07f;
constexpr float MAX_ORIGIN = 1073741824.0f;  // 2^30: exact origins saturate there

// geometry codes (ops/lk_level.py GEOMETRIES; "anchored" is CENTRED with
// active0)
constexpr int CENTRED = 0, V1 = 1, EXACT = 2;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums v0, v1, v2 over the block; every thread receives the totals.
template <int NV>
__device__ __forceinline__ void block_sum(double (&v)[NV], double (*red)[NW]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    double s = warp_sum(v[k]);
    if (lane == 0) red[k][warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[k][w];
    v[k] = s;
  }
  __syncthreads();  // red is reused by the next reduction
}

__device__ __forceinline__ float fix32(float v) {
  return floorf(__fadd_rn(__fmul_rn(v, 32.0f), 0.5f)) * (1.0f / 32.0f);
}

template <int GEOM>
__global__ void __launch_bounds__(NT) lk_level_kernel(
    const float* __restrict__ tmpl,      // (N, 3, win_h, win_w)
    const float* __restrict__ plane,     // (hp, wp) padded level plane
    int hp, int wp, int pad,
    const float* __restrict__ tl0,       // (N, 2) initial window top-left
    const int* __restrict__ crop_org,    // (N, 2) unpadded crop origin [x, y]
    const unsigned char* __restrict__ status0,  // (N,)
    const unsigned char* __restrict__ active0,  // (N,) or null: all active
    float* __restrict__ tl_out,          // (N, 2)
    unsigned char* __restrict__ status_out,     // (N,)
    int m, int win_w, int win_h, int level_w, int level_h, int max_iters,
    float eps2, int is_level0, float min_eig_threshold) {
  extern __shared__ float crop[];
  __shared__ double red[3][NW];

  const int pt = blockIdx.x;
  const int tid = threadIdx.x;
  const int npix = win_w * win_h;
  const int side = max(win_w, win_h) + 2 * m + 2;  // the v1 slab
  // row stride of what windows are read from: the crop, or the plane
  const int cw = GEOM == V1 ? side : GEOM == EXACT ? wp : win_w + 1 + 2 * m;
  const int ch = GEOM == V1 ? side : win_h + 1 + 2 * m;

  // ---- 1. template (registers) + structure tensor ----
  float iw[MAXK], ixw[MAXK], iyw[MAXK];
  int off[MAXK];  // r * cw + c: the pixel's place in a window row-major
  double a[3] = {0.0, 0.0, 0.0};
  const float* t = tmpl + (size_t)pt * 3 * npix;
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    const int p = tid + k * NT;
    if (p < npix) {
      iw[k] = t[p];
      ixw[k] = t[npix + p];
      iyw[k] = t[2 * npix + p];
      off[k] = (p / win_w) * cw + (p % win_w);
    } else {
      iw[k] = ixw[k] = iyw[k] = 0.0f;
      off[k] = 0;
    }
    a[0] += (double)ixw[k] * (double)ixw[k];
    a[1] += (double)ixw[k] * (double)iyw[k];
    a[2] += (double)iyw[k] * (double)iyw[k];
  }
  block_sum<3>(a, red);
  const float a11 = __fmul_rn((float)a[0], CV_SCALE);
  const float a12 = __fmul_rn((float)a[1], CV_SCALE);
  const float a22 = __fmul_rn((float)a[2], CV_SCALE);
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
    // ---- 2. the point's crop (the gather_rects_panels carve) ----
    int cbx = 0, cby = 0;
    if (GEOM != EXACT) {
      const int ox0 = min(max(crop_org[2 * pt] + pad, 0), wp - cw);
      const int oy0 = min(max(crop_org[2 * pt + 1] + pad, 0), hp - ch);
      // window offsets count from the unclamped origin, or in v1 from the
      // clamped one (lk_pallas.py:106-107)
      cbx = GEOM == V1 ? ox0 - pad : crop_org[2 * pt];
      cby = GEOM == V1 ? oy0 - pad : crop_org[2 * pt + 1];
      for (int i = tid; i < cw * ch; i += NT) {
        const int r = i / cw, c = i - r * cw;
        crop[i] = plane[(size_t)(oy0 + r) * wp + ox0 + c];
      }
      __syncthreads();
    }

    // ---- 3. Gauss-Newton iterations ----
    float pdx = 0.0f, pdy = 0.0f;
    for (int j = 0; j < max_iters; ++j) {
      const float ixf = floorf(tlx), iyf = floorf(tly);
      if (ixf < (float)-win_w || ixf >= (float)level_w ||
          iyf < (float)-win_h || iyf >= (float)level_h) {
        if (is_level0) status = false;
        break;
      }
      double b[2] = {0.0, 0.0};
      if (GEOM == EXACT) {
        // JAX extract_patches(plane, tl + pad): origin floor(tl + pad),
        // placed as dynamic_slice places it; weights formed first
        // (blend_bilinear), as csrc/patch_bilinear.cu
        const float px = __fadd_rn(tlx, (float)pad), py = __fadd_rn(tly, (float)pad);
        const float fx = floorf(px), fy = floorf(py);
        const float ax = __fsub_rn(px, fx), ay = __fsub_rn(py, fy);
        int ix = (int)fminf(fmaxf(fx, -MAX_ORIGIN), MAX_ORIGIN);
        int iy = (int)fminf(fmaxf(fy, -MAX_ORIGIN), MAX_ORIGIN);
        if (ix < 0) ix += wp;
        if (iy < 0) iy += hp;
        ix = min(max(ix, 0), wp - win_w - 1);
        iy = min(max(iy, 0), hp - win_h - 1);
        const float bx = __fsub_rn(1.0f, ax), by = __fsub_rn(1.0f, ay);
        const float w00 = __fmul_rn(bx, by), w10 = __fmul_rn(ax, by);
        const float w01 = __fmul_rn(bx, ay), w11 = __fmul_rn(ax, ay);
        const float* base = plane + (size_t)iy * wp + ix;
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          const float* s = base + off[k];
          float v = __fmul_rn(__ldg(s), w00);
          v = __fadd_rn(v, __fmul_rn(__ldg(s + 1), w10));
          v = __fadd_rn(v, __fmul_rn(__ldg(s + cw), w01));
          v = __fadd_rn(v, __fmul_rn(__ldg(s + cw + 1), w11));
          const double diff = (double)__fsub_rn(fix32(v), iw[k]);
          // pixels past npix carry zero gradients and add exact zeros
          b[0] += diff * (double)ixw[k];
          b[1] += diff * (double)iyw[k];
        }
      } else {
        const float ax = tlx - ixf, ay = tly - iyf;
        const float bx = 1.0f - ax, by = 1.0f - ay;
        const int ox = min(max((int)ixf - cbx, 0), 2 * m);
        const int oy = min(max((int)iyf - cby, 0), 2 * m);
        const float* base = crop + oy * cw + ox;
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          const float* s = base + off[k];
          float v = __fmul_rn(__fmul_rn(s[0], bx), by);
          v = __fadd_rn(v, __fmul_rn(__fmul_rn(s[1], ax), by));
          v = __fadd_rn(v, __fmul_rn(__fmul_rn(s[cw], bx), ay));
          v = __fadd_rn(v, __fmul_rn(__fmul_rn(s[cw + 1], ax), ay));
          const double diff = (double)__fsub_rn(fix32(v), iw[k]);
          // pixels past npix carry zero gradients and add exact zeros
          b[0] += diff * (double)ixw[k];
          b[1] += diff * (double)iyw[k];
        }
      }
      block_sum<2>(b, red);
      const float b1 = __fmul_rn((float)b[0], CV_SCALE);
      const float b2 = __fmul_rn((float)b[1], CV_SCALE);
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

template <int GEOM>
int launch(const float* tmpl, const float* plane, int hp, int wp, int pad,
           const float* tl0, const int* crop_org, const unsigned char* status0,
           const unsigned char* active0, float* tl_out,
           unsigned char* status_out, int n, int m, int win_w, int win_h,
           int level_w, int level_h, int max_iters, float eps2, int is_level0,
           float min_eig_threshold, cudaStream_t stream) {
  const size_t side = (size_t)((win_w > win_h ? win_w : win_h) + 2 * m + 2);
  const size_t smem =
      GEOM == EXACT ? 0
      : GEOM == V1  ? sizeof(float) * side * side
                    : sizeof(float) * (size_t)(win_w + 1 + 2 * m) *
                          (size_t)(win_h + 1 + 2 * m);
  // raise the kernel's shared-memory limit only when a launch needs more,
  // so that launches captured into a CUDA graph make no such call
  static size_t smem_limit = 0;
  if (smem > smem_limit) {
    cudaError_t err = cudaFuncSetAttribute(
        lk_level_kernel<GEOM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_limit = smem;
  }
  lk_level_kernel<GEOM><<<n, NT, smem, stream>>>(
      tmpl, plane, hp, wp, pad, tl0, crop_org, status0, active0, tl_out,
      status_out, m, win_w, win_h, level_w, level_h, max_iters, eps2,
      is_level0, min_eig_threshold);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// geometry: CENTRED (0), V1 (1) or EXACT (2); active0 may be null.
extern "C" int lk_level_launch(
    const float* tmpl, const float* plane, int hp, int wp, int pad,
    const float* tl0, const int* crop_org, const unsigned char* status0,
    const unsigned char* active0, float* tl_out, unsigned char* status_out,
    int n, int m, int win_w, int win_h, int level_w, int level_h,
    int max_iters, float eps2, int is_level0, float min_eig_threshold,
    int geometry, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (geometry) {
    case CENTRED:
      return launch<CENTRED>(tmpl, plane, hp, wp, pad, tl0, crop_org, status0,
                             active0, tl_out, status_out, n, m, win_w, win_h,
                             level_w, level_h, max_iters, eps2, is_level0,
                             min_eig_threshold, s);
    case V1:
      return launch<V1>(tmpl, plane, hp, wp, pad, tl0, crop_org, status0,
                        active0, tl_out, status_out, n, m, win_w, win_h,
                        level_w, level_h, max_iters, eps2, is_level0,
                        min_eig_threshold, s);
    case EXACT:
      return launch<EXACT>(tmpl, plane, hp, wp, pad, tl0, crop_org, status0,
                           active0, tl_out, status_out, n, m, win_w, win_h,
                           level_w, level_h, max_iters, eps2, is_level0,
                           min_eig_threshold, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int lk_level_max_pixels() { return NT * MAXK; }
