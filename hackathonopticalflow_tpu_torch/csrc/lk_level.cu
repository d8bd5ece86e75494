// lk_level: one pyramid level of Lucas-Kanade for N points on Hopper.
//
// Replaces four TPU (Pallas) kernels:
//   - hackathonopticalflow_tpu/ops/lk_pallas3.py::lk_iterate_grid_lanes_packed
//     (grid top level, anchor-centred crop of margin iter_margin_top);
//   - hackathonopticalflow_tpu/ops/lk_pallas3.py::lk_iterate_grid_lanes
//     (grid lower levels and the tracker's points, crop centred at the
//     point's init);
//   - hackathonopticalflow_tpu/ops/lk_pallas.py::lk_iterate (the v1
//     per-point kernel: square slab, offsets from the clamped slab origin;
//     the `v1` flag below);
//   - hackathonopticalflow_tpu/ops/carve_pallas.py::gather_rects_panels
//     (the per-point crop carve): here each block loads its own crop.
// The TPU layouts (128-point lane blocks, 32-point sublane blocks,
// masked-roll ladders, int8 bias, u8-in-int32 packing, 8-px DMA origins)
// are Mosaic workarounds and are not carried over.
//
// Design: one thread block per point. The block
//   1. keeps the point's (3, win_h, win_w) template in registers (each
//      thread owns at most MAXK pixels) and reduces the structure tensor;
//   2. loads the point's crop of the padded level plane into shared
//      memory, (win_h+1+2m, win_w+1+2m), or a square of max(win)+2m+2 in
//      the v1 geometry, its origin clamped into the plane as XLA's
//      dynamic_slice clamps it (a dead point never faults);
//   3. runs the Gauss-Newton iterations out of shared memory and stops as
//      soon as the point is inactive.
// Every window value and template value lies on the 1/32 grid, so the
// products in the A and b sums are exact in double precision, and so are
// the sums: they are accumulated in double, which makes the result
// independent of the summation order (deterministic, and bit-identical to
// the plain PyTorch version, which sums in float64 too). Build with
// -fmad=false: an FMA would round the bilinear blend differently from the
// plain version before the floor(v*32+0.5)/32 quantization.
//
// What bounds it on an H100: per point a crop of 29.6 KB (m=20) or
// 48.4 KB (m=32) of float32 read through L2 (the level plane, <= 9 MB at
// 1080p, stays resident in the 50 MB L2), then <= 10 iterations of
// 4 shared-memory loads and ~20 flops per window pixel plus two block
// reductions. At 2304 points the grid is ~17 waves of blocks over 132 SMs;
// the block reductions' latency and the crop load dominate, not bandwidth.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;   // threads per block
constexpr int NW = NT / 32;
constexpr int MAXK = 8;   // window pixels per thread: win_w*win_h <= NT*MAXK
constexpr float CV_SCALE = 1.0f / 1024.0f;
constexpr float FLT_EPS = 1.1920929e-07f;

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

__global__ void __launch_bounds__(NT) lk_level_kernel(
    const float* __restrict__ tmpl,      // (N, 3, win_h, win_w)
    const float* __restrict__ plane,     // (hp, wp) padded level plane
    int hp, int wp, int pad,
    const float* __restrict__ tl0,       // (N, 2) initial window top-left
    const int* __restrict__ crop_org,    // (N, 2) unpadded crop origin [x, y]
    const unsigned char* __restrict__ status0,  // (N,)
    float* __restrict__ tl_out,          // (N, 2)
    unsigned char* __restrict__ status_out,     // (N,)
    int m, int win_w, int win_h, int level_w, int level_h, int max_iters,
    float eps2, int is_level0, float min_eig_threshold, int v1) {
  extern __shared__ float crop[];
  __shared__ double red[3][NW];

  const int pt = blockIdx.x;
  const int tid = threadIdx.x;
  const int npix = win_w * win_h;
  const int side = max(win_w, win_h) + 2 * m + 2;  // the v1 slab
  const int cw = v1 ? side : win_w + 1 + 2 * m;
  const int ch = v1 ? side : win_h + 1 + 2 * m;

  // ---- 1. template (registers) + structure tensor ----
  float iw[MAXK], ixw[MAXK], iyw[MAXK];
  int off[MAXK];  // r * cw + c: the pixel's place in a crop row-major
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

  bool status = status0[pt] != 0;
  if (is_level0 && bad) status = false;
  float tlx = tl0[2 * pt], tly = tl0[2 * pt + 1];

  if (!bad) {
    // ---- 2. the point's crop (the gather_rects_panels carve) ----
    const int ox0 = min(max(crop_org[2 * pt] + pad, 0), wp - cw);
    const int oy0 = min(max(crop_org[2 * pt + 1] + pad, 0), hp - ch);
    // window offsets count from the unclamped origin, or in v1 from the
    // clamped one (lk_pallas.py:106-107)
    const int cbx = v1 ? ox0 - pad : crop_org[2 * pt];
    const int cby = v1 ? oy0 - pad : crop_org[2 * pt + 1];
    for (int i = tid; i < cw * ch; i += NT) {
      const int r = i / cw, c = i - r * cw;
      crop[i] = plane[(size_t)(oy0 + r) * wp + ox0 + c];
    }
    __syncthreads();

    // ---- 3. Gauss-Newton iterations ----
    float pdx = 0.0f, pdy = 0.0f;
    for (int j = 0; j < max_iters; ++j) {
      const float ixf = floorf(tlx), iyf = floorf(tly);
      if (ixf < (float)-win_w || ixf >= (float)level_w ||
          iyf < (float)-win_h || iyf >= (float)level_h) {
        if (is_level0) status = false;
        break;
      }
      const float ax = tlx - ixf, ay = tly - iyf;
      const float bx = 1.0f - ax, by = 1.0f - ay;
      const int ox = min(max((int)ixf - cbx, 0), 2 * m);
      const int oy = min(max((int)iyf - cby, 0), 2 * m);
      const float* base = crop + oy * cw + ox;
      double b[2] = {0.0, 0.0};
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

}  // namespace

extern "C" int lk_level_launch(
    const float* tmpl, const float* plane, int hp, int wp, int pad,
    const float* tl0, const int* crop_org, const unsigned char* status0,
    float* tl_out, unsigned char* status_out, int n, int m, int win_w,
    int win_h, int level_w, int level_h, int max_iters, float eps2,
    int is_level0, float min_eig_threshold, int v1, void* stream) {
  if (n == 0) return 0;
  const size_t side = (size_t)((win_w > win_h ? win_w : win_h) + 2 * m + 2);
  const size_t smem =
      v1 ? sizeof(float) * side * side
         : sizeof(float) * (size_t)(win_w + 1 + 2 * m) * (size_t)(win_h + 1 + 2 * m);
  // raise the kernel's shared-memory limit only when a launch needs more,
  // so that launches captured into a CUDA graph make no such call
  static size_t smem_limit = 0;
  if (smem > smem_limit) {
    cudaError_t err = cudaFuncSetAttribute(
        lk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_limit = smem;
  }
  lk_level_kernel<<<n, NT, smem, (cudaStream_t)stream>>>(
      tmpl, plane, hp, wp, pad, tl0, crop_org, status0, tl_out, status_out, m,
      win_w, win_h, level_w, level_h, max_iters, eps2, is_level0,
      min_eig_threshold, v1);
  return (int)cudaGetLastError();
}

extern "C" int lk_level_max_pixels() { return NT * MAXK; }
