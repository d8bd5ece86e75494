// warp_bilinear: bilinear sample of C channels at absolute coordinates on
// Hopper, the Farneback coefficient warp, in two geometries.
//
// Replaces the TPU (Pallas) kernel
//   hackathonopticalflow_tpu/ops/warp_pallas.py::warp_bilinear_pallas
// and the exact gather of hackathonopticalflow_tpu/ops/farneback.py
// (warp_mode "exact" and "packed"). Per pixel, for both geometries,
//   x0 = clamp(floor(fx), 0, W-2), y0 = clamp(floor(fy), 0, H-2),
//   ax = clamp(fx - x0, 0, 1),     ay = clamp(fy - y0, 0, 1).
//
// "gather" (warp_mode "exact", "packed", "hybrid"): the four corners at
// (y0, x0), the weights formed first and the four terms summed in order,
//   out[c] = v00 (1-ax)(1-ay) + v10 ax(1-ay) + v01 (1-ax)ay + v11 ax ay.
//
// "slab" (warp_mode "pallas", "pallas_bf16"): the function the Pallas
// kernel computes. Its output is tiled (8, 128); per tile it DMAs one
// (C, 96, 384) slab at the tile's minimum sample and clamps every sample
// that lies more than 72 rows / 128 columns past that minimum to the slab
// edge (warp_pallas.py:231-286). Per pixel (r, c), il = r % 8, jl = c % 128:
//   dy = y0 + 72 - il, dx = x0 + 128 - jl; over the tile's pixels inside
//   the image, ymin = min dy, xmin = min dx; by = 8 floor(ymin / 8),
//   bx = 128 floor(xmin / 128), rx0 = xmin - bx;
//   yi = min(dy - by, 80), xi = min(dx - bx, rx0 + 128);
//   ys = by + yi + il - 72, xs = bx + xi + jl - 128;
//   xb0 = (1-ax) t(ys, xs) + ax t(ys, xs+1), xb1 likewise at row ys+1,
//   out = xb0 (1-ay) + xb1 ay  (x-lerp, then y-lerp, as the TPU kernel).
// Within the margins ys = y0 and xs = x0. A clamped sample lies between
// the slab's base and the pixel's own corner: a clamped row is
// ys = by + 8 + il with by >= 64 (ymin >= 65), and ys < y0 <= H-2; a
// clamped column is xs = xmin + jl with xmin >= 1, and xs < x0 <= W-2. So
// every corner is inside the plane and the TPU slab's zero padding is
// never read: no bounds test.
//
// Source type: float32 or bfloat16 (warp_mode "pallas_bf16": the source
// rounded to bf16 once per level, as the TPU's bf16 slab; blended in
// float32). Every product and sum is rounded on its own (__fmul_rn /
// __fadd_rn, and the library is built with -fmad=false), as the separate
// PyTorch ops of ops/warp_bilinear.py's plain versions round them: the two
// agree bit for bit.
//
// Design. gather: one thread per output pixel of a (B, H, W) grid, a loop
// over the C channels inside. slab: one block of 8 x 128 threads per
// (8, 128) output tile and batch row, a thread per pixel; the tile's two
// minima by warp shuffles and one step through shared memory; each pixel
// then reads its four corners per channel through __ldg from the plane.
// Nothing is staged: neighbouring threads sample neighbouring source
// pixels (the flow is smooth), so a warp's corner loads fall in a few
// cache lines of each channel plane.
//
// What bounds it on an H100: memory. Per pixel it reads fx, fy (8 B) and
// C source values (C = 5: 20 B in float32, 10 B in bf16; each is a corner
// of about four output pixels, so the corner loads are mostly L1/L2 hits)
// and writes C floats (20 B). At 720p that is 44 MB (float32) or 35 MB
// (bf16) of HBM traffic, 13 us or 10.5 us at 3.35 TB/s; the corner loads
// are not coalesced where the flow varies, so the kernel reaches a
// fraction of that bound.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block, gather
constexpr int TH = 8, TW = 128;  // the TPU kernel's output tile
constexpr int PADT = 72, PADL = 128;  // its row and column margins
constexpr int YI_MAX = 80;  // its last slab row offset (RYC - 1)
constexpr int NWARP = TH * TW / 32;

// bf16 sources are read as their 16 bits; widening to float32 is exact
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const unsigned short* p) {
  return __uint_as_float(((unsigned int)__ldg(p)) << 16);
}

struct Corner {
  int x0, y0;
  float ax, ay;
};

__device__ __forceinline__ Corner corner(float x, float y, int h, int w) {
  Corner k;
  const float x0 = fminf(fmaxf(floorf(x), 0.0f), (float)(w - 2));
  const float y0 = fminf(fmaxf(floorf(y), 0.0f), (float)(h - 2));
  k.ax = fminf(fmaxf(__fsub_rn(x, x0), 0.0f), 1.0f);
  k.ay = fminf(fmaxf(__fsub_rn(y, y0), 0.0f), 1.0f);
  k.x0 = (int)x0;
  k.y0 = (int)y0;
  return k;
}

template <typename T>
__global__ void __launch_bounds__(NT) warp_gather_kernel(
    const T* __restrict__ src,     // (B, C, H, W)
    const float* __restrict__ fx,  // (B, H, W)
    const float* __restrict__ fy,  // (B, H, W)
    float* __restrict__ out,       // (B, C, H, W)
    long long n_pix,               // B * H * W
    int c, int h, int w) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= n_pix) return;
  const long long hw = (long long)h * w;
  const long long b = i / hw;
  const long long p = i - b * hw;

  const Corner k = corner(fx[i], fy[i], h, w);
  const float bx = __fsub_rn(1.0f, k.ax);
  const float by = __fsub_rn(1.0f, k.ay);
  const float w00 = __fmul_rn(bx, by);
  const float w10 = __fmul_rn(k.ax, by);
  const float w01 = __fmul_rn(bx, k.ay);
  const float w11 = __fmul_rn(k.ax, k.ay);

  const T* s = src + b * c * hw + (long long)k.y0 * w + k.x0;
  float* o = out + b * c * hw + p;
  for (int ch = 0; ch < c; ++ch) {
    float acc = __fmul_rn(load(s), w00);
    acc = __fadd_rn(acc, __fmul_rn(load(s + 1), w10));
    acc = __fadd_rn(acc, __fmul_rn(load(s + w), w01));
    acc = __fadd_rn(acc, __fmul_rn(load(s + w + 1), w11));
    *o = acc;
    s += hw;
    o += hw;
  }
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (tiles along W, tiles along H, B), block (128, 8)
template <typename T>
__global__ void __launch_bounds__(TH * TW) warp_slab_kernel(
    const T* __restrict__ src,     // (B, C, H, W)
    const float* __restrict__ fx,  // (B, H, W)
    const float* __restrict__ fy,  // (B, H, W)
    float* __restrict__ out,       // (B, C, H, W)
    int c, int h, int w) {
  __shared__ int part[2][NWARP];
  __shared__ int tile_min[2];
  const int jl = threadIdx.x, il = threadIdx.y;
  const int r = blockIdx.y * TH + il;
  const int col = blockIdx.x * TW + jl;
  const long long hw = (long long)h * w;
  const long long b = blockIdx.z;
  const bool live = r < h && col < w;
  const long long p = (long long)r * w + col;

  // pixels past the image's edge (ragged tiles) take no part in the minima
  Corner k = {0, 0, 0.0f, 0.0f};
  int dy = 1 << 30, dx = 1 << 30;
  if (live) {
    k = corner(fx[b * hw + p], fy[b * hw + p], h, w);
    dy = k.y0 + PADT - il;
    dx = k.x0 + PADL - jl;
  }
  const int my = warp_min(dy), mx = warp_min(dx);
  const int warp = (il * TW + jl) >> 5, lane = jl & 31;
  if (lane == 0) {
    part[0][warp] = my;
    part[1][warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    const int ty = warp_min(part[0][lane]), tx = warp_min(part[1][lane]);
    if (lane == 0) {
      tile_min[0] = ty;
      tile_min[1] = tx;
    }
  }
  __syncthreads();
  if (!live) return;

  const int ymin = max(tile_min[0], 0), xmin = max(tile_min[1], 0);
  const int by8 = ymin & ~(TH - 1), bx128 = xmin & ~(TW - 1);
  const int rx0 = xmin - bx128;
  const int yi = min(dy - by8, YI_MAX);
  const int xi = min(dx - bx128, rx0 + PADL);
  const int ys = by8 + yi + il - PADT;
  const int xs = bx128 + xi + jl - PADL;

  const float bx = __fsub_rn(1.0f, k.ax);
  const float by = __fsub_rn(1.0f, k.ay);
  const T* s = src + b * c * hw + (long long)ys * w + xs;
  float* o = out + b * c * hw + p;
  for (int ch = 0; ch < c; ++ch) {
    const float xb0 = __fadd_rn(__fmul_rn(bx, load(s)), __fmul_rn(k.ax, load(s + 1)));
    const float xb1 = __fadd_rn(__fmul_rn(bx, load(s + w)), __fmul_rn(k.ax, load(s + w + 1)));
    *o = __fadd_rn(__fmul_rn(xb0, by), __fmul_rn(xb1, k.ay));
    s += hw;
    o += hw;
  }
}

template <typename T>
int launch(const T* src, int slab, const float* fx, const float* fy, float* out, int b, int c, int h,
           int w, cudaStream_t stream) {
  if (slab) {
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
    warp_slab_kernel<T><<<grid, dim3(TW, TH), 0, stream>>>(src, fx, fy, out, c, h, w);
  } else {
    const long long n_pix = (long long)b * h * w;
    const long long blocks = (n_pix + NT - 1) / NT;
    warp_gather_kernel<T><<<(unsigned int)blocks, NT, 0, stream>>>(src, fx, fy, out, n_pix, c, h, w);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// src is float32 (src_bf16 = 0) or bfloat16 (src_bf16 = 1); slab selects
// the geometry (0 gather, 1 slab). Launches on `stream`; returns the
// cudaError_t of the launch (0 = ok).
extern "C" int warp_bilinear_launch(const void* src, int src_bf16, int slab, const float* fx,
                                    const float* fy, float* out, int b, int c, int h, int w,
                                    void* stream) {
  if (h < 2 || w < 2 || b < 0 || c < 0 || (slab && b > 65535)) return (int)cudaErrorInvalidValue;
  if ((long long)b * h * w == 0 || c == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (src_bf16) return launch((const unsigned short*)src, slab, fx, fy, out, b, c, h, w, s);
  return launch((const float*)src, slab, fx, fy, out, b, c, h, w, s);
}
