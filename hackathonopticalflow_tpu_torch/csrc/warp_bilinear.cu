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
// Design. The wrapper picks the launch (ops/warp_bilinear.py::
// launch_shape) among the ones this file takes (launch_shapes); it refuses
// any other. A block blends all five channels of its pixels (the caller's
// only C) or, where that leaves fewer blocks than the card has SMs, one
// channel (`groups` = C blocks share the pixels; the generic path for any
// C). A pixel's 20 corner loads (5 channels x 4 corners) are all issued
// before its first blend, and a pixel past the image loads at the plane's
// origin, so that only its store is conditional.
//   gather: blocks of 256 threads, a thread a pixel.
//   slab: a tile to `splits` blocks (1 or 2) of 256 / splits threads, a
//   warp a tile row, 4 pixels a thread interleaved at the warp's width
//   (lane l takes columns l, l + 32, l + 64, l + 96). Each block finds
//   the whole tile's minima itself: its warps read all 8 rows of fx and
//   fy (a split block re-reads the other block's rows from L2), a warp
//   shuffle, then one step through shared memory where every thread reads
//   the warps' minima (one barrier, where the previous design took two). The corners found for the block's own
//   row are kept for the blend. At most 64 registers (4 x splits blocks an
//   SM; ptxas then spills nothing).
//   Which launch is fastest depends on the level (chip_smoke.py phases 6
//   and 18 time every one the kernel takes): at 90x160 a tile and channel
//   a block (120 blocks) beats the tile split in 2 (240), so the slab
//   stays under one block an SM there; at 360x640 a tile to 2 blocks (450)
//   beats whole tiles (225). Tiles split 4 and 8 ways (64- and 32-thread
//   blocks, the last a single warp with no barrier) measured slower at
//   every level on the H100 (an earlier build of this file; PERF.md
//   section 6).
// Every warp instruction touches consecutive addresses: fx, fy and each
// output plane 128 bytes, each corner two cache lines. Reading fx and fy
// and writing the outputs as 8- or 16-byte vectors, contiguous pixels a
// thread, was not built or measured. Stores are plain: the next kernel
// (ops/farneback.py's _assemble_m) reads the five planes from L2.
// Nothing is staged in shared memory, and no TMA. The TPU kernel DMAs a
// (C, 96, 384) slab per tile, 737 KB in float32 (369 KB in bf16), more
// than the 227 KB a block can hold, and a slab holds 36 times the tile's
// own samples. Here the corners come through L1 and L2: neighbouring
// pixels sample neighbouring source pixels (the flow is smooth), and the
// source plane (18.4 MB at 720p in float32) stays in the 50 MB L2 across
// a level's three iterations.
//
// What bounds it on an H100: memory at the fine levels, the launch at the
// coarse ones. Per pixel it reads fx, fy (8 B) and C source values (C = 5:
// 20 B in float32, 10 B in bf16) and writes C floats (20 B): at 720p 44 MB
// (35 MB in bf16), 13.2 us (10.5 us) at 3.35 TB/s. At 90x160 the same
// bytes take 0.2 us, below the least time any kernel launch takes on the
// card (chip_smoke.py's launch_floor_ms), so there the launch and two
// dependent round trips to memory (fx and fy, then the corners) bound it.
//
// Measured (chip_smoke.py phases 6 and 18, device time per call by graph
// replay, on an H100 80GB HBM3 at 700.00 W; two runs of this design
// beside two of PR 12's in one call; PERF.md section 6). Launch floor
// (launch_floor_ms) 0.0011-0.0013 ms.
//   720x1280: gather 0.0179 ms, 74% of its 0.0132 ms bound
//   (F.grid_sample 0.0278); slab float32 0.0183-0.0184, 72%; slab bf16
//   0.0138, 76% of 0.0105. PR 12's design: 0.0187-0.0189, 0.0213-0.0214,
//   0.0165-0.0167.
//   90x160: gather 0.0018, slab 0.0020 (float32) and 0.0022-0.0023
//   (bf16): 1.4-2.1 times the floor against a bound of 0.0002. PR 12's
//   design: 0.0021-0.0022, 0.0030, 0.0031-0.0032.
//   ptxas: gather 26-32 registers, slab 56-64, no spills.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 8, TW = 128;        // the TPU kernel's output tile
constexpr int PADT = 72, PADL = 128;   // its row and column margins
constexpr int YI_MAX = 80;             // its last slab row offset (RYC - 1)
constexpr int SLAB_P = 4;              // slab: pixels a thread, a warp a tile row
constexpr int NT = TH * TW / SLAB_P;   // gather: threads a block; slab: a tile's (256)
// slab: blocks of a whole tile resident an SM, at least (x splits for a
// split tile; at most 64 registers a thread)
constexpr int SLAB_MIN_BLOCKS = 4;
constexpr int ALL_CHANNELS = 5;        // C of the only caller (ops/farneback.py)
constexpr int BIG = 1 << 30;           // a pixel past the image in the minima

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

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One pixel: loads the four corners of its CPB channels (all in flight),
// then blends them and, if the pixel is live, stores them. src / out: the
// block's first channel plane; so / dst: the pixel's top-left sample and
// its output in that plane; channel j adds j * hw.
template <bool SLAB, int CPB, typename T>
__device__ __forceinline__ void blend_store(const T* __restrict__ src, float* __restrict__ out, int so,
                                            int dst, bool live, Corner k, long long hw, int w) {
  float v[CPB][4];
#pragma unroll
  for (int j = 0; j < CPB; ++j) {
    const T* s = src + so + j * hw;
    v[j][0] = load(s);
    v[j][1] = load(s + 1);
    v[j][2] = load(s + w);
    v[j][3] = load(s + w + 1);
  }
  const float bx = __fsub_rn(1.0f, k.ax), by = __fsub_rn(1.0f, k.ay);
  float w00 = 0.0f, w10 = 0.0f, w01 = 0.0f, w11 = 0.0f;
  if (!SLAB) {
    w00 = __fmul_rn(bx, by);
    w10 = __fmul_rn(k.ax, by);
    w01 = __fmul_rn(bx, k.ay);
    w11 = __fmul_rn(k.ax, k.ay);
  }
#pragma unroll
  for (int j = 0; j < CPB; ++j) {
    float r;
    if (SLAB) {
      const float xb0 = __fadd_rn(__fmul_rn(bx, v[j][0]), __fmul_rn(k.ax, v[j][1]));
      const float xb1 = __fadd_rn(__fmul_rn(bx, v[j][2]), __fmul_rn(k.ax, v[j][3]));
      r = __fadd_rn(__fmul_rn(xb0, by), __fmul_rn(xb1, k.ay));
    } else {
      r = __fmul_rn(v[j][0], w00);
      r = __fadd_rn(r, __fmul_rn(v[j][1], w10));
      r = __fadd_rn(r, __fmul_rn(v[j][2], w01));
      r = __fadd_rn(r, __fmul_rn(v[j][3], w11));
    }
    if (live) out[dst + j * hw] = r;
  }
}

// 1-D grid: block id = (b * blocks a plane + pixel block) * groups +
// channel group; a thread a pixel
template <typename T, int CPB>
__global__ void __launch_bounds__(NT) warp_gather_kernel(
    const T* __restrict__ src,     // (B, C, H, W)
    const float* __restrict__ fx,  // (B, H, W)
    const float* __restrict__ fy,  // (B, H, W)
    float* __restrict__ out,       // (B, C, H, W)
    int c, int h, int w, int groups) {
  unsigned int id = blockIdx.x;
  const int g = id % groups;
  id /= groups;
  const int hw = h * w;
  const unsigned int per_plane = (hw + NT - 1) / NT;
  const int p = (id % per_plane) * NT + threadIdx.x;
  const long long b = id / per_plane;
  const long long base = (b * c + g * CPB) * hw;

  const bool live = p < hw;
  const int dst = live ? p : 0;  // past the plane: load at its origin, store nothing
  const Corner k = corner(fx[b * hw + dst], fy[b * hw + dst], h, w);
  blend_store<false, CPB>(src + base, out + base, k.y0 * w + k.x0, dst, live, k, hw, w);
}

// 1-D grid: block id = (((b * tiles_y + ty) * tiles_x + tx) * S + part) *
// groups + channel group. S blocks share a tile: block `part` blends its
// rows part * R .. part * R + R - 1 (R = 8 / S), a warp a row, SLAB_P
// pixels a thread, and finds the whole tile's minima itself, its warp w
// reading rows q * R + w (q < S) of fx and fy
template <typename T, int CPB, int S>
__global__ void __launch_bounds__(NT / S, SLAB_MIN_BLOCKS * S) warp_slab_kernel(
    const T* __restrict__ src,     // (B, C, H, W)
    const float* __restrict__ fx,  // (B, H, W)
    const float* __restrict__ fy,  // (B, H, W)
    float* __restrict__ out,       // (B, C, H, W)
    int c, int h, int w, int groups) {
  constexpr int R = TH / S;
  __shared__ int warp_mins[2][R];
  unsigned int id = blockIdx.x;
  const int g = id % groups;
  id /= groups;
  const int part = id % S;
  id /= S;
  const int ntx = (w + TW - 1) / TW, nty = (h + TH - 1) / TH;
  const int tx = id % ntx;
  id /= ntx;
  const int ty = id % nty;
  const long long b = id / nty;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int il = part * R + warp;  // the tile row this warp blends
  const int hw = h * w;
  const float* __restrict__ fxb = fx + b * hw;
  const float* __restrict__ fyb = fy + b * hw;

  // the tile's pixels this warp reads: corners, and their minima of dy
  // and dx (past the image: BIG); its own row's are kept
  Corner k[SLAB_P];
  int dy[SLAB_P], dx[SLAB_P], so[SLAB_P], dst[SLAB_P];
  bool live[SLAB_P];
  int my = BIG, mx = BIG;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int row = q * R + warp;
    const int r = ty * TH + row;
#pragma unroll
    for (int i = 0; i < SLAB_P; ++i) {
      const int jl = lane + 32 * i;
      const int col = tx * TW + jl;
      const bool in = r < h && col < w;
      Corner kk{0, 0, 0.0f, 0.0f};
      int ddy = BIG, ddx = BIG;
      if (in) {
        kk = corner(fxb[r * w + col], fyb[r * w + col], h, w);
        ddy = kk.y0 + PADT - row;
        ddx = kk.x0 + PADL - jl;
      }
      my = min(my, ddy);
      mx = min(mx, ddx);
      if (q == part) {
        k[i] = kk;
        dy[i] = ddy;
        dx[i] = ddx;
        live[i] = in;
        dst[i] = r * w + col;
      }
    }
  }
  // the tile's minima: a warp's, then every thread reads the R warps'
  my = warp_min(my);
  mx = warp_min(mx);
  if (lane == 0) {
    warp_mins[0][warp] = my;
    warp_mins[1][warp] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < R; ++i) {
    my = min(my, warp_mins[0][i]);
    mx = min(mx, warp_mins[1][i]);
  }

  const int ymin = max(my, 0), xmin = max(mx, 0);
  const int by8 = ymin & ~(TH - 1), bx128 = xmin & ~(TW - 1);
  const int rx0 = xmin - bx128;
#pragma unroll
  for (int i = 0; i < SLAB_P; ++i) {
    const int jl = lane + 32 * i;
    const int yi = min(dy[i] - by8, YI_MAX);
    const int xi = min(dx[i] - bx128, rx0 + PADL);
    const int ys = by8 + yi + il - PADT;
    const int xs = bx128 + xi + jl - PADL;
    so[i] = live[i] ? ys * w + xs : 0;  // past the image: load at the plane's origin, store nothing
  }
  const long long base = (b * c + g * CPB) * hw;
#pragma unroll
  for (int i = 0; i < SLAB_P; ++i)
    blend_store<true, CPB>(src + base, out + base, so[i], dst[i], live[i], k[i], hw, w);
}

template <typename T, int CPB>
int launch(const T* src, int slab, const float* fx, const float* fy, float* out, int c, int h, int w,
           int grid, int groups, int splits, cudaStream_t stream) {
  if (!slab)
    warp_gather_kernel<T, CPB><<<grid, NT, 0, stream>>>(src, fx, fy, out, c, h, w, groups);
  else if (splits == 1)
    warp_slab_kernel<T, CPB, 1><<<grid, NT, 0, stream>>>(src, fx, fy, out, c, h, w, groups);
  else
    warp_slab_kernel<T, CPB, 2><<<grid, NT / 2, 0, stream>>>(src, fx, fy, out, c, h, w, groups);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const T* src, int slab, const float* fx, const float* fy, float* out, int c, int h, int w,
             int grid, int groups, int splits, cudaStream_t stream) {
  if (groups == 1 && c == ALL_CHANNELS)
    return launch<T, ALL_CHANNELS>(src, slab, fx, fy, out, c, h, w, grid, groups, splits, stream);
  return launch<T, 1>(src, slab, fx, fy, out, c, h, w, grid, groups, splits, stream);
}

}  // namespace

// src is float32 (src_bf16 = 0) or bfloat16 (src_bf16 = 1); slab selects
// the geometry (0 gather, 1 slab). The launch is one of ops/
// warp_bilinear.py::launch_shapes: `grid` blocks, `groups` of them sharing
// a set of pixels (1: each blends all C = 5 channels; C: one channel
// each) and, in the slab geometry, `splits` (1 or 2; gather: 1) of them
// sharing a tile. Any other launch returns cudaErrorInvalidValue.
// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int warp_bilinear_launch(const void* src, int src_bf16, int slab, const float* fx,
                                    const float* fy, float* out, int b, int c, int h, int w, int grid,
                                    int groups, int splits, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  // in-plane offsets are 32-bit: a plane of at most 2^30 pixels
  if (h < 2 || w < 2 || b < 0 || c < 0 || (long long)h * w > (1LL << 30)) return bad;
  if (b == 0 || c == 0) return 0;
  if (!(groups == c || (groups == 1 && c == ALL_CHANNELS))) return bad;
  if (slab ? !(splits == 1 || splits == 2) : splits != 1) return bad;
  const long long per_plane = slab ? (long long)((h + TH - 1) / TH) * ((w + TW - 1) / TW) * splits
                                   : ((long long)h * w + NT - 1) / NT;
  if (per_plane * b * groups != grid) return bad;
  const cudaStream_t s = (cudaStream_t)stream;
  if (src_bf16)
    return launch_t((const unsigned short*)src, slab, fx, fy, out, c, h, w, grid, groups, splits, s);
  return launch_t((const float*)src, slab, fx, fy, out, c, h, w, grid, groups, splits, s);
}
