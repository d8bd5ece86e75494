// patch_bilinear: bilinear windows of C planes at N fractional top-lefts on
// Hopper (the LK tracker's template and residual windows, the exact LK
// path's templates).
//
// Replaces the TPU (Pallas) kernel
//   hackathonopticalflow_tpu/ops/carve_pallas.py::gather_rects_panels_multi
// together with what XLA computes around it in ops/patch.py
// (extract_patches / extract_patches_multi, blend_bilinear) and ops/lk.py
// (the W_BITS quantization _fix of the templates). The TPU kernel only
// DMAs (N, C, ry, 128) rects from a 16-shift panel stack at 8-px aligned
// origins, which the caller then shifts by <= 7 px with masked adds: those
// panels, the 8-px quantization and the shift ladder were Mosaic DMA
// workarounds and are not carried over.
//
// Contract (ops/patch_bilinear.py), per point n with top-left (x, y):
//   ix = floor(x), iy = floor(y), ax = x - ix, ay = y - iy;
//   the (size_h+1, size_w+1) crop starts at (ix, iy) as XLA's
//   dynamic_slice places it: a negative start is wrapped (+ the plane's
//   size), then clamped into [0, dim - crop];
//   w00 = (1-ax)(1-ay), w10 = ax(1-ay), w01 = (1-ax)ay, w11 = ax ay;
//   out = v00 w00 + v10 w10 + v01 w01 + v11 w11, summed in that order;
//   with quantize, out = floor(out * 32 + 0.5) / 32.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, and
// the library is built with -fmad=false), as the separate PyTorch ops of
// patch_bilinear_reference round them: the two agree bit for bit.
//
// Stream-batched calls: planes (nb, C, hp, wp) and the points stream-major
// (n / nb each), so point pt reads stack pt / (n / nb): one base-pointer
// offset; the clamps stay per plane. One launch serves every stream.
//
// Design: no shared memory. A block is (lanes, points): threadIdx.y picks
// one of `points` points, threadIdx.x one of the `lanes` threads that share
// its window, blockIdx.y the channel. Each thread computes the point's
// origin and four weights once, then EPT outputs of the window's flattened
// (size_h, size_w) plane per pass, elements tx, tx + lanes, ...: one
// division gives the first element's row and column, and each next one
// steps by (lanes / size_w, lanes % size_w). Its four corners are __ldg
// reads of the plane (the planes, <= 28 MB at 1080p L0, stay in the 50 MB
// L2; L1 serves the overlap of neighbouring outputs); every element loads
// (one past the window its last row's), so all of a thread's loads are in
// flight at once, and only the store is conditional. The store lands next
// to its neighbour lane's, so a warp writes 128 contiguous bytes, streamed
// (evict-first) so that the output does not push the planes out of L2.
// `lanes` is the smallest power of two in [32, 256] that covers the window
// in one pass: windows of <= 512 px at 2 outputs per thread, which keeps a
// small call to one round trip (the tracker's 15 x 15: 128 lanes), larger
// ones at 8 (45 x 45: 256 lanes). Windows of <= 64 px pack 128 / lanes
// points into a block.
//
// What bounds it on an H100: bytes, the output stream. At the exact
// scan's templates (2304 x 3 x 45 x 45) it writes 56 MB, 0.0167 ms at
// 3.35 TB/s, and reads the planes once; at the tracker's 256 x 3 x 15 x
// 15, 0.7 MB, the launch and one round trip set its time.
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700.00 W; device time
// per call, graph replay): the exact scan's templates at L2 / L1 / L0
// 0.0316 / 0.0323 / 0.0442 ms against byte bounds of 0.0175 / 0.0191 /
// 0.0252 ms and F.grid_sample's 0.0462 / 0.0528 / 0.0586 ms (the previous
// design, a block per point staging its crops in shared memory,
// 0.071-0.074 ms in the same run); the tracker's calls 0.0019-0.0022
// ms (previous design 0.0024-0.0035, F.grid_sample 0.0020-0.0027).
// ptxas: 32 registers, no spills; 64 warps resident per SM.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LANES = 256;  // threads per point
constexpr int MIN_BLOCK = 128;  // threads per block, at least
constexpr float MAX_ORIGIN = 1073741824.0f;  // 2^30: origins saturate there

// EPT: outputs per thread per pass (2 for windows of <= 512 px, else 8).
template <int EPT>
__global__ void __launch_bounds__(MAX_LANES) patch_bilinear_kernel(
    const float* __restrict__ planes,  // (nb, C, hp, wp)
    int nb, int c, int hp, int wp,
    const float* __restrict__ tl,      // (N, 2) top-left [x, y]
    int n, int size_h, int size_w, int quantize,
    float* __restrict__ out) {         // (N, C, size_h, size_w)
  const int pt = blockIdx.x * blockDim.y + threadIdx.y;
  if (pt >= n) return;
  const int chan = blockIdx.y;
  const int tx = threadIdx.x, lanes = blockDim.x;

  const float x = __ldg(tl + 2 * pt), y = __ldg(tl + 2 * pt + 1);
  const float fx = floorf(x), fy = floorf(y);
  const float ax = __fsub_rn(x, fx), ay = __fsub_rn(y, fy);
  int ix = (int)fminf(fmaxf(fx, -MAX_ORIGIN), MAX_ORIGIN);
  int iy = (int)fminf(fmaxf(fy, -MAX_ORIGIN), MAX_ORIGIN);
  if (ix < 0) ix += wp;
  if (iy < 0) iy += hp;
  ix = min(max(ix, 0), wp - size_w - 1);
  iy = min(max(iy, 0), hp - size_h - 1);
  const float bx = __fsub_rn(1.0f, ax), by = __fsub_rn(1.0f, ay);
  const float w00 = __fmul_rn(bx, by);
  const float w10 = __fmul_rn(ax, by);
  const float w01 = __fmul_rn(bx, ay);
  const float w11 = __fmul_rn(ax, ay);

  const int stack = pt / (n / nb);  // points are stream-major
  const float* src = planes + (((size_t)stack * c + chan) * hp + iy) * wp + ix;
  const int per_out = size_h * size_w;
  float* o = out + ((size_t)pt * c + chan) * per_out;
  int r = tx / size_w, col = tx - r * size_w;  // element tx
  const int dr = lanes / size_w, dc = lanes - dr * size_w;
  for (int first = tx; first < per_out; first += lanes * EPT) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      // every element loads (one past the window its last row's), so that
      // all of a thread's loads are in flight at once; only stores are
      // conditional
      const int i = first + e * lanes;
      const float* s = src + (size_t)min(r, size_h - 1) * wp + col;
      float v = __fmul_rn(__ldg(s), w00);
      v = __fadd_rn(v, __fmul_rn(__ldg(s + 1), w10));
      v = __fadd_rn(v, __fmul_rn(__ldg(s + wp), w01));
      v = __fadd_rn(v, __fmul_rn(__ldg(s + wp + 1), w11));
      if (quantize) v = floorf(__fadd_rn(__fmul_rn(v, 32.0f), 0.5f)) * (1.0f / 32.0f);
      if (i < per_out) __stcs(o + i, v);  // streamed: the planes keep L2
      r += dr;
      col += dc;
      if (col >= size_w) {
        col -= size_w;
        ++r;
      }
    }
  }
}

// Outputs per thread per pass: 2 where the lanes can spread the window
// that thin (one round trip for a small call), else 8.
constexpr int SMALL_WINDOW = 2 * MAX_LANES;

// The block of a window of size_h x size_w: (lanes, points per block).
// `lanes` is the smallest power of two in [32, 256] that covers the window
// in one pass.
dim3 block_shape(int size_h, int size_w) {
  const int per_out = size_h * size_w;
  const int ept = per_out <= SMALL_WINDOW ? 2 : 8;
  int lanes = 32;
  while (lanes < MAX_LANES && lanes * ept < per_out) lanes *= 2;
  const int points = lanes < MIN_BLOCK ? MIN_BLOCK / lanes : 1;
  return dim3(lanes, points);
}

using KernelFn = decltype(&patch_bilinear_kernel<2>);

KernelFn pick(int size_h, int size_w) {
  return size_h * size_w <= SMALL_WINDOW ? patch_bilinear_kernel<2> : patch_bilinear_kernel<8>;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// planes holds nb stacks of C planes; nb divides n (n / nb points each).
extern "C" int patch_bilinear_launch(const float* planes, int nb, int c, int hp,
                                     int wp, const float* tl, int n,
                                     int size_h, int size_w, int quantize,
                                     float* out, void* stream) {
  if (nb < 1 || n % nb != 0 || c < 1 || c > 65535 || size_h < 1 || size_w < 1 ||
      hp < size_h + 1 || wp < size_w + 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const dim3 block = block_shape(size_h, size_w);
  const dim3 grid((n + block.y - 1) / block.y, c);
  pick(size_h, size_w)<<<grid, block, 0, (cudaStream_t)stream>>>(
      planes, nb, c, hp, wp, tl, n, size_h, size_w, quantize, out);
  return (int)cudaGetLastError();
}

// The kernel's registers and local bytes per thread, and the threads per
// block and resident blocks per SM at a size_h x size_w window.
extern "C" int patch_bilinear_occupancy(int size_h, int size_w, int* threads,
                                        int* blocks_per_sm, int* regs,
                                        int* local_bytes) {
  const dim3 block = block_shape(size_h, size_w);
  const KernelFn fn = pick(size_h, size_w);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *threads = (int)(block.x * block.y);
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                            *threads, 0);
}
