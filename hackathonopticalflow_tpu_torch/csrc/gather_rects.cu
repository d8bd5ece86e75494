// gather_rects: one (ry, rx) rectangle of C planes per integer origin on
// Hopper.
//
// Replaces the TPU (Pallas) kernel
//   hackathonopticalflow_tpu/ops/carve_pallas.py::gather_rects
// (the generic rect gather behind ops/patch.py::extract_slabs_rect, which
// starts one HBM->VMEM DMA per rect from scalar-prefetched origins). The
// TPU's DMA semaphores and block-of-rects grid steps are not carried over.
//
// Contract (ops/gather_rects.py), per origin n = [x, y]: out[n, k, r, c] =
// planes[k, y0 + r, x0 + c], where each start is placed as XLA's
// dynamic_slice places it: a negative start is wrapped (+ the plane's
// size), then clamped into [0, dim - size]. A copy, bit for bit.
//
// Design: one block per rect; each warp copies whole rows, its 32 lanes
// on neighbouring columns, so loads and stores coalesce (a 128-px row is
// four 128-byte lines).
//
// What bounds it on an H100: bytes. At the blocked grid kernel's slab
// shape (2304 rects of 118 x 128 at 1080p L0) it writes 139 MB and reads
// at most the 2.5 MB plane (the rects overlap, and the plane stays in the
// 50 MB L2): ~42 us at 3.35 TB/s, the store stream.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;

__device__ __forceinline__ int slice_start(int start, int dim, int size) {
  if (start < 0) start += dim;
  return min(max(start, 0), dim - size);
}

__global__ void __launch_bounds__(NT) gather_rects_kernel(
    const float* __restrict__ planes,  // (C, h, w)
    int c, int h, int w,
    const int* __restrict__ tl,        // (N, 2) origins [x, y]
    int ry, int rx,
    float* __restrict__ out) {         // (N, C, ry, rx)
  const int n = blockIdx.x;
  const int x0 = slice_start(tl[2 * n], w, rx);
  const int y0 = slice_start(tl[2 * n + 1], h, ry);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* o = out + (size_t)n * c * ry * rx;
  for (int row = warp; row < c * ry; row += NW) {
    const int k = row / ry, r = row - k * ry;
    const float* src = planes + ((size_t)k * h + y0 + r) * w + x0;
    float* dst = o + (size_t)row * rx;
    for (int col = lane; col < rx; col += 32) dst[col] = __ldg(src + col);
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int gather_rects_launch(const float* planes, int c, int h, int w,
                                   const int* tl, int n, int ry, int rx,
                                   float* out, void* stream) {
  if (c < 1 || ry < 1 || rx < 1 || ry > h || rx > w)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  gather_rects_kernel<<<n, NT, 0, (cudaStream_t)stream>>>(planes, c, h, w, tl,
                                                          ry, rx, out);
  return (int)cudaGetLastError();
}
