// patch_bilinear: bilinear windows of C planes at N fractional top-lefts on
// Hopper (the LK tracker's template and residual windows).
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
// Design: one block per point. The block copies the point's C crops into
// shared memory (each plane's crop rows are contiguous, so the loads
// coalesce), then each thread blends outputs out of shared memory.
//
// What bounds it on an H100: memory latency, not bandwidth or arithmetic.
// At the tracker's shapes (N = 256, C = 3, 16 x 16 crops) it reads 786 KB
// of crops and writes 691 KB, 0.44 us at 3.35 TB/s, and does ~7 flops per
// output; the launch and one round trip to L2/HBM per block set its time.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr float MAX_ORIGIN = 1073741824.0f;  // 2^30: origins saturate there

__global__ void __launch_bounds__(NT) patch_bilinear_kernel(
    const float* __restrict__ planes,  // (C, hp, wp)
    int c, int hp, int wp,
    const float* __restrict__ tl,      // (N, 2) top-left [x, y]
    int size_h, int size_w, int quantize,
    float* __restrict__ out) {         // (N, C, size_h, size_w)
  extern __shared__ float crop[];      // (C, size_h + 1, size_w + 1)
  const int pt = blockIdx.x;
  const int cw = size_w + 1, ch = size_h + 1;

  const float x = tl[2 * pt], y = tl[2 * pt + 1];
  const float fx = floorf(x), fy = floorf(y);
  const float ax = __fsub_rn(x, fx), ay = __fsub_rn(y, fy);
  int ix = (int)fminf(fmaxf(fx, -MAX_ORIGIN), MAX_ORIGIN);
  int iy = (int)fminf(fmaxf(fy, -MAX_ORIGIN), MAX_ORIGIN);
  if (ix < 0) ix += wp;
  if (iy < 0) iy += hp;
  ix = min(max(ix, 0), wp - cw);
  iy = min(max(iy, 0), hp - ch);

  const int per_plane = ch * cw;
  for (int i = threadIdx.x; i < c * per_plane; i += NT) {
    const int k = i / per_plane;
    const int rem = i - k * per_plane;
    const int r = rem / cw;
    crop[i] = planes[((size_t)k * hp + iy + r) * wp + ix + (rem - r * cw)];
  }
  __syncthreads();

  const float bx = __fsub_rn(1.0f, ax), by = __fsub_rn(1.0f, ay);
  const float w00 = __fmul_rn(bx, by);
  const float w10 = __fmul_rn(ax, by);
  const float w01 = __fmul_rn(bx, ay);
  const float w11 = __fmul_rn(ax, ay);
  const int per_out = size_h * size_w;
  float* o = out + (size_t)pt * c * per_out;
  for (int i = threadIdx.x; i < c * per_out; i += NT) {
    const int k = i / per_out;
    const int rem = i - k * per_out;
    const int r = rem / size_w;
    const float* s = crop + k * per_plane + r * cw + (rem - r * size_w);
    float v = __fmul_rn(s[0], w00);
    v = __fadd_rn(v, __fmul_rn(s[1], w10));
    v = __fadd_rn(v, __fmul_rn(s[cw], w01));
    v = __fadd_rn(v, __fmul_rn(s[cw + 1], w11));
    if (quantize) v = floorf(__fadd_rn(__fmul_rn(v, 32.0f), 0.5f)) * (1.0f / 32.0f);
    o[i] = v;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int patch_bilinear_launch(const float* planes, int c, int hp,
                                     int wp, const float* tl, int n,
                                     int size_h, int size_w, int quantize,
                                     float* out, void* stream) {
  if (c < 1 || size_h < 1 || size_w < 1 || hp < size_h + 1 || wp < size_w + 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const size_t smem = sizeof(float) * (size_t)c * (size_h + 1) * (size_w + 1);
  // raise the kernel's shared-memory limit only when a launch needs more,
  // so that launches captured into a CUDA graph make no such call
  static size_t smem_limit = 0;
  if (smem > smem_limit) {
    cudaError_t err = cudaFuncSetAttribute(
        patch_bilinear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_limit = smem;
  }
  patch_bilinear_kernel<<<n, NT, smem, (cudaStream_t)stream>>>(
      planes, c, hp, wp, tl, size_h, size_w, quantize, out);
  return (int)cudaGetLastError();
}
