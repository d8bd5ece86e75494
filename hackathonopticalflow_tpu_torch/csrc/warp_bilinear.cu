// warp_bilinear: bilinear sample of C channels at absolute coordinates on
// Hopper, the Farneback coefficient warp.
//
// Replaces the TPU (Pallas) kernel
//   hackathonopticalflow_tpu/ops/warp_pallas.py::warp_bilinear_pallas
// whose (8, 128) output tiles, (C, 96, 384) slab DMA, lane-shuffle column
// gather, y-tent row sum and 72/128 px spread clamp were Mosaic
// workarounds for a TPU without a fast per-element gather. On the GPU
// each pixel reads its own four corners, so no spread clamp is needed and
// the result is exact for any flow.
//
// Contract (warp_pallas.py:216-234, ops/warp_bilinear.py): per pixel,
//   x0 = clamp(floor(fx), 0, W-2), y0 = clamp(floor(fy), 0, H-2),
//   ax = clamp(fx - x0, 0, 1),     ay = clamp(fy - y0, 0, 1),
//   out[c] = v00 (1-ax)(1-ay) + v10 ax(1-ay) + v01 (1-ax)ay + v11 ax ay,
// the weights formed first and the terms summed in that order. Every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn, and the
// library is built with -fmad=false), as the separate PyTorch ops of
// warp_bilinear_reference round them: the two agree bit for bit.
//
// Design: one thread per output pixel of a (B, H, W) grid, a loop over the
// C channels inside. Neighbouring threads sample neighbouring source
// pixels (the flow is smooth), so the corner loads of a warp fall in a few
// cache lines of each channel plane.
//
// What bounds it on an H100: memory. Per pixel it reads fx, fy (8 B) and
// 4 corners of C channels (C = 5: 80 B, mostly L1/L2 hits, since each
// source pixel is a corner of about four output pixels), and writes C
// floats (20 B). At 720p that is about 44 MB of distinct HBM traffic,
// 13 us at 3.35 TB/s; the corner loads are not coalesced where the flow
// varies, so the kernel reaches a fraction of that bound.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block

__global__ void __launch_bounds__(NT) warp_bilinear_kernel(
    const float* __restrict__ src,  // (B, C, H, W)
    const float* __restrict__ fx,   // (B, H, W)
    const float* __restrict__ fy,   // (B, H, W)
    float* __restrict__ out,        // (B, C, H, W)
    long long n_pix,                // B * H * W
    int c, int h, int w) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= n_pix) return;
  const long long hw = (long long)h * w;
  const long long b = i / hw;
  const long long p = i - b * hw;

  const float x = fx[i];
  const float y = fy[i];
  const float x0 = fminf(fmaxf(floorf(x), 0.0f), (float)(w - 2));
  const float y0 = fminf(fmaxf(floorf(y), 0.0f), (float)(h - 2));
  const float ax = fminf(fmaxf(__fsub_rn(x, x0), 0.0f), 1.0f);
  const float ay = fminf(fmaxf(__fsub_rn(y, y0), 0.0f), 1.0f);
  const float bx = __fsub_rn(1.0f, ax);
  const float by = __fsub_rn(1.0f, ay);
  const float w00 = __fmul_rn(bx, by);
  const float w10 = __fmul_rn(ax, by);
  const float w01 = __fmul_rn(bx, ay);
  const float w11 = __fmul_rn(ax, ay);

  const float* s = src + b * c * hw + (long long)y0 * w + (long long)x0;
  float* o = out + b * c * hw + p;
  for (int k = 0; k < c; ++k) {
    float acc = __fmul_rn(__ldg(s), w00);
    acc = __fadd_rn(acc, __fmul_rn(__ldg(s + 1), w10));
    acc = __fadd_rn(acc, __fmul_rn(__ldg(s + w), w01));
    acc = __fadd_rn(acc, __fmul_rn(__ldg(s + w + 1), w11));
    *o = acc;
    s += hw;
    o += hw;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int warp_bilinear_launch(const float* src, const float* fx,
                                    const float* fy, float* out, int b, int c,
                                    int h, int w, void* stream) {
  if (h < 2 || w < 2 || b < 0 || c < 0) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)b * h * w;
  if (n_pix == 0 || c == 0) return 0;
  const long long blocks = (n_pix + NT - 1) / NT;
  warp_bilinear_kernel<<<(unsigned int)blocks, NT, 0, (cudaStream_t)stream>>>(
      src, fx, fy, out, n_pix, c, h, w);
  return (int)cudaGetLastError();
}
