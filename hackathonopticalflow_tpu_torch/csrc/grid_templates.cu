// grid_templates: the grid LK path's templates on Hopper, cut straight from
// the three padded level planes (image, d/dx, d/dy) at the static
// measurement grid and quantized to the 1/32 grid.
//
// Replaces what XLA computes in the JAX package's
// hackathonopticalflow_tpu/ops/grid_patch.py::extract_grid_templates_lanes
// (no Pallas kernel there): on the GPU the plain version of it
// (ops/grid_templates.py::grid_templates_reference) is a row gather, a
// column gather and about eight full-size temporaries a level, ~1.2-1.5 GB
// of traffic at 1080p against the 56 MB of templates it produces.
//
// Contract (ops/grid_templates.py), per grid column ix and row iy (origin
// x0[ix], y0[iy] in the padded planes, float32 fractions fx[ix], fy[iy]
// made on the host in float64), per plane p and window pixel (r, c):
//   rows blended in y first: t(x) = p[y0 + r][x] (1 - fy) + p[y0 + r + 1][x] fy;
//   then columns in x:       v = t(x0 + c) (1 - fx) + t(x0 + c + 1) fx;
//   then quantized:          out = floor(v * 32 + 0.5) * (1 / 32).
// Every product, difference and sum is rounded on its own (__fmul_rn /
// __fsub_rn / __fadd_rn, 1 - f included; the library is built with
// -fmad=false), as the separate PyTorch ops of the plain version round
// them: the two agree bit for bit. This is not patch_bilinear's contract
// (weights formed first, four products summed), which differs from it in
// the last bit; the two kernels share no code.
//
// Layout: point k = ix * ky + iy (x-major), out (nb * kx * ky, 3, win_h,
// win_w), stream-major, as the LK level kernel reads its templates: no
// permute and no copy after it. The stream axis: stream b's planes start
// b * sstride floats past each plane's base (the planes may be three
// (nb, hp, wp) tensors, or the plane slices of one (nb, 3, hp, wp) stack);
// one launch serves every stream.
//
// Design: no shared memory, patch_bilinear's layout. A block is one
// (point, plane) window, blockIdx (iy, ix, stream * 3 + plane): no integer
// division finds them. Its `lanes` threads share the window's flattened
// (win_h, win_w) outputs, EPT a pass each, elements tx, tx + lanes, ...:
// one division gives the first element's row and column, and each next
// one steps by (lanes / win_w, lanes % win_w). Each output's four plane
// values are __ldg reads through L1 / L2 (a padded 1080p level-0 plane is
// 10 MB, and the three were written just before; L1 serves the overlap of
// neighbouring outputs). Every element loads (one past the window its last
// row's), so all of a thread's loads are in flight at once, and only the
// store is conditional. A warp stores 32 neighbouring outputs, streamed
// (evict-first) so that the 56 MB of templates does not push the planes
// out of L2. `lanes` comes from ops/grid_templates.py::launch_shape: the
// least power of two in [32, 128] that covers the window in one pass, 128
// at window 45 (two passes; 16 blocks and 64 warps resident per SM at <=
// 32 registers).
//
// Tried on an H100 at the 1080p levels, per level (graph replay): this
// layout 0.031 / 0.033 / 0.045 ms at L2 / L1 / L0 with 128 lanes (0.034 /
// 0.035 / 0.043 with 256); a thread per window column walking a run of
// rows, two loads an output with the row carried in registers, 0.042 /
// 0.044 / 0.053 (runs of 9 rows) and 0.034-0.042 / 0.035-0.042 /
// 0.044-0.048 with every row of a run loaded up front (runs of 3-9 rows):
// fewer loads, fewer of them in flight, and stores that split at the runs.
//
// What bounds it on an H100: bytes, the output stream. At 1080p (2304
// points, window 45) a level's templates are 2304 x 3 x 45 x 45 float32,
// 56 MB, 0.0167 ms at 3.35 TB/s; the three planes it reads, 3, 9 and 30
// MB at L2, L1 and L0, are mostly in L2.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LANES = 128;  // threads per block, at most
constexpr int EPT = 8;          // outputs per thread per pass

__global__ void __launch_bounds__(MAX_LANES) grid_templates_kernel(
    const float* __restrict__ img,  // ([nb,] hp, wp) rows of wp floats,
    const float* __restrict__ dix,  // stream b at b * sstride
    const float* __restrict__ diy,
    long long sstride, int wp,
    const int* __restrict__ y0,     // (ky,) window origin rows in the planes
    const float* __restrict__ fyv,  // (ky,)
    int ky,
    const int* __restrict__ x0,     // (kx,) window origin columns
    const float* __restrict__ fxv,  // (kx,)
    int kx, int win_h, int win_w,
    float* __restrict__ out) {      // (nb * kx * ky, 3, win_h, win_w)
  const int iy = blockIdx.x, ix = blockIdx.y;
  const int b = blockIdx.z / 3, chan = blockIdx.z - 3 * b;
  const int tx = threadIdx.x, lanes = blockDim.x;

  const float fy = __ldg(fyv + iy), fx = __ldg(fxv + ix);
  const float gy = __fsub_rn(1.0f, fy), gx = __fsub_rn(1.0f, fx);
  const float* plane = chan == 0 ? img : (chan == 1 ? dix : diy);
  const float* src = plane + (size_t)b * sstride + (size_t)__ldg(y0 + iy) * wp + __ldg(x0 + ix);
  const size_t pt = ((size_t)b * kx + ix) * ky + iy;  // stream-major, x-major
  const int per_out = win_h * win_w;
  float* o = out + (pt * 3 + chan) * per_out;
  int r = tx / win_w, col = tx - r * win_w;  // element tx
  const int dr = lanes / win_w, dc = lanes - dr * win_w;
  for (int first = tx; first < per_out; first += lanes * EPT) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = first + e * lanes;
      const float* s = src + (size_t)min(r, win_h - 1) * wp + col;
      // y blend of the two columns, then the x blend, then the 1/32 grid
      const float t0 = __fadd_rn(__fmul_rn(__ldg(s), gy), __fmul_rn(__ldg(s + wp), fy));
      const float t1 = __fadd_rn(__fmul_rn(__ldg(s + 1), gy), __fmul_rn(__ldg(s + wp + 1), fy));
      const float v = __fadd_rn(__fmul_rn(t0, gx), __fmul_rn(t1, fx));
      if (i < per_out) __stcs(o + i, __fmul_rn(floorf(__fadd_rn(__fmul_rn(v, 32.0f), 0.5f)), 0.03125f));
      r += dr;
      col += dc;
      if (col >= win_w) {
        col -= win_w;
        ++r;
      }
    }
  }
}

}  // namespace

// Launches on `stream` with blocks of `lanes` threads
// (ops/grid_templates.py::launch_shape); returns the cudaError_t of the
// launch (0 = ok). The caller has checked that every window lies inside
// the planes.
extern "C" int grid_templates_launch(const float* img, const float* dix, const float* diy,
                                     int nb, long long sstride, int wp,
                                     const int* y0, const float* fy, int ky,
                                     const int* x0, const float* fx, int kx,
                                     int win_h, int win_w, int lanes, float* out, void* stream) {
  if (nb < 1 || nb > 65535 / 3 || ky < 1 || kx < 1 || kx > 65535 || win_h < 1 || win_w < 1 ||
      wp < win_w + 1 || lanes < 1 || lanes > MAX_LANES)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ky, kx, 3 * nb);
  grid_templates_kernel<<<grid, lanes, 0, (cudaStream_t)stream>>>(
      img, dix, diy, sstride, wp, y0, fy, ky, x0, fx, kx, win_h, win_w, out);
  return (int)cudaGetLastError();
}

// The kernel's registers and local bytes per thread, and the resident
// blocks per SM at `lanes` threads a block.
extern "C" int grid_templates_occupancy(int lanes, int* blocks_per_sm, int* regs,
                                        int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, grid_templates_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, grid_templates_kernel,
                                                            lanes, 0);
}
