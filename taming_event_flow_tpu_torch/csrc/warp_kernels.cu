// Bilinear splat and gather for Hopper (sm_90a), with a plain C interface
// that taming_event_flow_tpu_torch/ops/cuda_warp.py loads through ctypes.
//
// Both kernels evaluate the 4-tap bilinear stencil
//     w(h, w) = tri(y - h) * tri(x - w),   tri(d) = max(0, 1 - |d|),
// at a fractional (y, x) location: the only taps with non-zero weight are
// {floor(y), floor(y)+1} x {floor(x), floor(x)+1}, with weights
// (1 - fy, fy) x (1 - fx, fx) where fy = y - floor(y). Taps outside
// [0, H-1] x [0, W-1] are dropped, so a coordinate in [-1, 0) keeps its
// in-frame tap, and an exactly-integer coordinate (fy == 0) puts weight 1
// on one tap. Rows that are padding or purged carry zero values (splat) and
// their outputs are masked by the caller (gather): the kernels do not
// special-case them.
//
// Layouts (the JAX package's conventions, all float32, contiguous):
//   loc    [B, M, 2]  (y, x) pixel coordinates
//   values [B, M, C]  per-point values (splat input)
//   maps   [B, H, W, C] NHWC image (gather input), out [B, H, W, C] (splat)
//
// splat_kernel replaces the Pallas `_splat_kernel`
// (taming_event_flow_tpu/ops/pallas_warp.py:128, call :186). The TPU kernel
// builds dense [TH, E] x [E, TW] triangle-factor matmuls per image tile so
// the MXU does the scatter; on Hopper a point touches at most 4 pixels, so
// one thread per (point, batch) issues at most 4*C float atomics (RED.ADD)
// into an NHWC output the wrapper zeroes. Bound on this card: bytes. Each
// point reads 8 + 4C bytes and the output is written once (at DSEC,
// M = 655,360, C = 4: 15.7 MB read, 4.9 MB written, ~6 us at 3.35 TB/s);
// the atomics land in L2 (the 4.9 MB image fits the 50 MB L2), so the cost
// is the point stream plus L2 atomic throughput. Integer coordinates (the
// round_idx splats of RSAT/FWL) issue one tap, not four. Atomics on one
// address serialise: the eval window's zero-valued padding rows all sit at
// (0, 0), and at DSEC shapes (~255k such rows) they set the splat's time
// (measured in PERF.md; skipping them is queued in ROADMAP.md). Atomic order
// changes the summation order of non-integer sums from run to run; sums of
// small integers (the count planes) stay exact.
//
// gather_kernel replaces the Pallas `_gather_kernel`
// (pallas_warp.py:206, call :261). The TPU kernel contracts dense factors
// against whole image tiles; here one thread per (point, batch) reads its
// <= 4 taps x C channels and writes C outputs, no atomics. Bound: bytes
// (points in, values out; the map is read through L2/L1 and at 2.5 MB for
// a 480x640x2 flow map stays L2-resident). Products and sums use
// __fmul_rn/__fadd_rn in tap order (00, 01, 10, 11) so that the result is
// bitwise the plain PyTorch version's (no FMA contraction).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int C>
__global__ void splat_kernel(const float* __restrict__ loc,
                             const float* __restrict__ values,
                             float* __restrict__ out, int M, int H, int W) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M) return;
  const int b = blockIdx.y;
  const int64_t row = (int64_t)b * M + e;
  const float y = loc[2 * row];
  const float x = loc[2 * row + 1];
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = values[row * C + c];

  const float y0 = floorf(y);
  const float x0 = floorf(x);
  const float fy = y - y0;
  const float fx = x - x0;
  // an exactly-integer coordinate has a single tap of weight 1
  const int ny = fy != 0.0f ? 2 : 1;
  const int nx = fx != 0.0f ? 2 : 1;
  float* img = out + (int64_t)b * H * W * C;
  for (int dy = 0; dy < ny; ++dy) {
    const float ty = y0 + (float)dy;
    if (!(ty >= 0.0f && ty <= (float)(H - 1))) continue;  // also drops NaN
    const float wy = dy ? fy : 1.0f - fy;
    for (int dx = 0; dx < nx; ++dx) {
      const float tx = x0 + (float)dx;
      if (!(tx >= 0.0f && tx <= (float)(W - 1))) continue;
      const float wx = dx ? fx : 1.0f - fx;
      const float w = __fmul_rn(wy, wx);
      float* px = img + ((int64_t)ty * W + (int64_t)tx) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) atomicAdd(px + c, __fmul_rn(w, v[c]));
    }
  }
}

template <int C>
__global__ void gather_kernel(const float* __restrict__ maps,
                              const float* __restrict__ loc,
                              float* __restrict__ out, int M, int H, int W) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M) return;
  const int b = blockIdx.y;
  const int64_t row = (int64_t)b * M + e;
  const float y = loc[2 * row];
  const float x = loc[2 * row + 1];
  const float y0 = floorf(y);
  const float x0 = floorf(x);
  const float fy = y - y0;
  const float fx = x - x0;
  const float* img = maps + (int64_t)b * H * W * C;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const float ty = y0 + (float)dy;
    if (!(ty >= 0.0f && ty <= (float)(H - 1))) continue;
    const float wy = dy ? fy : 1.0f - fy;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float tx = x0 + (float)dx;
      if (!(tx >= 0.0f && tx <= (float)(W - 1))) continue;
      const float wx = dx ? fx : 1.0f - fx;
      const float w = __fmul_rn(wy, wx);
      const float* px = img + ((int64_t)ty * W + (int64_t)tx) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, px[c]));
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) out[row * C + c] = acc[c];
}

template <int C>
void launch_splat(const float* loc, const float* values, float* out, int B,
                  int M, int H, int W, cudaStream_t s) {
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  splat_kernel<C><<<grid, kThreads, 0, s>>>(loc, values, out, M, H, W);
}

template <int C>
void launch_gather(const float* maps, const float* loc, float* out, int B,
                   int M, int H, int W, cudaStream_t s) {
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  gather_kernel<C><<<grid, kThreads, 0, s>>>(maps, loc, out, M, H, W);
}

}  // namespace

extern "C" {

// out must be zeroed by the caller. Returns cudaGetLastError() after launch.
int tef_splat_bilinear(const float* loc, const float* values, float* out,
                       int B, int M, int C, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: launch_splat<1>(loc, values, out, B, M, H, W, s); break;
    case 2: launch_splat<2>(loc, values, out, B, M, H, W, s); break;
    case 3: launch_splat<3>(loc, values, out, B, M, H, W, s); break;
    case 4: launch_splat<4>(loc, values, out, B, M, H, W, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int tef_gather_bilinear(const float* maps, const float* loc, float* out,
                        int B, int M, int C, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: launch_gather<1>(maps, loc, out, B, M, H, W, s); break;
    case 2: launch_gather<2>(maps, loc, out, B, M, H, W, s); break;
    case 3: launch_gather<3>(maps, loc, out, B, M, H, W, s); break;
    case 4: launch_gather<4>(maps, loc, out, B, M, H, W, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* tef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
