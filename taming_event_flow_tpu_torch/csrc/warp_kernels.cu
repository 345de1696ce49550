// Bilinear splat, gather and fused dual-stencil gather (the backward of both),
// and the row gather, for Hopper (sm_90a), with a plain C interface
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
//
// gather_fused_kernel replaces the Pallas `_gather_fused_kernel`
// (pallas_warp.py:281, call :361): in one pass over a point's taps it
// computes the gather and both location derivatives, contracted with
// per-point values over channels,
//     gv[c] = sum tri(y-h) tri(x-w) m_c
//     dy    = sum_c v_c sum dtri(y-h) tri(x-w) m_c
//     dx    = sum_c v_c sum tri(y-h) dtri(x-w) m_c
// which is the whole backward of the splat (m = the cotangent image,
// v = the splatted values; gv = d_values, (dy, dx) = d_loc) and the location
// half of the gather's backward (m = the gathered maps, v = the cotangent;
// gv unused, so the caller passes a null gv and the kernel skips it).
// The TPU kernel builds dense [TH, E] triangle and derivative factor tiles
// for the MXU because the TPU has no fast gather; on Hopper one thread per
// (point, batch) reads its taps x C channels of maps and writes C + 2
// outputs, with no atomics and no shared memory. dtri is the Pallas
// `_stencil` (pallas_warp.py:71-78), jax's autodiff rule for
// max(0, 1 - |d|): per axis, over the taps floor-1, floor, floor+1,
//     frac > 0:  tri = (0, 1-f, f),  dtri = (0,    -1, +1)
//     frac == 0: tri = (0, 1,   0),  dtri = (-0.5, -1, +0.5)
// so an exactly-integer coordinate reads three taps on that axis where the
// forward gather reads one; a fractional point reads 2x2 taps. Each tap is
// tested against [0, H-1] x [0, W-1] in float like gather_kernel (which also
// drops NaN). Bound on this card: bytes. Per point it reads 8 + 4C bytes of
// loc and values and writes 4C + 8 (4C of them only with gv); the taps' map
// rows are L2-resident (128x128x4 floats = 256 KB per lane at the training
// shape). Products and sums use __fmul_rn/__fadd_rn in a fixed order (y tap,
// then x tap, then channel) that the plain PyTorch version repeats, so the
// two agree bitwise.
//
// row_gather_kernel replaces the TPU row fetch `dma_gather`
// (scripts/bench_dma_gather.py:54, call :99), which issues one HBM->VMEM DMA
// per row through a ring of DMA semaphores. It computes the row gather
//     out[m, :] = table[clamp(idx[m], 0, R - 1), :]
// for table [R, W] float32, idx [M] int32, out [M, W]. An index outside
// [0, R - 1] is clamped to it (the rule of XLA's gather), so the kernel never
// reads outside the table; the plain version clamps the same way. The DMA
// ring's depth and block have no counterpart here: one thread per (row,
// vector) of the output, and the card hides the latency of scattered reads
// by keeping many threads in flight. A vector is a float4 when W % 4 == 0 and
// table and out are 16-byte aligned, a float2 when W % 2 == 0 and they are
// 8-byte aligned, one float otherwise; neighbouring threads read one row's
// vectors and write neighbouring addresses. Offsets are int64 (idx * W
// overflows int32 for large tables). Bound on this card: bytes,
// M * (4 + 2 * 4W) (the index read once, each gathered row read once and
// written once; at the rectified DSEC remap, M = 3,072,000 and W = 2: 61 MB,
// ~18 us at 3.35 TB/s). It is a copy, so it is bitwise the plain version.

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

// The dual stencil of one axis over the taps floor(c) - 1 + k, k = 0, 1, 2:
// weights tri/dtri (zero for a tap outside [0, size - 1]), the tap index and
// whether the tap has to be read at all.
__device__ __forceinline__ void dual_axis(float c, int size, float* tri,
                                          float* dtri, int* tap, bool* need) {
  const float c0 = floorf(c);
  const float f = c - c0;
  const bool integer = f == 0.0f;
  const float t3[3] = {0.0f, 1.0f - f, f};
  const float d3[3] = {integer ? -0.5f : 0.0f, -1.0f, integer ? 0.5f : 1.0f};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t = c0 + (float)(k - 1);
    const bool ok = t >= 0.0f && t <= (float)(size - 1);  // also drops NaN
    tri[k] = ok ? t3[k] : 0.0f;
    dtri[k] = ok ? d3[k] : 0.0f;
    need[k] = ok && (t3[k] != 0.0f || d3[k] != 0.0f);
    tap[k] = need[k] ? (int)t : 0;
  }
}

template <int C>
__global__ void gather_fused_kernel(const float* __restrict__ maps,
                                    const float* __restrict__ loc,
                                    const float* __restrict__ values,
                                    float* __restrict__ gv,
                                    float* __restrict__ dy,
                                    float* __restrict__ dx, int M, int H,
                                    int W) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M) return;
  const int b = blockIdx.y;
  const int64_t row = (int64_t)b * M + e;
  float wy[3], dwy[3], wx[3], dwx[3];
  int ty[3], tx[3];
  bool ny[3], nx[3];
  dual_axis(loc[2 * row], H, wy, dwy, ty, ny);
  dual_axis(loc[2 * row + 1], W, wx, dwx, tx, nx);
  const float* img = maps + (int64_t)b * H * W * C;
  float g[C], sy[C], sx[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = sy[c] = sx[c] = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    // a: the x contraction with tri, bx: with dtri, for this y tap
    float a[C], bx[C];
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = bx[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const bool need = ny[i] && nx[j];
      const float* px = img + ((int64_t)ty[i] * W + tx[j]) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float m = need ? px[c] : 0.0f;
        a[c] = __fadd_rn(a[c], __fmul_rn(wx[j], m));
        bx[c] = __fadd_rn(bx[c], __fmul_rn(dwx[j], m));
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      g[c] = __fadd_rn(g[c], __fmul_rn(wy[i], a[c]));
      sy[c] = __fadd_rn(sy[c], __fmul_rn(dwy[i], a[c]));
      sx[c] = __fadd_rn(sx[c], __fmul_rn(wy[i], bx[c]));
    }
  }
  float ddy = 0.0f, ddx = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float v = values[row * C + c];
    ddy = __fadd_rn(ddy, __fmul_rn(v, sy[c]));
    ddx = __fadd_rn(ddx, __fmul_rn(v, sx[c]));
  }
  if (gv != nullptr) {
#pragma unroll
    for (int c = 0; c < C; ++c) gv[row * C + c] = g[c];
  }
  dy[row] = ddy;
  dx[row] = ddx;
}

template <int C>
void launch_gather_fused(const float* maps, const float* loc,
                         const float* values, float* gv, float* dy, float* dx,
                         int B, int M, int H, int W, cudaStream_t s) {
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  gather_fused_kernel<C><<<grid, kThreads, 0, s>>>(maps, loc, values, gv, dy,
                                                   dx, M, H, W);
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

// V is float4, float2 or float; nv = W / (floats per V) vectors per row.
template <typename V>
__global__ void row_gather_kernel(const V* __restrict__ table,
                                  const int* __restrict__ idx,
                                  V* __restrict__ out, int64_t total, int R,
                                  int nv) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t m = t / nv;
  const int v = (int)(t - m * nv);
  const int r = min(max(__ldg(idx + m), 0), R - 1);
  out[t] = table[(int64_t)r * nv + v];
}

template <typename V>
void launch_row_gather(const float* table, const int* idx, float* out,
                       int64_t M, int R, int nv, cudaStream_t s) {
  const int64_t total = M * nv;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  row_gather_kernel<V><<<blocks, kThreads, 0, s>>>(
      reinterpret_cast<const V*>(table), idx, reinterpret_cast<V*>(out),
      total, R, nv);
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

// gv may be null (not written); dy and dx may not.
int tef_gather_fused(const float* maps, const float* loc, const float* values,
                     float* gv, float* dy, float* dx, int B, int M, int C,
                     int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: launch_gather_fused<1>(maps, loc, values, gv, dy, dx, B, M, H, W, s); break;
    case 2: launch_gather_fused<2>(maps, loc, values, gv, dy, dx, B, M, H, W, s); break;
    case 3: launch_gather_fused<3>(maps, loc, values, gv, dy, dx, B, M, H, W, s); break;
    case 4: launch_gather_fused<4>(maps, loc, values, gv, dy, dx, B, M, H, W, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out[m, :] = table[clamp(idx[m], 0, R - 1), :]; table [R, W], out [M, W].
int tef_row_gather(const float* table, const int* idx, float* out, int64_t M,
                   int R, int W, void* stream) {
  if (M <= 0) return 0;
  if (R <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if ((M * W + kThreads - 1) / kThreads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;  // beyond the grid's x limit
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t both = (uintptr_t)table | (uintptr_t)out;
  if (W % 4 == 0 && both % 16 == 0) {
    launch_row_gather<float4>(table, idx, out, M, R, W / 4, s);
  } else if (W % 2 == 0 && both % 8 == 0) {
    launch_row_gather<float2>(table, idx, out, M, R, W / 2, s);
  } else {
    launch_row_gather<float>(table, idx, out, M, R, W, s);
  }
  return (int)cudaGetLastError();
}

const char* tef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
