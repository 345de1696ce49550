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
// on one tap and weight 0 on the other: the splat and the gather read and
// write only the first (a skipped tap would add 0 * m).
//
// Layouts (the JAX package's conventions, all float32, contiguous):
//   loc    [B, M, 2]  (y, x) pixel coordinates
//   values [B, M, C]  per-point values (splat input)
//   maps   [B, H, W, C] NHWC image (gather input), out [B, H, W, C] (splat)
// loc is read as one float2 per point, and a pixel or value row of C = 2 or
// C = 4 floats as one float2 or float4, when the pointers are aligned for it
// (the entry points check; a misaligned input takes the scalar instance).
//
// splat_kernel replaces the Pallas `_splat_kernel`
// (taming_event_flow_tpu/ops/pallas_warp.py:128, call :186). The TPU kernel
// builds dense [TH, E] x [E, TW] triangle-factor matmuls per image tile so
// the MXU does the scatter; on Hopper a point touches at most 4 pixels, so
// one thread per (point, batch) issues at most 4 atomic adds into an NHWC
// output the wrapper zeroes, one per tap: for C = 4 one 16-byte vector
// reduction (atomicAdd on a float4, RED.ADD.F32x4 on sm_90), for C = 2 one
// 8-byte one, for C = 1 and C = 3 C scalar ones. Bound on this card: bytes.
// Each point reads 8 + 4C bytes and the output is written once (at DSEC,
// M = 655,360, C = 4: 15.7 MB read, 4.9 MB written, ~6 us at 3.35 TB/s);
// the atomics land in L2 (the 4.9 MB image fits the 50 MB L2), so the cost
// is the point stream plus L2 atomic throughput. Integer coordinates (the
// round_idx splats of RSAT/FWL) issue one tap, not four. Atomics on one
// address serialise, and the rows that carry zero values all sit at one
// pixel: the eval window's ~255k padding rows and the events that
// purge_unfeasible moves to (0, 0). So a tap whose C products w * v_c are
// all zero issues no atomic, and such a row costs the read of its 8 + 4C
// bytes and nothing else. That is exact: adding +-0 to a pixel changes at
// most the sign of a zero pixel, and a product that is NaN is not zero and
// is added. Atomic order changes the summation order of non-integer sums
// from run to run; sums of small integers (the count planes) stay exact.
//
// gather_kernel replaces the Pallas `_gather_kernel`
// (pallas_warp.py:206, call :261). The TPU kernel contracts dense factors
// against whole image tiles; here each thread takes kGatherPoints points of
// one batch lane, blockDim.x apart (coalesced), loads all their locations,
// then all their taps (read-only path), then sums and stores each point's C
// outputs as one vector, so several points' scattered tap reads are in
// flight at once; no atomics. Bound: bytes (points in, values out; the map
// is read through L2/L1 and at 2.5 MB for a 480x640x2 flow map stays
// L2-resident). At an integer coordinate it reads one tap on that axis, not
// two: the last pass's pixel grid reads one tap per point instead of four.
// Products and sums use __fmul_rn/__fadd_rn in tap order (00, 01, 10, 11),
// so the result is the plain PyTorch version's bit for bit (no FMA
// contraction) up to what the skipped zero-weight taps would have added:
// 0 * m, which for a finite m changes at most the sign of a zero result,
// and which drops a NaN or Inf that sits only in a zero-weight tap (the
// plain version returns NaN there). Out-of-frame taps were already skipped.
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
// the gather's launch shape: the fastest of 128 and 256 threads x 1, 2 and
// 4 points per thread on an H100 (PERF.md)
constexpr int kGatherThreads = 128;
constexpr int kGatherPoints = 2;  // points per thread

// C floats at p (a pixel or a value row) as one float4 (C = 4) or float2
// (C = 2) through the read-only path when V (p aligned to 4C bytes), else
// one float at a time.
template <int C, bool V>
__device__ __forceinline__ void load_row(const float* p, float* v) {
  if constexpr (V && C == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V && C == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(p + c);
  }
}

template <int C, bool V>
__device__ __forceinline__ void store_row(float* p, const float* v) {
  if constexpr (V && C == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V && C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = v[c];
  }
}

// (y, x) of point `row`: one float2 when V (loc 8-byte aligned).
template <bool V>
__device__ __forceinline__ float2 load_loc(const float* loc, int64_t row) {
  if constexpr (V) {
    return __ldg(reinterpret_cast<const float2*>(loc) + row);
  } else {
    return make_float2(__ldg(loc + 2 * row), __ldg(loc + 2 * row + 1));
  }
}

// px[c] += v[c] as one vector reduction for C = 4 and C = 2 (px aligned to
// 4C bytes: the entry point checks), C scalar ones otherwise.
template <int C>
__device__ __forceinline__ void add_row(float* px, const float* v) {
  if constexpr (C == 4) {
    atomicAdd(reinterpret_cast<float4*>(px), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(px), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(px + c, v[c]);
  }
}

template <int C, bool V>
__global__ void __launch_bounds__(kThreads)
splat_kernel(const float* __restrict__ loc, const float* __restrict__ values,
             float* __restrict__ out, int M, int H, int W) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M) return;
  const int b = blockIdx.y;
  const int64_t row = (int64_t)b * M + e;
  const float2 p = load_loc<V>(loc, row);
  float v[C];
  load_row<C, V>(values + row * C, v);

  const float y0 = floorf(p.x);
  const float x0 = floorf(p.y);
  const float fy = p.x - y0;
  const float fx = p.y - x0;
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
      float t[C];
      bool nonzero = false;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        t[c] = __fmul_rn(w, v[c]);
        nonzero |= t[c] != 0.0f;  // NaN counts as non-zero
      }
      if (nonzero) add_row<C>(img + ((int64_t)ty * W + (int64_t)tx) * C, t);
    }
  }
}

// One point's taps: the tap pixels' values (read only where `use`), the
// weights, and whether each tap is read at all.
template <int C>
struct Taps {
  float m[4][C];
  float w[4];
  bool use[4];
};

template <int C, bool V>
__device__ __forceinline__ void read_taps(const float* img, float2 p, int H,
                                          int W, Taps<C>& t) {
  const float y0 = floorf(p.x);
  const float x0 = floorf(p.y);
  const float fy = p.x - y0;
  const float fx = p.y - x0;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const float ty = y0 + (float)dy;
    // the second tap of an integer coordinate has weight 0: not read
    const bool in_y = ty >= 0.0f && ty <= (float)(H - 1) &&  // drops NaN
                      (dy == 0 || fy != 0.0f);
    const float wy = dy ? fy : 1.0f - fy;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int k = 2 * dy + dx;
      const float tx = x0 + (float)dx;
      t.use[k] = in_y && tx >= 0.0f && tx <= (float)(W - 1) &&
                 (dx == 0 || fx != 0.0f);
      t.w[k] = __fmul_rn(wy, dx ? fx : 1.0f - fx);
      if (t.use[k]) {
        load_row<C, V>(img + ((int64_t)ty * W + (int64_t)tx) * C, t.m[k]);
      }
    }
  }
}

template <int C, bool V>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const float* __restrict__ maps, const float* __restrict__ loc,
              float* __restrict__ out, int M, int H, int W) {
  const int b = blockIdx.y;
  const int stride = blockDim.x;
  const int first = blockIdx.x * stride * kGatherPoints + threadIdx.x;
  const float* img = maps + (int64_t)b * H * W * C;
  float2 p[kGatherPoints];
#pragma unroll
  for (int k = 0; k < kGatherPoints; ++k) {
    const int e = first + k * stride;
    if (e < M) p[k] = load_loc<V>(loc, (int64_t)b * M + e);
  }
  Taps<C> t[kGatherPoints];
#pragma unroll
  for (int k = 0; k < kGatherPoints; ++k) {
    if (first + k * stride < M) read_taps<C, V>(img, p[k], H, W, t[k]);
  }
#pragma unroll
  for (int k = 0; k < kGatherPoints; ++k) {
    const int e = first + k * stride;
    if (e >= M) break;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!t[k].use[j]) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c] = __fadd_rn(acc[c], __fmul_rn(t[k].w[j], t[k].m[j][c]));
      }
    }
    store_row<C, V>(out + ((int64_t)b * M + e) * C, acc);
  }
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

bool aligned(const void* p, uintptr_t bytes) {
  return (uintptr_t)p % bytes == 0;
}

// The vector instance when loc is 8-byte aligned and each row pointer is
// 4C-byte aligned (C = 2, 4), else the scalar one.
template <int C>
void launch_splat(const float* loc, const float* values, float* out, int B,
                  int M, int H, int W, cudaStream_t s) {
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  if (aligned(loc, 8) && aligned(values, 4 * C)) {
    splat_kernel<C, true><<<grid, kThreads, 0, s>>>(loc, values, out, M, H, W);
  } else {
    splat_kernel<C, false><<<grid, kThreads, 0, s>>>(loc, values, out, M, H, W);
  }
}

template <int C>
void launch_gather(const float* maps, const float* loc, float* out, int B,
                   int M, int H, int W, cudaStream_t s) {
  const int per_block = kGatherThreads * kGatherPoints;
  const dim3 grid((M + per_block - 1) / per_block, B);
  if (aligned(loc, 8) && aligned(maps, 4 * C) && aligned(out, 4 * C)) {
    gather_kernel<C, true><<<grid, kGatherThreads, 0, s>>>(maps, loc, out, M,
                                                           H, W);
  } else {
    gather_kernel<C, false><<<grid, kGatherThreads, 0, s>>>(maps, loc, out, M,
                                                            H, W);
  }
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

// Zeroes out [B, H, W, C] on the stream, then splats into it. out must be
// aligned to 4C bytes for the vector atomics of C = 2 and C = 4
// (cudaErrorInvalidValue otherwise). Returns the first CUDA error.
int tef_splat_bilinear(const float* loc, const float* values, float* out,
                       int B, int M, int C, int H, int W, void* stream) {
  if ((C == 2 || C == 4) && !aligned(out, 4 * C))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(
      out, 0, sizeof(float) * (size_t)B * H * W * C, s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  if (M == 0) return 0;
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
