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
// builds dense [TH, E] x [E, TW] triangle-factor matmuls per image tile and
// sums its point chunks in grid order, so a run repeats bit for bit; on
// Hopper a point touches at most 4 pixels, so one thread per (point, batch)
// adds its taps into the image with atomics, and float atomics would sum in
// an order that changes from run to run. So the splat sums in fixed point:
// integer addition is associative, and the atomics' order changes no bit.
// One call is four launches on the stream, nothing read back by the host:
//   1. a zero fill of the scratch: int64 acc [B, H, W, C], a uint32 flag
//      word per pixel [B, H, W], and per batch lane its max |v| and its
//      count of rows with a non-zero value;
//   2. splat_scan_kernel: each lane's max |v| over its finite values (as
//      float bits through atomicMax, order-free: for non-negative floats
//      the bit pattern orders as the value) and its non-zero rows n
//      (atomicAdd of per-block counts);
//   3. splat_kernel: each tap's product t = w * v_c (w = wy * wx, both
//      products rounded in float as the plain version rounds them) adds
//      q = llrint(t * 2^k) to its pixel with a 64-bit integer atomicAdd.
//      The lane's scale exponent is k = 62 - ceil(log2(4 n)) - e, where
//      max |v| = f * 2^e (frexp, f in [0.5, 1)): every |q| <= 2^62 / 4n
//      and a pixel takes at most n non-zero products, so no sum can
//      overflow int64. k depends on the lane's own values alone, not on
//      B, M or its zero rows, so a lane splats to the same bits alone, in
//      a batch or padded (the batched sweep's [T*B] splat and the looped
//      sweep's agree bitwise);
//   4. splat_finish_kernel: out = float(acc) * 2^-k, the int64 rounded to
//      float once and then scaled exactly (a result below float's normal
//      range rounds a second time, by at most 2^-150).
// Error bound: each tap's q is within 1/2 of t * 2^k, so a pixel holding m
// taps of non-zero product is within m * 2^(-k-1) + ulp(out) / 2 of the
// exact sum of its products t. At DSEC (~400k non-zero rows of 655,360,
// max |v| <= 10: k = 62 - 21 - 4 = 37) that is m * 3.6e-12, far inside
// the plain version's own float rounding; a product under 2^(-k-1) adds
// nothing. A product that is NaN or +-Inf cannot be held in an integer: it
// sets its bit (NaN, +Inf, -Inf for each channel) in the pixel's flag word
// with atomicOr, also order-free, and the finish pass writes NaN where
// float addition would (a NaN, or +Inf and -Inf both), else the infinity.
// A tap whose product rounds to q = 0 issues no atomic for that channel,
// so the rows that carry zero values, which all sit at one pixel (the eval
// window's ~255k padding rows and the events that purge_unfeasible moves to
// (0, 0)), cost the read of their 8 + 4C bytes and nothing else: adding 0
// changes no integer, and a zero pixel comes out +0, as the plain version's
// +0 start makes it. Integer coordinates (the round_idx splats of RSAT/FWL)
// issue one tap, not four. Sums of small integers (the count planes) come
// out exact, as before. Bound on this card: bytes. Each point reads 8 + 4C
// bytes and the output is written once (at DSEC, M = 655,360, C = 4:
// 15.7 MB read, 4.9 MB written, ~6 us at 3.35 TB/s); beyond that bound the
// call moves the int64 image three times (zero fill, atomics, finish: ~10
// MB each at DSEC, L2-resident), reads the values a second time for the
// scan, and issues C scalar 64-bit atomics a tap where a float kernel
// would issue one vector reduction: the atomics bind it at the training
// shapes, where every row carries values.
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
// gv unused, so the caller passes a null gv). It writes d_loc [B, M, 2] in
// (y, x) order, the location gradient as autograd takes it. The TPU kernel
// builds dense [TH, E] triangle and derivative factor tiles for the MXU
// because the TPU has no fast gather; here each point reads its own taps,
// with no atomics and no shared memory. dtri is the Pallas `_stencil`
// (pallas_warp.py:71-78), jax's autodiff rule for max(0, 1 - |d|): per
// axis, over the taps floor-1, floor, floor+1,
//     frac > 0:  tri = (0, 1-f, f),  dtri = (0,    -1, +1)
//     frac == 0: tri = (0, 1,   0),  dtri = (-0.5, -1, +0.5)
// Bound on this card: bytes. Per point it reads loc (8 B) and values (4C B)
// and writes d_loc (8 B), and 4C B more with gv; the maps (128x128xC floats
// a lane at the training shape, at most 2.1 MB a launch) are read from HBM
// once and then hit in L2. Those are the bytes chip_smoke.py counts. What
// goes through L1 beyond them is the taps: a fractional point reads 2 x 2
// tap pixels, two neighbours per row. At C = 4 a row's pair is 32 B, one
// 32-byte sector when the first tap's x is even and two when it is odd (1.5
// a row); at C = 2 it is 16 B, two sectors only when x % 4 == 3 (1.25 a
// row). So a point touches ~3 tap sectors at C = 4 and ~2.5 at C = 2 (more
// at an integer coordinate, with three taps on that axis), beside 1 (C = 4)
// or 0.75 (C = 2) sector of loc, values and d_loc: ~4x the bytes bound's
// traffic, in four scattered loads a point (each a different cache line
// for each thread of a warp). The design:
// - loc is one float2 load and each tap pixel and value row one float4
//   (C = 4) or float2 (C = 2) load, through the read-only path; d_loc is one
//   float2 store per point and gv one vector store (a misaligned input takes
//   the scalar instance);
// - a point fractional on both axes (read_quad, quad_sums) loads its 2 x 2
//   taps up front and sums them with tri (1 - f, f) and dtri (-1, +1); an
//   out-of-frame tap is read as 0. A point with an integer coordinate takes
//   the general path (dual_sums): each axis cut to its taps of non-zero
//   weight inside the frame (dual_axis), three at an integer coordinate;
// - each thread takes kFusedPoints points of one lane, blockDim.x apart
//   (coalesced), with the loads of all their taps before any sum;
// - without gv, a row whose values are all zero reads no taps and writes
//   d_loc = (+0, +0): the events that purge_unfeasible moved to (0, 0) with
//   a zero mask, padding rows and events whose location gets no gradient
//   (about half the C = 4 rows and two thirds of the C = 2 rows of a
//   training step).
// On an H100 the kernel takes ~2.7x its bound at C = 4 and ~2.9x at C = 2,
// ~1.6x with a training step's share of zero-valued rows (PERF.md). In
// every case the tap sectors counted above pass through L2 at 4.3-4.7
// TB/s, and no launch shape, occupancy or schedule tried moved that by
// more than ~5%: the tap traffic binds it.
// Products and sums use __fmul_rn/__fadd_rn (no FMA contraction) in the
// order y tap, x tap, channel, each sum starting at +0, as the plain PyTorch
// version sums, so the two agree bitwise on finite maps: a sum that starts
// at +0 is never -0 under round-to-nearest, so the terms skipped here, and
// the out-of-frame taps added as 0, each +-0 (a zero weight, value or tap
// times a finite number), change no bit. The one difference: a NaN or Inf
// in a skipped tap or under a zero-valued row, which the plain version
// turns into NaN (as for gather_kernel).
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
// the fused gather's: the fastest of the same six shapes at the training
// step's shapes (tools/bench_fused_shapes.py, PERF.md)
constexpr int kFusedThreads = 128;
constexpr int kFusedPoints = 1;

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

// A lane's scale exponent k (see the header) from its max |v| (as float
// bits) and its count of non-zero rows n: k = 62 - ceil(log2(4 n)) - e
// with max |v| = f * 2^e, f in [0.5, 1), so a pixel's sum of n products
// scaled by 2^k stays within 2^62.
__device__ __forceinline__ int splat_exponent(const unsigned* lane) {
  int e;
  frexpf(__uint_as_float(lane[0]), &e);  // e = 0 for max |v| = 0
  const unsigned long long n4 = 4ull * max(lane[1], 1u);
  return 62 - (64 - __clzll(n4 - 1)) - e;
}

// The flag bit of a non-finite product of channel c: NaN, +Inf, -Inf.
__device__ __forceinline__ unsigned nonfinite_bit(float t, int c) {
  const unsigned bit = isnan(t) ? 1u : (t > 0.0f ? 2u : 4u);
  return bit << (3 * c);
}

// Per lane (blockIdx.y) of values [B, M, C]: the max |v| over its finite
// entries, as float bits, into lanes[2 b], and its rows with a finite
// non-zero value into lanes[2 b + 1] (both zeroed by the caller): a
// grid-stride loop over the lane's rows, warp and block reductions, then
// one atomicMax and one atomicAdd a block.
template <int C>
__global__ void __launch_bounds__(kThreads)
splat_scan_kernel(const float* __restrict__ values, int M,
                  unsigned* __restrict__ lanes) {
  const float* lane = values + (int64_t)blockIdx.y * M * C;
  unsigned m = 0, n = 0;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < M;
       r += gridDim.x * blockDim.x) {
    bool live = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float a = fabsf(__ldg(lane + (int64_t)r * C + c));
      if (isfinite(a)) {
        m = max(m, __float_as_uint(a));
        live |= a != 0.0f;
      }
    }
    n += live;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    n += __shfl_xor_sync(0xffffffffu, n, off);
  }
  __shared__ unsigned warp_m[kThreads / 32], warp_n[kThreads / 32];
  if ((threadIdx.x & 31) == 0) {
    warp_m[threadIdx.x >> 5] = m;
    warp_n[threadIdx.x >> 5] = n;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const bool have = threadIdx.x < kThreads / 32;
    m = have ? warp_m[threadIdx.x] : 0u;
    n = have ? warp_n[threadIdx.x] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
      n += __shfl_xor_sync(0xffffffffu, n, off);
    }
    if (threadIdx.x == 0) {
      if (m != 0) atomicMax(lanes + 2 * blockIdx.y, m);
      if (n != 0) atomicAdd(lanes + 2 * blockIdx.y + 1, n);
    }
  }
}

template <int C, bool V>
__global__ void __launch_bounds__(kThreads)
splat_kernel(const float* __restrict__ loc, const float* __restrict__ values,
             unsigned long long* __restrict__ acc,
             unsigned* __restrict__ flags, const unsigned* __restrict__ lanes,
             int M, int H, int W) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M) return;
  const int b = blockIdx.y;
  const int64_t row = (int64_t)b * M + e;
  const float2 p = load_loc<V>(loc, row);
  float v[C];
  load_row<C, V>(values + row * C, v);
  const double scale = ldexp(1.0, splat_exponent(lanes + 2 * b));

  const float y0 = floorf(p.x);
  const float x0 = floorf(p.y);
  const float fy = p.x - y0;
  const float fx = p.y - x0;
  // an exactly-integer coordinate has a single tap of weight 1
  const int ny = fy != 0.0f ? 2 : 1;
  const int nx = fx != 0.0f ? 2 : 1;
  const int64_t plane = (int64_t)b * H * W;
  for (int dy = 0; dy < ny; ++dy) {
    const float ty = y0 + (float)dy;
    if (!(ty >= 0.0f && ty <= (float)(H - 1))) continue;  // also drops NaN
    const float wy = dy ? fy : 1.0f - fy;
    for (int dx = 0; dx < nx; ++dx) {
      const float tx = x0 + (float)dx;
      if (!(tx >= 0.0f && tx <= (float)(W - 1))) continue;
      const float wx = dx ? fx : 1.0f - fx;
      const float w = __fmul_rn(wy, wx);
      const int64_t pix = plane + (int64_t)ty * W + (int64_t)tx;
      unsigned bad = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float t = __fmul_rn(w, v[c]);
        if (!isfinite(t)) {
          bad |= nonfinite_bit(t, c);
          continue;
        }
        // exact in double (a float times a power of two), then rounded to
        // the nearest integer once; a negative q wraps in two's complement
        const long long q = __double2ll_rn((double)t * scale);
        if (q != 0) atomicAdd(acc + pix * C + c, (unsigned long long)q);
      }
      if (bad) atomicOr(flags + pix, bad);
    }
  }
}

// out [B, H, W, C] from the fixed-point sums and the flag words: one thread
// per pixel.
template <int C, bool V>
__global__ void __launch_bounds__(kThreads)
splat_finish_kernel(const long long* __restrict__ acc,
                    const unsigned* __restrict__ flags,
                    const unsigned* __restrict__ lanes,
                    float* __restrict__ out, int64_t pixels, int64_t hw) {
  const int64_t pix = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= pixels) return;
  const int k = splat_exponent(lanes + 2 * (pix / hw));
  const unsigned f = __ldg(flags + pix);
  float r[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const unsigned bits = (f >> (3 * c)) & 7u;
    if ((bits & 1u) || bits == 6u) {
      r[c] = __uint_as_float(0x7fffffffu);  // NaN, or +Inf plus -Inf
    } else if (bits == 2u) {
      r[c] = __uint_as_float(0x7f800000u);  // +Inf
    } else if (bits == 4u) {
      r[c] = __uint_as_float(0xff800000u);  // -Inf
    } else {
      r[c] = scalbnf(__ll2float_rn(__ldg(acc + pix * C + c)), -k);
    }
  }
  store_row<C, V>(out + pix * C, r);
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

// One axis of the dual stencil at coordinate c, cut to its taps of
// non-zero weight inside [0, size - 1]: n taps (0..3) from `first`, with
// weights tri[i], dtri[i] for i < n.
struct DualAxis {
  int first;
  int n;
  float tri[3];
  float dtri[3];
};

__device__ __forceinline__ DualAxis dual_axis(float c, int size) {
  const float c0 = floorf(c);
  const float f = c - c0;
  const bool integer = f == 0.0f;
  // the taps lo .. c0 + 1 and their weights: floor and floor + 1 at a
  // fractional coordinate, floor - 1 .. floor + 1 at an integer one
  const float lo = integer ? c0 - 1.0f : c0;
  const float hi = c0 + 1.0f;
  const float t[3] = {integer ? 0.0f : 1.0f - f, integer ? 1.0f : f, 0.0f};
  const float d[3] = {integer ? -0.5f : -1.0f, integer ? -1.0f : 1.0f, 0.5f};
  DualAxis a;
  a.first = 0;
  a.n = 0;
  if (!(hi >= 0.0f && lo <= (float)(size - 1))) {  // out of frame, or NaN
#pragma unroll
    for (int i = 0; i < 3; ++i) a.tri[i] = a.dtri[i] = 0.0f;
    return a;
  }
  const float first = lo < 0.0f ? 0.0f : lo;
  const float last = hi > (float)(size - 1) ? (float)(size - 1) : hi;
  const int skip = (int)(first - lo);  // taps below the frame: 0, 1 or 2
  a.first = (int)first;
  a.n = (int)(last - first) + 1;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int k1 = i + 1 < 3 ? i + 1 : 2, k2 = 2;  // (i + skip), clamped
    a.tri[i] = skip == 0 ? t[i] : skip == 1 ? t[k1] : t[k2];
    a.dtri[i] = skip == 0 ? d[i] : skip == 1 ? d[k1] : d[k2];
  }
  return a;
}

// The general path of the fused gather: one point's sums over its dual
// stencil (dual_axis on each axis), reading each tap row as it goes; in
// the kernel's order (y tap, x tap, channel). Taken by points with an
// integer (or non-finite) coordinate.
template <int C, bool V, bool G>
__device__ __forceinline__ void dual_sums(const float* img, float2 p, int H,
                                          int W, float* g, float* sy,
                                          float* sx) {
  const DualAxis y = dual_axis(p.x, H);
  const DualAxis x = dual_axis(p.y, W);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i >= y.n) break;
    const float* row = img + ((int64_t)(y.first + i) * W + x.first) * C;
    float m[3][C];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j < x.n) load_row<C, V>(row + j * C, m[j]);
    }
    // the x contraction of this tap row with tri (a) and dtri (bx)
    float a[C], bx[C];
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = bx[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j >= x.n) break;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        a[c] = __fadd_rn(a[c], __fmul_rn(x.tri[j], m[j][c]));
        bx[c] = __fadd_rn(bx[c], __fmul_rn(x.dtri[j], m[j][c]));
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (G) g[c] = __fadd_rn(g[c], __fmul_rn(y.tri[i], a[c]));
      sy[c] = __fadd_rn(sy[c], __fmul_rn(y.dtri[i], a[c]));
      sx[c] = __fadd_rn(sx[c], __fmul_rn(y.tri[i], bx[c]));
    }
  }
}

// A point whose coordinates are both fractional: its 2 x 2 taps
// (y0 + i, x0 + j), read up front, an out-of-frame one as 0.
template <int C>
struct QuadTaps {
  float fy, fx;  // the fractions; 0 marks a point for the general path
  float m[2][2][C];
};

template <int C, bool V>
__device__ __forceinline__ void read_quad(const float* img, float2 p, int H,
                                          int W, QuadTaps<C>& q) {
  const float y0 = floorf(p.x);
  const float x0 = floorf(p.y);
  q.fy = p.x - y0;
  q.fx = p.y - x0;
  // NaN and Inf give a NaN fraction: the general path drops them
  if (!(q.fy > 0.0f && q.fx > 0.0f)) {
    q.fy = 0.0f;
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float ty = y0 + (float)i;
    const bool in_y = ty >= 0.0f && ty <= (float)(H - 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float tx = x0 + (float)j;
      if (in_y && tx >= 0.0f && tx <= (float)(W - 1)) {
        load_row<C, V>(img + ((int64_t)ty * W + (int64_t)tx) * C, q.m[i][j]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) q.m[i][j][c] = 0.0f;
      }
    }
  }
}

// The sums of a fractional point: tri (1 - f, f) and dtri (-1, +1) on both
// axes, in the general path's order. An out-of-frame tap adds w * 0 = +-0,
// which changes no bit of a sum that starts at +0.
template <int C, bool G>
__device__ __forceinline__ void quad_sums(const QuadTaps<C>& q, float* g,
                                          float* sy, float* sx) {
  const float wy[2] = {1.0f - q.fy, q.fy};
  const float wx[2] = {1.0f - q.fx, q.fx};
  const float dw[2] = {-1.0f, 1.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float a[C], bx[C];
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = bx[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        a[c] = __fadd_rn(a[c], __fmul_rn(wx[j], q.m[i][j][c]));
        bx[c] = __fadd_rn(bx[c], __fmul_rn(dw[j], q.m[i][j][c]));
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (G) g[c] = __fadd_rn(g[c], __fmul_rn(wy[i], a[c]));
      sy[c] = __fadd_rn(sy[c], __fmul_rn(dw[i], a[c]));
      sx[c] = __fadd_rn(sx[c], __fmul_rn(wy[i], bx[c]));
    }
  }
}

// G: gv is written (and every row reads its taps).
template <int C, bool V, bool G>
__global__ void __launch_bounds__(kFusedThreads)
gather_fused_kernel(const float* __restrict__ maps,
                    const float* __restrict__ loc,
                    const float* __restrict__ values, float* __restrict__ gv,
                    float* __restrict__ d_loc, int M, int H, int W) {
  const int b = blockIdx.y;
  const int stride = blockDim.x;
  const int first = blockIdx.x * stride * kFusedPoints + threadIdx.x;
  const float* img = maps + (int64_t)b * H * W * C;
  // every point's loc and values, then the taps of every fractional point,
  // then the sums
  float2 p[kFusedPoints];
  float v[kFusedPoints][C];
#pragma unroll
  for (int k = 0; k < kFusedPoints; ++k) {
    const int e = first + k * stride;
    if (e < M) {
      const int64_t row = (int64_t)b * M + e;
      p[k] = load_loc<V>(loc, row);
      load_row<C, V>(values + row * C, v[k]);
    }
  }
  bool skip[kFusedPoints];
  QuadTaps<C> q[kFusedPoints];
#pragma unroll
  for (int k = 0; k < kFusedPoints; ++k) {
    skip[k] = !G && first + k * stride < M;
#pragma unroll
    for (int c = 0; c < C; ++c) skip[k] &= v[k][c] == 0.0f;  // NaN is not 0
    // d_loc = (+0, +0) without reading a tap where every value is zero
    if (!skip[k] && first + k * stride < M) {
      read_quad<C, V>(img, p[k], H, W, q[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kFusedPoints; ++k) {
    const int e = first + k * stride;
    if (e >= M) break;
    float g[C], sy[C], sx[C];
#pragma unroll
    for (int c = 0; c < C; ++c) g[c] = sy[c] = sx[c] = 0.0f;
    if (!skip[k]) {
      if (q[k].fy != 0.0f) {
        quad_sums<C, G>(q[k], g, sy, sx);
      } else {
        dual_sums<C, V, G>(img, p[k], H, W, g, sy, sx);
      }
    }
    float ddy = 0.0f, ddx = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ddy = __fadd_rn(ddy, __fmul_rn(v[k][c], sy[c]));
      ddx = __fadd_rn(ddx, __fmul_rn(v[k][c], sx[c]));
    }
    const int64_t row = (int64_t)b * M + e;
    if (V) {
      reinterpret_cast<float2*>(d_loc)[row] = make_float2(ddy, ddx);
    } else {
      d_loc[2 * row] = ddy;
      d_loc[2 * row + 1] = ddx;
    }
    if (G) store_row<C, V>(gv + row * C, g);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (uintptr_t)p % bytes == 0;
}

// The splat's three kernels on the zeroed scratch (see the header): the
// vector instance of splat_kernel when loc is 8-byte aligned and each value
// row 4C-byte aligned (C = 2, 4), else the scalar one; out is 4C-byte
// aligned (the entry point checks).
template <int C>
void launch_splat(const float* loc, const float* values, float* out, int B,
                  int M, int H, int W, unsigned long long* acc,
                  unsigned* flags, unsigned* lanes, cudaStream_t s) {
  // the scan: a grid-stride loop over each lane's rows, ~8 blocks an SM
  const int per_lane = B < 8 * 132 ? 8 * 132 / B : 1;
  const int blocks = (M + kThreads - 1) / kThreads;
  splat_scan_kernel<C>
      <<<dim3(blocks < per_lane ? blocks : per_lane, B), kThreads, 0, s>>>(
          values, M, lanes);
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  if (aligned(loc, 8) && aligned(values, 4 * C)) {
    splat_kernel<C, true><<<grid, kThreads, 0, s>>>(loc, values, acc, flags,
                                                    lanes, M, H, W);
  } else {
    splat_kernel<C, false><<<grid, kThreads, 0, s>>>(loc, values, acc, flags,
                                                     lanes, M, H, W);
  }
  const int64_t hw = (int64_t)H * W;
  const int64_t pixels = B * hw;
  splat_finish_kernel<C, true>
      <<<(unsigned)((pixels + kThreads - 1) / kThreads), kThreads, 0, s>>>(
          reinterpret_cast<const long long*>(acc), flags, lanes, out, pixels,
          hw);
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

// The vector instance when loc and d_loc are 8-byte aligned and every row
// pointer 4C-byte aligned (C = 2, 4), else the scalar one; gv written when
// not null.
template <int C>
void launch_gather_fused(const float* maps, const float* loc,
                         const float* values, float* gv, float* d_loc, int B,
                         int M, int H, int W, cudaStream_t s) {
  const int per_block = kFusedThreads * kFusedPoints;
  const dim3 grid((M + per_block - 1) / per_block, B);
  const bool v = aligned(loc, 8) && aligned(d_loc, 8) &&
                 aligned(maps, 4 * C) && aligned(values, 4 * C) &&
                 (gv == nullptr || aligned(gv, 4 * C));
  auto* kernel = v ? (gv ? &gather_fused_kernel<C, true, true>
                         : &gather_fused_kernel<C, true, false>)
                   : (gv ? &gather_fused_kernel<C, false, true>
                         : &gather_fused_kernel<C, false, false>);
  kernel<<<grid, kFusedThreads, 0, s>>>(maps, loc, values, gv, d_loc, M, H,
                                        W);
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

// Splats into out [B, H, W, C] through the fixed-point scratch, which must
// hold 8BHWC + 4BHW + 8B bytes, 8-byte aligned (the wrapper allocates it;
// this zeroes it on the stream). out must be aligned to 4C bytes for the
// vector stores of C = 2 and C = 4 (cudaErrorInvalidValue otherwise).
// Returns the first CUDA error.
int tef_splat_bilinear(const float* loc, const float* values, float* out,
                       int B, int M, int C, int H, int W, void* scratch,
                       void* stream) {
  if ((C == 2 || C == 4) && !aligned(out, 4 * C))
    return (int)cudaErrorInvalidValue;
  if (!aligned(scratch, 8)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t pixels = (int64_t)B * H * W;
  if (M == 0) {
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * (size_t)pixels * C,
                                s);
  }
  auto* acc = static_cast<unsigned long long*>(scratch);
  auto* flags = reinterpret_cast<unsigned*>(acc + pixels * C);
  unsigned* lanes = flags + pixels;  // [B, 2]: max |v| bits, non-zero rows
  const cudaError_t zeroed = cudaMemsetAsync(
      scratch, 0, (size_t)(8 * pixels * C + 4 * pixels + 8 * B), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  switch (C) {
    case 1: launch_splat<1>(loc, values, out, B, M, H, W, acc, flags, lanes, s); break;
    case 2: launch_splat<2>(loc, values, out, B, M, H, W, acc, flags, lanes, s); break;
    case 3: launch_splat<3>(loc, values, out, B, M, H, W, acc, flags, lanes, s); break;
    case 4: launch_splat<4>(loc, values, out, B, M, H, W, acc, flags, lanes, s); break;
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

// d_loc [B, M, 2] is (dy, dx) per point; gv may be null (not written).
int tef_gather_fused(const float* maps, const float* loc, const float* values,
                     float* gv, float* d_loc, int B, int M, int C, int H,
                     int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: launch_gather_fused<1>(maps, loc, values, gv, d_loc, B, M, H, W, s); break;
    case 2: launch_gather_fused<2>(maps, loc, values, gv, d_loc, B, M, H, W, s); break;
    case 3: launch_gather_fused<3>(maps, loc, values, gv, d_loc, B, M, H, W, s); break;
    case 4: launch_gather_fused<4>(maps, loc, values, gv, d_loc, B, M, H, W, s); break;
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
