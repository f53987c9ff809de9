// Skinny-M quantized GEMV for the packed 4/5-bit and the unpacked 8-bit
// weight planes (qmatmul.cu at M <= 8), and the planes' layout,
// level fetch and block reductions that every kernel of the port shares
// (the tensor-core GEMVs of qgemv_mma.cuh and qgemv_b1.cuh and the
// refill GEMM of prefill.cu read the same planes).
//
// Weight layout (biogpt_tpu_torch/quant/layouts.py), one of three level
// planes, the format BITS a template parameter beside HAS_MIN:
//   4 (Q4_0, Q4_1): uint8 (d_in/2, d_out) in split-half order -- byte row i
//     holds level row i in its low nibble and level row i + d_in/2 in its
//     high nibble, UNCENTERED (0..15);
//   5 (Q5_0, Q5_1): those nibble rows, then a split-eighth fifth-bit plane
//     of d_in/8 rows (bit p of plane row j is bit 4 of level row
//     p*d_in/8 + j), levels UNCENTERED (0..31). Since d_in/2 = 4 * d_in/8,
//     level rows k and k + d_in/2 take their fifth bits from the same plane
//     row k mod d_in/8, at bits q and q + 4 (q = k div d_in/8): one u32 load
//     per packed row gives both halves' bits for a lane's 4 columns, ORed
//     into the levels as integers before the float conversion, as the TPU
//     kernel does (pallas_qmatmul.py::unpack_levels_swar);
//   8 (Q8_0): int8 (d_in, d_out), levels already centered (offset 0).
// Scales and mins are bf16 (d_in/32, d_out) planes.
//
// Work split (the same for every format): a block owns TILE_COLS = 128
// output columns (32 lanes x 4 columns, one u32 load per level row per
// lane, so a warp reads 128 contiguous bytes of a row) and `gpb` packed
// 32-row groups along d_in. Packed group g carries level blocks g (rows
// g*32 + r, "low") and g + nbh (rows d_in/2 + g*32 + r, "high"), nbh =
// d_in/64. The block's warps stride over its groups; their per-column sums
// reduce across warps in shared memory in a fixed order, and across the
// blocks of a column tile (grid.y) in a second pass (epilogue kernels
// below) -- no atomics, so every run sums in one order, the same order for
// every format.
//
// Numerics XPRIME, those of biogpt_tpu/ops/pallas_qmatmul.py::
// qmatmul_pallas (`_kernel`): x rounded to bf16; per level block n the f32
// partial p_n = sum_k x_k * lv_k over UNCENTERED levels, then (p_n - offset
// * xsum_n) * scale_n [+ xsum_n * min_n], summed over n. (The WIDE
// numerics of qmatmul_pallas_wide, each weight dequantized in f32 and
// rounded once to bf16, are qgemv_mma.cuh's and qgemv_stream.cuh's.)
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace bgt {

constexpr int QK = 32;
constexpr int TILE_COLS = 128;
constexpr int GEMV_WARPS = 4;
constexpr int GEMV_THREADS = GEMV_WARPS * 32;
// shared-memory budget for the staged activation slices (static limit)
constexpr int XS_BYTES_MAX = 40 * 1024;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block (blockDim.x a multiple of 32, <= 1024); every thread
// gets the result. `scratch` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < nw; ++w) t += scratch[w];
  return t;
}

// Max over the block, as block_sum.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = scratch[0];
  for (int w = 1; w < nw; ++w) t = fmaxf(t, scratch[w]);
  return t;
}

struct GemvArgs {
  const float* x;            // (M, d_in) f32 activations
  const float* ln_w;         // (d_in) LayerNorm weight, or null: no LN
  const float* ln_b;         // (d_in)
  float eps;
  const uint8_t* lv;         // level plane of format `bits` (see top)
  const __nv_bfloat16* sc;   // (d_in/32, d_out)
  const __nv_bfloat16* mn;   // (d_in/32, d_out) or null (Q4_0)
  int d_in;
  int d_out;
  int offset;                // LEVEL_OFFSET: 8 Q4_0, 16 Q5_0, else 0
  int bits;                  // level format: 4, 5 or 8
  int gpb;                   // packed groups per block
};

// Byte rows of a (d_in, d_out) level plane of format `bits`: d_in/2,
// 5*d_in/8 or d_in (the layer stride of a layer-stacked plane).
__host__ __device__ inline size_t level_rows(int d_in, int bits) {
  return bits == 8 ? (size_t)d_in
                   : (size_t)(d_in / 2) + (bits == 5 ? d_in / 8 : 0);
}

// The fifth-bit plane positions of a group of level rows k0 + i, i < 32
// (k0 + i < d_in/2): at(i) gives plane row j and bit q of row k0 + i
// without a carried dependence from row to row, so an unrolled loop's
// loads issue together.
struct FifthBit {
  int k0, j0, q0, e;   // e = d_in/8 rows in the plane
  __device__ __forceinline__ FifthBit(int k0_, int d_in)
      : k0(k0_), e(d_in / 8) {
    q0 = k0 / e;
    j0 = k0 - q0 * e;
  }
  __device__ __forceinline__ void at(int i, int& j, int& q) const {
    if (e >= QK) {   // a group of QK rows wraps at most once
      j = j0 + i;
      q = q0;
      if (j >= e) {
        j -= e;
        ++q;
      }
    } else {
      q = (k0 + i) / e;
      j = k0 + i - q * e;
    }
  }
};

__device__ __forceinline__ uint32_t ld_u32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Level bytes of packed row k = fb.k0 + i (< d_in/2) for the 4 columns at
// `col`, one u32 each: lo holds level row k, hi level row k + d_in/2 --
// uncentered for the packed formats, signed bytes for BITS == 8.
template <int BITS>
__device__ __forceinline__ void fetch_levels4(const uint8_t* lv,
                                              const FifthBit& fb, int i,
                                              int half, int d_out, int col,
                                              uint32_t& lo, uint32_t& hi) {
  const int k = fb.k0 + i;
  if (BITS == 8) {
    lo = ld_u32(lv + (size_t)k * d_out + col);
    hi = ld_u32(lv + (size_t)(k + half) * d_out + col);
  } else {
    const uint32_t w = ld_u32(lv + (size_t)k * d_out + col);
    lo = w & 0x0F0F0F0Fu;
    hi = (w >> 4) & 0x0F0F0F0Fu;
    if (BITS == 5) {
      int j, q;
      fb.at(i, j, q);
      const uint32_t f = ld_u32(lv + (size_t)(half + j) * d_out + col);
      lo |= ((f >> q) & 0x01010101u) << 4;
      hi |= ((f >> (q + 4)) & 0x01010101u) << 4;
    }
  }
}

// Level of column c (byte c) of a fetched u32, as a float.
template <int BITS>
__device__ __forceinline__ float level_of(uint32_t u, int c) {
  const uint32_t b = (u >> (8 * c)) & 0xFFu;
  return BITS == 8 ? (float)(int)(int8_t)b : (float)b;
}

// Stage the bf16-rounded activations this block needs into shared memory:
// xs[(m * 2 + h) * span + i] = x[m, h * d_in/2 + g0 * QK + i], i < span,
// after LayerNorm when a.ln_w is set (statistics over the full row, as the
// TPU kernels' `_ln` computes them: mean, then the mean squared deviation).
template <int M>
__device__ void stage_x(const GemvArgs& a, float* xs, int g0, int span,
                        float* scratch) {
  const int half = a.d_in / 2;
  for (int m = 0; m < M; ++m) {
    const float* xr = a.x + (size_t)m * a.d_in;
    float mean = 0.f, rstd = 1.f;
    if (a.ln_w != nullptr) {
      float s = 0.f;
      for (int i = threadIdx.x; i < a.d_in; i += blockDim.x) s += xr[i];
      mean = block_sum(s, scratch) / (float)a.d_in;
      float q = 0.f;
      for (int i = threadIdx.x; i < a.d_in; i += blockDim.x) {
        const float c = xr[i] - mean;
        q += c * c;
      }
      const float var = block_sum(q, scratch) / (float)a.d_in;
      rstd = 1.0f / sqrtf(var + a.eps);
    }
    for (int t = threadIdx.x; t < 2 * span; t += blockDim.x) {
      const int h = t / span, i = t % span;
      const int k = h * half + g0 * QK + i;
      float v = xr[k];
      if (a.ln_w != nullptr) v = (v - mean) * rstd * a.ln_w[k] + a.ln_b[k];
      xs[(m * 2 + h) * span + i] = bf16r(v);
    }
  }
}

// The per-thread half of a block's column tile: acc[m][c] for columns
// tile * 128 + lane * 4 + c, summed over this warp's packed groups.
template <int M, int BITS, bool HAS_MIN>
__device__ __forceinline__ void gemv_accumulate(const GemvArgs& a,
                                                const float* xs, int tile,
                                                int g0, float (&acc)[M][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = tile * TILE_COLS + lane * 4;
  const int nbh = a.d_in / (2 * QK);
  const int half = a.d_in / 2;
  const int span = a.gpb * QK;
  const float off = (float)a.offset;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int gi = warp; gi < a.gpb; gi += GEMV_WARPS) {
    const int g = g0 + gi;
    // block scales (and mins) of level blocks g (low) and g + nbh (high)
    float slo[4], shi[4], mlo[4] = {0.f, 0.f, 0.f, 0.f},
                          mhi[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const uint2 s0 = *reinterpret_cast<const uint2*>(
          a.sc + (size_t)g * a.d_out + col0);
      const uint2 s1 = *reinterpret_cast<const uint2*>(
          a.sc + (size_t)(g + nbh) * a.d_out + col0);
      const __nv_bfloat16* p0 = reinterpret_cast<const __nv_bfloat16*>(&s0);
      const __nv_bfloat16* p1 = reinterpret_cast<const __nv_bfloat16*>(&s1);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        slo[c] = __bfloat162float(p0[c]);
        shi[c] = __bfloat162float(p1[c]);
      }
      if (HAS_MIN) {
        const uint2 n0 = *reinterpret_cast<const uint2*>(
            a.mn + (size_t)g * a.d_out + col0);
        const uint2 n1 = *reinterpret_cast<const uint2*>(
            a.mn + (size_t)(g + nbh) * a.d_out + col0);
        const __nv_bfloat16* q0 = reinterpret_cast<const __nv_bfloat16*>(&n0);
        const __nv_bfloat16* q1 = reinterpret_cast<const __nv_bfloat16*>(&n1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          mlo[c] = __bfloat162float(q0[c]);
          mhi[c] = __bfloat162float(q1[c]);
        }
      }
    }
    FifthBit fb(g * QK, a.d_in);
    float plo[M][4], phi[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) plo[m][c] = phi[m][c] = 0.f;
#pragma unroll 8
    for (int r = 0; r < QK; ++r) {
      uint32_t ulo, uhi;
      fetch_levels4<BITS>(a.lv, fb, r, half, a.d_out, col0, ulo, uhi);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float xl = xs[(m * 2 + 0) * span + gi * QK + r];
        const float xh = xs[(m * 2 + 1) * span + gi * QK + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          plo[m][c] += xl * level_of<BITS>(ulo, c);
          phi[m][c] += xh * level_of<BITS>(uhi, c);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float sl = 0.f, sh = 0.f;   // per-block activation sums
      for (int r = 0; r < QK; ++r) {
        sl += xs[(m * 2 + 0) * span + gi * QK + r];
        sh += xs[(m * 2 + 1) * span + gi * QK + r];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float tl = (plo[m][c] - off * sl) * slo[c];
        float th = (phi[m][c] - off * sh) * shi[c];
        if (HAS_MIN) {
          tl += sl * mlo[c];
          th += sh * mhi[c];
        }
        acc[m][c] += tl;
        acc[m][c] += th;
      }
    }
  }
}

// Fixed-order cross-warp sum of acc into out[m * out_stride + col] for the
// block's 128 columns (col = threadIdx.x). `red` holds GEMV_WARPS * 128.
template <int M>
__device__ __forceinline__ void warp_tile_reduce(float (&acc)[M][4], float* red,
                                                 float* out, size_t out_stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp * TILE_COLS + lane * 4 + c] = acc[m][c];
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < GEMV_WARPS; ++w) s += red[w * TILE_COLS + threadIdx.x];
    out[m * out_stride + threadIdx.x] = s;
  }
}

// Partial products: part[(blockIdx.y * M + m) * d_out + col].
// grid = (d_out / 128, nbh / gpb), block = GEMV_THREADS.
template <int M, int BITS, bool HAS_MIN>
__global__ void __launch_bounds__(GEMV_THREADS)
qgemv_partial_kernel(GemvArgs a, float* part) {
  __shared__ float xs[XS_BYTES_MAX / 4];
  __shared__ float red[GEMV_WARPS * TILE_COLS];
  __shared__ float scratch[32];
  const int g0 = blockIdx.y * a.gpb;
  stage_x<M>(a, xs, g0, a.gpb * QK, scratch);
  __syncthreads();
  float acc[M][4];
  gemv_accumulate<M, BITS, HAS_MIN>(a, xs, blockIdx.x, g0, acc);
  float* out = part + (size_t)blockIdx.y * M * a.d_out + blockIdx.x * TILE_COLS;
  warp_tile_reduce<M>(acc, red, out, a.d_out);
}

// Epilogue over the partials: y[m, o] = act(sum_s part[s, m, o] + bias[o])
// (+ res[m, o]), summed over s in order. `res` may alias `y` (in-place
// residual update). act: 0 none, 1 exact-erf GELU.
__global__ void partial_sum_kernel(const float* part, int splits, int rows,
                                   int d_out, const float* bias, int act,
                                   const float* res, float* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * d_out) return;
  const int o = i % d_out;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * rows * d_out + i];
  if (res != nullptr) {
    // residual order of the TPU kernel: (x + proj) + bias
    float v = res[i] + s;
    if (bias != nullptr) v += bias[o];
    y[i] = v;
    return;
  }
  if (bias != nullptr) s += bias[o];
  if (act == 1) s = 0.5f * s * (1.0f + erff(s * 0.70710678118654752f));
  y[i] = s;
}

// Packed groups per block: the largest divisor of d_in/64 up to one per
// warp, so a projection's partial blocks spread over the card and the
// staged activations (M * 2 * gpb * 32 floats) stay within XS_BYTES_MAX.
inline int pick_gpb(int d_in) {
  const int nbh = d_in / (2 * QK);
  int g = GEMV_WARPS;
  while (nbh % g != 0) --g;
  return g;
}

// The five (format, mins) pairs the kernels are built for: calls
// f(Fmt<BITS, HAS_MIN>{}) for the pair of (bits, mins) -> false for
// another pair (Q8_0 has no mins).
template <int B_, bool M_>
struct Fmt {
  static constexpr int BITS = B_;
  static constexpr bool HAS_MIN = M_;
};

template <typename F>
inline bool with_format(int bits, bool mins, F f) {
  switch (bits) {
    case 4:
      if (mins) f(Fmt<4, true>{});
      else f(Fmt<4, false>{});
      return true;
    case 5:
      if (mins) f(Fmt<5, true>{});
      else f(Fmt<5, false>{});
      return true;
    case 8:
      if (mins) return false;
      f(Fmt<8, false>{});
      return true;
    default:
      return false;
  }
}

template <int M, int BITS, bool HAS_MIN>
inline void launch_partial(const GemvArgs& a, float* part, cudaStream_t st) {
  const int nbh = a.d_in / (2 * QK);
  dim3 grid(a.d_out / TILE_COLS, nbh / a.gpb);
  qgemv_partial_kernel<M, BITS, HAS_MIN>
      <<<grid, GEMV_THREADS, 0, st>>>(a, part);
}

// launch_partial for the format of `a` -> false for an unknown format
template <int M>
inline bool launch_partial_fmt(const GemvArgs& a, float* part,
                               cudaStream_t st) {
  return with_format(a.bits, a.mn != nullptr, [&](auto fmt) {
    using T = decltype(fmt);
    launch_partial<M, T::BITS, T::HAS_MIN>(a, part, st);
  });
}

inline void launch_partial_sum(const float* part, int splits, int rows,
                               int d_out, const float* bias, int act,
                               const float* res, float* y, cudaStream_t st) {
  const int n = rows * d_out;
  partial_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, splits, rows, d_out,
                                                       bias, act, res, y);
}

}  // namespace bgt
