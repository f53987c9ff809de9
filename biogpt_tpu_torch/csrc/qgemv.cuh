// The quantized weight planes' layout, level fetch and block reductions
// that every GEMV and GEMM of the port shares (the tensor-core GEMVs of
// qgemv_mma.cuh, qgemv_b1.cuh and qgemv_stream.cuh, qmatmul.cu's M <= 8
// GEMV and the refill GEMM of prefill.cu read the same planes).
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
//     row k mod d_in/8, at bits q and q + 4 (q = k div d_in/8): one load
//     per packed row gives both halves' bits, ORed into the levels as
//     integers before the float conversion, as the TPU kernel does
//     (pallas_qmatmul.py::unpack_levels_swar);
//   8 (Q8_0): int8 (d_in, d_out), levels already centered (offset 0).
// Scales and mins are bf16 (d_in/32, d_out) planes. A packed group g (32
// packed rows, 64 rows of d_in) carries level blocks g (rows g*32 + r,
// "low") and g + d_in/64 (rows d_in/2 + g*32 + r, "high").
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace bgt {

constexpr int QK = 32;

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

// One projection of layer-stacked planes, as decode_layers.cuh's
// layer_args picks layer l's.
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

}  // namespace bgt
