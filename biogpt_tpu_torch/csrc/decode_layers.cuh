// Per-layer plumbing shared by the decode-step chains (decode_step.cu at
// B=1, decode_batched.cu at 2 <= B <= 32) and the prefill chain
// (prefill.cu): the head width and attention split the kernels are built
// for, one projection's layer-stacked planes, the GEMV arguments of layer
// l, and the cache reads of the bf16 and int8 KV modes.
#pragma once

#include "qgemv.cuh"

namespace bgt {

constexpr int DK = 64;           // head width the attention kernels take
constexpr int ATT_ROWS = 64;     // cache rows per attention split
constexpr int ATT_THREADS = 128;

// One projection's layer-stacked planes and bias.
struct Proj {
  const uint8_t* lv;
  const __nv_bfloat16* sc;
  const __nv_bfloat16* mn;
  const float* b;
};

inline Proj make_proj(const uint8_t* lv, const void* sc, const void* mn,
                      const float* b) {
  return Proj{lv, static_cast<const __nv_bfloat16*>(sc),
              static_cast<const __nv_bfloat16*>(mn), b};
}

inline GemvArgs layer_args(const Proj& p, int l, int d_in, int d_out,
                           const float* x, const float* ln_w, const float* ln_b,
                           float eps, int offset) {
  GemvArgs a;
  const size_t lv_stride = (size_t)(d_in / 2) * d_out;
  const size_t sc_stride = (size_t)(d_in / QK) * d_out;
  a.x = x;
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.eps = eps;
  a.lv = p.lv + l * lv_stride;
  a.sc = p.sc + l * sc_stride;
  a.mn = p.mn != nullptr ? p.mn + l * sc_stride : nullptr;
  a.d_in = d_in;
  a.d_out = d_out;
  a.offset = offset;
  a.gpb = pick_gpb(d_in);
  return a;
}

// Partial-sum blocks along d_in of a layer GEMV.
inline int splits_of(int d_in) { return d_in / (2 * QK) / pick_gpb(d_in); }

// Two neighbouring cache elements as floats: bf16 values, or int8 levels
// (exact in bf16, as the TPU kernel widens them before its dots).
__device__ __forceinline__ float2 kv_pair(const __nv_bfloat16* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__low2float(v), __high2float(v));
}

__device__ __forceinline__ float2 kv_pair(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return make_float2((float)v.x, (float)v.y);
}

// The int8 mode's current-token row element, quantized and dequantized
// with its row's absmax `amax` (pallas_decode.py::_fake_quant_rows: scale
// amax * (1/127), floored at 1e-12, round half to even, clip +-127; a NaN
// stays NaN).
__device__ __forceinline__ float fake_quant(float x, float amax) {
  const float safe = fmaxf(amax * (1.0f / 127.0f), 1e-12f);
  float r = rintf(x / safe);
  r = r < -127.f ? -127.f : (r > 127.f ? 127.f : r);
  return r * safe;
}

}  // namespace bgt
