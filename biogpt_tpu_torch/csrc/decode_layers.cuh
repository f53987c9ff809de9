// Per-layer plumbing shared by the decode-step chains (decode_step.cu at
// B=1; decode_batched.cu and decode_paged.cu over B slots; decode_tp.cu's
// halves) and the prefill chain (prefill.cu): the head width and block
// size the attention kernels are built for, one projection's layer-stacked planes,
// the GEMV arguments of layer l, the cache reads of the bf16 and int8 KV
// modes, and the batched chains' layer loop around their own attention,
// whose projections take the tensor-core GEMV of qgemv_mma.cuh.
#pragma once

#include "qgemv.cuh"
#include "qgemv_mma.cuh"

namespace bgt {

constexpr int DK = 64;           // head width the attention kernels take
constexpr int ATT_THREADS = 128;

// One projection's layer-stacked planes, their level format (4, 5 or 8;
// qgemv.cuh) and bias.
struct Proj {
  const uint8_t* lv;
  const __nv_bfloat16* sc;
  const __nv_bfloat16* mn;
  const float* b;
  int bits;
};

inline Proj make_proj(const uint8_t* lv, const void* sc, const void* mn,
                      const float* b, int bits) {
  return Proj{lv, static_cast<const __nv_bfloat16*>(sc),
              static_cast<const __nv_bfloat16*>(mn), b, bits};
}

// Layer l's planes: the level plane's layer stride follows the format.
inline GemvArgs layer_args(const Proj& p, int l, int d_in, int d_out,
                           const float* x, const float* ln_w, const float* ln_b,
                           float eps, int offset) {
  GemvArgs a;
  const size_t lv_stride = level_rows(d_in, p.bits) * d_out;
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
  a.bits = p.bits;
  return a;
}

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

// The batched chains' operands: M padded activation rows (B live), per-slot
// positions on the device, the caches and the scratch every layer reuses.
struct BatchedStep {
  float* x;                  // (M, D) residual stream, updated in place
  int L, D, F, H, S, B, W;
  const int* past;           // (B,) int32
  float eps;
  int offset, bits;
  const float *ln0w, *ln0b, *ln1w, *ln1b;   // (L, D) f32
  Proj qkv, o, fc1, fc2;
  const void *kc, *vc;                      // (L, B, S, D) bf16 or int8
  const float *ks, *vs;                     // (L, B, 1, S) f32, or null
  void *kr, *vr;                            // (L, B, D) bf16, or f32 (int8)
  float *qkvbuf, *ctx, *ff;                 // scratch; ctx (M, D) zeroed
  float* stats;                             // (M, 2) LayerNorm statistics
  int* n_gemv;                              // host int: +1 a GEMV launch
};

inline BatchedStep batched_step(
    float* x, int L, int D, int F, int H, int S, int B, int W,
    const int* past, float eps, int offset, int bits, const float* ln0w,
    const float* ln0b, const float* ln1w, const float* ln1b,
    const uint8_t* qkv_lv, const void* qkv_sc, const void* qkv_mn, const float* qkv_b,
    const uint8_t* o_lv, const void* o_sc, const void* o_mn, const float* o_b,
    const uint8_t* fc1_lv, const void* fc1_sc, const void* fc1_mn, const float* fc1_b,
    const uint8_t* fc2_lv, const void* fc2_sc, const void* fc2_mn, const float* fc2_b,
    const void* k_cache, const void* v_cache, const float* k_scales,
    const float* v_scales, void* k_rows, void* v_rows, float* qkv,
    float* ctx, float* ff, float* stats, int* n_gemv) {
  BatchedStep s;
  s.x = x;
  s.L = L; s.D = D; s.F = F; s.H = H; s.S = S; s.B = B; s.W = W;
  s.past = past;
  s.eps = eps;
  s.offset = offset;
  s.bits = bits;
  s.ln0w = ln0w; s.ln0b = ln0b; s.ln1w = ln1w; s.ln1b = ln1b;
  s.qkv = make_proj(qkv_lv, qkv_sc, qkv_mn, qkv_b, bits);
  s.o = make_proj(o_lv, o_sc, o_mn, o_b, bits);
  s.fc1 = make_proj(fc1_lv, fc1_sc, fc1_mn, fc1_b, bits);
  s.fc2 = make_proj(fc2_lv, fc2_sc, fc2_mn, fc2_b, bits);
  s.kc = k_cache; s.vc = v_cache;
  s.ks = k_scales; s.vs = v_scales;
  s.kr = k_rows; s.vr = v_rows;
  s.qkvbuf = qkv; s.ctx = ctx; s.ff = ff;
  s.stats = stats; s.n_gemv = n_gemv;
  return s;
}

// Layer l's projection `p` (d_in -> d_out) of the M rows x as an MmaGemv:
// LayerNorm prologue where ln_w is set (its statistics in `stats`),
// epilogue `epi` with `bias` (or none) into y.
inline MmaGemv layer_gemv(const Proj& p, int l, int d_in, int d_out,
                          const float* x, const float* ln_w,
                          const float* ln_b, int offset, float* stats,
                          const float* bias, int epi, float* y) {
  const GemvArgs g = layer_args(p, l, d_in, d_out, x, ln_w, ln_b, 0.f,
                                offset);
  MmaGemv a;
  a.x = x;
  a.stats = stats;
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.lv = g.lv;
  a.sc = g.sc;
  a.mn = g.mn;
  a.d_in = d_in;
  a.d_out = d_out;
  a.offset = offset;
  a.bias = bias;
  a.epi = epi;
  a.res = epi == MMA_EPI_RESID ? y : nullptr;
  a.y = y;
  return a;
}

// The same for a batched step, with the layer's bias.
inline MmaGemv mma_args(const BatchedStep& s, const Proj& p, int l, int d_in,
                        int d_out, const float* x, const float* ln_w,
                        const float* ln_b, int epi, float* y) {
  return layer_gemv(p, l, d_in, d_out, x, ln_w, ln_b, s.offset, s.stats,
                    p.b + (size_t)l * d_out, epi, y);
}

// All L layers over M rows: qkv GEMV (LayerNorm-0 prologue) + bias into
// qkvbuf; `attend(l)`, which reads qkvbuf, writes ctx rows < B and layer
// l's K/V rows; o GEMV + residual, fc1 GEMV with LayerNorm-1 prologue +
// exact erf GELU, fc2 GEMV + residual. Each projection is the tensor-core
// GEMV of qgemv_mma.cuh in level format BITS (the numerics of `_qmm_dq`),
// after its LayerNorm statistics where it has a prologue: 2 + 4 launches a
// layer beside the attention's.
template <int M, int BITS, bool HAS_MIN, typename Attend>
void batched_layers(const BatchedStep& s, Attend attend, cudaStream_t st) {
  const int D = s.D, F = s.F;
  auto gemv = [&](const MmaGemv& a) {
    launch_mma_gemv<M, BITS, HAS_MIN>(a, s.eps, st);
    if (s.n_gemv != nullptr) ++*s.n_gemv;
  };
  for (int l = 0; l < s.L; ++l) {
    gemv(mma_args(s, s.qkv, l, D, 3 * D, s.x, s.ln0w + (size_t)l * D,
                  s.ln0b + (size_t)l * D, MMA_EPI_BIAS, s.qkvbuf));
    attend(l);
    gemv(mma_args(s, s.o, l, D, D, s.ctx, nullptr, nullptr, MMA_EPI_RESID,
                  s.x));
    gemv(mma_args(s, s.fc1, l, D, F, s.x, s.ln1w + (size_t)l * D,
                  s.ln1b + (size_t)l * D, MMA_EPI_GELU, s.ff));
    gemv(mma_args(s, s.fc2, l, F, D, s.ff, nullptr, nullptr, MMA_EPI_RESID,
                  s.x));
  }
}

// The chain at M = 8, 16 or 32 rows in the planes' format -> false for
// another M or format.
template <typename Attend>
bool run_batched(const BatchedStep& s, int M, Attend attend, cudaStream_t st) {
  if (M != 8 && M != 16 && M != 32) return false;
  return with_format(s.bits, s.qkv.mn != nullptr, [&](auto fmt) {
    using T = decltype(fmt);
    switch (M) {
      case 8: batched_layers<8, T::BITS, T::HAS_MIN>(s, attend, st); break;
      case 16: batched_layers<16, T::BITS, T::HAS_MIN>(s, attend, st); break;
      case 32: batched_layers<32, T::BITS, T::HAS_MIN>(s, attend, st); break;
    }
  });
}

}  // namespace bgt
