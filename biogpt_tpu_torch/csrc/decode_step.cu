// One single-stream (B=1) decode step through all L layers, bf16 or int8 KV
// cache, Q4_0 / Q4_1 / Q5_0 / Q5_1 (packed) or Q8_0 (unpacked) weights,
// and the step's projection alone (bgt_decode_gemv_b1).
//
// Replaces biogpt_tpu/ops/pallas_decode.py::decode_step_fused, B=1 lockstep
// path (`_make_kernel`, its int8-KV mode :288-318). Contract: (x0 (1,D)
// f32, layers, k_cache, v_cache (L,1,S,D) bf16, past (1,) int32 on the
// card, window W) -> (x (1,D) f32, k_rows, v_rows (L,1,D) bf16); the
// caller commits the rows at position `past`. Attention reads cache rows
// < min(past, W), never row `past` itself. In the int8 mode the caches
// hold int8 levels with f32 row scales (L,1,1,S): each score is multiplied
// by its row's K scale, the V scale folds into p before p's bf16 rounding
// (the denominator sums raw p), the current token's k/v enter attention
// fake-quantized with their row's absmax (amax * (1/127)), and the rows
// leave in f32 for the caller to quantize.
//
// Bound on an H100: bytes -- the layer weights (~7 MB a layer at 347M in
// Q4_0, ~13.4 MB in Q8_0) and the `past` live KV rows of each layer, read
// once per token: 0.0541 ms at past 100 in Q4_0 (tools/kernel_bounds.py).
// Its 302 M multiply-adds a token are ~10 us at the card's f32 rate. What
// a step loses is launches and latency, so the TPU megakernel becomes a
// chain of FIVE kernels a layer, bf16 or int8 cache, behind one host call,
// none of which sends a partial sum through device memory:
//   qkv GEMV (qgemv_b1.cuh, LayerNorm-0 computed in each block) + bias
//   attention: attn_paged.cuh's single-pass CTA per head over the
//     contiguous cache, in the TPU kernel's KV blocks `_kv_block(W, 1, D)`
//     (the wrapper's `kvb`), so p rounds to bf16 against the same running
//     maxima as the TPU kernel and the plain version; it writes the
//     layer's K/V rows (bf16, or f32 in the int8 mode) and the context row,
//     and in the int8 mode takes the current k and v rows' absmax itself
//     (16 CTAs each reading the 8 KB row: cheaper than a launch)
//   o GEMV + residual, fc1 GEMV with LayerNorm-1 + exact erf GELU, fc2
//     GEMV + residual (qgemv_b1.cuh)
// Every kernel is a programmatic dependent of the kernel before it: it is
// resident, a GEMV's weights loading, while that kernel finishes, so the
// chain pays no launch gap; each GEMV reduces its split-K blocks inside a
// thread block cluster. Numerics as the TPU kernel: X'
// projections (`_qmm`), h rounded to bf16 before each product, q * (1 /
// sqrt(Dk)) rounded to bf16, scores in f32 against bf16 (or int8) K, the
// current token's k/v unrounded in attention (only the cache copies are
// bf16); only the order of f32 sums differs. `past` is read on the card,
// and the scratch does not depend on it.
#include "attn_paged.cuh"
#include "qgemv_b1.cuh"

using namespace bgt;

namespace {

// Layer l's projection p (d_in -> d_out) of the row x: LayerNorm prologue
// where ln_w is set, epilogue `epi` with the layer's bias into y.
B1Gemv b1_args(const Proj& p, int l, int d_in, int d_out, const float* x,
               const float* ln_w, const float* ln_b, float eps, int offset,
               int epi, float* y) {
  const GemvArgs g = layer_args(p, l, d_in, d_out, x, ln_w, ln_b, eps,
                                offset);
  B1Gemv a;
  a.x = x;
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.eps = eps;
  a.lv = g.lv;
  a.sc = g.sc;
  a.mn = g.mn;
  a.d_in = d_in;
  a.d_out = d_out;
  a.offset = offset;
  a.splits = 0;
  a.bias = p.b + (size_t)l * d_out;
  a.epi = epi;
  a.res = epi == MMA_EPI_RESID ? y : nullptr;
  a.y = y;
  a.late = false;
  return a;
}

}  // namespace

extern "C" int bgt_decode_head_dim() { return DK; }

// The step. Scratch the wrapper allocates: qkv 3D, ctx D, ff F floats.
// past: (1,) int32 on the card. kvb: the KV
// block of window W (<= PG_MAX_KVB). k_scales/v_scales: (L,1,1,S) f32 in
// the int8 mode (the caches int8, the rows f32), else null (bf16 caches
// and rows). n_gemv: a host int the entry adds its GEMV launches to, or
// null.
extern "C" int bgt_decode_step(
    float* x, int L, int D, int F, int H, int S, int W, int kvb,
    const int* past, float eps, int offset, int bits, const float* ln0w,
    const float* ln0b, const float* ln1w, const float* ln1b,
    const uint8_t* qkv_lv, const void* qkv_sc, const void* qkv_mn, const float* qkv_b,
    const uint8_t* o_lv, const void* o_sc, const void* o_mn, const float* o_b,
    const uint8_t* fc1_lv, const void* fc1_sc, const void* fc1_mn, const float* fc1_b,
    const uint8_t* fc2_lv, const void* fc2_sc, const void* fc2_mn, const float* fc2_b,
    const void* k_cache, const void* v_cache, const float* k_scales,
    const float* v_scales, void* k_rows, void* v_rows, float* qkv,
    float* ctx, float* ff, int* n_gemv, void* stream) {
  const bool quant = k_scales != nullptr;
  if (D != H * DK || quant != (v_scales != nullptr) || W < 1 || W > S || kvb < 1 || kvb > PG_MAX_KVB
      || !mma_widths_ok(D, 3 * D) || !mma_widths_ok(D, F)
      || !mma_widths_ok(F, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Proj pqkv = make_proj(qkv_lv, qkv_sc, qkv_mn, qkv_b, bits);
  const Proj po = make_proj(o_lv, o_sc, o_mn, o_b, bits);
  const Proj pfc1 = make_proj(fc1_lv, fc1_sc, fc1_mn, fc1_b, bits);
  const Proj pfc2 = make_proj(fc2_lv, fc2_sc, fc2_mn, fc2_b, bits);
  const size_t row_bytes = quant ? sizeof(float) : sizeof(__nv_bfloat16);
  char* kr = static_cast<char*>(k_rows);
  char* vr = static_cast<char*>(v_rows);
  const float scale = 1.0f / sqrtf((float)DK);
  const bool fmt_ok = with_format(bits, qkv_mn != nullptr, [&](auto fmt) {
    using T = decltype(fmt);
    auto gemv = [&](const B1Gemv& a) {
      launch_b1_gemv<T::BITS, T::HAS_MIN>(a, st);
      if (n_gemv != nullptr) ++*n_gemv;
    };
    for (int l = 0; l < L; ++l) {
      // the attention after it launches as the products end: the chain
      // runs one layer ahead of attention (qgemv_b1.cuh)
      B1Gemv aq = b1_args(pqkv, l, D, 3 * D, x, ln0w + (size_t)l * D,
                          ln0b + (size_t)l * D, eps, offset, MMA_EPI_BIAS,
                          qkv);
      aq.late = true;
      gemv(aq);
      const size_t kv_off = (size_t)l * S * D;
      void* krl = kr + (size_t)l * D * row_bytes;
      void* vrl = vr + (size_t)l * D * row_bytes;
      const __nv_bfloat16* none = nullptr;
      const float* nof = nullptr;
      if (quant) {
        launch_dependent(
            attn_paged_kernel<int8_t, true, false, false, true>,
            dim3(H, 1), dim3(ATT_THREADS), 1, st, (const float*)qkv, D,
            static_cast<const int8_t*>(k_cache) + kv_off,
            static_cast<const int8_t*>(v_cache) + kv_off,
            k_scales + (size_t)l * S, v_scales + (size_t)l * S, S, past, W,
            kvb, 0, none, none, 0, nof, scale, ctx, krl, vrl, nof, nof, nof);
      } else {
        launch_dependent(
            attn_paged_kernel<__nv_bfloat16, false, false, false, true>,
            dim3(H, 1), dim3(ATT_THREADS), 1, st, (const float*)qkv, D,
            static_cast<const __nv_bfloat16*>(k_cache) + kv_off,
            static_cast<const __nv_bfloat16*>(v_cache) + kv_off, nof, nof, S,
            past, W, kvb, 0, none, none, 0, nof, scale, ctx, krl, vrl, nof,
            nof, nof);
      }
      gemv(b1_args(po, l, D, D, ctx, nullptr, nullptr, eps, offset,
                   MMA_EPI_RESID, x));
      gemv(b1_args(pfc1, l, D, F, x, ln1w + (size_t)l * D,
                   ln1b + (size_t)l * D, eps, offset, MMA_EPI_GELU, ff));
      gemv(b1_args(pfc2, l, F, D, ff, nullptr, nullptr, eps, offset,
                   MMA_EPI_RESID, x));
    }
  });
  if (!fmt_ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// One projection of the step alone: x (d_in) f32, LayerNorm'd where ln_w
// is set, times the planes (level format bits), then the epilogue epi
// (MMA_EPI_*: + bias; + bias and GELU; (res + y) + bias) into y (d_out).
// bias may be null.
extern "C" int bgt_decode_gemv_b1(
    const float* x, int d_in, int d_out, const float* ln_w,
    const float* ln_b, float eps, const uint8_t* lv, const void* sc,
    const void* mn, int offset, int bits, const float* bias, int epi,
    const float* res, float* y, void* stream) {
  if (!mma_widths_ok(d_in, d_out) || epi < 0 || epi > 2
      || (epi == MMA_EPI_RESID) != (res != nullptr)
      || (ln_w == nullptr) != (ln_b == nullptr))
    return (int)cudaErrorInvalidValue;
  B1Gemv a;
  a.x = x;
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.eps = eps;
  a.lv = lv;
  a.sc = static_cast<const __nv_bfloat16*>(sc);
  a.mn = static_cast<const __nv_bfloat16*>(mn);
  a.d_in = d_in;
  a.d_out = d_out;
  a.offset = offset;
  a.splits = 0;
  a.bias = bias;
  a.epi = epi;
  a.res = res;
  a.y = y;
  a.late = false;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!with_format(bits, mn != nullptr, [&](auto fmt) {
        using T = decltype(fmt);
        launch_b1_gemv<T::BITS, T::HAS_MIN>(a, st);
      }))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
