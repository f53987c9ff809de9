// The halves of one tensor-parallel decode layer, for one rank's shard:
// B <= 32 slots at their own positions, Q4_0 / Q4_1 / Q5_0 / Q5_1 (packed)
// or Q8_0 (unpacked) planes, a bf16 or an int8 KV shard.
//
// Replaces biogpt_tpu/ops/pallas_decode_tp.py::decode_step_fused_tp (:294),
// one entry point per TPU kernel it launches, each called once per layer:
//   bgt_tp_attn, bf16 KV: `_make_attn_kernel_tp` (:95, call :494) -- LN0,
//     the local fused qkv (columns q_s|k_s|v_s of shard s), attention over
//     the H/tp local heads and the local (L, B, S, D/tp) cache shard, then
//     ctx times the shard's d_in rows of o: a PARTIAL (B, D) f32 with no
//     bias, and the layer's local K/V rows (B, D/tp) bf16;
//   bgt_tp_attn, int8 KV: the same kernel with `ext_qkv=True` (call :428):
//     q, and k/v quantized with the full-row scale and dequantized, come
//     from the caller (the scale needs an all-reduce max over the shards,
//     which no kernel can do); no rows out;
//   bgt_tp_qkv: `_make_qkv_kernel_tp` (:240, call :455) -- LN0 and the
//     local qkv with its bias, (B, 3D/tp) f32, and each slot's local k and
//     v absmax (B, 2), which the caller's all-reduce max completes;
//   bgt_tp_ffn: `_make_ffn_kernel_tp` (:268, call :526) -- LN1, the local
//     fc1 columns with bias, exact erf GELU, the shard's d_in rows of fc2:
//     a PARTIAL (B, D) f32 with no bias.
// The sum over shards, the residual and the o and fc2 biases stay outside
// the kernels (ops/decode_tp_kernels.py), between the calls: on Hopper the
// collectives are torch.distributed calls between launches.
//
// Each entry is a short chain of launches built from what the batched steps
// use: every projection is the tensor-core GEMV of qgemv_mma.cuh at M = 8,
// 16 or 32 rows (`_qmm_dq` numerics: the weight dequantized in f32 and
// rounded once to bf16, x rounded to bf16, f32 sums; split-K over a thread
// block cluster, a programmatic dependent launch), after its LayerNorm
// statistics where it has a prologue, in every format, on the LOCAL
// planes: qkv d_out 3D/tp, fc1 d_out F/tp, and o and fc2 with d_in D/tp
// and F/tp rows taken from a chunk-packed plane (parallel/tp.py packs each
// shard's d_in chunk on its own, so a shard's rows are a packed plane of
// d_in D/tp or F/tp by themselves, in the GEMV's group layout: one split
// at d_in 256, two at 512). The o and fc2 GEMVs store their sums alone (a
// null bias: the partial). Attention is the single-pass online-softmax CTA
// per (head, slot) of the paged step (attn_paged.cuh), here over the local
// heads and a cache row of D/tp, in the TPU kernel's lockstep KV blocks
// `_kv_block(W, B, D/tp)` so that p rounds to bf16 against the same
// running maxima.
//
// Bound on an H100: bytes. One rank's step reads its share of the planes
// (1/tp of every projection) and its slots' live rows of the local K/V
// shard: at tp = 4, B = 32, window 512, Q4_0, one shard's step moves
// 194,732,160 bytes, 0.0581 ms at 3.35 TB/s (tools/kernel_bounds.py). The
// tensor-core GEMV keeps every byte of a projection in flight; what a
// rank's step loses beside it is launches and the torch glue between the
// halves (PERF.md section 6).
#include <type_traits>

#include "attn_paged.cuh"

using namespace bgt;

namespace {

template <typename F>
bool with_rows(int M, F f) {
  switch (M) {
    case 8: f(std::integral_constant<int, 8>{}); return true;
    case 16: f(std::integral_constant<int, 16>{}); return true;
    case 32: f(std::integral_constant<int, 32>{}); return true;
    default: return false;
  }
}

// One M-row projection of layer l on the tensor-core GEMV: the LayerNorm
// statistics into `stats` first where ln_w is set, then the product with
// its epilogue `epi` into y: + bias (qkv), bias + GELU (fc1), or, with a
// null bias, the partial sum alone (o, fc2).
bool gemv(int M, const Proj& p, int l, int d_in, int d_out, const float* x,
          const float* ln_w, const float* ln_b, float eps, int offset,
          const float* bias, int epi, float* stats, float* y,
          cudaStream_t st) {
  const MmaGemv a = layer_gemv(p, l, d_in, d_out, x, ln_w, ln_b, offset,
                               stats, bias, epi, y);
  bool fmt_ok = false;
  const bool rows_ok = with_rows(M, [&](auto rows) {
    constexpr int R = decltype(rows)::value;
    fmt_ok = with_format(p.bits, p.mn != nullptr, [&](auto fmt) {
      using T = decltype(fmt);
      launch_mma_gemv<R, T::BITS, T::HAS_MIN>(a, eps, st);
    });
  });
  return rows_ok && fmt_ok;
}

bool shapes_ok(int D, int Dl, int H, int B, int M) {
  return Dl == H * DK && B >= 1 && B <= M && mma_widths_ok(D, 3 * Dl)
         && mma_widths_ok(Dl, D);
}

}  // namespace

// The attention half of layer l. x (M, D) f32 (rows >= B zero); qkv
// (M, 3Dl), ctx (M, Dl) zeroed and stats (M, 2) are scratch; out (M, D)
// the partial. bf16 mode (k_scales null): k_cache/v_cache (L, B, S, Dl) bf16,
// k_row/v_row (B, Dl) bf16 out. int8 mode: the caches int8 with
// k_scales/v_scales (L, B, 1, S) f32, and q_ext, k_ext, v_ext (B, Dl) f32
// in (x, LN0 and the qkv planes unused); no rows out.
extern "C" int bgt_tp_attn(
    const float* x, int L, int l, int D, int Dl, int H, int S, int B, int M,
    int W, int kvb, const int* past, float eps, int offset, int bits,
    const float* ln0w, const float* ln0b, const uint8_t* qkv_lv,
    const void* qkv_sc, const void* qkv_mn, const float* qkv_b,
    const uint8_t* o_lv, const void* o_sc, const void* o_mn,
    const void* k_cache, const void* v_cache, const float* k_scales,
    const float* v_scales, const float* q_ext, const float* k_ext,
    const float* v_ext, void* k_row, void* v_row, float* stats, float* qkv,
    float* ctx, float* out, void* stream) {
  const bool quant = k_scales != nullptr;
  if (!shapes_ok(D, Dl, H, B, M) || l < 0 || l >= L || W < 1 || W > S
      || kvb < 1 || kvb > PG_MAX_KVB || quant != (v_scales != nullptr)
      || quant != (q_ext != nullptr) || (quant && (!k_ext || !v_ext)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Proj pqkv = make_proj(qkv_lv, qkv_sc, qkv_mn, qkv_b, bits);
  const Proj po = make_proj(o_lv, o_sc, o_mn, nullptr, bits);
  const size_t kv_off = (size_t)l * B * S * Dl;
  const size_t sc_off = (size_t)l * B * S;
  if (quant) {
    attn_paged_kernel<int8_t, true, false, true>
        <<<dim3(H, B), ATT_THREADS, 0, st>>>(
            nullptr, Dl, static_cast<const int8_t*>(k_cache) + kv_off,
            static_cast<const int8_t*>(v_cache) + kv_off, k_scales + sc_off,
            v_scales + sc_off, S, past, W, kvb, 0, nullptr, nullptr, 0,
            nullptr, 1.0f, ctx, nullptr, nullptr, q_ext, k_ext, v_ext);
  } else {
    if (!gemv(M, pqkv, l, D, 3 * Dl, x, ln0w + (size_t)l * D,
              ln0b + (size_t)l * D, eps, offset, qkv_b + (size_t)l * 3 * Dl,
              MMA_EPI_BIAS, stats, qkv, st))
      return (int)cudaErrorInvalidValue;
    attn_paged_kernel<__nv_bfloat16, false, false>
        <<<dim3(H, B), ATT_THREADS, 0, st>>>(
            qkv, Dl, static_cast<const __nv_bfloat16*>(k_cache) + kv_off,
            static_cast<const __nv_bfloat16*>(v_cache) + kv_off, nullptr,
            nullptr, S, past, W, kvb, 0, nullptr, nullptr, 0, nullptr,
            1.0f / sqrtf((float)DK), ctx, k_row, v_row);
  }
  if (!gemv(M, po, l, Dl, D, ctx, nullptr, nullptr, eps, offset, nullptr,
            MMA_EPI_BIAS, stats, out, st))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// LN0 and the local qkv of layer l with its bias: qkv (M, 3Dl) f32 out,
// amax (B, 2) the absmax of each slot's local k and v rows; stats (M, 2)
// scratch.
extern "C" int bgt_tp_qkv(
    const float* x, int L, int l, int D, int Dl, int B, int M, float eps,
    int offset, int bits, const float* ln0w, const float* ln0b,
    const uint8_t* qkv_lv, const void* qkv_sc, const void* qkv_mn,
    const float* qkv_b, float* stats, float* qkv, float* amax, void* stream) {
  if (!shapes_ok(D, Dl, Dl / DK, B, M) || l < 0 || l >= L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Proj pqkv = make_proj(qkv_lv, qkv_sc, qkv_mn, qkv_b, bits);
  if (!gemv(M, pqkv, l, D, 3 * Dl, x, ln0w + (size_t)l * D,
            ln0b + (size_t)l * D, eps, offset, qkv_b + (size_t)l * 3 * Dl,
            MMA_EPI_BIAS, stats, qkv, st))
    return (int)cudaErrorInvalidValue;
  row_absmax_kernel<<<B, 256, 0, st>>>(qkv, Dl, amax);
  return (int)cudaGetLastError();
}

// The FFN half of layer l: x (M, D) f32 (rows >= B zero), ff (M, Fl) and
// stats (M, 2) scratch, out (M, D) the partial.
extern "C" int bgt_tp_ffn(
    const float* x, int L, int l, int D, int Fl, int M, float eps, int offset,
    int bits, const float* ln1w, const float* ln1b, const uint8_t* fc1_lv,
    const void* fc1_sc, const void* fc1_mn, const float* fc1_b,
    const uint8_t* fc2_lv, const void* fc2_sc, const void* fc2_mn,
    float* stats, float* ff, float* out, void* stream) {
  if (l < 0 || l >= L || !mma_widths_ok(D, Fl) || !mma_widths_ok(Fl, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Proj p1 = make_proj(fc1_lv, fc1_sc, fc1_mn, fc1_b, bits);
  const Proj p2 = make_proj(fc2_lv, fc2_sc, fc2_mn, nullptr, bits);
  if (!gemv(M, p1, l, D, Fl, x, ln1w + (size_t)l * D, ln1b + (size_t)l * D,
            eps, offset, fc1_b + (size_t)l * Fl, MMA_EPI_GELU, stats, ff, st)
      || !gemv(M, p2, l, Fl, D, ff, nullptr, nullptr, eps, offset, nullptr,
               MMA_EPI_BIAS, stats, out, st))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
