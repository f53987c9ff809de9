// One batched decode step (2 <= B <= 32 slots, each at its own position)
// through all L layers, bf16 or int8 KV cache, Q4_0 / Q4_1 / Q5_0 / Q5_1
// (packed) or Q8_0 (unpacked) weights.
//
// Replaces biogpt_tpu/ops/pallas_decode.py::decode_step_fused, batched
// lockstep path (`_make_kernel_batched`, calls :1322 grouped and :1333; its
// int8-KV mode :438-439, :455-496, as in decode_step.cu: scores times the
// row's K scale, V scale folded into p before its bf16 rounding, the
// current token fake-quantized, rows out in f32 for the caller to quantize;
// slot b's scales are the contiguous (S) row of the (L,B,1,S) planes, and
// each attention CTA copies those of its rows with them).
// Contract: (x0 (B,D) f32, layers, k_cache, v_cache (L,B,S,D) bf16, past
// (B,) int32 on the device, window W) -> (x (B,D) f32, k_rows, v_rows
// (L,B,D) bf16); the caller commits slot b's rows at past[b]. Slot b's
// attention reads only its own cache rows idx < min(past[b], W), never row
// past[b] itself: a dead slot sits at past 0, and a slot whose position
// ran past the window (or past S) reads the window only. The TPU kernel's
// `kv_groups` changes which KV blocks it copies, not the math; here every
// slot reads its own live rows, so there is nothing to group.
//
// Bound on an H100: bytes -- the layer weights (~7 MB a layer at 347M in
// Q4_0, ~13.4 MB in Q8_0), read once for all B rows, plus each slot's live
// KV rows: 0.2323 ms (bf16) and 0.1435 ms (int8) at B = 32, window 512,
// ragged positions (tools/kernel_bounds.py). A chain of per-layer kernels
// behind ONE host call (the layer loop is decode_layers.cuh's
// `batched_layers`, which decode_paged.cu shares):
//   qkv GEMV (M rows, LayerNorm-0 prologue) + bias
//   attention (attn_batched.cuh): one launch, a programmatic dependent of
//     the qkv GEMV that streams each slot's live rows while the GEMV runs,
//     the TPU kernel's online softmax over its KV blocks of
//     `_kv_block(W, B, D)` rows (p rounds to bf16 against the running max
//     after its block), the current token (its k/v UNROUNDED, as in the
//     TPU kernel) last; it writes the context and the new bf16 K/V rows
//   o GEMV + residual, fc1 GEMV with LayerNorm-1 prologue + exact erf
//   GELU, fc2 GEMV + residual
// The projections are the tensor-core GEMV of qgemv_mma.cuh (the numerics
// of `_qmm_dq`, which the TPU kernel uses at every B >= 2: bf16 x, each
// weight rounded once to bf16, mma.sync with f32 accumulation), which keeps
// every byte of a projection in flight and splits d_in over enough blocks
// to fill the card, where qgemv.cuh's scalar f32 FMAs took 84% of a 7.3 ms
// step (H100). It runs on M = 8, 16 or 32 rows: rows B..M-1 are zero
// padding the wrapper adds. bgt_decode_gemv exposes one projection alone.
// Attention numerics as decode_step.cu: q * (1/sqrt(Dk)) rounds to bf16,
// scores are f32 against bf16 K, p rounds to bf16 before p.V.
#include "attn_batched.cuh"

using namespace bgt;

namespace {

// One projection alone at M = 8, 16 or 32 rows in the planes' format
// (launch_mma_gemv) -> false for another M or format.
bool run_gemv(const MmaGemv& a, int M, int bits, float eps, cudaStream_t st) {
  if (M != 8 && M != 16 && M != 32) return false;
  return with_format(bits, a.mn != nullptr, [&](auto fmt) {
    using T = decltype(fmt);
    switch (M) {
      case 8: launch_mma_gemv<8, T::BITS, T::HAS_MIN>(a, eps, st); break;
      case 16: launch_mma_gemv<16, T::BITS, T::HAS_MIN>(a, eps, st); break;
      case 32: launch_mma_gemv<32, T::BITS, T::HAS_MIN>(a, eps, st); break;
    }
  });
}

}  // namespace

// Scratch sizes (floats) the wrapper allocates for M padded rows: qkv
// M*3D, ctx M*D (zeroed), ff M*F, stats M*2. k_scales/v_scales: (L,B,1,S)
// f32 in the int8 mode (the caches int8, the rows f32), else null (bf16
// caches and rows). kvb: the KV block; cluster, rows_cap: the attention's
// CTAs a (head, slot) and the rows each holds (attn_batched.cuh). n_gemv,
// n_attn (host ints, or null): each GEMV or attention launch adds one. D,
// F <= 4096.

extern "C" int bgt_decode_batched(
    float* x, int L, int D, int F, int H, int S, int B, int M, int W,
    const int* past, float eps, int offset, int bits, const float* ln0w,
    const float* ln0b, const float* ln1w, const float* ln1b,
    const uint8_t* qkv_lv, const void* qkv_sc, const void* qkv_mn, const float* qkv_b,
    const uint8_t* o_lv, const void* o_sc, const void* o_mn, const float* o_b,
    const uint8_t* fc1_lv, const void* fc1_sc, const void* fc1_mn, const float* fc1_b,
    const uint8_t* fc2_lv, const void* fc2_sc, const void* fc2_mn, const float* fc2_b,
    const void* k_cache, const void* v_cache, const float* k_scales,
    const float* v_scales, void* k_rows, void* v_rows, float* qkv,
    float* ctx, float* ff, float* stats, int kvb, int cluster, int rows_cap,
    int* n_gemv, int* n_attn, void* stream) {
  if (D != H * DK || B < 1 || B > M || W < 1 || W > S || D % MMA_COLS != 0
      || F % MMA_COLS != 0 || D % (2 * QK) != 0 || F % (2 * QK) != 0
      || mma_splits(F) > MMA_MAX_SPLITS || mma_splits(D) > MMA_MAX_SPLITS
      || (k_scales == nullptr) != (v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BatchedStep s = batched_step(
      x, L, D, F, H, S, B, W, past, eps, offset, bits, ln0w, ln0b, ln1w,
      ln1b,
      qkv_lv, qkv_sc, qkv_mn, qkv_b, o_lv, o_sc, o_mn, o_b,
      fc1_lv, fc1_sc, fc1_mn, fc1_b, fc2_lv, fc2_sc, fc2_mn, fc2_b,
      k_cache, v_cache, k_scales, v_scales, k_rows, v_rows, qkv, ctx, ff,
      stats, n_gemv);
  size_t smem;
  if (!attn_batched_fits(step_attn(s, 0, kvb, rows_cap, 0, nullptr, nullptr,
                                   0),
                         cluster, k_scales != nullptr, &smem))
    return (int)cudaErrorInvalidValue;
  auto attend = [&](int l) {
    launch_attn(step_attn(s, l, kvb, rows_cap, 0, nullptr, nullptr, 0), B,
                cluster, st);
    if (n_attn != nullptr) ++*n_attn;
  };
  if (!run_batched(s, M, attend, st)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// One projection alone: y (M, d_out) f32 = epi(LN?(x) (M, d_in) @ the
// planes) -- qgemv_mma.cuh's GEMV at M = 8, 16 or 32 rows, the LayerNorm
// prologue where ln_w is set (statistics into stats, M*2 floats), epi
// 0 (+ bias), 1 (+ bias, exact-erf GELU) or 2 ((res + y) + bias; res may
// alias y); bias may be null. d_in <= 4096.

extern "C" int bgt_decode_gemv(
    const float* x, int M, int d_in, int d_out, const float* ln_w,
    const float* ln_b, float eps, const uint8_t* lv, const void* sc,
    const void* mn, int offset, int bits, const float* bias, int epi,
    const float* res, float* y, float* stats, void* stream) {
  if (!mma_widths_ok(d_in, d_out) || epi < 0 || epi > 2
      || (epi == MMA_EPI_RESID) != (res != nullptr)
      || (ln_w == nullptr) != (ln_b == nullptr))
    return (int)cudaErrorInvalidValue;
  MmaGemv a;
  a.x = x;
  a.stats = stats;
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.lv = lv;
  a.sc = static_cast<const __nv_bfloat16*>(sc);
  a.mn = static_cast<const __nv_bfloat16*>(mn);
  a.d_in = d_in;
  a.d_out = d_out;
  a.offset = offset;
  a.bias = bias;
  a.epi = epi;
  a.res = res;
  a.y = y;
  if (!run_gemv(a, M, bits, eps, static_cast<cudaStream_t>(stream)))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
