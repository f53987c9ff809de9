// The paged (per-slot KV) and staged decode steps: 1 <= B <= 32 slots, each
// at its own position, through all L layers, Q4_0 / Q4_1 / Q5_0 / Q5_1
// (packed) or Q8_0 (unpacked) weights.
//
// Replaces biogpt_tpu/ops/pallas_decode.py::decode_step_fused in two more
// modes:
//   paged, bf16 or int8 KV (`_make_kernel_paged` :573-751, call :1297; the
//     int8 mode :680-702, scale rows :1182-1189): slot b walks only its
//     live KV blocks j < clip(ceil(past[b] / KVB), 1, W / KVB), KVB 128
//     rows when the window divides by 128 (`_kv_block_paged`).
//   staged, bf16 KV (`_make_kernel_batched(staged=True)` :384-392,
//     :472-475, :502-534, call :1333): slot b reads its cache rows below
//     min(past[b] - step_i, W) in the lockstep blocks (`_kv_block(W, B,
//     D)`), then the chunk's staged rows < step_i of (L, B, C, D) staging
//     as one more block with its own running max, then the current token.
// Contract as decode_batched.cu: (x0 (B,D) f32, layers, caches, past (B,)
// int32 on the device, window W) -> (x (B,D) f32, k_rows, v_rows (L,B,D)
// bf16, or f32 in the int8 mode for the caller to quantize).
//
// Bound on an H100: bytes -- the layer weights (~7 MB a layer at 347M in
// Q4_0, ~13.4 MB in Q8_0) read once for all B rows, plus each slot's live
// K/V rows (and their scales), plus the staged rows < step_i: 0.2323 ms
// (paged bf16), 0.1435 ms (paged int8) and 0.2389 ms (staged, step 7 of
// 16) at B = 32, window 512, ragged positions (tools/kernel_bounds.py).
// The layer chain is decode_batched.cu's (`batched_layers` in
// decode_layers.cuh), and with it the tensor-core GEMV of qgemv_mma.cuh
// (the dequant-then-dot numerics of `_qmm_dq`, which the paged kernel uses
// at every B, B=1 included: the paged step at B = 1 runs it on M = 8
// rows). Attention is one single-pass CTA per (head, slot) instead of
// split + combine, carrying the TPU kernel's design over:
//   - the CTA streams the slot's live rows only, in 64-row tiles of one
//     head's K or V slice (and, in the int8 mode, the rows' scales),
//     double-buffered in shared memory with cp.async (the counterpart of
//     the TPU kernel's make_async_copy pair): the next tile's copy is in
//     flight while the current one is used;
//   - the TPU kernel's online softmax, in its order: per KV block, m_new
//     over the whole block's scores, p = exp(s - m_new) in f32, raw p into
//     the denominator, in int8 each score times its row's K scale and the
//     V scale folded into p, p rounded to bf16, then p.V into the
//     accumulator. p rounds relative to the running max, as on the TPU, so
//     only f32 summation order and the bf16 flips it causes differ from
//     the plain version (see the tolerance in chip_smoke.py);
//   - the current token folds in last and the same CTA writes the context
//     row and the layer's K/V rows (the current token enters attention
//     unrounded, or fake-quantized in the int8 mode with its row's absmax,
//     computed once per slot by row_absmax_kernel, not in every head's
//     CTA).
// Rows of a block past a slot's live count are neither read nor scored:
// the TPU kernel masks them to p = 0, which changes no sum.
#include "attn_paged.cuh"

using namespace bgt;

namespace {

// Layer l's attention: the int8 mode's per-slot absmax, then one CTA per
// (head, slot).
template <typename KT, bool QUANT, bool STAGED>
void attention(const BatchedStep& s, int l, int kvb, int step_i,
               const __nv_bfloat16* kst, const __nv_bfloat16* vst, int C,
               float* amax, float scale, cudaStream_t st) {
  const size_t kv_off = (size_t)l * s.B * s.S * s.D;
  const size_t sc_off = (size_t)l * s.B * s.S;
  const size_t st_off = (size_t)l * s.B * C * s.D;
  const size_t row_off = (size_t)l * s.B * s.D * (QUANT ? 4 : 2);
  if (QUANT) row_absmax_kernel<<<s.B, 256, 0, st>>>(s.qkvbuf, s.D, amax);
  attn_paged_kernel<KT, QUANT, STAGED><<<dim3(s.H, s.B), ATT_THREADS, 0, st>>>(
      s.qkvbuf, s.D, static_cast<const KT*>(s.kc) + kv_off,
      static_cast<const KT*>(s.vc) + kv_off,
      QUANT ? s.ks + sc_off : nullptr, QUANT ? s.vs + sc_off : nullptr, s.S,
      s.past, s.W, kvb, STAGED ? step_i : 0,
      STAGED ? kst + st_off : nullptr, STAGED ? vst + st_off : nullptr, C,
      amax, scale, s.ctx, static_cast<char*>(s.kr) + row_off,
      static_cast<char*>(s.vr) + row_off);
}

}  // namespace

// Scratch sizes (floats) the wrapper allocates for M padded rows: qkv
// M*3D, ctx M*D (zeroed), ff M*F, amax B*2, stats M*2; n_gemv (host int,
// or null): each GEMV launch adds one; D, F <= 4096. k_scales/v_scales:
// (L,B,1,S) f32 in the int8 mode (the caches int8, the rows f32), else
// null. kvb: the KV block; k_stage and v_stage ((L,B,C,D) bf16) with
// step_i select the staged mode (bf16 only), else null.
extern "C" int bgt_decode_paged(
    float* x, int L, int D, int F, int H, int S, int B, int M, int W,
    const int* past, float eps, int offset, int bits, const float* ln0w,
    const float* ln0b, const float* ln1w, const float* ln1b,
    const uint8_t* qkv_lv, const void* qkv_sc, const void* qkv_mn, const float* qkv_b,
    const uint8_t* o_lv, const void* o_sc, const void* o_mn, const float* o_b,
    const uint8_t* fc1_lv, const void* fc1_sc, const void* fc1_mn, const float* fc1_b,
    const uint8_t* fc2_lv, const void* fc2_sc, const void* fc2_mn, const float* fc2_b,
    const void* k_cache, const void* v_cache, const float* k_scales,
    const float* v_scales, void* k_rows, void* v_rows, float* qkv,
    float* ctx, float* ff, float* amax, int kvb, int step_i, int C,
    const void* k_stage, const void* v_stage, float* stats, int* n_gemv,
    void* stream) {
  const bool quant = k_scales != nullptr, staged = k_stage != nullptr;
  if (D != H * DK || B < 1 || B > M || W < 1 || W > S || kvb < 1
      || D % MMA_COLS != 0 || F % MMA_COLS != 0 || D % (2 * QK) != 0
      || F % (2 * QK) != 0 || mma_splits(F) > MMA_MAX_SPLITS
      || mma_splits(D) > MMA_MAX_SPLITS || kvb > PG_MAX_KVB || (k_scales == nullptr) != (v_scales == nullptr)
      || staged != (v_stage != nullptr) || (staged && quant)
      || (staged && (step_i < 0 || step_i > C || C > PG_MAX_KVB)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BatchedStep s = batched_step(
      x, L, D, F, H, S, B, W, past, eps, offset, bits, ln0w, ln0b, ln1w,
      ln1b,
      qkv_lv, qkv_sc, qkv_mn, qkv_b, o_lv, o_sc, o_mn, o_b,
      fc1_lv, fc1_sc, fc1_mn, fc1_b, fc2_lv, fc2_sc, fc2_mn, fc2_b,
      k_cache, v_cache, k_scales, v_scales, k_rows, v_rows, qkv, ctx, ff,
      stats, n_gemv);
  const float scale = 1.0f / sqrtf((float)DK);
  const auto* kst = static_cast<const __nv_bfloat16*>(k_stage);
  const auto* vst = static_cast<const __nv_bfloat16*>(v_stage);
  auto attend = [&](int l) {
    if (quant)
      attention<int8_t, true, false>(s, l, kvb, 0, nullptr, nullptr, 0, amax,
                                     scale, st);
    else if (staged)
      attention<__nv_bfloat16, false, true>(s, l, kvb, step_i, kst, vst, C,
                                            amax, scale, st);
    else
      attention<__nv_bfloat16, false, false>(s, l, kvb, 0, nullptr, nullptr,
                                             0, amax, scale, st);
  };
  if (!run_batched(s, M, attend, st)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
