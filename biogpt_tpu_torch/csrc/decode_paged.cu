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
// rows), and its attention: attn_batched.cuh's kernel, one launch a layer
// as a programmatic dependent of the qkv GEMV, over the paged step's
// blocks of `_kv_block_paged(W)` rows or the staged step's lockstep blocks
// and its staged rows, in the int8 mode taking each slot's absmax itself.
// Rows of a block past a slot's live count are neither read nor scored:
// the TPU kernel masks them to p = 0, which changes no sum.
#include "attn_batched.cuh"

using namespace bgt;

// Scratch sizes (floats) the wrapper allocates for M padded rows: qkv
// M*3D, ctx M*D (zeroed), ff M*F, stats M*2; n_gemv, n_attn (host ints,
// or null): each GEMV or attention launch adds one; D, F <= 4096.
// k_scales/v_scales: (L,B,1,S) f32 in the int8 mode (the caches int8, the
// rows f32), else null. kvb: the KV block; cluster, rows_cap: the
// attention's CTAs a (head, slot) and the rows each holds
// (attn_batched.cuh). k_stage and v_stage ((L,B,C,D) bf16) with step_i
// select the staged mode (bf16 only), else null.
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
    float* ctx, float* ff, int kvb, int cluster, int rows_cap, int step_i,
    int C, const void* k_stage, const void* v_stage, float* stats,
    int* n_gemv, int* n_attn, void* stream) {
  const bool quant = k_scales != nullptr, staged = k_stage != nullptr;
  if (D != H * DK || B < 1 || B > M || W < 1 || W > S || kvb < 1
      || D % MMA_COLS != 0 || F % MMA_COLS != 0 || D % (2 * QK) != 0
      || F % (2 * QK) != 0 || mma_splits(F) > MMA_MAX_SPLITS
      || mma_splits(D) > MMA_MAX_SPLITS
      || (k_scales == nullptr) != (v_scales == nullptr)
      || staged != (v_stage != nullptr) || (staged && quant)
      || (staged && (step_i < 0 || step_i > C)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BatchedStep s = batched_step(
      x, L, D, F, H, S, B, W, past, eps, offset, bits, ln0w, ln0b, ln1w,
      ln1b,
      qkv_lv, qkv_sc, qkv_mn, qkv_b, o_lv, o_sc, o_mn, o_b,
      fc1_lv, fc1_sc, fc1_mn, fc1_b, fc2_lv, fc2_sc, fc2_mn, fc2_b,
      k_cache, v_cache, k_scales, v_scales, k_rows, v_rows, qkv, ctx, ff,
      stats, n_gemv);
  const auto* kst = static_cast<const __nv_bfloat16*>(k_stage);
  const auto* vst = static_cast<const __nv_bfloat16*>(v_stage);
  size_t smem;
  if (!attn_batched_fits(step_attn(s, 0, kvb, rows_cap, step_i, kst, vst, C),
                         cluster, quant, &smem))
    return (int)cudaErrorInvalidValue;
  auto attend = [&](int l) {
    launch_attn(step_attn(s, l, kvb, rows_cap, step_i, kst, vst, C), B,
                cluster, st);
    if (n_attn != nullptr) ++*n_attn;
  };
  if (!run_batched(s, M, attend, st)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// One layer's attention alone, as the batched steps launch it: qkv (B, 3D)
// f32 with bias; k_cache, v_cache (B, S, D) bf16, or int8 levels with
// k_scales, v_scales (B, S) f32; past (B,) int32; k_stage, v_stage (B, C,
// D) bf16 with step_i, or null -> ctx (B, D) f32 and the K/V rows (B, D),
// bf16 or (int8) f32. kvb, cluster, rows_cap as bgt_decode_paged.
extern "C" int bgt_batched_attention(
    const float* qkv, int D, int H, int B, int S, int W, const int* past,
    int kvb, int cluster, int rows_cap, const void* k_cache,
    const void* v_cache, const float* k_scales, const float* v_scales,
    int step_i, int C, const void* k_stage, const void* v_stage, float* ctx,
    void* k_rows, void* v_rows, void* stream) {
  if (D != H * DK || B < 1 || W < 1 || W > S
      || (k_scales == nullptr) != (v_scales == nullptr)
      || (k_stage == nullptr) != (v_stage == nullptr)
      || (k_stage != nullptr && (k_scales != nullptr || step_i < 0
                                 || step_i > C)))
    return (int)cudaErrorInvalidValue;
  BatchedAttn a;
  a.qkv = qkv;
  a.kc = k_cache;
  a.vc = v_cache;
  a.ks = k_scales;
  a.vs = v_scales;
  a.kst = static_cast<const __nv_bfloat16*>(k_stage);
  a.vst = static_cast<const __nv_bfloat16*>(v_stage);
  a.past = past;
  a.ctx = ctx;
  a.k_rows = k_rows;
  a.v_rows = v_rows;
  a.D = D;
  a.H = H;
  a.S = S;
  a.W = W;
  a.kvb = kvb;
  a.step_i = k_stage != nullptr ? step_i : 0;
  a.C = C;
  a.rows_cap = rows_cap;
  a.scale = 1.0f / sqrtf((float)DK);
  if (!launch_attn(a, B, cluster, static_cast<cudaStream_t>(stream)))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
