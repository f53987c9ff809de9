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
// each (head, split, slot) block stages its split's 64 of them once).
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
//   split-KV attention over B*H head-rows: grid (H, ceil(W/64), B), a
//     block per (head, 64-row split, slot); splits past a slot's live rows
//     exit at once
//   combine: folds the splits and the current token (its k/v enter
//     UNROUNDED, as in the TPU kernel), writes the new bf16 K/V rows
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
// scores are f32 against bf16 K, p rounds to bf16 before p.V relative to
// its own split's max (the TPU kernel rounds relative to its running max
// over KV blocks; see the tolerance in chip_smoke.py).
#include "decode_layers.cuh"

using namespace bgt;

namespace {

// grid (H, ns, B), block ATT_THREADS. qkv: (M, 3D) f32 with bias.
// ml: (B, H, ns, 2) = (max, sum); acc: (B, H, ns, DK). KT: bf16 values, or
// int8 levels with row scales ks, vs ((B, S) of this layer; else null).
template <typename KT>
__global__ void __launch_bounds__(ATT_THREADS)
attn_split_batched_kernel(const float* qkv, int D, const KT* kc, const KT* vc,
                          const float* ks, const float* vs, int S,
                          const int* past, int W, float scale, float* ml,
                          float* acc) {
  __shared__ float q[DK];
  __shared__ float sc[ATT_ROWS];
  __shared__ float kss[ATT_ROWS], vss[ATT_ROWS];
  __shared__ float red[ATT_THREADS / 32][DK];
  __shared__ float scratch[32];
  const int h = blockIdx.x, sp = blockIdx.y, ns = gridDim.y, b = blockIdx.z;
  const int H = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = ATT_THREADS / 32;
  const size_t o = ((size_t)(b * H + h) * ns + sp);
  const int live = max(0, min(past[b], W));
  const int s0 = sp * ATT_ROWS;
  const int n = min(live - s0, ATT_ROWS);
  if (n <= 0) {   // no live rows in this split: a neutral partial
    if (threadIdx.x < DK) acc[o * DK + threadIdx.x] = 0.f;
    if (threadIdx.x == 0) {
      ml[o * 2 + 0] = -INFINITY;
      ml[o * 2 + 1] = 0.f;
    }
    return;
  }
  if (threadIdx.x < DK)
    q[threadIdx.x] = bf16r(qkv[(size_t)b * 3 * D + h * DK + threadIdx.x] * scale);
  if (ks != nullptr && threadIdx.x < n) {
    kss[threadIdx.x] = ks[(size_t)b * S + s0 + threadIdx.x];
    vss[threadIdx.x] = vs[(size_t)b * S + s0 + threadIdx.x];
  }
  __syncthreads();
  const KT* kb = kc + (size_t)b * S * D;
  const KT* vb = vc + (size_t)b * S * D;
  const float q0 = q[2 * lane], q1 = q[2 * lane + 1];
  for (int r = warp; r < n; r += nw) {
    const float2 k2 = kv_pair(kb + (size_t)(s0 + r) * D + h * DK + 2 * lane);
    const float d = warp_sum(q0 * k2.x + q1 * k2.y);
    if (lane == 0) sc[r] = ks != nullptr ? d * kss[r] : d;
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int r = threadIdx.x; r < n; r += ATT_THREADS) mx = fmaxf(mx, sc[r]);
  mx = block_max(mx, scratch);
  float ls = 0.f;
  for (int r = threadIdx.x; r < n; r += ATT_THREADS) {
    const float p = expf(sc[r] - mx);
    sc[r] = p;
    ls += p;
  }
  const float l = block_sum(ls, scratch);   // (syncs before reading sc)
  float a0 = 0.f, a1 = 0.f;
  for (int r = warp; r < n; r += nw) {
    const float p = bf16r(vs != nullptr ? sc[r] * vss[r] : sc[r]);
    const float2 v2 = kv_pair(vb + (size_t)(s0 + r) * D + h * DK + 2 * lane);
    a0 += p * v2.x;
    a1 += p * v2.y;
  }
  red[warp][2 * lane] = a0;
  red[warp][2 * lane + 1] = a1;
  __syncthreads();
  if (threadIdx.x < DK) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[w][threadIdx.x];
    acc[o * DK + threadIdx.x] = s;
  }
  if (threadIdx.x == 0) {
    ml[o * 2 + 0] = mx;
    ml[o * 2 + 1] = l;
  }
}

// grid (H, B), block DK. Folds slot b's splits and its current token into
// its context row; writes the K/V rows (B, D) of this layer: bf16, or in
// the int8 mode (QUANT) raw f32, the current token then entering attention
// fake-quantized with its whole row's absmax.
template <bool QUANT>
__global__ void __launch_bounds__(DK)
attn_combine_batched_kernel(const float* qkv, int D, const float* ml,
                            const float* acc, int ns, float scale, float* ctx,
                            void* k_rows, void* v_rows) {
  __shared__ float scratch[32];
  pdl_trigger();   // the o GEMV may start loading its weights
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, t = threadIdx.x;
  const int col = h * DK + t;
  const float* row = qkv + (size_t)b * 3 * D;
  const float q = bf16r(row[col] * scale);
  float k = row[D + col];
  float v = row[2 * D + col];
  if (QUANT) {
    static_cast<float*>(k_rows)[(size_t)b * D + col] = k;
    static_cast<float*>(v_rows)[(size_t)b * D + col] = v;
    float ka = 0.f, va = 0.f;
    for (int c = t; c < D; c += DK) {
      ka = fmaxf(ka, fabsf(row[D + c]));
      va = fmaxf(va, fabsf(row[2 * D + c]));
    }
    k = fake_quant(k, block_max(ka, scratch));
    v = fake_quant(v, block_max(va, scratch));
  } else {
    static_cast<__nv_bfloat16*>(k_rows)[(size_t)b * D + col] = __float2bfloat16(k);
    static_cast<__nv_bfloat16*>(v_rows)[(size_t)b * D + col] = __float2bfloat16(v);
  }
  const float cur = block_sum(q * k, scratch);
  const size_t base = (size_t)(b * H + h) * ns;
  float m = cur;
  for (int j = 0; j < ns; ++j) m = fmaxf(m, ml[(base + j) * 2]);
  float l = 0.f, a = 0.f;
  for (int j = 0; j < ns; ++j) {
    const float w = expf(ml[(base + j) * 2] - m);
    l += ml[(base + j) * 2 + 1] * w;
    a += acc[(base + j) * DK + t] * w;
  }
  const float pc = expf(cur - m);
  l += pc;
  a += pc * v;
  ctx[(size_t)b * D + col] = a / l;
}

// Split + combine of layer l's attention (bf16 or int8 KV).
// ml: (B, H, ns, 2) = (max, sum); acc: (B, H, ns, DK).
template <typename KT, bool QUANT>
void attention(const BatchedStep& s, int l, int ns, float scale, float* ml,
               float* acc, cudaStream_t st) {
  const size_t kv_off = (size_t)l * s.B * s.S * s.D;
  const size_t sc_off = (size_t)l * s.B * s.S;
  const size_t row_off = (size_t)l * s.B * s.D * (QUANT ? 4 : 2);
  attn_split_batched_kernel<KT><<<dim3(s.H, ns, s.B), ATT_THREADS, 0, st>>>(
      s.qkvbuf, s.D, static_cast<const KT*>(s.kc) + kv_off,
      static_cast<const KT*>(s.vc) + kv_off,
      QUANT ? s.ks + sc_off : nullptr, QUANT ? s.vs + sc_off : nullptr, s.S,
      s.past, s.W, scale, ml, acc);
  attn_combine_batched_kernel<QUANT><<<dim3(s.H, s.B), DK, 0, st>>>(
      s.qkvbuf, s.D, ml, acc, ns, scale, s.ctx,
      static_cast<char*>(s.kr) + row_off, static_cast<char*>(s.vr) + row_off);
}

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
// M*3D, ml B*H*ceil(W/64)*2, acc B*H*ceil(W/64)*64, ctx M*D (zeroed), ff
// M*F, stats M*2. k_scales/v_scales: (L,B,1,S) f32 in the int8 mode (the
// caches int8, the rows f32), else null (bf16 caches and rows). n_gemv
// (host int, or null): each GEMV launch adds one. D, F <= 4096.

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
    float* ml, float* acc, float* ctx, float* ff, float* stats, int* n_gemv,
    void* stream) {
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
  const float scale = 1.0f / sqrtf((float)DK);
  const int ns = (W + ATT_ROWS - 1) / ATT_ROWS;
  auto attend = [&](int l) {
    if (k_scales != nullptr) attention<int8_t, true>(s, l, ns, scale, ml, acc, st);
    else attention<__nv_bfloat16, false>(s, l, ns, scale, ml, acc, st);
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
