// One single-stream (B=1) decode step through all L layers, bf16 or int8 KV
// cache, Q4_0 / Q4_1 / Q5_0 / Q5_1 (packed) or Q8_0 (unpacked) weights.
//
// Replaces biogpt_tpu/ops/pallas_decode.py::decode_step_fused, B=1 lockstep
// path (`_make_kernel`, its int8-KV mode :288-318). Contract: (x0 (1,D)
// f32, layers, k_cache, v_cache (L,1,S,D) bf16, past) -> (x (1,D) f32,
// k_rows, v_rows (L,1,D) bf16); the caller commits the rows at position
// `past`. In the int8 mode the caches hold int8 levels with f32 row scales
// (L,1,1,S): each score is multiplied by its row's K scale, the V scale
// folds into p before p's bf16 rounding (the denominator sums raw p), the
// current token's k/v enter attention fake-quantized with their row's
// absmax (amax * (1/127)), and the rows leave in f32 for the caller to
// quantize. Bound on an H100: bytes --
// the layer weights (~7 MB a layer at 347M in Q4_0, ~13.4 MB in Q8_0) and
// the `past` live KV
// rows of each layer are read once per token; every other operand is a
// vector. The TPU megakernel kept all layers in one pallas_call because
// op issue dominated there; this first Hopper version is a chain of
// per-layer kernels on the current stream, launched by ONE host entry
// point (Python pays one ctypes call per token):
//   qkv GEMV with LayerNorm-0 in its prologue (qgemv.cuh)
//   split-KV attention: blocks of 64 cache rows per (head, split), each
//     writing (max, sum, P.V) -- 16 heads alone would fill 16 SMs
//   combine: folds the splits and the current token, writes the new K/V
//     rows (the current token's k/v enter attention UNROUNDED, as in the
//     TPU kernel; only the cache copies are bf16)
//   o GEMV + residual, fc1 GEMV with LayerNorm-1 prologue + exact erf GELU,
//     fc2 GEMV + residual
// Numerics mirror pallas_decode.py:276-349: h rounds to bf16 before each
// product, q * (1/sqrt(Dk)) rounds to bf16, scores are f32 against bf16 K,
// p rounds to bf16 before p.V (the denominators keep f32 p). Cache row
// `past` is never read. An int8 cache halves the KV bytes; each (head,
// split) block stages its split's 64 K and V scales in shared memory once.
#include "decode_layers.cuh"

using namespace bgt;

namespace {

// qkv[col] = sum of the qkv GEMV's partials + bias (fixed split order)
__device__ __forceinline__ float qkv_value(const float* part, int splits,
                                           int width, const float* bias,
                                           int col) {
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * width + col];
  return s + bias[col];
}

// grid (H, n_splits), block ATT_THREADS. ml: (H, n_splits, 2) = (max, sum);
// acc: (H, n_splits, DK) = sum_s bf16(exp(score_s - max) [* vs_s]) * V[s].
// KT: bf16 values, or int8 levels with row scales ks, vs (else null).
template <typename KT>
__global__ void __launch_bounds__(ATT_THREADS)
attn_split_kernel(const float* qkv_part, int qsplits, const float* qkv_b,
                  int D, const KT* kc, const KT* vc, const float* ks,
                  const float* vs, int past, float scale, float* ml,
                  float* acc) {
  __shared__ float q[DK];
  __shared__ float sc[ATT_ROWS];
  __shared__ float kss[ATT_ROWS], vss[ATT_ROWS];
  __shared__ float red[ATT_THREADS / 32][DK];
  __shared__ float scratch[32];
  const int h = blockIdx.x, sp = blockIdx.y, ns = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = ATT_THREADS / 32;
  const int s0 = sp * ATT_ROWS;
  const int n = min(past - s0, ATT_ROWS);
  if (threadIdx.x < DK)
    q[threadIdx.x] = bf16r(
        qkv_value(qkv_part, qsplits, 3 * D, qkv_b, h * DK + threadIdx.x) * scale);
  if (ks != nullptr && threadIdx.x < n) {
    kss[threadIdx.x] = ks[s0 + threadIdx.x];
    vss[threadIdx.x] = vs[s0 + threadIdx.x];
  }
  __syncthreads();
  const float q0 = q[2 * lane], q1 = q[2 * lane + 1];
  for (int r = warp; r < n; r += nw) {
    const float2 k2 = kv_pair(kc + (size_t)(s0 + r) * D + h * DK + 2 * lane);
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
    const float2 v2 = kv_pair(vc + (size_t)(s0 + r) * D + h * DK + 2 * lane);
    a0 += p * v2.x;
    a1 += p * v2.y;
  }
  red[warp][2 * lane] = a0;
  red[warp][2 * lane + 1] = a1;
  __syncthreads();
  if (threadIdx.x < DK) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[w][threadIdx.x];
    acc[((size_t)h * ns + sp) * DK + threadIdx.x] = s;
  }
  if (threadIdx.x == 0) {
    ml[((size_t)h * ns + sp) * 2 + 0] = mx;
    ml[((size_t)h * ns + sp) * 2 + 1] = l;
  }
}

// grid H, block DK. Folds the cache splits and the current token into the
// context row; writes the K/V rows the caller commits: bf16, or in the int8
// mode (QUANT) the raw f32 rows, the current token then entering attention
// fake-quantized with its whole row's absmax.
template <bool QUANT>
__global__ void __launch_bounds__(DK)
attn_combine_kernel(const float* qkv_part, int qsplits, const float* qkv_b,
                    int D, const float* ml, const float* acc, int ns,
                    float scale, float* ctx, void* k_row, void* v_row) {
  __shared__ float scratch[32];
  const int h = blockIdx.x, t = threadIdx.x, col = h * DK + t;
  const float q = bf16r(qkv_value(qkv_part, qsplits, 3 * D, qkv_b, col) * scale);
  float k = qkv_value(qkv_part, qsplits, 3 * D, qkv_b, D + col);
  float v = qkv_value(qkv_part, qsplits, 3 * D, qkv_b, 2 * D + col);
  if (QUANT) {
    static_cast<float*>(k_row)[col] = k;
    static_cast<float*>(v_row)[col] = v;
    float ka = 0.f, va = 0.f;
    for (int c = t; c < D; c += DK) {
      ka = fmaxf(ka, fabsf(qkv_value(qkv_part, qsplits, 3 * D, qkv_b, D + c)));
      va = fmaxf(va, fabsf(qkv_value(qkv_part, qsplits, 3 * D, qkv_b, 2 * D + c)));
    }
    k = fake_quant(k, block_max(ka, scratch));
    v = fake_quant(v, block_max(va, scratch));
  } else {
    static_cast<__nv_bfloat16*>(k_row)[col] = __float2bfloat16(k);
    static_cast<__nv_bfloat16*>(v_row)[col] = __float2bfloat16(v);
  }
  const float cur = block_sum(q * k, scratch);
  float m = cur;
  for (int j = 0; j < ns; ++j) m = fmaxf(m, ml[((size_t)h * ns + j) * 2]);
  float l = 0.f, a = 0.f;
  for (int j = 0; j < ns; ++j) {
    const float w = expf(ml[((size_t)h * ns + j) * 2] - m);
    l += ml[((size_t)h * ns + j) * 2 + 1] * w;
    a += acc[((size_t)h * ns + j) * DK + t] * w;
  }
  const float pc = expf(cur - m);
  l += pc;
  a += pc * v;
  ctx[col] = a / l;
}

}  // namespace

// Scratch sizes (floats) the wrapper allocates: part >= bgt_decode_part_size,
// ml >= H * ceil(past/64) * 2, acc >= H * ceil(past/64) * 64, ctx D, ff F.
// k_scales/v_scales: (L,1,1,S) f32 in the int8 mode (the caches int8, the
// rows f32), else null (bf16 caches and rows).
extern "C" int bgt_decode_part_size(int D, int F) {
  const int a = splits_of(D) * 3 * D, b = splits_of(D) * F, c = splits_of(F) * D;
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

extern "C" int bgt_decode_head_dim() { return DK; }

extern "C" int bgt_decode_step(
    float* x, int L, int D, int F, int H, int S, int past, float eps,
    int offset, int bits, const float* ln0w, const float* ln0b,
    const float* ln1w, const float* ln1b,
    const uint8_t* qkv_lv, const void* qkv_sc, const void* qkv_mn, const float* qkv_b,
    const uint8_t* o_lv, const void* o_sc, const void* o_mn, const float* o_b,
    const uint8_t* fc1_lv, const void* fc1_sc, const void* fc1_mn, const float* fc1_b,
    const uint8_t* fc2_lv, const void* fc2_sc, const void* fc2_mn, const float* fc2_b,
    const void* k_cache, const void* v_cache, const float* k_scales,
    const float* v_scales, void* k_rows, void* v_rows, float* part, float* ml,
    float* acc, float* ctx, float* ff, void* stream) {
  if (D != H * DK || (k_scales == nullptr) != (v_scales == nullptr)
      || !with_format(bits, qkv_mn != nullptr, [](auto) {}))
    return (int)cudaErrorInvalidValue;
  const bool quant = k_scales != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Proj qkv = make_proj(qkv_lv, qkv_sc, qkv_mn, qkv_b, bits);
  const Proj o = make_proj(o_lv, o_sc, o_mn, o_b, bits);
  const Proj fc1 = make_proj(fc1_lv, fc1_sc, fc1_mn, fc1_b, bits);
  const Proj fc2 = make_proj(fc2_lv, fc2_sc, fc2_mn, fc2_b, bits);
  auto gemv = [&](const GemvArgs& a) { launch_partial_fmt<1, false>(a, part, st); };
  const size_t row_bytes = quant ? sizeof(float) : sizeof(__nv_bfloat16);
  char* kr = static_cast<char*>(k_rows);
  char* vr = static_cast<char*>(v_rows);
  const float scale = 1.0f / sqrtf((float)DK);
  const int ns = (past + ATT_ROWS - 1) / ATT_ROWS;
  const int sd = splits_of(D), sf = splits_of(F);

  for (int l = 0; l < L; ++l) {
    gemv(layer_args(qkv, l, D, 3 * D, x, ln0w + (size_t)l * D,
                    ln0b + (size_t)l * D, eps, offset));
    const float* bq = qkv_b + (size_t)l * 3 * D;
    const size_t kv_off = (size_t)l * S * D;
    void* krl = kr + (size_t)l * D * row_bytes;
    void* vrl = vr + (size_t)l * D * row_bytes;
    if (quant) {
      if (ns > 0)
        attn_split_kernel<int8_t><<<dim3(H, ns), ATT_THREADS, 0, st>>>(
            part, sd, bq, D, static_cast<const int8_t*>(k_cache) + kv_off,
            static_cast<const int8_t*>(v_cache) + kv_off,
            k_scales + (size_t)l * S, v_scales + (size_t)l * S, past, scale,
            ml, acc);
      attn_combine_kernel<true><<<H, DK, 0, st>>>(
          part, sd, bq, D, ml, acc, ns, scale, ctx, krl, vrl);
    } else {
      if (ns > 0)
        attn_split_kernel<__nv_bfloat16><<<dim3(H, ns), ATT_THREADS, 0, st>>>(
            part, sd, bq, D, static_cast<const __nv_bfloat16*>(k_cache) + kv_off,
            static_cast<const __nv_bfloat16*>(v_cache) + kv_off, nullptr,
            nullptr, past, scale, ml, acc);
      attn_combine_kernel<false><<<H, DK, 0, st>>>(
          part, sd, bq, D, ml, acc, ns, scale, ctx, krl, vrl);
    }
    gemv(layer_args(o, l, D, D, ctx, nullptr, nullptr, eps, offset));
    launch_partial_sum(part, sd, 1, D, o_b + (size_t)l * D, 0, x, x, st);
    gemv(layer_args(fc1, l, D, F, x, ln1w + (size_t)l * D,
                    ln1b + (size_t)l * D, eps, offset));
    launch_partial_sum(part, sd, 1, F, fc1_b + (size_t)l * F, 1, nullptr, ff, st);
    gemv(layer_args(fc2, l, F, D, ff, nullptr, nullptr, eps, offset));
    launch_partial_sum(part, sf, 1, D, fc2_b + (size_t)l * D, 0, x, x, st);
  }
  return (int)cudaGetLastError();
}
