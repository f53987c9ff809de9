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
// K/V rows (and their scales), plus the staged rows < step_i. The layer
// chain and its M-row dequant-then-dot GEMVs (`_qmm_dq`, which the paged
// kernel uses at every B, B=1 included) are decode_batched.cu's
// (`batched_layers` in decode_layers.cuh). Attention is one single-pass
// CTA per (head, slot) instead of split + combine, carrying the TPU
// kernel's design over:
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
#include "decode_layers.cuh"

using namespace bgt;

namespace {

constexpr int PG_ROWS = 64;        // cache rows per streamed tile
constexpr int PG_MAX_KVB = 1024;   // largest KV block (its scores in smem)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// grid B, block 256: amax (B, 2) = the absmax of slot b's new k and v rows
// (qkv (M, 3D) f32 with bias), for the int8 mode's fake-quantized current
// token.
__global__ void row_absmax_kernel(const float* qkv, int D, float* amax) {
  __shared__ float scratch[32];
  const float* row = qkv + (size_t)blockIdx.x * 3 * D;
  float ka = 0.f, va = 0.f;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    ka = fmaxf(ka, fabsf(row[D + c]));
    va = fmaxf(va, fabsf(row[2 * D + c]));
  }
  ka = block_max(ka, scratch);
  va = block_max(va, scratch);
  if (threadIdx.x == 0) {
    amax[2 * blockIdx.x] = ka;
    amax[2 * blockIdx.x + 1] = va;
  }
}

// Where tile i of a slot's stream lies: each KV block j contributes its K
// tiles, then its V tiles; every block but the last holds kvb rows.
struct TileMap {
  int nb, kvb, nsub, last_rows, last_sub;

  __device__ int count() const {
    return nb > 0 ? 2 * nsub * (nb - 1) + 2 * last_sub : 0;
  }

  // -> block j, K (0) or V (1), tile `sub` of the block, the block's live
  // rows and tiles
  __device__ void at(int i, int& j, int& kind, int& sub, int& rows,
                     int& tiles) const {
    int r = i;
    if (i < 2 * nsub * (nb - 1)) {
      j = i / (2 * nsub);
      r = i % (2 * nsub);
      rows = kvb;
      tiles = nsub;
    } else {
      j = nb - 1;
      r = i - 2 * nsub * (nb - 1);
      rows = last_rows;
      tiles = last_sub;
    }
    kind = r / tiles;
    sub = r % tiles;
  }
};

// grid (H, B), block ATT_THREADS: slot b's attention for head h over its
// live cache rows (and, STAGED, its staged rows < step_i), then the
// current token -> ctx row (b, h) and the layer's K/V rows (b, h). KT: bf16
// values, or int8 levels with row scales ks, vs ((B, S) of this layer).
// kst/vst: this layer's (B, C, D) staging; amax: (B, 2) (QUANT).
template <typename KT, bool QUANT, bool STAGED>
__global__ void __launch_bounds__(ATT_THREADS)
attn_paged_kernel(const float* qkv, int D, const KT* kc, const KT* vc,
                  const float* ks, const float* vs, int S, const int* past,
                  int W, int kvb, int step_i, const __nv_bfloat16* kst,
                  const __nv_bfloat16* vst, int C, const float* amax,
                  float scale, float* ctx, void* k_rows, void* v_rows) {
  constexpr int ROW_BYTES = DK * sizeof(KT);   // one head's slice of a row
  constexpr int PIECES = ROW_BYTES / 16;
  __shared__ __align__(16) KT tile[2][PG_ROWS * DK];
  __shared__ float tsc[2][PG_ROWS];   // the tile's row scales (int8 mode)
  __shared__ float q[DK];
  __shared__ float sc[PG_MAX_KVB];
  __shared__ float red[ATT_THREADS / 32][DK];
  __shared__ float scratch[32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  constexpr int NW = ATT_THREADS / 32;
  const float* row = qkv + (size_t)b * 3 * D;
  if (t < DK) q[t] = bf16r(row[h * DK + t] * scale);

  const int live = max(0, min(past[b] - step_i, W));
  TileMap map;
  map.kvb = kvb;
  map.nb = (live + kvb - 1) / kvb;
  map.nsub = (kvb + PG_ROWS - 1) / PG_ROWS;
  map.last_rows = live - (map.nb - 1) * kvb;
  map.last_sub = (map.last_rows + PG_ROWS - 1) / PG_ROWS;
  const int ntiles = map.count();
  const KT* kb = kc + (size_t)b * S * D + h * DK;
  const KT* vb = vc + (size_t)b * S * D + h * DK;

  auto issue = [&](int i) {
    int j, kind, sub, rows, tiles;
    map.at(i, j, kind, sub, rows, tiles);
    const int n = min(PG_ROWS, rows - sub * PG_ROWS);
    const char* src = reinterpret_cast<const char*>(
        (kind == 0 ? kb : vb) + (size_t)(j * kvb + sub * PG_ROWS) * D);
    char* dst = reinterpret_cast<char*>(tile[i & 1]);
    for (int c = t; c < n * PIECES; c += ATT_THREADS) {
      const int r = c / PIECES, piece = c % PIECES;
      cp_async16(dst + r * ROW_BYTES + piece * 16,
                 src + (size_t)r * D * sizeof(KT) + piece * 16);
    }
    if (QUANT) {   // the rows' K or V scales travel with the tile
      const float* srow = (kind == 0 ? ks : vs) + (size_t)b * S + j * kvb
                          + sub * PG_ROWS;
      for (int r = t; r < n; r += ATT_THREADS)
        cp_async4(&tsc[i & 1][r], srow + r);
    }
    cp_async_commit();
  };

  if (ntiles > 0) issue(0);
  __syncthreads();
  const float q0 = q[2 * lane], q1 = q[2 * lane + 1];
  float m = -1e30f, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int j, kind, sub, rows, tiles;
    map.at(i, j, kind, sub, rows, tiles);
    const int n = min(PG_ROWS, rows - sub * PG_ROWS);
    const KT* tl = tile[i & 1];
    const float* ts = tsc[i & 1];
    if (kind == 0) {
      for (int r = warp; r < n; r += NW) {
        const float2 k2 = kv_pair(tl + r * DK + 2 * lane);
        const float d = warp_sum(q0 * k2.x + q1 * k2.y);
        if (lane == 0) sc[sub * PG_ROWS + r] = QUANT ? d * ts[r] : d;
      }
      if (sub == tiles - 1) {   // the block's scores are in: its softmax step
        __syncthreads();
        float mx = -1e30f;
        for (int r = t; r < rows; r += ATT_THREADS) mx = fmaxf(mx, sc[r]);
        const float m_new = fmaxf(m, block_max(mx, scratch));
        float ls = 0.f;
        for (int r = t; r < rows; r += ATT_THREADS) {
          const float p = expf(sc[r] - m_new);
          sc[r] = p;
          ls += p;
        }
        const float alpha = expf(m - m_new);
        l = l * alpha + block_sum(ls, scratch);
        a0 *= alpha;
        a1 *= alpha;
        m = m_new;
      }
    } else {
      for (int r = warp; r < n; r += NW) {
        const float p0 = sc[sub * PG_ROWS + r];
        const float p = bf16r(QUANT ? p0 * ts[r] : p0);
        const float2 v2 = kv_pair(tl + r * DK + 2 * lane);
        a0 += p * v2.x;
        a1 += p * v2.y;
      }
    }
    __syncthreads();   // tile i's buffer is free for tile i + 2
  }
  red[warp][2 * lane] = a0;
  red[warp][2 * lane + 1] = a1;
  __syncthreads();
  float acc = 0.f;
  if (t < DK)
    for (int w = 0; w < NW; ++w) acc += red[w][t];

  if (STAGED && step_i > 0) {
    // the chunk's staged rows < step_i: one more block, its own m_new
    const __nv_bfloat16* ksb = kst + (size_t)b * C * D + h * DK;
    const __nv_bfloat16* vsb = vst + (size_t)b * C * D + h * DK;
    for (int r = warp; r < step_i; r += NW) {
      const float2 k2 = kv_pair(ksb + (size_t)r * D + 2 * lane);
      const float d = warp_sum(q0 * k2.x + q1 * k2.y);
      if (lane == 0) sc[r] = d;
    }
    __syncthreads();
    float mx = -1e30f;
    for (int r = t; r < step_i; r += ATT_THREADS) mx = fmaxf(mx, sc[r]);
    const float m_new = fmaxf(m, block_max(mx, scratch));
    float ls = 0.f;
    for (int r = t; r < step_i; r += ATT_THREADS) {
      const float p = expf(sc[r] - m_new);
      sc[r] = p;
      ls += p;
    }
    const float alpha = expf(m - m_new);
    l = l * alpha + block_sum(ls, scratch);   // (syncs: sc holds p)
    if (t < DK) {
      float s = 0.f;
      for (int r = 0; r < step_i; ++r)
        s += bf16r(sc[r]) * __bfloat162float(vsb[(size_t)r * D + t]);
      acc = acc * alpha + s;
    }
    m = m_new;
  }

  // the current token, then the context row and the layer's new K/V rows
  const int col = h * DK + t;
  float k = 0.f, v = 0.f;
  if (t < DK) {
    k = row[D + col];
    v = row[2 * D + col];
    if (QUANT) {
      static_cast<float*>(k_rows)[(size_t)b * D + col] = k;
      static_cast<float*>(v_rows)[(size_t)b * D + col] = v;
      k = fake_quant(k, amax[2 * b]);
      v = fake_quant(v, amax[2 * b + 1]);
    } else {
      static_cast<__nv_bfloat16*>(k_rows)[(size_t)b * D + col] = __float2bfloat16(k);
      static_cast<__nv_bfloat16*>(v_rows)[(size_t)b * D + col] = __float2bfloat16(v);
    }
  }
  const float cur = block_sum(t < DK ? q[t] * k : 0.f, scratch);
  if (t < DK) {
    const float m_fin = fmaxf(m, cur);
    const float alpha2 = expf(m - m_fin), pc = expf(cur - m_fin);
    ctx[(size_t)b * D + col] = (acc * alpha2 + pc * v) / (l * alpha2 + pc);
  }
}

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

// Scratch sizes (floats) the wrapper allocates for M padded rows:
// part >= bgt_decode_paged_part_size(D, F, M), qkv M*3D, ctx M*D (zeroed),
// ff M*F, amax B*2. k_scales/v_scales: (L,B,1,S) f32 in the int8 mode (the
// caches int8, the rows f32), else null. kvb: the KV block; k_stage and
// v_stage ((L,B,C,D) bf16) with step_i select the staged mode (bf16 only),
// else null.
extern "C" int bgt_decode_paged_part_size(int D, int F, int M) {
  return batched_part_size(D, F, M);
}

extern "C" int bgt_decode_paged(
    float* x, int L, int D, int F, int H, int S, int B, int M, int W,
    const int* past, float eps, int offset, int bits, const float* ln0w,
    const float* ln0b, const float* ln1w, const float* ln1b,
    const uint8_t* qkv_lv, const void* qkv_sc, const void* qkv_mn, const float* qkv_b,
    const uint8_t* o_lv, const void* o_sc, const void* o_mn, const float* o_b,
    const uint8_t* fc1_lv, const void* fc1_sc, const void* fc1_mn, const float* fc1_b,
    const uint8_t* fc2_lv, const void* fc2_sc, const void* fc2_mn, const float* fc2_b,
    const void* k_cache, const void* v_cache, const float* k_scales,
    const float* v_scales, void* k_rows, void* v_rows, float* part,
    float* qkv, float* ctx, float* ff, float* amax, int kvb, int step_i, int C,
    const void* k_stage, const void* v_stage, void* stream) {
  const bool quant = k_scales != nullptr, staged = k_stage != nullptr;
  if (D != H * DK || B < 1 || B > M || W < 1 || W > S || kvb < 1
      || kvb > PG_MAX_KVB || (k_scales == nullptr) != (v_scales == nullptr)
      || staged != (v_stage != nullptr) || (staged && quant)
      || (staged && (step_i < 0 || step_i > C || C > PG_MAX_KVB)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BatchedStep s = batched_step(
      x, L, D, F, H, S, B, W, past, eps, offset, bits, ln0w, ln0b, ln1w,
      ln1b,
      qkv_lv, qkv_sc, qkv_mn, qkv_b, o_lv, o_sc, o_mn, o_b,
      fc1_lv, fc1_sc, fc1_mn, fc1_b, fc2_lv, fc2_sc, fc2_mn, fc2_b,
      k_cache, v_cache, k_scales, v_scales, k_rows, v_rows, part, qkv, ctx,
      ff);
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
