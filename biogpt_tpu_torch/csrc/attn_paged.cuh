// The single-pass decode attention CTA of the B=1 step (decode_step.cu)
// and the tensor-parallel attention half (decode_tp.cu): one CTA per
// (head, slot) streams the slot's live KV rows in 64-row cp.async
// double-buffered tiles and runs the TPU kernels' online softmax in their
// order: per KV block, m_new over the whole block's scores, p = exp(s -
// m_new) in f32, raw p into the denominator, in int8 each score times its
// row's K scale and the V scale folded into p, p rounded to bf16, then
// p.V into the accumulator; the current token last. The batched steps
// take attn_batched.cuh's kernel instead.
// The head width is DK; `D` below is the cache's row width -- d_model, or
// one rank's d_model / tp under tensor parallelism.
#pragma once

#include "async_copy.cuh"
#include "decode_layers.cuh"

namespace bgt {

constexpr int PG_ROWS = 64;        // cache rows per streamed tile
constexpr int PG_MAX_KVB = 1024;   // largest KV block (its scores in smem)

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
// live cache rows, then the current token -> ctx row (b, h) and the layer's K/V rows (b, h). KT: bf16
// values, or int8 levels with row scales ks, vs ((B, S) of this layer).
// The current token's q, k, v come from qkv ((B, 3D) rows, q scaled here
// by `scale`), or, EXT, from q_ext, k_ext, v_ext ((B, D) rows each, q
// already scaled, k and v already quantized and dequantized by the caller:
// no fake quantization here and no K/V rows out). amax: (B, 2) (QUANT,
// not EXT), or, DEP, null. DEP:
// launched as a programmatic dependent of the kernel that wrote qkv (the
// B=1 chain, decode_step.cu): it waits for that kernel before reading
// anything, and in the QUANT mode takes its slot's k and v absmax itself,
// so no launch sits between the two.
template <typename KT, bool QUANT, bool EXT = false, bool DEP = false>
__global__ void __launch_bounds__(ATT_THREADS)
attn_paged_kernel(const float* qkv, int D, const KT* kc, const KT* vc,
                  const float* ks, const float* vs, int S, const int* past,
                  int W, int kvb, const float* amax,
                  float scale, float* ctx, void* k_rows, void* v_rows,
                  const float* q_ext = nullptr, const float* k_ext = nullptr,
                  const float* v_ext = nullptr) {
  constexpr int ROW_BYTES = DK * sizeof(KT);   // one head's slice of a row
  constexpr int PIECES = ROW_BYTES / 16;
  __shared__ __align__(16) KT tile[2][PG_ROWS * DK];
  __shared__ float tsc[2][PG_ROWS];   // the tile's row scales (int8 mode)
  __shared__ float q[DK];
  __shared__ float sc[PG_MAX_KVB];
  __shared__ float red[ATT_THREADS / 32][DK];
  __shared__ float scratch[32];
  pdl_trigger();   // the o GEMV after it may start loading its weights
  if (DEP) pdl_wait();
  const int h = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  constexpr int NW = ATT_THREADS / 32;
  const float* row = EXT ? nullptr : qkv + (size_t)b * 3 * D;
  if (t < DK)
    q[t] = bf16r((EXT ? q_ext[(size_t)b * D + h * DK + t] : row[h * DK + t])
                 * scale);

  const int live = max(0, min(past[b], W));
  TileMap map;
  map.kvb = kvb;
  map.nb = (live + kvb - 1) / kvb;
  map.nsub = (kvb + PG_ROWS - 1) / PG_ROWS;
  map.last_rows = live - (map.nb - 1) * kvb;
  map.last_sub = (map.last_rows + PG_ROWS - 1) / PG_ROWS;
  const int ntiles = map.count();
  const KT* kb = kc + (size_t)b * S * D + h * DK;
  const KT* vb = vc + (size_t)b * S * D + h * DK;

  auto load_tile = [&](int i) {
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

  if (ntiles > 0) load_tile(0);
  float kmax = 0.f, vmax = 0.f;   // DEP, QUANT: the row's absmax
  if (DEP && QUANT && !EXT) {
    for (int c = t; c < D; c += ATT_THREADS) {
      kmax = fmaxf(kmax, fabsf(row[D + c]));
      vmax = fmaxf(vmax, fabsf(row[2 * D + c]));
    }
    kmax = block_max(kmax, scratch);
    vmax = block_max(vmax, scratch);
  }
  __syncthreads();
  const float q0 = q[2 * lane], q1 = q[2 * lane + 1];
  float m = -1e30f, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_tile(i + 1);
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

  // the current token, then the context row and the layer's new K/V rows
  const int col = h * DK + t;
  float k = 0.f, v = 0.f;
  if (t < DK && EXT) {
    k = k_ext[(size_t)b * D + col];
    v = v_ext[(size_t)b * D + col];
  } else if (t < DK) {
    k = row[D + col];
    v = row[2 * D + col];
    if (QUANT) {
      static_cast<float*>(k_rows)[(size_t)b * D + col] = k;
      static_cast<float*>(v_rows)[(size_t)b * D + col] = v;
      k = fake_quant(k, DEP ? kmax : amax[2 * b]);
      v = fake_quant(v, DEP ? vmax : amax[2 * b + 1]);
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

}  // namespace bgt
