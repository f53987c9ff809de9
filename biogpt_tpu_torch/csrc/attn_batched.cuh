// The attention of every batched decode step: decode_batched.cu's lockstep
// step and decode_paged.cu's paged and staged steps, 1 <= B <= 32 slots,
// bf16 or int8 KV. One launch a layer, as a programmatic dependent of the
// qkv GEMV.
//
// Replaces the attention of biogpt_tpu/ops/pallas_decode.py::
// decode_step_fused in its batched modes: lockstep (`_make_kernel_batched`,
// the online softmax :479-497 over `_kv_block(W, B, D)` blocks, the int8
// mode :455-496), paged (`_make_kernel_paged` :573-751, over
// `_kv_block_paged(W)` blocks, the int8 mode :680-702) and staged
// (:502-534: the chunk's staged rows fold in as one more block).
//
// Bound on an H100: bytes -- each slot's live K/V rows, read once, and in
// the int8 mode their f32 scales: 25.1 MB a layer at B = 32, window 512,
// ragged positions, 7.5 us at 3.35 TB/s (tools/kernel_bounds.py,
// `attn_sub_rows`). The work is about one FLOP a cache byte; what a CTA
// costs is its chain of latencies (the loads, the exchanges), so the
// design keeps every CTA's bytes in flight at once and its chain short.
//
// Design:
//   - a slot's rows are its live cache rows, min(past - step_i, W) of
//     them, then the chunk's staged rows < step_i (staged step);
//   - grid (cs, H, B): a CTA a (head, slot) when the rows are few, else a
//     thread block cluster of cs CTAs a (head, slot) (the wrapper's plan,
//     ops/decode_kernels.py::attn_plan: up to 16 CTAs of rows_cap rows).
//     CTA c takes the slot's rows [c rows_cap, (c + 1) rows_cap); the CTAs
//     past a slot's rows (its "inactive" ones) exit as soon as they have
//     started, so a short slot costs one CTA a head, and no cluster-wide
//     barrier waits for them;
//   - before griddepcontrol.wait, while the qkv GEMV still runs, every
//     thread issues its cp.async copies of the CTA's whole range -- the
//     head's slice of its K rows, then of its V rows (and, int8, their
//     scales), each half completing on an mbarrier. Only q and the current
//     token come from the GEMV. The cache rows were committed by earlier
//     steps, and the staged rows by earlier steps of the chunk; reading
//     them before the wait is safe because every kernel that writes them
//     (kv_commit.cu's commits, write_block, the staging copy) is an
//     ordinary launch that never triggers its dependents early: the
//     kernels after it in the stream, and so this one, start only once
//     all of its CTAs have finished. A writer launched as a programmatic
//     dependent, or one that calls griddepcontrol.launch_dependents,
//     would let these copies read rows still being written
//     (tests/test_torch_attn_split.py checks the writers' launches);
//   - scores: a thread a 16-byte piece (its q piece in registers), the
//     head's pieces on neighbouring lanes summed by shuffles; each active
//     CTA's maxima over the KV blocks its rows touch go to every active CTA
//     of the cluster (asynchronous stores into their shared memory that
//     complete on their mbarriers), so every CTA knows the TPU kernel's
//     running max after each block j, the prefix max M_j;
//   - p = exp(s - M_j) rounds to bf16 against M_j, as the TPU kernel rounds
//     against its running max (int8: each score times its row's K scale,
//     p times its row's V scale before the rounding); the raw p (the
//     denominator) and the rounded p.V are rescaled to the last block's max
//     by exp(M_j - M_last), which the sequential fold applies as a product
//     of per-block factors: only f32 rounding and order differ;
//   - each active CTA's (l, acc) goes to the cluster's first CTA the same
//     way (the others exit without waiting), which sums them in rank
//     order, folds the current token in last (k and v unrounded; int8:
//     fake-quantized with its row's absmax, which that CTA takes itself)
//     and writes the context row and the layer's K/V rows.
#pragma once

#include "async_copy.cuh"
#include "decode_layers.cuh"

namespace bgt {

constexpr int AB_THREADS = 128;
constexpr int AB_MAX_CLUSTER = 16;
constexpr int AB_MAX_ROWS = 512;      // cache rows a CTA holds
constexpr int AB_MAX_BLOCKS = 64;     // KV blocks of a window + the staged one
constexpr int AB_MAX_SMEM = 200 * 1024;

// One layer's attention: the operands of attn_batched_kernel.
struct BatchedAttn {
  const float* qkv;                  // (M, 3D) f32 with bias
  const void* kc;                    // this layer's (B, S, D): bf16 or int8
  const void* vc;
  const float* ks;                   // this layer's (B, S) scales, or null
  const float* vs;
  const __nv_bfloat16* kst;          // this layer's (B, C, D) staging, or null
  const __nv_bfloat16* vst;
  const int* past;                   // (B,) int32
  float* ctx;                        // (M, D) f32
  void* k_rows;                      // this layer's (B, D): bf16, or f32 (int8)
  void* v_rows;
  int D, H, S, W, kvb, step_i, C, rows_cap;
  float scale;
};

// the staged rows after a slot's cache rows (0 without staging)
__host__ __device__ inline int attn_staged_rows(const BatchedAttn& a) {
  return a.kst != nullptr ? a.step_i : 0;
}

// the table's columns: the window's KV blocks and the staged block
__host__ __device__ inline int attn_max_blocks(const BatchedAttn& a) {
  return (a.W + a.kvb - 1) / a.kvb + 1;
}

// Where each part of a CTA's dynamic shared memory lies (bytes from its
// start), for cs CTAs a (head, slot).
struct AttnSmem {
  size_t kt, vt, sc, table, mj, fj, ksc, vsc, total;
};

__host__ __device__ inline AttnSmem attn_smem(const BatchedAttn& a, int cs,
                                              bool quant) {
  const size_t rows = (size_t)a.rows_cap;
  const size_t slice = (size_t)DK * (quant ? 1 : 2);   // a row's head slice
  const int nbt = attn_max_blocks(a);
  AttnSmem m;
  m.kt = 0;
  m.vt = m.kt + rows * slice;
  m.sc = m.vt + rows * slice;
  m.table = m.sc + rows * 4;
  m.mj = m.table + (size_t)cs * nbt * 4;
  m.fj = m.mj + (size_t)nbt * 4;
  m.ksc = m.fj + (size_t)nbt * 4;
  m.vsc = m.ksc + (quant ? (size_t)a.rows_cap * 4 : 0);
  m.total = m.vsc + (quant ? (size_t)a.rows_cap * 4 : 0);
  return m;
}

// q . k over one 16-byte piece u of a row: 8 bf16 values or 16 int8
// levels (q: the piece's floats, in registers)
template <typename KT>
__device__ __forceinline__ float dot_piece(const uint4& u, const float* q);

template <>
__device__ __forceinline__ float dot_piece<__nv_bfloat16>(const uint4& u,
                                                          const float* q) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
  float d = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(v[e]);
    d = fmaf(q[2 * e], f.x, d);
    d = fmaf(q[2 * e + 1], f.y, d);
  }
  return d;
}

template <>
__device__ __forceinline__ float dot_piece<int8_t>(const uint4& u,
                                                   const float* q) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&u);
  float d = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) d = fmaf(q[e], (float)v[e], d);
  return d;
}

// grid (cs, H, B), cluster (cs, 1, 1), block AB_THREADS, dynamic shared
// memory attn_smem(...).total: layer attention of head h = blockIdx.y over
// slot b = blockIdx.z's live rows (see the file's comment). KT: bf16
// values, or int8 levels with row scales (QUANT). Launched as a
// programmatic dependent of the kernel that writes qkv.
template <typename KT, bool QUANT>
__global__ void __launch_bounds__(AB_THREADS)
attn_batched_kernel(const BatchedAttn a) {
  constexpr int EPP = 16 / sizeof(KT);     // elements a 16-byte piece
  constexpr int PIECES = DK / EPP;         // pieces of a row's head slice
  constexpr int RPP = AB_THREADS / PIECES; // rows a score pass
  constexpr int NW = AB_THREADS / 32;
  extern __shared__ __align__(16) unsigned char ab_smem[];
  __shared__ uint64_t bars[2];             // K, then V landed
  __shared__ uint64_t xbar, fbar;          // the table, the partials in
  __shared__ float accs[AB_MAX_CLUSTER][DK];
  __shared__ float ls[AB_MAX_CLUSTER];
  __shared__ float red[NW][DK];
  __shared__ float lred[NW];
  __shared__ float bml[AB_MAX_BLOCKS];     // this CTA's maxima by block
  __shared__ float q[DK];
  __shared__ float scratch[32];
  __shared__ float stmax, mlast_s;

  const int cs = gridDim.x, rank = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int D = a.D;
  pdl_trigger();   // the o GEMV after it may start loading its weights

  // this CTA's rows [r0, r0 + nr) of the slot's live cache rows, then its
  // staged rows: n cache rows from row r0, then nst staged rows from s0
  const int live = max(0, min(a.past[b] - a.step_i, a.W));
  const int step_cap = attn_staged_rows(a);
  const int tot = live + step_cap;
  const int act = max(1, (tot + a.rows_cap - 1) / a.rows_cap);
  const int r0 = min(rank * a.rows_cap, tot);
  const int nr = min(a.rows_cap, tot - r0);
  const int n = max(0, min(nr, live - r0));
  const int nst = nr - n;
  const int s0 = max(0, r0 - live);
  const int nb = (live + a.kvb - 1) / a.kvb;
  const int nbt = nb + (step_cap > 0 ? 1 : 0);   // + the staged block

  const AttnSmem sm = attn_smem(a, cs, QUANT);
  KT* kt = reinterpret_cast<KT*>(ab_smem + sm.kt);
  KT* vt = reinterpret_cast<KT*>(ab_smem + sm.vt);
  float* sc = reinterpret_cast<float*>(ab_smem + sm.sc);
  float* table = reinterpret_cast<float*>(ab_smem + sm.table);
  float* mj = reinterpret_cast<float*>(ab_smem + sm.mj);
  float* fj = reinterpret_cast<float*>(ab_smem + sm.fj);
  float* ksc = reinterpret_cast<float*>(ab_smem + sm.ksc);
  float* vsc = reinterpret_cast<float*>(ab_smem + sm.vsc);

  if (t == 0) {
    mbar_init(&bars[0], AB_THREADS);
    mbar_init(&bars[1], AB_THREADS);
    mbar_init(&xbar, 1);
    mbar_init(&fbar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  // the first half of the barrier before the first remote store: by its
  // second half every CTA of the cluster has started and initialized its
  // mbarriers; an inactive CTA arrives and leaves
  if (cs > 1) cluster_arrive();
  if (rank >= act) return;

  // 1. every copy of the CTA's range in flight: the head's slice of its K
  // rows (and their scales), then of its V rows
  const size_t slot_row = (size_t)b * a.S + r0;
  for (int kind = 0; kind < 2; ++kind) {
    const KT* cache = static_cast<const KT*>(kind == 0 ? a.kc : a.vc)
                      + slot_row * D + h * DK;
    const __nv_bfloat16* stage = (kind == 0 ? a.kst : a.vst);
    KT* dst = kind == 0 ? kt : vt;
    for (int x = t; x < nr * PIECES; x += AB_THREADS) {
      const int r = x / PIECES, piece = x % PIECES;
      const void* src =
          r < n ? static_cast<const void*>(cache + (size_t)r * D + piece * EPP)
                : static_cast<const void*>(
                      stage + ((size_t)b * a.C + s0 + r - n) * D + h * DK
                      + piece * 8);
      cp_async16(dst + r * DK + piece * EPP, src);
    }
    if (QUANT)
      for (int r = t; r < n; r += AB_THREADS)
        cp_async4((kind == 0 ? ksc : vsc) + r,
                  (kind == 0 ? a.ks : a.vs) + slot_row + r);
    cp_async_mbar_arrive(&bars[kind]);
  }

  // 2. the qkv GEMV's outputs: q; in the first CTA the current token (the
  // layer's K/V rows out, its k and v as attention takes them, q . k)
  pdl_wait();
  const float* row = a.qkv + (size_t)b * 3 * D;
  const int col = h * DK + t;
  if (t < DK) q[t] = bf16r(row[col] * a.scale);
  float kcur = 0.f, vcur = 0.f;
  if (rank == 0) {
    if (t < DK) {
      kcur = row[D + col];
      vcur = row[2 * D + col];
      if (QUANT) {
        static_cast<float*>(a.k_rows)[(size_t)b * D + col] = kcur;
        static_cast<float*>(a.v_rows)[(size_t)b * D + col] = vcur;
      } else {
        static_cast<__nv_bfloat16*>(a.k_rows)[(size_t)b * D + col] =
            __float2bfloat16(kcur);
        static_cast<__nv_bfloat16*>(a.v_rows)[(size_t)b * D + col] =
            __float2bfloat16(vcur);
      }
    }
    if (QUANT) {
      float ka = 0.f, va = 0.f;
      for (int c = t; c < D; c += AB_THREADS) {
        ka = fmaxf(ka, fabsf(row[D + c]));
        va = fmaxf(va, fabsf(row[2 * D + c]));
      }
      ka = block_max(ka, scratch);
      va = block_max(va, scratch);
      kcur = fake_quant(kcur, ka);
      vcur = fake_quant(vcur, va);
    }
  }
  __syncthreads();
  float cur = 0.f;
  if (rank == 0) cur = block_sum(t < DK ? q[t] * kcur : 0.f, scratch);

  // 3. scores: a thread a piece, the slice's pieces on neighbouring lanes
  const int piece = t % PIECES;
  float qr[EPP];
#pragma unroll
  for (int e = 0; e < EPP; ++e) qr[e] = q[piece * EPP + e];
  mbar_wait(&bars[0], 0);
  for (int base = 0; base < nr; base += RPP) {
    const int r = base + t / PIECES;
    float d = 0.f;
    if (r < nr)
      d = dot_piece<KT>(*reinterpret_cast<const uint4*>(kt + r * DK
                                                        + piece * EPP),
                        qr);
#pragma unroll
    for (int o = 1; o < PIECES; o <<= 1)
      d += __shfl_xor_sync(0xffffffffu, d, o);
    if (r < nr && piece == 0) sc[r] = QUANT && r < n ? d * ksc[r] : d;
  }
  __syncthreads();

  // 4. this CTA's maximum in each KV block its rows touch (a warp a
  // block), and over the staged rows
  const int j0 = n > 0 ? r0 / a.kvb : 0;
  const int j1 = n > 0 ? (r0 + n - 1) / a.kvb : -1;
  for (int j = j0 + warp; j <= j1; j += NW) {
    const int lo = max(r0, j * a.kvb) - r0;
    const int hi = min(r0 + n, (j + 1) * a.kvb) - r0;
    float mx = -1e30f;
    for (int r = lo + lane; r < hi; r += 32) mx = fmaxf(mx, sc[r]);
    mx = warp_max(mx);
    if (lane == 0) bml[j - j0] = mx;
  }
  if (nst > 0 && warp == NW - 1) {
    float mx = -1e30f;
    for (int r = n + lane; r < nr; r += 32) mx = fmaxf(mx, sc[r]);
    mx = warp_max(mx);
    if (lane == 0) stmax = mx;
  }
  __syncthreads();

  // 5. the maxima to every active CTA of the cluster: row `rank` of each
  // one's table, -1e30 for the blocks this CTA has no rows in
  if (act > 1) {
    if (t == 0) mbar_arrive_expect_tx(&xbar, (unsigned)(act * nbt * 4));
    cluster_wait();
    for (int x = t; x < act * nbt; x += AB_THREADS) {
      const int dst = x / nbt, j = x % nbt;
      float v = -1e30f;
      if (j >= j0 && j <= j1) v = bml[j - j0];
      if (j == nb && nst > 0) v = stmax;
      st_async(cluster_addr(&table[rank * nbt + j], dst), v,
               cluster_addr(&xbar, dst));
    }
    mbar_wait_cluster(&xbar, 0);
  } else {
    if (cs > 1) cluster_wait();
    for (int j = t; j < nbt; j += AB_THREADS)
      table[j] = j >= j0 && j <= j1 ? bml[j - j0]
                 : (j == nb && nst > 0 ? stmax : -1e30f);
    __syncthreads();
  }

  // 6. the prefix maxima M_j (the running max after block j, from the
  // TPU kernel's -1e30), M_last, and each block's exp(M_j - M_last)
  if (warp == 0) {
    float carry = -1e30f;
    for (int base = 0; base < nbt; base += 32) {
      const int j = base + lane;
      float v = -1e30f;
      if (j < nbt)
        for (int c = 0; c < act; ++c) v = fmaxf(v, table[c * nbt + j]);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v = fmaxf(v, u);
      }
      v = fmaxf(v, carry);
      if (j < nbt) mj[j] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    for (int j = lane; j < nbt; j += 32) fj[j] = expf(mj[j] - carry);
    if (lane == 0) mlast_s = carry;
  }
  __syncthreads();

  // 7. each row's weight, a thread a row: p against its block's prefix max,
  // rounded to bf16, rescaled to M_last (over the row's score)
  float lsum = 0.f;
  if (QUANT) mbar_wait(&bars[1], 0);   // the V scales
  for (int r = t; r < nr; r += AB_THREADS) {
    const int j = r < n ? (r0 + r) / a.kvb : nb;
    const float p = expf(sc[r] - mj[j]);
    const float f = fj[j];
    sc[r] = bf16r(QUANT ? p * vsc[r] : p) * f;
    lsum = fmaf(p, f, lsum);
  }
  lsum = warp_sum(lsum);
  if (lane == 0) lred[warp] = lsum;
  __syncthreads();

  // 8. p.V, a warp a row, two columns a lane
  mbar_wait(&bars[1], 0);
  float a0 = 0.f, a1 = 0.f;
  for (int r = warp; r < nr; r += NW) {
    const float w = sc[r];
    const float2 v2 = kv_pair(vt + r * DK + 2 * lane);
    a0 = fmaf(w, v2.x, a0);
    a1 = fmaf(w, v2.y, a1);
  }
  red[warp][2 * lane] = a0;
  red[warp][2 * lane + 1] = a1;
  __syncthreads();

  // 9. this CTA's (acc, l) into slot `rank` of the first CTA; the others
  // leave, the first waits for every active CTA's
  if (rank == 0 && t == 0 && act > 1)
    mbar_arrive_expect_tx(&fbar, (unsigned)((act - 1) * (DK + 1) * 4));
  if (t <= DK) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += t < DK ? red[w][t] : lred[w];
    float* p = t < DK ? &accs[rank][t] : &ls[rank];
    if (rank == 0)
      *p = s;
    else
      st_async(cluster_addr(p, 0), s, cluster_addr(&fbar, 0));
  }
  if (rank != 0) return;
  if (act > 1) mbar_wait_cluster(&fbar, 0);
  __syncthreads();

  // 10. the first CTA: the CTAs' sums in rank order, then the current token
  if (t < DK) {
    float acc = 0.f, l = 0.f;
    for (int c = 0; c < act; ++c) {
      acc += accs[c][t];
      l += ls[c];
    }
    const float m = mlast_s;
    const float m_fin = fmaxf(m, cur);
    const float alpha2 = expf(m - m_fin), pc = expf(cur - m_fin);
    a.ctx[(size_t)b * D + col] = (acc * alpha2 + pc * vcur) / (l * alpha2 + pc);
  }
}

// Whether the launch's operands fit the kernel (cs CTAs a (head, slot) of
// rows_cap rows each cover the window; the KV blocks and the staged one
// fit the table; the heads and the shared memory fit)
// -> its dynamic shared memory in `smem`.
inline bool attn_batched_fits(const BatchedAttn& a, int cs, bool quant,
                              size_t* smem) {
  if (cs < 1 || cs > AB_MAX_CLUSTER || a.kvb < 1 || a.W < 1 || a.H < 1)
    return false;
  *smem = attn_smem(a, cs, quant).total;
  return a.D == a.H * DK
         && (size_t)a.rows_cap * cs >= (size_t)a.W + attn_staged_rows(a)
         && a.rows_cap <= AB_MAX_ROWS
         && attn_max_blocks(a) <= AB_MAX_BLOCKS && a.step_i >= 0
         && *smem <= AB_MAX_SMEM;
}

// Launch layer attention over B slots as a programmatic dependent of the
// stream's previous kernel -> false if the operands do not fit
// (attn_batched_fits). Internal linkage (static), as the GEMVs' launchers:
// each library sets its own kernels' attributes.
template <typename KT, bool QUANT>
static bool launch_attn_batched(const BatchedAttn& a, int B, int cs,
                                cudaStream_t st) {
  size_t smem;
  if (!attn_batched_fits(a, cs, QUANT, &smem)) return false;
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaFuncSetAttribute(attn_batched_kernel<KT, QUANT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         AB_MAX_SMEM);
    cudaFuncSetAttribute(attn_batched_kernel<KT, QUANT>,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attrs_set = true;
  }
  launch_dependent_ex(attn_batched_kernel<KT, QUANT>, dim3(cs, a.H, B),
                      dim3(AB_THREADS), dim3(cs, 1, 1), smem, st, a);
  return true;
}

// The same for the int8 mode (a.ks set: int8 levels) or bf16.
static inline bool launch_attn(const BatchedAttn& a, int B, int cs,
                               cudaStream_t st) {
  return a.ks != nullptr
             ? launch_attn_batched<int8_t, true>(a, B, cs, st)
             : launch_attn_batched<__nv_bfloat16, false>(a, B, cs, st);
}

// Layer l's attention operands of a batched step (kvb rows a KV block;
// cs CTAs a slot of rows_cap rows each; kst, vst: the (L, B, C, D) staging
// with the step's step_i, or null).
inline BatchedAttn step_attn(const BatchedStep& s, int l, int kvb,
                             int rows_cap, int step_i,
                             const __nv_bfloat16* kst,
                             const __nv_bfloat16* vst, int C) {
  const bool quant = s.ks != nullptr;
  const size_t kv_off = (size_t)l * s.B * s.S * s.D * (quant ? 1 : 2);
  const size_t row_off = (size_t)l * s.B * s.D * (quant ? 4 : 2);
  BatchedAttn a;
  a.qkv = s.qkvbuf;
  a.kc = static_cast<const char*>(s.kc) + kv_off;
  a.vc = static_cast<const char*>(s.vc) + kv_off;
  a.ks = quant ? s.ks + (size_t)l * s.B * s.S : nullptr;
  a.vs = quant ? s.vs + (size_t)l * s.B * s.S : nullptr;
  a.kst = kst != nullptr ? kst + (size_t)l * s.B * C * s.D : nullptr;
  a.vst = vst != nullptr ? vst + (size_t)l * s.B * C * s.D : nullptr;
  a.past = s.past;
  a.ctx = s.ctx;
  a.k_rows = static_cast<char*>(s.kr) + row_off;
  a.v_rows = static_cast<char*>(s.vr) + row_off;
  a.D = s.D;
  a.H = s.H;
  a.S = s.S;
  a.W = s.W;
  a.kvb = kvb;
  a.step_i = kst != nullptr ? step_i : 0;
  a.C = C;
  a.rows_cap = rows_cap;
  a.scale = 1.0f / sqrtf((float)DK);
  return a;
}

}  // namespace bgt
