// The single-stream (M = 1) GEMV of the B=1 decode step (decode_step.cu):
// one activation row against one packed 4/5-bit or unpacked 8-bit weight
// plane (qgemv.cuh's layouts), with the numerics of pallas_decode.py::_qmm,
// which the TPU's B=1 decode kernel uses (`_make_kernel`, :246-352) and
// qgemv.cuh calls XPRIME: x rounded to bf16; per 32-level block n the f32
// partial p_n = sum_k x_k * lv_k over UNCENTERED levels, then (p_n - offset
// * xsum_n) * scale_n [+ xsum_n * min_n], summed over n. Only the order of
// the f32 sums differs from the plain version (qmatmul_kernels.
// xprime_logits), one fixed order for every format.
//
// Bound on an H100: bytes, and in practice latency. One 347M projection
// moves 0.5-2.4 MB of Q4_0 planes (0.15-0.7 us at 3.35 TB/s) for 1-4 M
// multiply-adds, so what a chain of them pays is each kernel's launch and
// serial path: the design keeps both short, in qgemv_mma.cuh's structure
// at one row:
//   - a block owns MMA_COLS = 64 output columns and MMA_WARPS = 4 packed
//     groups (level blocks grp and grp + d_in/64), one per warp; grid
//     (d_out / 64, splits), splits = ceil(d_in / 256): 192-256 blocks for
//     a 347M projection, 64 for o (1024 -> 1024);
//   - each warp issues its group's level rows (and fifth-bit or high
//     rows), scales and mins with 16-byte cp.async before anything else,
//     and the kernel is launched as a programmatic dependent, so a
//     projection's weights load while the kernel before it finishes. It
//     lets the next kernel launch at once, or, `late`, only after its
//     products: every kernel of a chain that lets the next launch at once
//     lets the chain run ahead, its weights loading beside the running
//     kernel, and at B=1 a long attention (900 cached rows on 16 SMs)
//     then shares the memory with the next layers' planes and slows; the
//     B=1 step's qkv GEMV holds the chain one layer ahead;
//   - the LayerNorm prologue is computed in every block from the single
//     row, read once into registers (mean, then the mean squared deviation,
//     as the TPU kernels' `_ln` and row_stats_kernel), so no statistics
//     launch precedes the GEMV;
//   - the uncentered levels are exact in bf16, so each warp's partials come
//     from mma.sync.m16n8k16 (row 0 of the A tile holds x, rows 1-15 are
//     zero): the two k16 chunks of a level block accumulate from zero into
//     their own fragment, which is p_n for that block's 64 columns; its
//     scale, offset and min apply in f32 before the block joins the sum;
//   - the four warps' sums meet in shared memory in warp order, and the
//     splits of a column tile, one thread block cluster (at most 16 blocks:
//     d_in <= 4096), in split order: each block writes its sums into the
//     shared memory of the block that owns their columns (a ceil(64 /
//     splits)-column slice each) through distributed shared memory, and
//     after one cluster barrier each block sums its slice and applies the
//     epilogue: + bias (qkv); (x + y) + bias (o, fc2); bias + exact-erf
//     GELU (fc1). No partial sums through device memory, no second pass,
//     and no block waits at its end for the others to read it;
//   - the bias, the LayerNorm parameters and (after the wait) the residual
//     are loaded before they are needed, off the kernel's critical path.
#pragma once

#include "qgemv_mma.cuh"

namespace bgt {

// Row elements a thread holds for the LayerNorm's statistics: d_in <=
// 4096 over MMA_THREADS threads.
constexpr int B1_LN_PER_THREAD = 4096 / MMA_THREADS;

// One projection of one row.
struct B1Gemv {
  const float* x;            // (d_in) f32 activations
  const float* ln_w;         // (d_in) LayerNorm weight, or null: no LN
  const float* ln_b;
  float eps;
  const uint8_t* lv;         // level plane of format BITS (qgemv.cuh)
  const __nv_bfloat16* sc;   // (d_in/32, d_out)
  const __nv_bfloat16* mn;   // (d_in/32, d_out) or null
  int d_in, d_out, offset;
  int splits;                // blocks along d_in (launch_b1_gemv sets it)
  const float* bias;         // (d_out) or null
  int epi;                   // MMA_EPI_*
  const float* res;          // MMA_EPI_RESID: (d_out), may alias y
  float* y;                  // (d_out) f32 out
  bool late;                 // let the next kernel launch only after the
                             // products, not at the start (see below)
};

// The uncentered levels of column t in packed rows r0 and r1 as a bf16x2
// B-fragment register (r0's in the low half): exact, since every level
// has at most 8 bits. Packed levels become bf16 128 + level by their bits
// (0x4300 | level) and lose 128 exactly.
template <int BITS>
__device__ __forceinline__ uint32_t level_pair(uint64_t w0, uint64_t w1,
                                               uint64_t f0, uint64_t f1,
                                               int q0, int q1, bool high,
                                               int t) {
  if (BITS == 8)
    return pack2_bf16((float)level_at<8>(w0, f0, 0, high, t),
                      (float)level_at<8>(w1, f1, 0, high, t));
  const uint32_t v = packed_pair<BITS>(w0, w1, f0, f1, q0, q1, high, t);
  return bf162_bits(__hsub2(bf162_of(v | 0x43004300u),
                            bf162_of(0x43004300u)));
}

// The X' products of one packed group into acc[0][t][c], c < 2 (row g of
// the A tile, column 8 (2tg + c) + t): A rows 8..15 zero, xsum[h] row g's
// sum of its bf16 activations over level block grp (h = 0) and grp +
// d_in/64 (h = 1). Each level block's two k16 chunks accumulate from zero
// into p over the uncentered levels, then (p - offset * xsum) * scale
// [+ xsum * min] in f32 joins the sum, the low block before the high one.
template <int BITS, bool HAS_MIN>
__device__ __forceinline__ void xprime_group_products(
    const uint8_t* lvs, const __nv_bfloat16* scs, const FifthBit& fb,
    float off, const uint32_t (&af)[4][1][4], const float (&xsum)[2],
    float (&acc)[1][8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  uint64_t wlo[2][4], whi[2][4];
  int q5[2][4];
  group_words<BITS>(lvs, fb, g, tg, wlo, whi, q5);
  // the scales (and mins) of the lane's columns 16 tg + 8 c + t: [h][c]
  uint4 s4[2][2], m4[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      s4[h][c] = *reinterpret_cast<const uint4*>(scs + h * MMA_COLS
                                                 + 16 * tg + 8 * c);
      m4[h][c] = HAS_MIN ? *reinterpret_cast<const uint4*>(
                               scs + (2 + h) * MMA_COLS + 16 * tg + 8 * c)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool high = h == 1;
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t b0 = level_pair<BITS>(wlo[c][0], wlo[c][1], whi[c][0],
                                             whi[c][1], q5[c][0], q5[c][1],
                                             high, t);
        const uint32_t b1 = level_pair<BITS>(wlo[c][2], wlo[c][3], whi[c][2],
                                             whi[c][3], q5[c][2], q5[c][3],
                                             high, t);
        mma_bf16_16816(p, af[2 * h + c][0], b0, b1);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float u = (p[c] - off * xsum[h])
                  * __uint_as_float(bf16_bits(s4[h][c], t) << 16);
        if (HAS_MIN)
          u += xsum[h] * __uint_as_float(bf16_bits(m4[h][c], t) << 16);
        acc[0][t][c] += u;
      }
    }
  }
}

// y of column col from its summed product v, its bias b (read where
// a.bias is set) and its residual r (MMA_EPI_RESID).
__device__ __forceinline__ void b1_epilogue(const B1Gemv& a, int col,
                                            float v, float b, float r) {
  float y;
  if (a.epi == MMA_EPI_RESID) {
    // residual order of the TPU kernel: (x + proj) + bias
    y = r + v;
    if (a.bias != nullptr) y += b;
  } else {
    y = a.bias != nullptr ? v + b : v;
    if (a.epi == MMA_EPI_GELU)
      y = 0.5f * y * (1.0f + erff(y * 0.70710678118654752f));
  }
  a.y[col] = y;
}

template <int BITS, bool HAS_MIN>
__global__ void __launch_bounds__(MMA_THREADS)
qgemv_b1_kernel(B1Gemv a) {
  constexpr int R = BITS == 4 ? QK : 2 * QK;   // level byte rows per group
  constexpr int LV_BYTES = R * MMA_LROW;
  constexpr int SC_BYTES = 4 * MMA_COLS * 2;
  constexpr int A_BYTES = 2 * QK * 2;
  constexpr int WARP_BYTES = LV_BYTES + SC_BYTES + A_BYTES;
  __shared__ __align__(16) unsigned char smem[MMA_WARPS * WARP_BYTES];
  __shared__ float red[MMA_WARPS * MMA_COLS];
  __shared__ float part[MMA_MAX_SPLITS * MMA_COLS];   // [split][column]
  __shared__ float scratch[32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * MMA_COLS;
  const int groups = a.d_in / (2 * QK);
  const int grp = blockIdx.y * MMA_WARPS + warp;
  const int half = a.d_in / 2;
  const bool active = grp < groups;
  unsigned char* base = smem + warp * WARP_BYTES;
  uint8_t* lvs = base;
  __nv_bfloat16* scs = reinterpret_cast<__nv_bfloat16*>(base + LV_BYTES);
  __nv_bfloat16* as =
      reinterpret_cast<__nv_bfloat16*>(base + LV_BYTES + SC_BYTES);
  const int k0 = grp * QK;   // first packed row of the group
  const FifthBit fb(k0, a.d_in);
  // the first half of a barrier step 5 completes before its shared memory
  // writes: by then every block of the cluster has started
  if (a.splits > 1) cluster_arrive_relaxed();

  // 1. the group's weight bytes in flight, its LayerNorm parameters, and
  // the bias of the column this thread's epilogue writes (step 5's slice:
  // column ecol of the tile where it is below `per`)
  const int per = (MMA_COLS + a.splits - 1) / a.splits;
  const int ecol = (a.splits == 1 ? 0 : blockIdx.y * per) + threadIdx.x;
  const bool writes = threadIdx.x < per && ecol < MMA_COLS;
  const float bias = writes && a.bias != nullptr ? a.bias[n0 + ecol] : 0.f;
  float lw[2] = {1.f, 1.f}, lb[2] = {0.f, 0.f};
  if (active) {
    issue_group<BITS, HAS_MIN>(a.lv, a.sc, a.mn, a.d_in, a.d_out, n0, grp,
                               fb, lvs, scs, lane);
    if (a.ln_w != nullptr) {
      lw[0] = a.ln_w[k0 + lane];
      lw[1] = a.ln_w[half + k0 + lane];
      lb[0] = a.ln_b[k0 + lane];
      lb[1] = a.ln_b[half + k0 + lane];
    }
  }
  // what follows reads the previous kernel's outputs (x, the residual)
  // and writes this one's
  if (!a.late) pdl_trigger();
  pdl_wait();
  const float res = writes && a.epi == MMA_EPI_RESID ? a.res[n0 + ecol] : 0.f;

  // 2. the row's LayerNorm statistics (every thread of the block), and the
  // warp's activations: columns k0 + lane (slot lane, level block grp) and
  // half + k0 + lane (slot 32 + lane, block grp + groups), to bf16, with
  // their blocks' sums of the rounded values
  float xl = 0.f, xh = 0.f;
  if (active) {
    xl = a.x[k0 + lane];
    xh = a.x[half + k0 + lane];
  }
  if (a.ln_w != nullptr) {
    // the row is read once, every load issued before the first sum
    float xr[B1_LN_PER_THREAD];
#pragma unroll
    for (int j = 0; j < B1_LN_PER_THREAD; ++j) {
      const int i = threadIdx.x + j * MMA_THREADS;
      xr[j] = i < a.d_in ? a.x[i] : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < B1_LN_PER_THREAD; ++j) s += xr[j];
    const float mean = block_sum(s, scratch) / (float)a.d_in;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < B1_LN_PER_THREAD; ++j) {
      const float c = xr[j] - mean;
      if (threadIdx.x + j * MMA_THREADS < a.d_in) q += c * c;
    }
    const float var = block_sum(q, scratch) / (float)a.d_in;
    const float rstd = 1.0f / sqrtf(var + a.eps);
    xl = (xl - mean) * rstd * lw[0] + lb[0];
    xh = (xh - mean) * rstd * lw[1] + lb[1];
  }

  // the warp's sum of column 8 (2tg + c) + t at acc[0][t][c], c < 2
  // (lanes g = 0)
  float acc[1][8][4] = {};
  if (active) {
    const __nv_bfloat16 bl = __float2bfloat16(xl), bh = __float2bfloat16(xh);
    as[lane] = bl;
    as[QK + lane] = bh;
    const float xsum[2] = {warp_sum(__bfloat162float(bl)),
                           warp_sum(__bfloat162float(bh))};
    cp_async_wait<0>();
    __syncwarp();

    // 3. products: A's row g = 0 holds x, the other rows 0
    uint32_t af[4][1][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const __nv_bfloat16* ap = as + kc * 16 + tg * 2;
      af[kc][0][0] = g == 0 ? *reinterpret_cast<const uint32_t*>(ap) : 0u;
      af[kc][0][2] = g == 0 ? *reinterpret_cast<const uint32_t*>(ap + 8) : 0u;
      af[kc][0][1] = af[kc][0][3] = 0u;
    }
    xprime_group_products<BITS, HAS_MIN>(lvs, scs, fb, (float)a.offset, af,
                                         xsum, acc);
  }

  if (a.late) pdl_trigger();
  // 4. the warps' sums in warp order (inactive warps add zeros)
  if (g == 0)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        red[warp * MMA_COLS + 8 * (2 * tg + c) + t] = acc[0][t][c];
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < MMA_COLS) {
    s = red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < MMA_WARPS; ++w) s += red[w * MMA_COLS + threadIdx.x];
  }
  if (a.splits == 1) {
    if (writes) b1_epilogue(a, n0 + ecol, s, bias, res);
    return;
  }

  // 5. the splits of the column tile are one thread block cluster: block k
  // writes its sum of column c into part[k][c] of the block that owns c
  // (block r owns columns [r * per, (r + 1) * per), per = ceil(64 /
  // splits), the last slice shorter or empty) through distributed shared
  // memory; after the cluster barrier each block sums its slice over k =
  // 0, 1, ... in order and applies the epilogue. No block reads another's
  // shared memory, so none waits for the others to finish.
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();
  if (threadIdx.x < MMA_COLS)
    *cluster.map_shared_rank(part + blockIdx.y * MMA_COLS + threadIdx.x,
                             threadIdx.x / per) = s;
  cluster_arrive();
  cluster_wait();
  if (writes) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < MMA_MAX_SPLITS; ++k)
      if (k < a.splits) t += part[k * MMA_COLS + ecol];
    b1_epilogue(a, n0 + ecol, t, bias, res);
  }
}

// The projection of `a` in level format BITS, launched as a programmatic
// dependent of the kernel before it. d_in a multiple of 64 up to 4096 and
// d_out a multiple of 64 (the caller checks): the splits form one cluster.
// Internal linkage (static), as launch_mma_gemv: each library sets its own
// kernels' cluster attribute.
template <int BITS, bool HAS_MIN>
static void launch_b1_gemv(B1Gemv a, cudaStream_t st) {
  a.splits = mma_splits(a.d_in);
  static bool wide_clusters = false;   // 16 blocks: past the portable 8
  if (!wide_clusters) {
    cudaFuncSetAttribute(qgemv_b1_kernel<BITS, HAS_MIN>,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    wide_clusters = true;
  }
  launch_dependent(qgemv_b1_kernel<BITS, HAS_MIN>,
                   dim3(a.d_out / MMA_COLS, a.splits), dim3(MMA_THREADS),
                   a.splits, st, a);
}

}  // namespace bgt
