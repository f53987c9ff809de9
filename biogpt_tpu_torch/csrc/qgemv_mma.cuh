// Tensor-core GEMV for the batched decode chains (decode_layers.cuh's
// `batched_layers`, run by decode_batched.cu and decode_paged.cu), the
// tensor-parallel halves (decode_tp.cu) and the M=16/32 lm_head tails
// (lm_head_argmax.cu, through mma_block_sums with the rows LayerNorm'd
// once in bf16; qgemv_b1.cuh takes its group loads and fragment layout to
// one row with the X' numerics, prefill.cu its `weight_pair`): the
// layer projections of M = 8, 16 or 32 activation rows against one packed
// 4/5-bit or unpacked 8-bit weight plane (qgemv.cuh's layouts), with the
// numerics of pallas_decode.py::_qmm_dq, which the TPU's batched and paged
// decode kernels use: x rounded to bf16, each weight dequantized in f32 and
// rounded once to bf16, w = bf16((lv - offset) * scale [+ min]), and
// y = sum_k x_k * w_k with exact f32 products. Only the order of the f32
// sums differs from the plain version, and it is one fixed order for every
// format, so a weight re-encoded exactly in another format gives the same
// bits.
//
// Bound on an H100: bytes. At M = 32 the four projections of a 347M layer
// do 2 * 32 * 12.6M operations on 7.1 MB of Q4_0 planes (13.4 MB in Q8_0):
// 114 (60) operations per byte, under the card's 295 for bf16, so the
// planes' bytes at 3.35 TB/s set the pace (0.051 ms a step in Q4_0). The
// design keeps every byte of a projection in flight at once:
//   - a block owns MMA_COLS = 64 output columns and MMA_WARPS = 4 packed
//     groups (k-steps of 32 packed rows: level rows k0 + i and
//     d_in/2 + k0 + i), one per warp; grid (d_out / 64, splits), splits =
//     ceil(d_in / 256), so a 347M projection runs 192-256 blocks, and 64
//     (o, 1024 -> 1024) where its 0.5 MB is in flight anyway;
//   - each warp issues its group's level rows (and fifth-bit or high rows),
//     scales and mins with 16-byte cp.async before anything else, then
//     reads its 64 activation columns of the M rows (f32, LayerNorm applied
//     from per-row statistics computed once per projection by
//     row_stats_kernel) and rounds them to bf16 in shared memory;
//   - it dequantizes straight into mma.sync.m16n8k16 B fragments (bf16 in,
//     f32 accumulation): lane (g, tg) reads 8 consecutive columns of a
//     level row with one 64-bit shared load, so column 8g + t of the tile
//     is column g of the t-th n8 fragment; M = 32 is two m16 tiles, M = 16
//     one, and M = 8 one with zero rows;
//   - the four warps' sums meet in shared memory in warp order, and the
//     splits of a column tile in split order: the splits of a tile are one
//     thread block cluster (at most 16 blocks: d_in <= 4096), each block
//     keeps its sums in shared memory, and after a cluster barrier block r
//     sums its slice of the tile (ceil(M * 64 / splits) sums, the last
//     slice shorter) over the cluster's blocks through distributed shared
//     memory and applies the epilogue (bias; bias +
//     exact-erf GELU; or the residual (x + y) + bias). No atomics, and no
//     partial sums through device memory;
//   - it is launched as a programmatic dependent of the kernel before it:
//     its weights are in flight while that kernel finishes.
// No wgmma or TMA: M = 32 fills half of wgmma's 64-row tile, and bytes, not
// the tensor rate, bound the work.
#pragma once

#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "qgemv.cuh"

namespace bgt {

namespace cg = cooperative_groups;

constexpr int MMA_COLS = 64;              // output columns per block
constexpr int MMA_WARPS = 4;              // packed groups per block
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int MMA_LROW = MMA_COLS + 16;   // level row stride in shared memory
constexpr int MMA_AROW = 2 * QK + 8;      // activation row stride (bf16)
constexpr int MMA_RROW = MMA_COLS + 1;    // row stride of the warps' sums
// splits of d_in: one cluster of at most 16 blocks (d_in <= 4096)
constexpr int MMA_MAX_SPLITS = 16;

enum { MMA_EPI_BIAS = 0, MMA_EPI_GELU = 1, MMA_EPI_RESID = 2 };

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack2_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// One projection of M rows.
struct MmaGemv {
  const float* x;            // (M, d_in) f32 activations
  float* stats;              // (M, 2) mean, 1/std of x's rows (with ln_w)
  const __nv_bfloat16* xn;   // or (mma_block_sums<..., XN>) x's rows
                             // LayerNorm'd to bf16 (ln_rows_kernel)
  const float* ln_w;         // (d_in) LayerNorm weight, or null: no LN
  const float* ln_b;
  const uint8_t* lv;         // level plane of format BITS (qgemv.cuh)
  const __nv_bfloat16* sc;   // (d_in/32, d_out)
  const __nv_bfloat16* mn;   // (d_in/32, d_out) or null
  int d_in, d_out, offset;
  int splits;                // blocks along d_in (launch_mma_gemv sets it)
  const float* bias;         // (d_out) or null
  int epi;                   // MMA_EPI_*
  const float* res;          // MMA_EPI_RESID: (M, d_out), may alias y
  float* y;                  // (M, d_out) f32 out
};

// Blocks along d_in: one packed group per warp.
__host__ __device__ inline int mma_splits(int d_in) {
  const int groups = d_in / (2 * QK);
  return (groups + MMA_WARPS - 1) / MMA_WARPS;
}

// The widths the tensor-core GEMVs take: d_in a multiple of 64 up to 4096
// (its splits one cluster), d_out a multiple of 64.
inline bool mma_widths_ok(int d_in, int d_out) {
  return d_in > 0 && d_in % (2 * QK) == 0
         && mma_splits(d_in) <= MMA_MAX_SPLITS && d_out > 0
         && d_out % MMA_COLS == 0;
}

// grid M, block THREADS: stats[m] = (mean, 1/sqrt(var + eps)) of x's row
// m, the mean, then the mean squared deviation (the TPU kernels' `_ln`).
// A template, so only the libraries that launch it build it.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
row_stats_kernel(const float* x, int d, float eps, float* stats) {
  __shared__ float scratch[32];
  pdl_trigger();
  pdl_wait();
  const float* xr = x + (size_t)blockIdx.x * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += THREADS) s += xr[i];
  const float mean = block_sum(s, scratch) / (float)d;
  float q = 0.f;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const float c = xr[i] - mean;
    q += c * c;
  }
  const float var = block_sum(q, scratch) / (float)d;
  if (threadIdx.x == 0) {
    stats[2 * blockIdx.x] = mean;
    stats[2 * blockIdx.x + 1] = 1.0f / sqrtf(var + eps);
  }
}

// grid M, block THREADS: out[m] = bf16 LayerNorm of x's row m, its
// statistics as row_stats_kernel computes them.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
ln_rows_kernel(const float* x, int d, const float* w, const float* b,
               float eps, __nv_bfloat16* out) {
  __shared__ float scratch[32];
  pdl_trigger();
  pdl_wait();
  const float* xr = x + (size_t)blockIdx.x * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += THREADS) s += xr[i];
  const float mean = block_sum(s, scratch) / (float)d;
  float q = 0.f;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const float c = xr[i] - mean;
    q += c * c;
  }
  const float rstd = 1.0f / sqrtf(block_sum(q, scratch) / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += THREADS)
    out[(size_t)blockIdx.x * d + i] =
        __float2bfloat16((xr[i] - mean) * rstd * w[i] + b[i]);
}

// y of (row m, column col) from its summed product v.
__device__ __forceinline__ void mma_epilogue(const MmaGemv& a, int m, int col,
                                             float v) {
  const size_t i = (size_t)m * a.d_out + col;
  float y;
  if (a.epi == MMA_EPI_RESID) {
    // residual order of the TPU kernel: (x + proj) + bias
    y = a.res[i] + v;
    if (a.bias != nullptr) y += a.bias[col];
  } else {
    y = a.bias != nullptr ? v + a.bias[col] : v;
    if (a.epi == MMA_EPI_GELU)
      y = 0.5f * y * (1.0f + erff(y * 0.70710678118654752f));
  }
  a.y[i] = y;
}

// The bits of bf16 element t (< 8) of 16 loaded bytes.
__device__ __forceinline__ uint32_t bf16_bits(const uint4& v, int t) {
  const uint32_t w = t < 2 ? v.x : t < 4 ? v.y : t < 6 ? v.z : v.w;
  return (t & 1) ? w >> 16 : w & 0xFFFFu;
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bf162_of(uint32_t bits) {
  return *reinterpret_cast<__nv_bfloat162*>(&bits);
}

// (level - offset) * scale [+ min] in f32, one rounding each (no fused
// multiply-add); the caller rounds it to bf16
template <bool HAS_MIN>
__device__ __forceinline__ float dequant1(int lvl, float off, float s,
                                          float mn) {
  float w = __fmul_rn((float)lvl - off, s);
  if (HAS_MIN) w = __fadd_rn(w, mn);
  return w;
}

// Level of column t of a lane's 8 columns of one packed row: `lo_word`
// holds the row's nibbles (Q8_0: its low level row), `hi_word` its
// fifth-bit plane row, bit q (Q8_0: its high level row); `high` picks the
// level row d_in/2 + k over k.
template <int BITS>
__device__ __forceinline__ int level_at(uint64_t lo_word, uint64_t hi_word,
                                        int q, bool high, int t) {
  const uint32_t b = (uint32_t)(lo_word >> (8 * t)) & 0xFFu;
  if (BITS == 8) {
    const uint32_t h = (uint32_t)(hi_word >> (8 * t)) & 0xFFu;
    return (int)(int8_t)(high ? h : b);
  }
  int v = high ? (int)(b >> 4) : (int)(b & 15u);
  if (BITS == 5) {
    const uint32_t f = (uint32_t)(hi_word >> (8 * t)) & 0xFFu;
    v |= (int)((f >> (high ? q + 4 : q)) & 1u) << 4;
  }
  return v;
}

// The uncentered levels of column t in packed rows r0 and r1 of a packed
// format (BITS 4 or 5), r0's in the low 16 bits and r1's in the high 16:
// w0, w1 the rows' words, f0, f1 their fifth-bit plane words, q0, q1 their
// fifth-bit positions; `high` picks the level row d_in/2 + k over k.
template <int BITS>
__device__ __forceinline__ uint32_t packed_pair(uint64_t w0, uint64_t w1,
                                                uint64_t f0, uint64_t f1,
                                                int q0, int q1, bool high,
                                                int t) {
  const int b = t & 3;
  const uint32_t sel = b | (b << 4) | ((4 + b) << 8) | ((4 + b) << 12);
  const uint32_t p = __byte_perm((uint32_t)(t < 4 ? w0 : w0 >> 32),
                                 (uint32_t)(t < 4 ? w1 : w1 >> 32), sel);
  uint32_t v = (high ? p >> 4 : p) & 0x000F000Fu;
  if (BITS == 5) {
    const uint32_t f = __byte_perm((uint32_t)(t < 4 ? f0 : f0 >> 32),
                                   (uint32_t)(t < 4 ? f1 : f1 >> 32), sel);
    const int qa = high ? q0 + 4 : q0, qb = high ? q1 + 4 : q1;
    v |= (((f >> qa) & 1u) << 4) | (((f >> (16 + qb)) & 1u) << 20);
  }
  return v;
}

// The bf16 weights of column t in packed rows r0 and r1 (a B-fragment
// register, r0's in the low half): w0, w1 the rows' words, f0, f1 their
// fifth-bit plane (Q5) or high-row (Q8_0) words, q0, q1 their fifth-bit
// positions. Each is bf16((level - offset) * scale [+ min]): the product
// of a level (at most 8 bits) and a bf16 scale is exact in f32, so without
// a min one bf16x2 multiply of the exact integers (level - offset) rounds
// it once, as the f32 product rounded to bf16 does; packed levels become
// bf16 128 + level by their bits (0x4300 | level) and lose 128 + offset
// exactly. With a min, the f32 sum rounds first, then bf16: f32 as written.
template <int BITS, bool HAS_MIN>
__device__ __forceinline__ uint32_t weight_pair(uint64_t w0, uint64_t w1,
                                                uint64_t f0, uint64_t f1,
                                                int q0, int q1, bool high,
                                                int t, float off, float s,
                                                float mn, uint32_t s2,
                                                uint32_t off2) {
  if (HAS_MIN) {
    return pack2_bf16(
        dequant1<true>(level_at<BITS>(w0, f0, q0, high, t), off, s, mn),
        dequant1<true>(level_at<BITS>(w1, f1, q1, high, t), off, s, mn));
  }
  if (BITS == 8) {   // signed levels, exact in bf16
    const uint32_t v = pack2_bf16((float)level_at<8>(w0, f0, 0, high, t),
                                  (float)level_at<8>(w1, f1, 0, high, t));
    return bf162_bits(__hmul2(bf162_of(v), bf162_of(s2)));
  }
  const uint32_t v = packed_pair<BITS>(w0, w1, f0, f1, q0, q1, high, t);
  const __nv_bfloat162 lv = __hsub2(bf162_of(v | 0x43004300u), bf162_of(off2));
  return bf162_bits(__hmul2(lv, bf162_of(s2)));
}

// One warp's packed group grp of a 64-column tile at n0 in flight (16-byte
// cp.async, one commit): R level byte rows of 64 bytes into lvs (rows
// < 32: packed rows k0 + r, or Q8_0's low level rows; rows >= 32: the
// fifth-bit plane rows of packed rows k0 + r - 32, or Q8_0's high level
// rows; R = 32 for BITS 4, else 64), then into scs the scale (and min)
// rows of level blocks grp and grp + d_in/64: scales low, high, then mins
// low, high, 64 bf16 each.
template <int BITS, bool HAS_MIN>
__device__ __forceinline__ void issue_group(const uint8_t* lv,
                                            const __nv_bfloat16* sc,
                                            const __nv_bfloat16* mn,
                                            int d_in, int d_out, int n0,
                                            int grp, const FifthBit& fb,
                                            uint8_t* lvs, __nv_bfloat16* scs,
                                            int lane) {
  constexpr int R = BITS == 4 ? QK : 2 * QK;
  const int groups = d_in / (2 * QK), half = d_in / 2, k0 = grp * QK;
  for (int i = lane; i < R * 4; i += 32) {
    const int r = i >> 2, c = (i & 3) * 16;
    size_t row;
    if (r < QK) {
      row = (size_t)k0 + r;
    } else if (BITS == 8) {
      row = (size_t)half + k0 + r - QK;
    } else {
      int j, q;
      fb.at(r - QK, j, q);
      row = (size_t)half + j;
    }
    cp_async16(lvs + r * MMA_LROW + c, lv + row * d_out + n0 + c);
  }
  for (int i = lane; i < (HAS_MIN ? 4 : 2) * 8; i += 32) {
    const int r = i >> 3, c = (i & 7) * 8;
    const __nv_bfloat16* src = (r >= 2 ? mn : sc)
                               + (size_t)(grp + (r & 1) * groups) * d_out
                               + n0 + c;
    cp_async16(scs + r * MMA_COLS + c, src);
  }
  cp_async_commit();
}

// Lane (g, tg)'s words of a group issued by issue_group: wlo[c][e] the 8
// columns 8g.. of packed row r = 16c + 2tg + (e & 1) + 8 (e >> 1) (Q8_0:
// its low level row), whi[c][e] its fifth-bit plane row (Q8_0: its high
// level row), q5[c][e] its fifth-bit position.
template <int BITS>
__device__ __forceinline__ void group_words(const uint8_t* lvs,
                                            const FifthBit& fb, int g, int tg,
                                            uint64_t (&wlo)[2][4],
                                            uint64_t (&whi)[2][4],
                                            int (&q5)[2][4]) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * c + 2 * tg + (e & 1) + 8 * (e >> 1);
      wlo[c][e] = *reinterpret_cast<const uint64_t*>(lvs + r * MMA_LROW + 8 * g);
      whi[c][e] = BITS == 4 ? 0ull
                            : *reinterpret_cast<const uint64_t*>(
                                  lvs + (QK + r) * MMA_LROW + 8 * g);
      int j = 0, q = 0;
      if (BITS == 5) fb.at(r, j, q);
      q5[c][e] = q;
    }
}

// The WIDE products of one packed group into acc (MI m16 tiles of A
// fragments af): lvs, scs the group's level rows, scales and mins as
// issue_group lands them. Chunks 0, 1 take the low levels of packed rows
// 16c + {2tg, 2tg+1, 2tg+8, 2tg+9}, chunks 2, 3 the high levels of the same
// rows; column 8g + t of the tile is column g of n8 fragment t.
template <int BITS, bool HAS_MIN, int MI>
__device__ __forceinline__ void wide_group_products(
    const uint8_t* lvs, const __nv_bfloat16* scs, const FifthBit& fb,
    float off, const uint32_t (&af)[4][MI][4], float (&acc)[MI][8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  uint64_t wlo[2][4], whi[2][4];   // [low chunk][e]: rows 16c + 2tg + ...
  int q5[2][4];
  group_words<BITS>(lvs, fb, g, tg, wlo, whi, q5);
  const uint4 s4[2] = {*reinterpret_cast<const uint4*>(scs + 8 * g),
                       *reinterpret_cast<const uint4*>(scs + MMA_COLS + 8 * g)};
  uint4 m4[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
  if (HAS_MIN) {
    m4[0] = *reinterpret_cast<const uint4*>(scs + 2 * MMA_COLS + 8 * g);
    m4[1] = *reinterpret_cast<const uint4*>(scs + 3 * MMA_COLS + 8 * g);
  }
  const uint32_t off2 = bf162_bits(__floats2bfloat162_rn(128.f + off,
                                                         128.f + off));
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    uint32_t s2[2];
    float s[2], mn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t sb = bf16_bits(s4[h], t);
      s2[h] = sb | (sb << 16);
      s[h] = __uint_as_float(sb << 16);
      mn[h] = __uint_as_float(bf16_bits(m4[h], t) << 16);
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const int c = kc & 1;
      const bool high = kc >= 2;
      const int h = high ? 1 : 0;
      const uint32_t b0 = weight_pair<BITS, HAS_MIN>(
          wlo[c][0], wlo[c][1], whi[c][0], whi[c][1], q5[c][0], q5[c][1],
          high, t, off, s[h], mn[h], s2[h], off2);
      const uint32_t b1 = weight_pair<BITS, HAS_MIN>(
          wlo[c][2], wlo[c][3], whi[c][2], whi[c][3], q5[c][2], q5[c][3],
          high, t, off, s[h], mn[h], s2[h], off2);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        mma_bf16_16816(acc[mi][t], af[kc][mi], b0, b1);
    }
  }
}

// Shared memory of a GEMV block at M rows in level format BITS: each
// warp's group (level rows, scales and mins, activations), then the warps'
// sums over the same bytes.
template <int M, int BITS>
struct MmaSmem {
  static constexpr int R = BITS == 4 ? QK : 2 * QK;   // level byte rows
  static constexpr int LV_BYTES = R * MMA_LROW;
  static constexpr int SC_BYTES = 4 * MMA_COLS * 2;
  static constexpr int A_BYTES = M * MMA_AROW * 2;
  static constexpr int WARP_BYTES = LV_BYTES + SC_BYTES + A_BYTES;
  static constexpr int RED_BYTES = MMA_WARPS * M * MMA_RROW * 4;
  static constexpr int BYTES = MMA_WARPS * WARP_BYTES > RED_BYTES
                                   ? MMA_WARPS * WARP_BYTES : RED_BYTES;
  static_assert(BYTES <= 48 * 1024, "static shared memory");
};

// Steps 1-4 of a GEMV block (column tile blockIdx.x, split blockIdx.y):
// its sums over its warps' groups, the sum of (row m, column col) at
// smem[m * MMA_RROW + col] (floats), written by the thread that owns
// element m * 64 + col (threadIdx.x + k * MMA_THREADS). XN: the rows come
// LayerNorm'd in bf16 (a.xn), by cp.async beside the weights.
template <int M, int BITS, bool HAS_MIN, bool XN = false>
__device__ __forceinline__ void mma_block_sums(const MmaGemv& a,
                                               unsigned char* smem) {
  constexpr int MI = (M + 15) / 16;            // m16 tiles
  using Sm = MmaSmem<M, BITS>;
  constexpr int LV_BYTES = Sm::LV_BYTES;
  constexpr int SC_BYTES = Sm::SC_BYTES;
  constexpr int WARP_BYTES = Sm::WARP_BYTES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * MMA_COLS;
  const int groups = a.d_in / (2 * QK);
  const int grp = blockIdx.y * MMA_WARPS + warp;
  const int half = a.d_in / 2;
  const float off = (float)a.offset;

  float acc[MI][8][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][t][c] = 0.f;

  const bool active = grp < groups;
  unsigned char* base = smem + warp * WARP_BYTES;
  uint8_t* lvs = base;
  __nv_bfloat16* scs = reinterpret_cast<__nv_bfloat16*>(base + LV_BYTES);
  __nv_bfloat16* as =
      reinterpret_cast<__nv_bfloat16*>(base + LV_BYTES + SC_BYTES);
  const int k0 = grp * QK;   // first packed row of the group
  const FifthBit fb(k0, a.d_in);

  if (active)   // 1. the group's weight bytes in flight
    issue_group<BITS, HAS_MIN>(a.lv, a.sc, a.mn, a.d_in, a.d_out, n0, grp,
                               fb, lvs, scs, lane);
  // the weights are in flight; what follows reads the previous kernel's
  // outputs (x, the statistics, the residual) and writes this one's
  pdl_trigger();
  pdl_wait();

  if (active && XN) {
    // 2. activations: row m's columns k0..k0+31 (slots 0..31) and
    // half+k0..half+k0+31 (slots 32..63), already LayerNorm'd bf16
    for (int i = lane; i < M * 8; i += 32) {
      const int m = i >> 3, c = i & 7;
      const int col = c < 4 ? k0 + 8 * c : half + k0 + 8 * (c - 4);
      cp_async16(as + m * MMA_AROW + c * 8, a.xn + (size_t)m * a.d_in + col);
    }
    cp_async_commit();
  }
  if (active) {
    if constexpr (!XN) {
    // 2. activations: row m's columns k0..k0+31 (slots 0..31) and
    // half+k0..half+k0+31 (slots 32..63), LayerNorm'd where set, to bf16.
    // Lane l reads float4 c4 = l % 16 of rows 2j + l / 16, j < M/2: every
    // load (and the LayerNorm's parameters and statistics) is issued
    // before the first is used.
    constexpr int NV = M / 2;
    const int c4 = lane & 15;
    const int col = c4 < 8 ? k0 + c4 * 4 : half + k0 + (c4 - 8) * 4;
    float4 v[NV];
    float2 st[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int m = 2 * j + (lane >> 4);
      v[j] = *reinterpret_cast<const float4*>(a.x + (size_t)m * a.d_in + col);
    }
    const bool ln = a.ln_w != nullptr;
    float4 lw = make_float4(0.f, 0.f, 0.f, 0.f), lb = lw;
    if (ln) {
      lw = *reinterpret_cast<const float4*>(a.ln_w + col);
      lb = *reinterpret_cast<const float4*>(a.ln_b + col);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        st[j] = *reinterpret_cast<const float2*>(a.stats + 2 * (2 * j + (lane >> 4)));
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int m = 2 * j + (lane >> 4);
      float4 u = v[j];
      if (ln) {
        const float mean = st[j].x, rstd = st[j].y;
        u.x = (u.x - mean) * rstd * lw.x + lb.x;
        u.y = (u.y - mean) * rstd * lw.y + lb.y;
        u.z = (u.z - mean) * rstd * lw.z + lb.z;
        u.w = (u.w - mean) * rstd * lw.w + lb.w;
      }
      uint2 p;
      p.x = pack2_bf16(u.x, u.y);
      p.y = pack2_bf16(u.z, u.w);
      *reinterpret_cast<uint2*>(as + m * MMA_AROW + c4 * 4) = p;
    }
    }
    cp_async_wait<0>();
    __syncwarp();

    // 3. products over the group's four k16 chunks: the A fragments of
    // the M rows (slots kc * 16 ..), then wide_group_products
    uint32_t af[4][MI][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const __nv_bfloat16* ap =
            as + (mi * 16 + g) * MMA_AROW + kc * 16 + tg * 2;
        af[kc][mi][0] = *reinterpret_cast<const uint32_t*>(ap);
        af[kc][mi][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        if (M > 8) {
          af[kc][mi][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * MMA_AROW);
          af[kc][mi][3] =
              *reinterpret_cast<const uint32_t*>(ap + 8 * MMA_AROW + 8);
        } else {
          af[kc][mi][1] = af[kc][mi][3] = 0u;
        }
      }
    wide_group_products<BITS, HAS_MIN, MI>(lvs, scs, fb, off, af, acc);
  }

  // 4. the warps' sums in warp order, into warp 0's slice of red
  // (red[warp][m][col], rows of MMA_RROW floats: at most two-way bank
  // conflicts); fragment element c of n8 tile t lies at row mi*16 + g (+8
  // for c >= 2), column 8 * (2tg + (c & 1)) + t
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = mi * 16 + g + (c >= 2 ? 8 : 0);
        if (m < M)
          red[(warp * M + m) * MMA_RROW + 8 * (2 * tg + (c & 1)) + t] =
              acc[mi][t][c];
      }
  __syncthreads();
  for (int e = threadIdx.x; e < M * MMA_COLS; e += MMA_THREADS) {
    const int m = e / MMA_COLS, col = e % MMA_COLS;
    float s = red[m * MMA_RROW + col];
#pragma unroll
    for (int w = 1; w < MMA_WARPS; ++w) s += red[(w * M + m) * MMA_RROW + col];
    red[m * MMA_RROW + col] = s;
  }
}

template <int M, int BITS, bool HAS_MIN>
__global__ void __launch_bounds__(MMA_THREADS)
qgemv_mma_kernel(MmaGemv a) {
  __shared__ __align__(16) unsigned char smem[MmaSmem<M, BITS>::BYTES];
  mma_block_sums<M, BITS, HAS_MIN>(a, smem);
  const int n0 = blockIdx.x * MMA_COLS;
  float* red = reinterpret_cast<float*>(smem);
  if (a.splits == 1) {
    for (int e = threadIdx.x; e < M * MMA_COLS; e += MMA_THREADS) {
      const int m = e / MMA_COLS, col = e % MMA_COLS;
      mma_epilogue(a, m, n0 + col, red[m * MMA_RROW + col]);
    }
    return;
  }

  // 5. the splits of the column tile are one thread block cluster: block
  // k's sums stay in its shared memory, and block r sums its slice of the
  // tile, elements [r * per, (r + 1) * per) with per = ceil(M * 64 /
  // splits) (the last slice shorter where splits does not divide M * 64),
  // over the blocks k = 0, 1, ... in order (distributed shared memory),
  // then applies the epilogue
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int TILE = M * MMA_COLS;
  const int per = (TILE + a.splits - 1) / a.splits;
  const int end = min(TILE, (int)(blockIdx.y + 1) * per);
  for (int e = blockIdx.y * per + threadIdx.x; e < end; e += MMA_THREADS) {
    const int m = e / MMA_COLS, col = e % MMA_COLS;
    float* mine = red + m * MMA_RROW + col;
    float v[MMA_MAX_SPLITS];
#pragma unroll
    for (int k = 0; k < MMA_MAX_SPLITS; ++k)
      if (k < a.splits) v[k] = *cluster.map_shared_rank(mine, k);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < MMA_MAX_SPLITS; ++k)
      if (k < a.splits) s += v[k];
    mma_epilogue(a, m, n0 + col, s);
  }
  cluster.sync();   // the other blocks read this one's sums until here
}

inline void launch_row_stats(const float* x, int rows, int d, float eps,
                             float* stats, cudaStream_t st) {
  launch_dependent(row_stats_kernel<256>, dim3(rows), dim3(256), 1, st, x, d,
                   eps, stats);
}

// The projection of `a` at M rows in level format BITS: the LayerNorm
// statistics first where a.ln_w is set (into a.stats, from a.x). d_in <=
// 4096 (the caller checks): its splits form one cluster. Internal linkage
// (static): each library sets its own kernels' cluster attribute once --
// an inline function's static flag would be one symbol for every library
// loaded in the process.
template <int M, int BITS, bool HAS_MIN>
static void launch_mma_gemv(MmaGemv a, float eps, cudaStream_t st) {
  if (a.ln_w != nullptr)
    launch_row_stats(a.x, M, a.d_in, eps, a.stats, st);
  a.splits = mma_splits(a.d_in);
  static bool wide_clusters = false;   // 16 blocks: past the portable 8
  if (!wide_clusters) {
    cudaFuncSetAttribute(qgemv_mma_kernel<M, BITS, HAS_MIN>,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    wide_clusters = true;
  }
  launch_dependent(qgemv_mma_kernel<M, BITS, HAS_MIN>,
                   dim3(a.d_out / MMA_COLS, a.splits), dim3(MMA_THREADS),
                   a.splits, st, a);
}

}  // namespace bgt
