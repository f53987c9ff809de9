// y = x @ dequant(W) for the Q4_0 / Q4_1 / Q5_0 / Q5_1 (packed) and Q8_0
// (unpacked int8) planes of qgemv.cuh, M <= 32 rows, one launch a call:
//   bgt_qmatmul       M <= 8, XPRIME numerics: qmatmul_kernel (below) at
//                     vocab width and past 1024 rows of d_in,
//                     qgemv_stream.cuh's M <= 8 X' path at projection
//                     widths of up to 1024 rows, where it measured faster
//                     (ops/qmatmul_kernels.qmm_plan picks)
//   bgt_qmatmul_wide  8 < M <= 32, WIDE numerics (qgemv_stream.cuh)
//
// Replaces biogpt_tpu/ops/pallas_qmatmul.py::qmatmul_pallas (M <= 8) and
// ::qmatmul_pallas_wide (8 < M <= 32). Bound on an H100: bytes -- every
// weight byte (0.5, 0.625 or 1 B/weight of levels + 1/16 B/weight of bf16
// scales [+ 1/16 of mins]) is read once per call and the product does 2*M
// flops per weight, below the card's ~295 flop/byte balance point. At the
// lm_head (1024 -> 42,496) the Q4_0 planes are 24.5 MB: 0.0073 ms at
// 3.35 TB/s; at the layer projections (0.6-2.4 MB) a call pays latency.
//
// qmatmul_kernel (M <= 8) computes the X' numerics of the TPU kernel
// (`_kernel`): x rounded to bf16; per 32-level block n the f32 partial p_n
// over the UNCENTERED levels, then (p_n - offset * xsum_n) * scale_n
// [+ xsum_n * min_n] in f32, summed over n. Only the order of the f32 sums
// differs from the plain version (qmatmul_kernels.qmatmul_plain): within a
// block's slice of d_in the packed groups in order, each group's low level
// block before its high one, then the cluster's slices in split order --
// one fixed order for every format and grid (transcribed in
// tests/test_torch_qmatmul_plan.py::qmatmul_sum_order). The design:
//   - one warp of each block is a producer: it streams the planes of the
//     block's output columns through a ring of stages in shared memory, a
//     stage up to 4 packed groups (32 packed rows each: level blocks grp
//     and grp + d_in/64), each unit of 32 columns one TMA box of its level
//     rows (Q8_0: of both its planes, a 3-D box; Q5: its fifth-bit rows,
//     in boxes that stop at the fifth-bit plane's end) and one 3-D box of the stage's scales (and one of
//     its mins), low and high blocks together, completed on mbarriers;
//     the consumers free a stage through a second mbarrier. Two stages
//     are in flight (QMM_AHEAD: ~50 KB an SM at the lm_head, where
//     Little's law asks ~30 KB: 3.35 TB/s x ~1.2 us / 132 SMs), so that
//     they land in order and the consumers start on the first while the
//     rest stream. 1-D bulk copies of each row segment (a 352-byte copy
//     per packed row) were slower at the lm_head, paced by the copies'
//     count, not their bytes: the tensor maps make them 22-44 a stage.
//     What paces the kernel now is the consumers' instruction stream (a
//     byte permute, masks and a bf16 subtract for every two weights) and a
//     fixed cost beyond an empty launch (x's rows, y's stores, the block's
//     start). The maps are encoded once a plane (qmm_maps_cached);
//   - each consumer warp owns a unit of 32 output columns for the whole of
//     the block's d_in slice, so its sums never leave its registers until
//     the end: no cross-warp reduction (a second warp a unit, the odd
//     groups, was no faster at the lm_head: the products are bound by the
//     SM's issue rate, not by the warps' latencies);
//   - products on the tensor cores, mma.sync.m16n8k16 with the weights as
//     the A operand (16 output columns a tile, two tiles a warp) and x as
//     the B operand (n = the M <= 8 rows, unpadded: the lanes of rows past
//     M hold zeros). A lane's 4 columns' bytes of two packed rows become
//     the bf16 pairs of both level blocks with one byte permute, a mask
//     (and shift) with the exponent bits 0x4300 ORed in (128 + level) and a
//     bf16 subtract of 128: exact, since every uncentered level has at most
//     8 bits (Q5: the fifth bit ORed in from its plane; Q8_0: the signed
//     byte as 16 * (high nibble - 8) + low nibble, one bf16 FMA);
//   - x is read once a block, rounded to bf16 into shared memory in the
//     B-fragment order (one 16-byte load a lane a level block), with each
//     level block's sum of the rounded values;
//   - grid (plan: ops/qmatmul_kernels.qmm_plan): at vocab width (d_out / 64
//     >= the card's SMs) one persistent block per SM, each over a
//     contiguous run of 32-column units (the card's bytes split within one
//     unit of even), d_in not split up to 4096; at projection widths a
//     block of 4 consumer warps per 128 columns and d_in split over a
//     thread block cluster, whose blocks sum their slices in split order
//     through distributed shared memory. No partial sums through device
//     memory, no second pass, no atomics;
//   - launched as a programmatic dependent: the producer streams weights
//     while the kernel before finishes; the consumers wait before they
//     read x. It writes no cache.
#include <cuda.h>

#include <map>
#include <mutex>
#include <tuple>

#include "qgemv_stream.cuh"

using namespace bgt;

namespace {

constexpr int QMM_UNIT = 32;           // output columns of a consumer warp
constexpr int QMM_MAX_WARPS = 16;      // consumer warps of a block
constexpr int QMM_MAX_SPLITS = 16;     // blocks of a cluster along d_in
constexpr int QMM_MAX_STAGES = 8;
constexpr int QMM_SMEM_MAX = 232448;   // the H100's 227 KB a block
// packed groups of a block's d_in slice: x's rows in bf16 stay within
// 64 KB of shared memory (d_in 4096 at M = 8)
constexpr int QMM_MAX_SLICE_GROUPS = 64;
// stages the producer keeps in flight: more let them land out of order,
// so the consumers would start late
constexpr int QMM_AHEAD = 2;

struct QmmArgs {
  const float* x;              // (M, d_in) f32
  int M, d_in, d_out, offset;
  int splits;                  // blocks of a cluster along d_in
  int warps;                   // consumer warps of a block
  int sg;                      // packed groups a stage (1, 2 or 4)
  int stages;                  // ring stages
  int ahead;                   // stages in flight at most
  int fbox;                    // Q5: fifth-bit rows a box (qmm_fifth_box)
  float* y;                    // (M, d_out) f32
};

// The tensor maps of the planes (qmm_maps), one 32-column box of a unit
// each: the level rows (Q8_0: its low and high rows, a 3-D box), Q5's
// fifth-bit rows, and the scales and mins of the stage's low and high
// level blocks (3-D boxes: the G = d_in / 64 rows apart as a dimension).
struct QmmMaps {
  CUtensorMap lv, fifth, sc, mn;
};

// Shared memory of a block, in bytes from the base: the stages' full and
// empty mbarriers; the ring, a stage holding each unit's boxes (`unit`
// bytes a unit: the level rows, 32 bytes each, at 0, the second level
// plane -- Q5's fifth-bit rows or Q8_0's high rows -- at `extra`, the
// scales at `scale`, the mins at `min`: [low | high][group][32] bf16); x's
// rows in bf16 in B-fragment order; each level block's sums of them; the
// cluster's exchange of the block's sums.
struct QmmLayout {
  int extra, scale, min, unit, stage, ring, xs, xsum, red, bytes;
};

__host__ __device__ inline int qmm_align(int v) { return (v + 127) / 128 * 128; }

__host__ __device__ inline QmmLayout qmm_layout(int bits, bool mins,
                                                int warps, int M, int gpb,
                                                int splits, int sg,
                                                int stages) {
  QmmLayout o;
  const int lv = sg * QK * QMM_UNIT, sc = 2 * sg * QMM_UNIT * 2;
  o.extra = qmm_align(lv);
  o.scale = o.extra + (bits == 4 ? 0 : qmm_align(lv));
  o.min = o.scale + qmm_align(sc);
  o.unit = o.min + (mins ? qmm_align(sc) : 0);
  o.stage = warps * o.unit;
  o.ring = 2 * QMM_MAX_STAGES * 8 + 128;
  o.xs = o.ring + stages * o.stage;
  o.xsum = o.xs + 2 * gpb * M * 64;
  o.red = o.xsum + 2 * gpb * 8 * 4;
  o.bytes = o.red + (splits > 1 ? M * warps * QMM_UNIT * 4 : 0);
  return o;
}

// Bytes the TMA copies of one unit's boxes land (the full boxes).
__host__ __device__ inline int qmm_unit_bytes(int bits, bool mins, int sg) {
  const int lv = sg * QK * QMM_UNIT, sc = 2 * sg * QMM_UNIT * 2;
  return (bits == 4 ? lv : 2 * lv) + (mins ? 2 : 1) * sc;
}

__device__ __forceinline__ void tma_2d(void* smem, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* smem, const CUtensorMap* map,
                                       int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// The bf16 pairs of one lane column c (byte c of the words) of packed rows
// ra (word wa, the pair's low half) and ra + 1 (wb): lo the levels of the
// group's low level block, hi those of its high block, uncentered (Q8_0:
// the signed levels), exact. fa, fb: the rows' fifth-bit plane words (Q5:
// bit q for the low block, q + 4 for the high; both rows of a pair take
// the same q, since d_in / 8 is even). Q8_0 keeps its two blocks in rows
// of their own: `lo` is the pair of the rows given, `hi` unset.
template <int BITS>
__device__ __forceinline__ void level_pairs(uint32_t wa, uint32_t wb,
                                            uint32_t fa, uint32_t fb, int q,
                                            int c, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t sel = c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12);
  const __nv_bfloat162 k128 = bf162_of(0x43004300u);
  if (BITS == 8) {
    // bytes 0, 2: the signed levels of rows ra, ra + 1; flipping their
    // sign bits gives u = level + 128, split as 16 * (u >> 4) + (u & 15)
    const uint32_t v = __byte_perm(wa, wb, sel);
    const uint32_t l = (v & 0x000F000Fu) | 0x43004300u;
    const uint32_t h = (((v >> 4) & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u;
    const __nv_bfloat162 k136 = bf162_of(0x43084308u);   // 136
    const __nv_bfloat162 k16 = bf162_of(0x41804180u);    // 16
    lo = bf162_bits(__hfma2(__hsub2(bf162_of(h), k136), k16,
                            __hsub2(bf162_of(l), k128)));
    return;
  }
  const uint32_t v = __byte_perm(wa, wb, sel);
  uint32_t l = (v & 0x000F000Fu) | 0x43004300u;
  uint32_t h = ((v >> 4) & 0x000F000Fu) | 0x43004300u;
  if (BITS == 5) {
    const uint32_t f = __byte_perm(fa, fb, sel);
    l |= ((f >> q) & 0x00010001u) << 4;
    h |= ((f >> (q + 4)) & 0x00010001u) << 4;
  }
  lo = bf162_bits(__hsub2(bf162_of(l), k128));
  hi = bf162_bits(__hsub2(bf162_of(h), k128));
}

__device__ __forceinline__ float bf16_at(uint2 v, int i) {
  const uint32_t w = i < 2 ? v.x : v.y;
  return __uint_as_float((i & 1) ? (w & 0xFFFF0000u) : (w << 16));
}

// Grid (grid_x, splits), cluster (1, splits, 1), block (warps + 1) * 32:
// warps 0..warps-1 consume, warp `warps` produces.
template <int BITS, bool HAS_MIN>
__global__ void __launch_bounds__((QMM_MAX_WARPS + 1) * 32, 1)
qmatmul_kernel(const __grid_constant__ QmmMaps maps, QmmArgs a) {
  extern __shared__ __align__(128) unsigned char qmm_smem[];
  const int groups = a.d_in / (2 * QK), half = a.d_in / 2;
  const int units = a.d_out / QMM_UNIT;
  const int gpb = (groups + a.splits - 1) / a.splits;
  const int g0 = blockIdx.y * gpb, ng = min(groups, g0 + gpb) - g0;
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  const int passes = (u1 - u0 + a.warps - 1) / a.warps;
  const int steps = (ng + a.sg - 1) / a.sg;   // stages a pass
  const int items = passes * steps;
  const QmmLayout o = qmm_layout(BITS, HAS_MIN, a.warps, a.M, gpb, a.splits,
                                 a.sg, a.stages);
  // the ring's stages start 128-byte aligned, as the TMA boxes need
  const uint32_t base = smem_addr(qmm_smem);
  unsigned char* ring_base = qmm_smem + ((base + 2 * QMM_MAX_STAGES * 8 + 127)
                                         / 128 * 128 - base);
  uint64_t* full = reinterpret_cast<uint64_t*>(qmm_smem);
  uint64_t* empty = full + QMM_MAX_STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, a.warps);
    }
    fence_mbar_init();
  }
  __syncthreads();
  pdl_trigger();

  if (warp == a.warps) {
    // the producer: item i is step i % steps (groups g0 + sg * step ..) of
    // pass i / steps, into stage i % stages once the consumers have freed
    // that stage's last use; lane u issues unit u's boxes
    const int e8 = a.d_in / 8;
    for (int i = 0; i < items; ++i) {
      const int s = i % a.stages, k = i / a.stages;
      if (k > 0) mbar_wait(empty + s, (k - 1) & 1);
      // at most `ahead` stages in flight, so that they land in order and
      // the consumers start on the first while the rest stream
      const int back = i - a.ahead;
      if (back >= 0) mbar_wait(full + back % a.stages, (back / a.stages) & 1);
      const int p = i / steps, grp = g0 + a.sg * (i % steps);
      const int nu = min(a.warps, u1 - u0 - p * a.warps);
      unsigned char* st = ring_base + s * o.stage;
      if (lane == 0)
        mbar_arrive_expect_tx(full + s,
                              nu * qmm_unit_bytes(BITS, HAS_MIN, a.sg));
      __syncwarp();
      if (lane < nu) {
        unsigned char* ub = st + lane * o.unit;
        const int col = (u0 + p * a.warps + lane) * QMM_UNIT;
        const int row = grp * QK;   // packed row
        if (BITS == 8) {
          tma_3d(ub, &maps.lv, col, row, 0, full + s);
        } else {
          tma_2d(ub, &maps.lv, col, row, full + s);
          // the fifth-bit rows of packed rows row + r: plane row (row + r)
          // % e8, in boxes that never cross the plane's end
          if (BITS == 5)
            for (int r = 0; r < a.sg * QK; r += a.fbox)
              tma_2d(ub + o.extra + r * QMM_UNIT, &maps.fifth, col,
                     (row + r) % e8, full + s);
        }
        tma_3d(ub + o.scale, &maps.sc, col, grp, 0, full + s);
        if (HAS_MIN) tma_3d(ub + o.min, &maps.mn, col, grp, 0, full + s);
      }
    }
    if (a.splits > 1) {   // the cluster's two barriers of the consumers
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  // the consumers: x's rows, then the passes
  const int g = lane >> 2, tg = lane & 3;
  const int nthr = a.warps * 32;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(qmm_smem + o.xs);
  float* xsum = reinterpret_cast<float*>(qmm_smem + o.xsum);
  pdl_wait();
  {
    // xs[((jh * M + m) * 4 + tg) * 8 + i]: row m's bf16 activations of
    // level block jh (2 j + h: the slice's group j, low or high), level row
    // r = 16 ch + 8 b + 2 tg + e at i = 4 ch + 2 b + e -- lane (g, tg)'s
    // B fragments of both k16 chunks in one 16-byte load. xsum[jh * 8 +
    // m]: the block's sum of the rounded values (0 for rows past M).
    // Eight lanes a level block, a float4 each; every load of a round
    // issued before its first use.
    constexpr int XU = 8;
    const int nq = 2 * ng * a.M * 8;
    uint32_t* xw = reinterpret_cast<uint32_t*>(xs);
    for (int base0 = 0; base0 < nq; base0 += XU * nthr) {
      float4 v[XU];
#pragma unroll
      for (int u = 0; u < XU; ++u) {
        const int i = base0 + u * nthr + threadIdx.x;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < nq) {
          const int item = i >> 3, f = i & 7;
          const int m = item % a.M, jh = item / a.M;
          const int col = (jh & 1) * half + (g0 + (jh >> 1)) * QK + 4 * f;
          v[u] = *reinterpret_cast<const float4*>(a.x + (size_t)m * a.d_in
                                                  + col);
        }
      }
#pragma unroll
      for (int u = 0; u < XU; ++u) {
        const int i = base0 + u * nthr + threadIdx.x;
        const int item = i >> 3, f = i & 7;
        const __nv_bfloat162 p0 = __floats2bfloat162_rn(v[u].x, v[u].y);
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(v[u].z, v[u].w);
        float s = (__low2float(p0) + __high2float(p0))
                  + (__low2float(p1) + __high2float(p1));
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        if (i < nq) {
          // level rows 4f .. 4f + 3: ch = f / 4, b = (f / 2) & 1, and the
          // pairs (e = 0, 1) at tg = 2 (f & 1) and 2 (f & 1) + 1
          const int ch = f >> 2, b = (f >> 1) & 1, t0 = 2 * (f & 1);
          const int slot = ch * 2 + b;   // the u32 of the 16 bytes
          xw[(item * 4 + t0) * 4 + slot] = bf162_bits(p0);
          xw[(item * 4 + t0 + 1) * 4 + slot] = bf162_bits(p1);
          if (f == 0) {
            const int m = item % a.M, jh = item / a.M;
            xsum[jh * 8 + m] = s;
          }
        }
      }
    }
    for (int i = threadIdx.x; i < 2 * ng * 8; i += nthr)
      if ((i & 7) >= a.M) xsum[i] = 0.f;
  }
  named_barrier(1, nthr);

  const float off = (float)a.offset;
  for (int p = 0; p < passes; ++p) {
    const int unit = u0 + p * a.warps + warp;
    const bool active = unit < u1;
    float acc[2][4] = {};
    for (int step = 0; step < steps; ++step) {
      const int i = p * steps + step, s = i % a.stages;
      mbar_wait(full + s, (i / a.stages) & 1);
      if (active) {
        const unsigned char* ub = ring_base + s * o.stage + warp * o.unit;
        for (int sj = 0; sj < a.sg; ++sj) {
          const int j = step * a.sg + sj;   // the slice's group
          if (j >= ng) break;
          // rows r of the group: the lane's 4 columns at 4g of row
          // sj * 32 + r (32 bytes a row)
          const unsigned char* lvs = ub + sj * QK * QMM_UNIT + 4 * g;
          const unsigned char* scs = ub + o.scale + (sj * QMM_UNIT + 4 * g) * 2;
          const int hs = a.sg * QMM_UNIT * 2;   // low to high block rows
          const uint2 s_lo = *reinterpret_cast<const uint2*>(scs);
          const uint2 s_hi = *reinterpret_cast<const uint2*>(scs + hs);
          uint2 m_lo = make_uint2(0u, 0u), m_hi = m_lo;
          if (HAS_MIN) {
            m_lo = *reinterpret_cast<const uint2*>(scs + o.min - o.scale);
            m_hi = *reinterpret_cast<const uint2*>(scs + o.min - o.scale + hs);
          }
          uint4 xl = make_uint4(0u, 0u, 0u, 0u), xh = xl;
          if (g < a.M) {
            const uint4* xv = reinterpret_cast<const uint4*>(xs);
            xl = xv[((2 * j) * a.M + g) * 4 + tg];
            xh = xv[((2 * j + 1) * a.M + g) * 4 + tg];
          }
          const float2 sl = *reinterpret_cast<const float2*>(
              xsum + (2 * j) * 8 + 2 * tg);
          const float2 sh = *reinterpret_cast<const float2*>(
              xsum + (2 * j + 1) * 8 + 2 * tg);
          const FifthBit fb((g0 + j) * QK, a.d_in);
          float plo[2][4] = {}, phi[2][4] = {};
#pragma unroll
          for (int ch = 0; ch < 2; ++ch) {
            const int r0 = 16 * ch + 2 * tg;
            uint32_t w[4], f[4] = {0u, 0u, 0u, 0u}, w8[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = r0 + (e & 1) + 8 * (e >> 1);
              w[e] = *reinterpret_cast<const uint32_t*>(lvs + r * QMM_UNIT);
              if (BITS == 5)
                f[e] = *reinterpret_cast<const uint32_t*>(
                    lvs + o.extra + r * QMM_UNIT);
              if (BITS == 8)
                w8[e] = *reinterpret_cast<const uint32_t*>(
                    lvs + o.extra + r * QMM_UNIT);
            }
            int qa = 0, qb = 0;
            if (BITS == 5) {
              int jj;
              fb.at(r0, jj, qa);
              fb.at(r0 + 8, jj, qb);
            }
            // A registers of tile t: {rows r0, r0+1} of columns 4g + 2t
            // (reg 0) and 4g + 2t + 1 (reg 1), rows r0 + 8, r0 + 9 (regs
            // 2, 3)
            uint32_t alo[2][4], ahi[2][4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int t = c >> 1, odd = c & 1;
              if (BITS == 8) {   // the high block's rows are a plane apart
                uint32_t unused;
                level_pairs<8>(w[0], w[1], 0u, 0u, 0, c, alo[t][odd], unused);
                level_pairs<8>(w[2], w[3], 0u, 0u, 0, c, alo[t][2 + odd],
                               unused);
                level_pairs<8>(w8[0], w8[1], 0u, 0u, 0, c, ahi[t][odd],
                               unused);
                level_pairs<8>(w8[2], w8[3], 0u, 0u, 0, c, ahi[t][2 + odd],
                               unused);
              } else {
                level_pairs<BITS>(w[0], w[1], f[0], f[1], qa, c, alo[t][odd],
                                  ahi[t][odd]);
                level_pairs<BITS>(w[2], w[3], f[2], f[3], qb, c,
                                  alo[t][2 + odd], ahi[t][2 + odd]);
              }
            }
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              mma_bf16_16816(plo[t], alo[t], ch ? xl.z : xl.x,
                             ch ? xl.w : xl.y);
              mma_bf16_16816(phi[t], ahi[t], ch ? xh.z : xh.x,
                             ch ? xh.w : xh.y);
            }
          }
          // X': (p - offset * xsum) * scale [+ xsum * min], the low block
          // before the high one; C element e: column 4g + 2t + (e >> 1),
          // row 2tg + (e & 1)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ci = 2 * t + (e >> 1);
              const float xl_s = (e & 1) ? sl.y : sl.x;
              const float xh_s = (e & 1) ? sh.y : sh.x;
              float u = (plo[t][e] - off * xl_s) * bf16_at(s_lo, ci);
              if (HAS_MIN) u += xl_s * bf16_at(m_lo, ci);
              acc[t][e] += u;
              u = (phi[t][e] - off * xh_s) * bf16_at(s_hi, ci);
              if (HAS_MIN) u += xh_s * bf16_at(m_hi, ci);
              acc[t][e] += u;
            }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }

    // rows 2tg, 2tg + 1 of the warp's columns 4g .. 4g + 3
    const float4 r0v = make_float4(acc[0][0], acc[0][2], acc[1][0], acc[1][2]);
    const float4 r1v = make_float4(acc[0][1], acc[0][3], acc[1][1], acc[1][3]);
    const int m0 = 2 * tg;
    if (a.splits == 1) {
      if (active) {
        const size_t col = (size_t)unit * QMM_UNIT + 4 * g;
        if (m0 < a.M)
          *reinterpret_cast<float4*>(a.y + m0 * (size_t)a.d_out + col) = r0v;
        if (m0 + 1 < a.M)
          *reinterpret_cast<float4*>(a.y + (m0 + 1) * (size_t)a.d_out + col) =
              r1v;
      }
      continue;
    }
    // the cluster's slices (one pass): red[m][c] holds the block's sums of
    // its columns c < W; block r sums elements [r * per, (r + 1) * per) of
    // the M x W over the cluster's blocks in rank order
    float* red = reinterpret_cast<float*>(qmm_smem + o.red);
    const int W = (u1 - u0) * QMM_UNIT;
    if (active) {
      const int col = warp * QMM_UNIT + 4 * g;
      if (m0 < a.M) *reinterpret_cast<float4*>(red + m0 * W + col) = r0v;
      if (m0 + 1 < a.M)
        *reinterpret_cast<float4*>(red + (m0 + 1) * W + col) = r1v;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster_arrive();
    cluster_wait();
    const int total = a.M * W;
    const int per = (total + a.splits - 1) / a.splits;
    const int rank = (int)cluster.block_rank();
    const int end = min(total, (rank + 1) * per);
    for (int e = rank * per + threadIdx.x; e < end; e += nthr) {
      float v[QMM_MAX_SPLITS];
#pragma unroll
      for (int q = 0; q < QMM_MAX_SPLITS; ++q)
        if (q < a.splits) v[q] = *cluster.map_shared_rank(red + e, q);
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < QMM_MAX_SPLITS; ++q)
        if (q < a.splits) sum += v[q];
      const int m = e / W, c = e % W;
      a.y[(size_t)m * a.d_out + (size_t)u0 * QMM_UNIT + c] = sum;
    }
    cluster_arrive();   // the others have read this block's sums
    cluster_wait();
  }
}

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime (no link
// to libcuda)
typedef CUresult (*TmapEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                               void*, const cuuint64_t*, const cuuint64_t*,
                               const cuuint32_t*, const cuuint32_t*,
                               CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion,
                               CUtensorMapFloatOOBfill);

TmapEncode tmap_encode() {
  static const TmapEncode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &q) == cudaSuccess
                   && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TmapEncode>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of `rank` dimensions over `ptr` (dims innermost first,
// strides in bytes of dims 1..), box `box`, elements of `dt`.
bool tmap(CUtensorMap* m, CUtensorMapDataType dt, int rank, const void* ptr,
          const cuuint64_t* dims, const cuuint64_t* strides,
          const cuuint32_t* box) {
  const TmapEncode enc = tmap_encode();
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc != nullptr
         && enc(m, dt, rank, const_cast<void*>(ptr), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Fifth-bit rows of a Q5 box for stages of `sg` groups: the most that
// divide both the stage's sg * 32 packed rows and the plane's d_in / 8 rows
// (8 at least: d_in is a multiple of 64), so that no box crosses the
// plane's end where packed row r reads plane row r % (d_in / 8).
int qmm_fifth_box(int d_in, int sg) {
  int a = d_in / 8, b = sg * QK;
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The maps of one plane for stages of `sg` groups: boxes of one unit's 32
// columns by sg * 32 packed rows (Q8_0: its low and high planes as a third
// dimension; Q5's fifth-bit rows: qmm_fifth_box rows), by sg groups of
// scales (and mins) of the low and high blocks.
bool qmm_maps(QmmMaps* m, int bits, const uint8_t* lv,
              const __nv_bfloat16* sc, const __nv_bfloat16* mn, int d_in,
              int d_out, int sg) {
  const cuuint64_t D = (cuuint64_t)d_out, half = d_in / 2;
  const cuuint64_t G = d_in / (2 * QK);
  const cuuint32_t rows = sg * QK;
  bool ok;
  if (bits == 8) {
    const cuuint64_t dims[3] = {D, half, 2}, st[2] = {D, half * D};
    const cuuint32_t box[3] = {QMM_UNIT, rows, 2};
    ok = tmap(&m->lv, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, lv, dims, st, box);
    m->fifth = m->lv;
  } else {
    const cuuint64_t dims[2] = {D, half}, st[1] = {D};
    const cuuint32_t box[2] = {QMM_UNIT, rows};
    ok = tmap(&m->lv, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, lv, dims, st, box);
    if (bits == 5) {
      const cuuint64_t fdims[2] = {D, (cuuint64_t)d_in / 8};
      const cuuint32_t fbox[2] = {QMM_UNIT,
                                  (cuuint32_t)qmm_fifth_box(d_in, sg)};
      ok = ok && tmap(&m->fifth, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                      lv + half * D, fdims, st, fbox);
    } else {
      m->fifth = m->lv;
    }
  }
  const cuuint64_t sdims[3] = {D, G, 2}, sst[2] = {D * 2, G * D * 2};
  const cuuint32_t sbox[3] = {QMM_UNIT, (cuuint32_t)sg, 2};
  ok = ok && tmap(&m->sc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, sc, sdims,
                  sst, sbox);
  if (mn != nullptr)
    ok = ok && tmap(&m->mn, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, mn, sdims,
                    sst, sbox);
  else
    m->mn = m->sc;
  return ok;
}

// qmm_maps through a cache keyed by everything a map encodes (the planes'
// addresses, the format, the widths and the stage's groups), so that a
// plane's maps are encoded on the host once, not at every call; emptied
// when it passes QMM_MAP_CACHE entries.
constexpr size_t QMM_MAP_CACHE = 4096;

bool qmm_maps_cached(QmmMaps* m, int bits, const uint8_t* lv,
                     const __nv_bfloat16* sc, const __nv_bfloat16* mn,
                     int d_in, int d_out, int sg) {
  using Key = std::tuple<const void*, const void*, const void*, int, int,
                         int, int>;
  static std::mutex mu;
  static std::map<Key, QmmMaps> cache;
  const Key key{lv, sc, mn, bits, d_in, d_out, sg};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *m = it->second;
    return true;
  }
  if (!qmm_maps(m, bits, lv, sc, mn, d_in, d_out, sg)) return false;
  if (cache.size() >= QMM_MAP_CACHE) cache.clear();
  cache.emplace(key, *m);
  return true;
}

// Launch qmatmul_kernel for `a` over grid_x blocks along the columns and
// a.splits along d_in (one cluster), after checking the plan: every block
// at least one 32-column unit, every split at least one packed group, a
// slice of at most QMM_MAX_SLICE_GROUPS groups, one pass a block where d_in
// is split. Sets the stage's groups a.sg (2, 4 or 1: the first that divides
// the slices and leaves two stages, or every stage, room), a.stages,
// a.ahead and a.fbox.
template <int BITS, bool HAS_MIN>
cudaError_t launch_qmm(QmmArgs a, const uint8_t* lv, const __nv_bfloat16* sc,
                       const __nv_bfloat16* mn, int grid_x, cudaStream_t st) {
  if (a.M < 1 || a.M > 8 || a.d_in <= 0 || a.d_in % (2 * QK) != 0
      || a.d_out <= 0 || a.d_out % QMM_UNIT != 0 || grid_x < 1
      || a.splits < 1 || a.splits > QMM_MAX_SPLITS || a.warps < 1
      || a.warps > QMM_MAX_WARPS)
    return cudaErrorInvalidValue;
  const int groups = a.d_in / (2 * QK), units = a.d_out / QMM_UNIT;
  const int gpb = (groups + a.splits - 1) / a.splits;
  if (grid_x > units || (a.splits - 1) * gpb >= groups
      || gpb > QMM_MAX_SLICE_GROUPS
      || (a.splits > 1 && (units + grid_x - 1) / grid_x > a.warps))
    return cudaErrorInvalidValue;
  const int passes = ((units + grid_x - 1) / grid_x + a.warps - 1) / a.warps;
  a.stages = 0;
  const int sgs[3] = {2, 4, 1};   // 2: finer stages, the boxes as fast
  for (int sg : sgs) {
    if (a.stages > 0 || gpb % sg != 0) continue;
    const QmmLayout o0 = qmm_layout(BITS, HAS_MIN, a.warps, a.M, gpb,
                                    a.splits, sg, 0);
    const int items = passes * (gpb / sg);
    const int fit = min(QMM_MAX_STAGES, (QMM_SMEM_MAX - o0.bytes) / o0.stage);
    if (fit >= min(2, items) || sg == 1) {
      a.sg = sg;
      a.stages = min(fit, items);
    }
  }
  if (a.stages < 1) return cudaErrorInvalidValue;
  // the producer's wait on the stage `ahead` back must fall in that
  // stage's current or previous phase
  a.ahead = min(QMM_AHEAD, a.stages);
  a.fbox = qmm_fifth_box(a.d_in, a.sg);
  QmmMaps maps;
  if (!qmm_maps_cached(&maps, BITS, lv, sc, mn, a.d_in, a.d_out, a.sg))
    return cudaErrorInvalidValue;
  const int smem = qmm_layout(BITS, HAS_MIN, a.warps, a.M, gpb, a.splits,
                              a.sg, a.stages).bytes;
  auto kernel = qmatmul_kernel<BITS, HAS_MIN>;
  static const cudaError_t attrs = [kernel] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, QMM_SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (attrs != cudaSuccess) return attrs;
  launch_dependent_ex(kernel, dim3(grid_x, a.splits),
                      dim3((a.warps + 1) * 32), dim3(1, a.splits, 1), smem,
                      st, maps, a);
  return cudaGetLastError();
}

}  // namespace

// x (M, d_in) f32 with M <= 8 -> y (M, d_out) f32, X' numerics, on the plan
// of ops/qmatmul_kernels.qmm_plan: `warps` > 0, qmatmul_kernel on grid_x
// blocks along the columns of `warps` consumer warps each and `splits`
// blocks of a cluster along d_in; `warps` 0, qgemv_stream.cuh's M <= 8 X'
// path (the kernel of the lm_head's M <= 8 tails, with the plain y
// epilogue) on grid_x blocks along the 64-column tiles and `splits` along
// d_in -- the plan's choice at projection widths of up to 1024 rows.
// bits: the level format (4, 5 or 8; qgemv.cuh).
extern "C" int bgt_qmatmul(const float* x, const uint8_t* lv, const void* sc,
                           const void* mn, int M, int d_in, int d_out,
                           int offset, int bits, int grid_x, int splits,
                           int warps, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* scb = static_cast<const __nv_bfloat16*>(sc);
  const auto* mnb = static_cast<const __nv_bfloat16*>(mn);
  cudaError_t err = cudaErrorInvalidValue;
  if (warps == 0) {
    StreamGemv a{};
    a.x = x;
    a.lv = lv;
    a.sc = scb;
    a.mn = mnb;
    a.M = M;
    a.d_in = d_in;
    a.d_out = d_out;
    a.offset = offset;
    a.splits = splits;
    a.y = y;
    if (M < 1 || M > 8) return (int)err;
    with_format(bits, mn != nullptr, [&](auto fmt) {
      using T = decltype(fmt);
      err = launch_stream<8, true, T::BITS, T::HAS_MIN, STREAM_Y>(a, grid_x,
                                                                  st);
    });
    return (int)err;
  }
  QmmArgs a{};
  a.x = x;
  a.M = M;
  a.d_in = d_in;
  a.d_out = d_out;
  a.offset = offset;
  a.splits = splits;
  a.warps = warps;
  a.y = y;
  with_format(bits, mn != nullptr, [&](auto fmt) {
    using T = decltype(fmt);
    err = launch_qmm<T::BITS, T::HAS_MIN>(a, lv, scb, mnb, grid_x, st);
  });
  return (int)err;
}

// x (M, d_in) f32 with 8 < M <= 32 -> y (M, d_out) f32, WIDE numerics; the
// plan (ops/qmatmul_kernels.stream_plan): grid_x blocks along the 64-column
// tiles, `splits` blocks of a cluster along d_in.
extern "C" int bgt_qmatmul_wide(const float* x, const uint8_t* lv,
                                const void* sc, const void* mn, int M,
                                int d_in, int d_out, int offset, int bits,
                                int grid_x, int splits, float* y,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  StreamGemv a{};
  a.x = x;
  a.lv = lv;
  a.sc = static_cast<const __nv_bfloat16*>(sc);
  a.mn = static_cast<const __nv_bfloat16*>(mn);
  a.M = M;
  a.d_in = d_in;
  a.d_out = d_out;
  a.offset = offset;
  a.splits = splits;
  a.y = y;
  if (M <= 8 || M > 32) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  with_format(bits, mn != nullptr, [&](auto fmt) {
    using T = decltype(fmt);
    err = M <= 16
        ? launch_stream<16, false, T::BITS, T::HAS_MIN, STREAM_Y>(a, grid_x, st)
        : launch_stream<32, false, T::BITS, T::HAS_MIN, STREAM_Y>(a, grid_x,
                                                                  st);
  });
  return (int)err;
}
