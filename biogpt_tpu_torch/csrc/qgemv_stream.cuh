// Streaming tensor-core GEMV of up to 32 activation rows against one packed
// 4/5-bit or unpacked 8-bit weight plane (qgemv.cuh's layouts), one launch
// a call, for
//   - qmatmul.cu's ``bgt_qmatmul_wide`` (8 < M <= 32, WIDE numerics: x
//     rounded to bf16, w = bf16((lv - offset) * scale [+ min]), exact
//     products, f32 sums; pallas_qmatmul.py::qmatmul_pallas_wide,
//     `_kernel_wide`), and
//   - lm_head_argmax.cu's M <= 8 tails (XPRIME numerics after the final
//     LayerNorm rounded to bf16: per 32-level block the partial p over the
//     UNCENTERED levels, then (p - offset * xsum) * scale [+ xsum * min] in
//     f32; pallas_qmatmul.py::_ln_lmhead_tile at M <= 8), with an argmax
//     triple or a logits + maximum epilogue per 64-column tile.
// Only the order of the f32 sums differs from the plain versions
// (qmatmul_kernels.qmatmul_wide_plain, lm_head_logits_plain), one fixed
// order for every format and every grid.
//
// Bound on an H100: bytes. At the lm_head (1024 -> 42,496) the Q4_0 planes
// are 24.5 MB (0.0073 ms at 3.35 TB/s) against 2.8 GFLOP at M = 32; at the
// layer projections (0.6-2.4 MB) what a call pays is latency. The design:
//   - tensor cores: mma.sync.m16n8k16 bf16 on weight fragments dequantized
//     in registers from the planes' raw bytes (qgemv_mma.cuh's group loads,
//     fragment layout and `wide_group_products` for WIDE, qgemv_b1.cuh's
//     `xprime_group_products` for XPRIME); M = 9..16 fills one m16 A tile,
//     17..32 two, and M <= 8 the first 8 rows of one. Rows past M are zero
//     in the A fragments: the caller passes the real M, no row is padded in
//     memory;
//   - a block of 8 warps owns a 64-column tile at a time; warp w takes the
//     packed groups (64 levels of d_in: level blocks grp and grp + d_in/64)
//     g0 + w, g0 + w + 8, ... of the block's slice of d_in, and keeps the
//     A fragments of two of them in registers: up to 16 splits of 1024
//     rows (every width of the engines) those are all of its groups, held
//     for every tile it walks, so x is read (and LayerNorm'd: each block
//     takes the statistics of the M <= 8 rows once, a warp a row) once per
//     block, not once per tile; past that the fragments are loaded again
//     two groups at a time;
//   - each warp streams its groups' level rows, scales and mins tile after
//     tile through a ring of four (Q5 and Q8_0 at 32 rows: three) 16-byte
//     cp.async stages in shared memory, that many groups less one ahead of
//     its products (up to 8 * 3 * 5.6 KB in flight per SM), across tile
//     boundaries, so a tile's reduction runs while the next tile's bytes
//     arrive;
//   - two grid regimes, chosen by the wrapper (ops/qmatmul_kernels.
//     stream_plan): at vocab width (d_out / 64 >= the card's SMs) about one
//     persistent block per SM walks tiles blockIdx.x, + gridDim.x, ..., with
//     no split of d_in up to 1024 rows; at projection widths a block per
//     tile, d_in split over a thread block cluster of `splits` blocks (one
//     group a warp where 16 splits allow it);
//   - the 8 warps' sums meet in shared memory, each warp's in a slot of
//     its own, summed in warp order by the warp that owns the row (two
//     barriers a tile), and a cluster's splits in split order through
//     distributed shared memory: no partial sums through device memory, no
//     second pass, no atomics;
//   - launched as a programmatic dependent: the first stages of weights are
//     in flight before it waits for the kernel before it.
#pragma once

#include <cooperative_groups.h>

#include "qgemv_b1.cuh"

namespace bgt {

constexpr int STREAM_WARPS = 8;
constexpr int STREAM_THREADS = STREAM_WARPS * 32;
// shared memory a block may take (the H100's 227 KB)
constexpr int STREAM_SMEM_MAX = 232448;
constexpr int STREAM_GPW = 2;         // groups whose A fragments a warp holds
constexpr int STREAM_MAX_SPLITS = 16;

enum { STREAM_Y = 0, STREAM_ARGMAX = 1, STREAM_LOGITS = 2 };

struct StreamGemv {
  const float* x;             // (M, d_in) f32 activations
  const float* ln_w;          // (d_in) LayerNorm weight, or null: no LN
  const float* ln_b;
  float eps;
  const uint8_t* lv;          // level plane of format BITS (qgemv.cuh)
  const __nv_bfloat16* sc;    // (d_in/32, d_out)
  const __nv_bfloat16* mn;    // (d_in/32, d_out) or null
  int M, d_in, d_out, offset;
  int splits;                 // blocks of a cluster along d_in
  int n_valid;                // ARGMAX, LOGITS: columns >= n_valid pad
  float* y;                   // Y: (M, d_out); LOGITS: the logits
  float* tmax;                // ARGMAX, LOGITS: per (row m, tile t) at
  int* tidx;                  //   m * (d_out / 64) + t
  int* tnan;
};

// Bytes of one ring stage: the level byte rows of a group (BITS 4: 32
// packed rows; 5: those and their fifth-bit rows; 8: low and high rows),
// then its scales and mins (issue_group's layout).
template <int BITS>
__host__ __device__ constexpr int stream_stage_bytes() {
  return (BITS == 4 ? QK : 2 * QK) * MMA_LROW + 4 * MMA_COLS * 2;
}

// A reduction slot of MR rows for each warp, and the LayerNorm statistics.
template <int MR>
__host__ __device__ constexpr int stream_red_bytes() {
  return STREAM_WARPS * MR * MMA_RROW * 4 + STREAM_WARPS * 2 * 4;
}

// Ring stages a warp keeps (three in flight while it computes on one):
// four, or three where four would not fit beside the slots (Q5 and Q8_0
// planes at 32 rows).
template <int MR, int BITS>
__host__ __device__ constexpr int stream_stages() {
  return STREAM_WARPS * 4 * stream_stage_bytes<BITS>() + stream_red_bytes<MR>()
                 <= STREAM_SMEM_MAX
             ? 4 : 3;
}

// Dynamic shared memory of a block: the warps' rings, then the slots.
template <int MR, int BITS>
__host__ __device__ constexpr int stream_smem_bytes() {
  return STREAM_WARPS * stream_stages<MR, BITS>() * stream_stage_bytes<BITS>()
         + stream_red_bytes<MR>();
}

// The activation slot `s` (0..63) of packed group `grp`: level row k0 + s
// (s < 32) or d_in/2 + k0 + s - 32.
__device__ __forceinline__ int stream_col(int grp, int s, int half) {
  return s < QK ? grp * QK + s : half + grp * QK + s - QK;
}

// Two adjacent activations of row m at column col, LayerNorm'd where set
// (stats: each row's mean and 1/std), as a bf16x2 A-fragment register; zero
// for a row past M.
__device__ __forceinline__ uint32_t stream_pair(const StreamGemv& a,
                                                const float* stats, int m,
                                                int col) {
  if (m >= a.M) return 0u;
  float2 v = *reinterpret_cast<const float2*>(a.x + (size_t)m * a.d_in + col);
  if (a.ln_w != nullptr) {
    const float mean = stats[2 * m], rstd = stats[2 * m + 1];
    v.x = (v.x - mean) * rstd * a.ln_w[col] + a.ln_b[col];
    v.y = (v.y - mean) * rstd * a.ln_w[col + 1] + a.ln_b[col + 1];
  }
  return pack2_bf16(v.x, v.y);
}

// acc into reduction slot `slot` (rows of MMA_RROW floats): fragment
// element c of n8 tile t of m16 tile mi is row mi * 16 + g (+8 for c >=
// 2), column 8 * (2tg + (c & 1)) + t.
template <int MR, int MI>
__device__ __forceinline__ void stream_slot(const float (&acc)[MI][8][4],
                                            float* red, int slot) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  float* base = red + slot * MR * MMA_RROW;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = mi * 16 + g + (c >= 2 ? 8 : 0);
        if (m < MR)
          base[m * MMA_RROW + 8 * (2 * tg + (c & 1)) + t] = acc[mi][t][c];
      }
}

__device__ __forceinline__ void stream_wait(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// MR: A rows the kernel covers (8: XPRIME, M <= 8; 16 or 32: WIDE, M <=
// MR). XP: XPRIME numerics (else WIDE). MODE: STREAM_Y, _ARGMAX, _LOGITS.
// CHUNKED: a warp's groups exceed STREAM_GPW (d_in past 16 splits of 1024
// rows) and their A fragments are loaded STREAM_GPW groups at a time.
// Grid (blocks along the tiles, a.splits), cluster (1, a.splits, 1).
template <int MR, bool XP, int BITS, bool HAS_MIN, int MODE, bool CHUNKED>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
qgemv_stream_kernel(StreamGemv a) {
  constexpr int MI = MR > 16 ? 2 : 1;
  constexpr int STREAM_STAGES = stream_stages<MR, BITS>();
  constexpr int STAGE = stream_stage_bytes<BITS>();
  constexpr int LV_BYTES = STAGE - 4 * MMA_COLS * 2;
  extern __shared__ __align__(16) unsigned char stream_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  unsigned char* ring = stream_smem + warp * STREAM_STAGES * STAGE;
  float* red = reinterpret_cast<float*>(stream_smem
                                        + STREAM_WARPS * STREAM_STAGES * STAGE);
  float* stats = red + STREAM_WARPS * MR * MMA_RROW;

  const int groups = a.d_in / (2 * QK), tiles = a.d_out / MMA_COLS;
  const int half = a.d_in / 2;
  const int gpb = (groups + a.splits - 1) / a.splits;
  const int g0 = blockIdx.y * gpb, g1 = min(groups, g0 + gpb);
  // this warp's groups: g0 + warp + 8 j, j < gpw
  const int gpw = max(0, (g1 - g0 - warp + STREAM_WARPS - 1) / STREAM_WARPS);
  const int n_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1)
                      / (int)gridDim.x;
  const int n_items = n_tiles * gpw;

  // item i of the warp: group j = i % gpw of tile k = i / gpw, into ring
  // stage i % STREAM_STAGES; one commit group each (empty past the end)
  auto issue = [&](int i) {
    if (i < n_items) {
      const int grp = g0 + warp + STREAM_WARPS * (i % gpw);
      const int n0 = (blockIdx.x + (i / gpw) * gridDim.x) * MMA_COLS;
      uint8_t* st = ring + (i % STREAM_STAGES) * STAGE;
      issue_group<BITS, HAS_MIN>(
          a.lv, a.sc, a.mn, a.d_in, a.d_out, n0, grp, FifthBit(grp * QK, a.d_in),
          st, reinterpret_cast<__nv_bfloat16*>(st + LV_BYTES), lane);
    } else {
      cp_async_commit();
    }
  };
  // 1. the first stages of weights in flight; what follows reads the
  // kernel before's outputs (x)
#pragma unroll
  for (int i = 0; i < STREAM_STAGES - 1; ++i) issue(i);
  pdl_trigger();
  pdl_wait();

  // 2. the rows' LayerNorm statistics (M <= 8: warp m takes row m, the
  // mean, then the mean squared deviation), then the A fragments of the
  // warp's groups (and, XPRIME, each level block's sum of row g's bf16
  // activations), kept for every tile
  if (a.ln_w != nullptr) {
    if (warp < a.M) {
      // float4 c + 32 u of the row, lane c, eight loads issued at once
      const float4* xr =
          reinterpret_cast<const float4*>(a.x + (size_t)warp * a.d_in);
      const int n4 = a.d_in / 4;
      float s = 0.f;
      for (int i0 = lane; i0 < n4; i0 += 32 * 8) {
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = i0 + 32 * u < n4 ? xr[i0 + 32 * u]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < 8; ++u) s += (v[u].x + v[u].y) + (v[u].z + v[u].w);
      }
      const float mean = warp_sum(s) / (float)a.d_in;
      float q = 0.f;
      for (int i0 = lane; i0 < n4; i0 += 32 * 8) {
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = i0 + 32 * u < n4 ? xr[i0 + 32 * u]
                                  : make_float4(mean, mean, mean, mean);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float a0 = v[u].x - mean, a1 = v[u].y - mean;
          const float a2 = v[u].z - mean, a3 = v[u].w - mean;
          q += (a0 * a0 + a1 * a1) + (a2 * a2 + a3 * a3);
        }
      }
      const float var = warp_sum(q) / (float)a.d_in;
      if (lane == 0) {
        stats[2 * warp] = mean;
        stats[2 * warp + 1] = 1.0f / sqrtf(var + a.eps);
      }
    }
    __syncthreads();
  }
  // (the fragments of STREAM_GPW groups at a time: groups j0, j0 + 1 --
  // one chunk, loaded once, at every d_in up to 16 splits of 1024)
  uint32_t af[STREAM_GPW][4][MI][4];
  float xsum[STREAM_GPW][2];
  auto load_chunk = [&](int j0) {
#pragma unroll
    for (int jj = 0; jj < STREAM_GPW; ++jj) {
      const int j = j0 + jj;
      xsum[jj][0] = xsum[jj][1] = 0.f;
      const int grp = g0 + warp + STREAM_WARPS * j;
      const bool live = j < gpw;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int s = kc * 16 + tg * 2;
          const int c0 = stream_col(grp, s, half);
          const int c1 = stream_col(grp, s + 8, half);
          const int r0 = mi * 16 + g;
          af[jj][kc][mi][0] = live ? stream_pair(a, stats, r0, c0) : 0u;
          af[jj][kc][mi][2] = live ? stream_pair(a, stats, r0, c1) : 0u;
          if (XP) {
            af[jj][kc][mi][1] = af[jj][kc][mi][3] = 0u;
          } else {
            af[jj][kc][mi][1] = live ? stream_pair(a, stats, r0 + 8, c0) : 0u;
            af[jj][kc][mi][3] = live ? stream_pair(a, stats, r0 + 8, c1) : 0u;
          }
        }
      if (XP) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = 0.f;
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const __nv_bfloat162 v = bf162_of(af[jj][2 * h + c][0][e]);
              s += __low2float(v) + __high2float(v);
            }
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          xsum[jj][h] = s;
        }
      }
    }
  };
  load_chunk(0);

  // 3. the tiles: each warp's groups through the ring, then the warps'
  // sums in warp order, the splits in split order, and the epilogue
  const float off = (float)a.offset;
  const int rows_per = (a.M + a.splits - 1) / a.splits;
  const int r0 = a.splits == 1 ? 0 : blockIdx.y * rows_per;
  const int r1 = a.splits == 1 ? a.M : min(a.M, r0 + rows_per);
  cg::cluster_group cluster = cg::this_cluster();
  int item = 0;
  for (int k = 0; k < n_tiles; ++k) {
    const int tile = blockIdx.x + k * gridDim.x;
    float acc[MI][8][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][t][c] = 0.f;
    // group j of the tile, its fragments af[jj]
    auto group = [&](int j, int jj) {
      __syncwarp();   // every lane is done with the stage issue() refills
      issue(item + STREAM_STAGES - 1);
      stream_wait(STREAM_STAGES - 1);
      __syncwarp();
      const uint8_t* st = ring + (item % STREAM_STAGES) * STAGE;
      const __nv_bfloat16* scs =
          reinterpret_cast<const __nv_bfloat16*>(st + LV_BYTES);
      const FifthBit fb((g0 + warp + STREAM_WARPS * j) * QK, a.d_in);
      if constexpr (XP)
        xprime_group_products<BITS, HAS_MIN>(st, scs, fb, off, af[jj],
                                             xsum[jj], acc);
      else
        wide_group_products<BITS, HAS_MIN, MI>(st, scs, fb, off, af[jj],
                                               acc);
      ++item;
    };
    if constexpr (CHUNKED) {
      for (int j0 = 0; j0 < gpw; j0 += STREAM_GPW) {
        if (k > 0 || j0 > 0) load_chunk(j0);
#pragma unroll
        for (int jj = 0; jj < STREAM_GPW; ++jj)
          if (j0 + jj < gpw) group(j0 + jj, jj);
      }
    } else {
#pragma unroll
      for (int j = 0; j < STREAM_GPW; ++j)
        if (j < gpw) group(j, j);
    }

    // the warps' sums: each warp's into its own slot, then per row of the
    // tile its warp (rows r0 + warp, + 8, ...: lane l columns l, l + 32)
    // sums the eight slots in warp order; with splits, the block's sums go
    // to slot 0 and the cluster's blocks sum them in split order through
    // distributed shared memory
    __syncthreads();   // every warp is done reading the slots of the last tile
    stream_slot<MR, MI>(acc, red, warp);
    __syncthreads();
    auto block_sum_at = [&](int m, int col) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < STREAM_WARPS; ++w)
        v += red[(w * MR + m) * MMA_RROW + col];
      return v;
    };
    if (a.splits > 1) {
      for (int m = warp; m < a.M; m += STREAM_WARPS) {
        const float v0 = block_sum_at(m, lane), v1 = block_sum_at(m, lane + 32);
        red[m * MMA_RROW + lane] = v0;
        red[m * MMA_RROW + lane + 32] = v1;
      }
      cluster.sync();
    }
    auto value = [&](int m, int col) {
      if (a.splits == 1) return block_sum_at(m, col);
      const float* mine = red + m * MMA_RROW + col;
      float v = 0.f;
      for (int q = 0; q < a.splits; ++q) v += *cluster.map_shared_rank(mine, q);
      return v;
    };

    // epilogue: rows [r0, r1) of the tile
    for (int m = r0 + warp; m < r1; m += STREAM_WARPS) {
      const int gc0 = tile * MMA_COLS + lane, gc1 = gc0 + 32;
      float v0 = value(m, lane), v1 = value(m, lane + 32);
      if (MODE == STREAM_Y) {
        a.y[(size_t)m * a.d_out + gc0] = v0;
        a.y[(size_t)m * a.d_out + gc1] = v1;
        continue;
      }
      if (gc0 >= a.n_valid) v0 = -1e30f;
      if (gc1 >= a.n_valid) v1 = -1e30f;
      if (MODE == STREAM_LOGITS) {
        a.y[(size_t)m * a.d_out + gc0] = v0;
        a.y[(size_t)m * a.d_out + gc1] = v1;
      }
      const int any_nan = __any_sync(0xffffffffu, isnan(v0) || isnan(v1));
      const float mx = warp_max(fmaxf(isnan(v0) ? -INFINITY : v0,
                                      isnan(v1) ? -INFINITY : v1));
      int id = v0 == mx ? gc0 : v1 == mx ? gc1 : 0x7fffffff;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        id = min(id, __shfl_xor_sync(0xffffffffu, id, o));
      if (lane == 0) {
        const int kk = m * tiles + tile;
        if (MODE == STREAM_LOGITS) {
          a.tmax[kk] = any_nan ? __int_as_float(0x7fc00000) : mx;
        } else {
          a.tmax[kk] = mx;
          a.tidx[kk] = id;
          a.tnan[kk] = any_nan;
        }
      }
    }
    if (a.splits > 1) cluster.sync();   // the others have read this slot 0
  }
  cp_async_wait<0>();
}

// Launch qgemv_stream_kernel for `a` over grid_x blocks along the column
// tiles and a.splits along d_in (one cluster), after checking the plan:
// splits 1..16, no more than the packed groups; the chunked kernel where a
// warp takes more than STREAM_GPW groups (WIDE only: the tails' gate keeps
// them within it). Internal linkage (static): each library sets its own
// kernels' attributes once.
template <int MR, bool XP, int BITS, bool HAS_MIN, int MODE, bool CHUNKED>
static cudaError_t launch_stream_as(const StreamGemv& a, int grid_x,
                                    cudaStream_t st) {
  auto kernel = qgemv_stream_kernel<MR, XP, BITS, HAS_MIN, MODE, CHUNKED>;
  constexpr int smem = stream_smem_bytes<MR, BITS>();
  static bool attrs = false;
  if (!attrs) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    attrs = true;
  }
  launch_dependent_ex(kernel, dim3(grid_x, a.splits), dim3(STREAM_THREADS),
                      dim3(1, a.splits, 1), smem, st, a);
  return cudaGetLastError();
}

template <int MR, bool XP, int BITS, bool HAS_MIN, int MODE>
static cudaError_t launch_stream(const StreamGemv& a, int grid_x,
                                 cudaStream_t st) {
  const int groups = a.d_in / (2 * QK);
  if (a.d_in <= 0 || a.d_in % (2 * QK) != 0 || a.d_out <= 0
      || a.d_out % MMA_COLS != 0 || a.M < 1 || a.M > MR || grid_x < 1
      || a.splits < 1 || a.splits > STREAM_MAX_SPLITS || a.splits > groups
      || (a.ln_w != nullptr && a.M > STREAM_WARPS))
    return cudaErrorInvalidValue;
  const int gpb = (groups + a.splits - 1) / a.splits;
  if (gpb <= STREAM_WARPS * STREAM_GPW)
    return launch_stream_as<MR, XP, BITS, HAS_MIN, MODE, false>(a, grid_x,
                                                                st);
  if constexpr (XP) {
    return cudaErrorInvalidValue;
  } else {
    return launch_stream_as<MR, XP, BITS, HAS_MIN, MODE, true>(a, grid_x,
                                                               st);
  }
}

}  // namespace bgt
