// Serving and decode tails over LayerNorm(x) @ dequant(lm_head), M <= 32
// rows, the Q4_0 / Q4_1 / Q5_0 / Q5_1 (packed) and Q8_0 (unpacked) planes
// of qgemv.cuh:
//   bgt_lm_head_argmax       greedy: argmax over the first n_valid columns
//   bgt_lm_head_logits_gmax  sampled: the logits (pad columns -1e30) and
//                            their per-128-column group maxima
//
// Replaces biogpt_tpu/ops/pallas_qmatmul.py::lm_head_argmax_pallas and the
// lm_head parts of ::lm_head_argmax_commit_pallas and
// ::lm_head_logits_gmax_commit_pallas (tile body `_ln_lmhead_tile`: X'
// numerics at M <= 8, dequant-then-dot at M > 8, pallas_qmatmul.py:320).
// The KV commits of the two fused TPU epilogues are kv_commit.cu, launched
// next on the same stream by the wrappers. Bound on an H100: bytes -- the
// 1024 x 42496 lm_head (21.8 MB of Q4 levels, 27.2 MB of Q5, 43.5 MB of
// Q8_0, and 2.7 MB of bf16 scales [+ 2.7 MB of mins]) is read once; the
// argmax never writes logits, the sampled tail writes them once (5.4 MB at
// M=32). The TPU kernels walked vocab tiles in order carrying state in
// VMEM; here the columns are cut into blocks that run in any order, and
// each block's result is folded afterwards in column order:
//   - M = 1..8 (X' numerics): qgemv_stream.cuh's streaming tensor-core
//     GEMV in one launch, the M rows LayerNorm'd once per block from their
//     statistics (a warp a row) into the A fragments, persistent blocks
//     walking the d_out/64 column tiles (664 at BioGPT-347M), the argmax
//     or the logits + maximum of each tile written by its block;
//   - M = 16, 32 (dequant-then-dot, _qmm_dq's roundings): the LayerNorm'd
//     rows once, in bf16 (ln_rows_kernel), then qgemv_mma.cuh's
//     tensor-core GEMV (lm_head_mma_kernel; each warp's rows by cp.async
//     beside its weights): 664 column tiles of 64 x 4 splits of d_in,
//     each tile's splits one thread block cluster whose blocks sum their
//     partials in split order through distributed shared memory; block r
//     of a cluster owns rows [r, r + 1) * ceil(M / splits) of the tile and
//     folds each row's 64 sums into the epilogue's result;
// then per block of columns and row:
//   argmax: one (max, lowest index, any-NaN) triple over its 64 columns
//     (pad columns at -1e30); a second one-warp-per-row kernel folds them in
//     column order with the TPU kernel's rules, tile by tile (T = its lane
//     tile, 512 columns at 347M): a tile holding a NaN yields (NaN,
//     n_valid - 1) (jnp.max propagates NaN and no column then satisfies
//     `logits >= tmax`; the id clamps); tiles fold with a strict `>` from
//     tile 0, so ties keep the lowest index and a NaN first tile pins the
//     result (the health lane's probe);
//   logits+gmax: its logits and their maximum, NaN-propagating as jnp.max
//     (the two 64-column maxima of a 128-column group fold in a second
//     kernel).
#include <cooperative_groups.h>

#include "qgemv_stream.cuh"

using namespace bgt;

namespace {

// One warp per row: per-tile results in column order, then the strict-`>`
// fold from tile 0. Dynamic shared memory: n_tiles * 8 bytes.
__global__ void argmax_fold_kernel(const float* bmax, const int* bidx,
                                   const int* bnan, int nblk, int tile_blocks,
                                   int n_valid, int* out_idx, float* out_max) {
  extern __shared__ float fold_smem[];
  const int m = blockIdx.x;
  const int n_tiles = nblk / tile_blocks;
  float* tv = fold_smem;
  int* ti = reinterpret_cast<int*>(fold_smem + n_tiles);
  for (int j = threadIdx.x; j < n_tiles; j += blockDim.x) {
    int nan_seen = 0;
    float best = 0.f;
    int bi = 0;
    for (int b = j * tile_blocks; b < (j + 1) * tile_blocks; ++b) {
      const int k = m * nblk + b;
      nan_seen |= bnan[k];
      if (b == j * tile_blocks || bmax[k] > best) {
        best = bmax[k];
        bi = bidx[k];
      }
    }
    if (nan_seen) {
      tv[j] = __int_as_float(0x7fc00000);
      ti[j] = n_valid - 1;
    } else {
      tv[j] = best;
      ti[j] = min(bi, n_valid - 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = tv[0];
    int bi = ti[0];
    for (int j = 1; j < n_tiles; ++j) {
      if (tv[j] > bv) {
        bv = tv[j];
        bi = ti[j];
      }
    }
    out_idx[m] = bi;
    out_max[m] = bv;
  }
}

// M = 16 or 32 (_qmm_dq numerics): the tensor-core GEMV of column tile
// blockIdx.x (64 columns), split blockIdx.y of a.splits (one cluster);
// block r owns rows [r * rows, (r + 1) * rows) of the tile, rows =
// ceil(M / splits), sums them over the cluster's blocks in split order and
// writes, per row and tile (index m * gridDim.x + blockIdx.x):
//   LOGITS: the logits (pad columns -1e30) into out (M, d_out), and their
//     NaN-propagating maximum into tmax;
//   else: the (max over the non-NaN values, lowest column holding it, any
//     NaN) triple into tmax, tidx, tnan -- pad columns at -1e30.
// Lane l of warp w reads column 32 (w & 1) + l of row r0 + 2 it + (w >> 1):
// each warp folds half a row, and the halves meet in shared memory.
template <int M, int BITS, bool HAS_MIN, bool LOGITS>
__global__ void __launch_bounds__(MMA_THREADS)
lm_head_mma_kernel(MmaGemv a, int n_valid, float* out, float* tmax, int* tidx,
                   int* tnan) {
  __shared__ __align__(16) unsigned char smem[MmaSmem<M, BITS>::BYTES];
  __shared__ float hmax[M][2];
  __shared__ int hidx[M][2], hnan[M][2];
  mma_block_sums<M, BITS, HAS_MIN, true>(a, smem);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float* red = reinterpret_cast<const float*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = (M + a.splits - 1) / a.splits;
  const int r0 = blockIdx.y * rows, r1 = min(M, r0 + rows);
  const int half = warp & 1, col = 32 * half + lane;
  const int gcol = blockIdx.x * MMA_COLS + col;
  for (int m0 = r0; m0 < r1; m0 += 2) {
    const int m = m0 + (warp >> 1);
    const bool live = m < r1;   // uniform over the warp
    float v = 0.f;
    if (live) {
      const float* mine = red + m * MMA_RROW + col;
      float p[MMA_MAX_SPLITS];
#pragma unroll
      for (int k = 0; k < MMA_MAX_SPLITS; ++k)
        if (k < a.splits) p[k] = *cluster.map_shared_rank(mine, k);
#pragma unroll
      for (int k = 0; k < MMA_MAX_SPLITS; ++k)
        if (k < a.splits) v += p[k];
      if (gcol >= n_valid) v = -1e30f;
      if (LOGITS) out[(size_t)m * a.d_out + gcol] = v;
    }
    const int any_nan = __any_sync(0xffffffffu, live && isnan(v));
    const float mx = warp_max(live && !isnan(v) ? v : -INFINITY);
    int id = (live && v == mx) ? gcol : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      id = min(id, __shfl_xor_sync(0xffffffffu, id, o));
    if (live && lane == 0) {
      hmax[m][half] = mx;
      hidx[m][half] = id;
      hnan[m][half] = any_nan;
    }
  }
  __syncthreads();
  const int m = r0 + (int)threadIdx.x;
  if (m < r1) {
    const float mx = fmaxf(hmax[m][0], hmax[m][1]);
    const int any_nan = hnan[m][0] | hnan[m][1];
    const int k = m * gridDim.x + blockIdx.x;
    if (LOGITS) {
      tmax[k] = any_nan ? __int_as_float(0x7fc00000) : mx;
    } else {
      tmax[k] = mx;
      tidx[k] = hmax[m][0] == mx ? hidx[m][0] : hidx[m][1];
      tnan[k] = any_nan;
    }
  }
  cluster.sync();   // the other blocks read this one's sums until here
}

// gmax (M, d_out/128) from the 64-column maxima tmax (M, d_out/64),
// NaN-propagating; grid M, block 128.
__global__ void gmax_pair_kernel(const float* tmax, int n64, float* gmax) {
  const float* t = tmax + (size_t)blockIdx.x * n64;
  for (int j = threadIdx.x; j < n64 / 2; j += blockDim.x) {
    const float a = t[2 * j], b = t[2 * j + 1];
    gmax[(size_t)blockIdx.x * (n64 / 2) + j] =
        isnan(a) || isnan(b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
  }
}

// Launch lm_head_mma_kernel over the d_out/64 column tiles after the
// LayerNorm of its M rows (into a.xn, bf16). Internal linkage: this
// library sets its own kernels' cluster attribute (qgemv_mma.cuh's
// launch_mma_gemv).
template <int M, bool LOGITS>
cudaError_t launch_mma_tail(MmaGemv a, float eps, int n_valid, float* out,
                            float* tmax, int* tidx, int* tnan, int bits,
                            cudaStream_t st) {
  a.splits = mma_splits(a.d_in);
  if (!mma_widths_ok(a.d_in, a.d_out)) return cudaErrorInvalidValue;
  launch_dependent(ln_rows_kernel<256>, dim3(M), dim3(256), 1, st, a.x,
                   a.d_in, a.ln_w, a.ln_b, eps,
                   const_cast<__nv_bfloat16*>(a.xn));
  const bool ok = with_format(bits, a.mn != nullptr, [&](auto fmt) {
    using T = decltype(fmt);
    auto kernel = lm_head_mma_kernel<M, T::BITS, T::HAS_MIN, LOGITS>;
    static bool wide_clusters = false;   // 16 blocks: past the portable 8
    if (!wide_clusters) {
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      wide_clusters = true;
    }
    launch_dependent(kernel, dim3(a.d_out / MMA_COLS, a.splits),
                     dim3(MMA_THREADS), a.splits, st, a, n_valid, out, tmax,
                     tidx, tnan);
  });
  return ok ? cudaGetLastError() : cudaErrorInvalidValue;
}

MmaGemv tail_gemv(const float* x, void* xn, const float* ln_w,
                  const float* ln_b, const uint8_t* lv, const void* sc,
                  const void* mn, int d_in, int d_out, int offset) {
  MmaGemv a{};
  a.x = x;
  a.xn = static_cast<const __nv_bfloat16*>(xn);
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.lv = lv;
  a.sc = static_cast<const __nv_bfloat16*>(sc);
  a.mn = static_cast<const __nv_bfloat16*>(mn);
  a.d_in = d_in;
  a.d_out = d_out;
  a.offset = offset;
  return a;
}

// The M <= 8 tails' streaming GEMV (XPRIME numerics, the LayerNorm in
// each block) with epilogue MODE, over grid_x x splits blocks.
template <int MODE>
cudaError_t launch_xp_tail(const float* x, const float* ln_w,
                           const float* ln_b, float eps, const uint8_t* lv,
                           const void* sc, const void* mn, int M, int d_in,
                           int d_out, int offset, int bits, int n_valid,
                           int grid_x, int splits, float* out, float* tmax,
                           int* tidx, int* tnan, cudaStream_t st) {
  StreamGemv a{};
  a.x = x;
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.eps = eps;
  a.lv = lv;
  a.sc = static_cast<const __nv_bfloat16*>(sc);
  a.mn = static_cast<const __nv_bfloat16*>(mn);
  a.M = M;
  a.d_in = d_in;
  a.d_out = d_out;
  a.offset = offset;
  a.splits = splits;
  a.n_valid = n_valid;
  a.y = out;
  a.tmax = tmax;
  a.tidx = tidx;
  a.tnan = tnan;
  cudaError_t err = cudaErrorInvalidValue;
  with_format(bits, mn != nullptr, [&](auto fmt) {
    using T = decltype(fmt);
    err = launch_stream<8, true, T::BITS, T::HAS_MIN, MODE>(a, grid_x, st);
  });
  return err;
}

}  // namespace

// x (M, d_in) f32 with M in 1..8 (X' numerics) or 16 / 32 (dequant-then-
// dot; the wrapper pads 9..32 rows with zeros); ln_w/ln_b (d_in) f32;
// scratch: bmax/bidx/bnan M * d_out/64 entries each, xn (M, d_in) bf16
// (M = 16, 32); out_idx (M,) i32, out_max (M,) f32; bits: the level format
// (4, 5 or 8); tile: the TPU kernel's lane tile (columns) the fold runs
// over; grid_x, splits: the M <= 8 GEMV's plan (ops/qmatmul_kernels.
// stream_plan).
extern "C" int bgt_lm_head_argmax(const float* x, const float* ln_w,
                                  const float* ln_b, float eps,
                                  const uint8_t* lv, const void* sc,
                                  const void* mn, int M, int d_in, int d_out,
                                  int offset, int bits, int n_valid, int tile,
                                  int grid_x, int splits, float* bmax,
                                  int* bidx, int* bnan, void* xn,
                                  int* out_idx, float* out_max,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M >= 1 && M <= 8) {
    err = launch_xp_tail<STREAM_ARGMAX>(x, ln_w, ln_b, eps, lv, sc, mn, M,
                                        d_in, d_out, offset, bits, n_valid,
                                        grid_x, splits, nullptr, bmax, bidx,
                                        bnan, st);
  } else {
    const MmaGemv t = tail_gemv(x, xn, ln_w, ln_b, lv, sc, mn, d_in, d_out,
                                offset);
    switch (M) {
      case 16:
        err = launch_mma_tail<16, false>(t, eps, n_valid, nullptr, bmax,
                                         bidx, bnan, bits, st);
        break;
      case 32:
        err = launch_mma_tail<32, false>(t, eps, n_valid, nullptr, bmax,
                                         bidx, bnan, bits, st);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return (int)err;
  if (tile % MMA_COLS != 0 || d_out % tile != 0)
    return (int)cudaErrorInvalidValue;
  const int nblk = d_out / MMA_COLS;
  const int n_tiles = d_out / tile;
  argmax_fold_kernel<<<M, 32, n_tiles * 8, st>>>(bmax, bidx, bnan, nblk,
                                                 tile / MMA_COLS, n_valid,
                                                 out_idx, out_max);
  return (int)cudaGetLastError();
}

// x (M, d_in) f32 with M in 1..8 (X' numerics) or 16 / 32 (dequant-then-
// dot; the wrapper pads 9..32); out (M, d_out) f32; gmax (M, d_out/128)
// f32; scratch: tmax M * d_out/64 f32, xn (M, d_in) bf16 (M = 16, 32);
// grid_x, splits: the M <= 8 GEMV's plan.
extern "C" int bgt_lm_head_logits_gmax(const float* x, const float* ln_w,
                                       const float* ln_b, float eps,
                                       const uint8_t* lv, const void* sc,
                                       const void* mn, int M, int d_in,
                                       int d_out, int offset, int bits,
                                       int n_valid, int grid_x, int splits,
                                       float* out, float* gmax, float* tmax,
                                       void* xn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M >= 1 && M <= 8) {
    err = launch_xp_tail<STREAM_LOGITS>(x, ln_w, ln_b, eps, lv, sc, mn, M,
                                        d_in, d_out, offset, bits, n_valid,
                                        grid_x, splits, out, tmax, nullptr,
                                        nullptr, st);
  } else {
    const MmaGemv t = tail_gemv(x, xn, ln_w, ln_b, lv, sc, mn, d_in, d_out,
                                offset);
    switch (M) {
      case 16:
        err = launch_mma_tail<16, true>(t, eps, n_valid, out, tmax, nullptr,
                                        nullptr, bits, st);
        break;
      case 32:
        err = launch_mma_tail<32, true>(t, eps, n_valid, out, tmax, nullptr,
                                        nullptr, bits, st);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return (int)err;
  gmax_pair_kernel<<<M, 128, 0, st>>>(tmax, d_out / MMA_COLS, gmax);
  return (int)cudaGetLastError();
}
