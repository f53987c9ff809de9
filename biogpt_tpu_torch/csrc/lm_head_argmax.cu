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
// M=32). The TPU kernels walked vocab tiles in order
// carrying state in VMEM; here each of the d_out/128 blocks (332 at
// BioGPT-347M, enough to fill the card) recomputes the LayerNorm of all M
// rows into dynamic shared memory (M * d_in floats), computes its 128
// logits per row over the full d_in, and then
//   argmax: writes one (max, lowest index, any-NaN) triple per row; a
//     second one-warp-per-row kernel folds them in column order with the
//     TPU kernel's rules, tile by tile (T = its lane tile, 512 columns at
//     347M): a tile holding a NaN yields (NaN, n_valid - 1) (jnp.max
//     propagates NaN and no column then satisfies `logits >= tmax`; the id
//     clamps); tiles fold with a strict `>` from tile 0, so ties keep the
//     lowest index and a NaN first tile pins the result (the health
//     lane's probe);
//   logits+gmax: writes its 128 logits per row and their maximum -- one
//     block is one 128-column group -- NaN-propagating as jnp.max.
#include "qgemv.cuh"

using namespace bgt;

namespace {

// LayerNorm of all M rows into xs (dynamic shared memory), then this
// block's 128 logits per row into logits (M, 128).
template <int M, bool WIDE, int BITS, bool HAS_MIN>
__device__ __forceinline__ void lm_head_tile(const GemvArgs& a, float* xs,
                                             float* red, float* logits,
                                             float* scratch) {
  stage_x<M>(a, xs, 0, a.gpb * QK, scratch);
  __syncthreads();
  float acc[M][4];
  gemv_accumulate<M, WIDE, BITS, HAS_MIN>(a, xs, blockIdx.x, 0, acc);
  warp_tile_reduce<M>(acc, red, logits, TILE_COLS);
  __syncthreads();
}

// NaN-propagating max of v over the block (as jnp.max); every thread gets
// it. `wmax` holds GEMV_WARPS floats.
__device__ __forceinline__ float block_max_nan(float v, float* wmax) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int any_nan = __syncthreads_or(isnan(v) ? 1 : 0);
  float mx = warp_max(isnan(v) ? -INFINITY : v);
  if (lane == 0) wmax[warp] = mx;
  __syncthreads();
  mx = wmax[0];
  for (int w = 1; w < GEMV_WARPS; ++w) mx = fmaxf(mx, wmax[w]);
  __syncthreads();
  return any_nan ? __int_as_float(0x7fc00000) : mx;
}

template <int M, bool WIDE, int BITS, bool HAS_MIN>
__global__ void __launch_bounds__(GEMV_THREADS)
lm_head_block_kernel(GemvArgs a, int n_valid, float* bmax, int* bidx,
                     int* bnan) {
  extern __shared__ float xs[];
  __shared__ float red[GEMV_WARPS * TILE_COLS];
  __shared__ float logits[M * TILE_COLS];
  __shared__ float scratch[32];
  __shared__ float wmax[GEMV_WARPS];
  __shared__ int widx[GEMV_WARPS];
  lm_head_tile<M, WIDE, BITS, HAS_MIN>(a, xs, red, logits, scratch);

  const int nblk = gridDim.x;
  const int col = blockIdx.x * TILE_COLS + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = 0; m < M; ++m) {
    const float v = col < n_valid ? logits[m * TILE_COLS + threadIdx.x] : -1e30f;
    const int any_nan = __syncthreads_or(isnan(v) ? 1 : 0);
    float mx = warp_max(isnan(v) ? -INFINITY : v);
    if (lane == 0) wmax[warp] = mx;
    __syncthreads();
    mx = wmax[0];
    for (int w = 1; w < GEMV_WARPS; ++w) mx = fmaxf(mx, wmax[w]);
    int id = (v == mx) ? col : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) id = min(id, __shfl_xor_sync(0xffffffffu, id, o));
    if (lane == 0) widx[warp] = id;
    __syncthreads();
    if (threadIdx.x == 0) {
      int best = widx[0];
      for (int w = 1; w < GEMV_WARPS; ++w) best = min(best, widx[w]);
      bmax[m * nblk + blockIdx.x] = mx;
      bidx[m * nblk + blockIdx.x] = best;
      bnan[m * nblk + blockIdx.x] = any_nan;
    }
    __syncthreads();
  }
}

// logits (M, d_out) with pad columns -1e30; gmax (M, d_out/128).
template <int M, bool WIDE, int BITS, bool HAS_MIN>
__global__ void __launch_bounds__(GEMV_THREADS)
lm_head_logits_gmax_kernel(GemvArgs a, int n_valid, float* out,
                           float* gmax) {
  extern __shared__ float xs[];
  __shared__ float red[GEMV_WARPS * TILE_COLS];
  __shared__ float logits[M * TILE_COLS];
  __shared__ float scratch[32];
  __shared__ float wmax[GEMV_WARPS];
  lm_head_tile<M, WIDE, BITS, HAS_MIN>(a, xs, red, logits, scratch);

  const int nblk = gridDim.x;
  const int col = blockIdx.x * TILE_COLS + threadIdx.x;
  for (int m = 0; m < M; ++m) {
    const float v = col < n_valid ? logits[m * TILE_COLS + threadIdx.x] : -1e30f;
    out[(size_t)m * a.d_out + col] = v;
    const float mx = block_max_nan(v, wmax);
    if (threadIdx.x == 0) gmax[m * nblk + blockIdx.x] = mx;
  }
}

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

// Launch `kernel` over the d_out/128 column blocks with M * d_in floats of
// dynamic shared memory (above 48 KB only after opting in).
template <typename Kernel, typename... Args>
cudaError_t launch_tiles(Kernel kernel, int M, const GemvArgs& a,
                         cudaStream_t st, Args... args) {
  const size_t smem = (size_t)M * a.d_in * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.d_out / TILE_COLS, GEMV_THREADS, smem, st>>>(a, args...);
  return cudaGetLastError();
}

template <int M, bool WIDE>
cudaError_t launch_argmax(const GemvArgs& a, int n_valid, float* bmax,
                          int* bidx, int* bnan, cudaStream_t st) {
  cudaError_t err = cudaErrorInvalidValue;
  with_format(a.bits, a.mn != nullptr, [&](auto fmt) {
    using T = decltype(fmt);
    err = launch_tiles(lm_head_block_kernel<M, WIDE, T::BITS, T::HAS_MIN>, M,
                       a, st, n_valid, bmax, bidx, bnan);
  });
  return err;
}

template <int M, bool WIDE>
cudaError_t launch_logits(const GemvArgs& a, int n_valid, float* out,
                          float* gmax, cudaStream_t st) {
  cudaError_t err = cudaErrorInvalidValue;
  with_format(a.bits, a.mn != nullptr, [&](auto fmt) {
    using T = decltype(fmt);
    err = launch_tiles(
        lm_head_logits_gmax_kernel<M, WIDE, T::BITS, T::HAS_MIN>, M, a, st,
        n_valid, out, gmax);
  });
  return err;
}

GemvArgs lm_head_args(const float* x, const float* ln_w, const float* ln_b,
                      float eps, const uint8_t* lv, const void* sc,
                      const void* mn, int d_in, int d_out, int offset,
                      int bits) {
  GemvArgs a;
  a.x = x;
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.eps = eps;
  a.lv = lv;
  a.sc = static_cast<const __nv_bfloat16*>(sc);
  a.mn = static_cast<const __nv_bfloat16*>(mn);
  a.d_in = d_in;
  a.d_out = d_out;
  a.offset = offset;
  a.bits = bits;
  a.gpb = d_in / (2 * QK);   // one block covers the whole of d_in
  return a;
}

}  // namespace

// x (M, d_in) f32 with M in 1..8 (X' numerics) or 16 / 32 (dequant-then-
// dot; the wrapper pads 9..32 rows with zeros); ln_w/ln_b (d_in) f32;
// scratch bmax/bidx/bnan hold M * d_out/128 entries each; out_idx (M,)
// i32, out_max (M,) f32; bits: the level format (4, 5 or 8).
extern "C" int bgt_lm_head_argmax(const float* x, const float* ln_w,
                                  const float* ln_b, float eps,
                                  const uint8_t* lv, const void* sc,
                                  const void* mn, int M, int d_in, int d_out,
                                  int offset, int bits, int n_valid,
                                  int tile_blocks,
                                  float* bmax, int* bidx, int* bnan,
                                  int* out_idx, float* out_max, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GemvArgs a = lm_head_args(x, ln_w, ln_b, eps, lv, sc, mn, d_in,
                                  d_out, offset, bits);
  cudaError_t err;
  switch (M) {
    case 1: err = launch_argmax<1, false>(a, n_valid, bmax, bidx, bnan, st); break;
    case 2: err = launch_argmax<2, false>(a, n_valid, bmax, bidx, bnan, st); break;
    case 3: err = launch_argmax<3, false>(a, n_valid, bmax, bidx, bnan, st); break;
    case 4: err = launch_argmax<4, false>(a, n_valid, bmax, bidx, bnan, st); break;
    case 5: err = launch_argmax<5, false>(a, n_valid, bmax, bidx, bnan, st); break;
    case 6: err = launch_argmax<6, false>(a, n_valid, bmax, bidx, bnan, st); break;
    case 7: err = launch_argmax<7, false>(a, n_valid, bmax, bidx, bnan, st); break;
    case 8: err = launch_argmax<8, false>(a, n_valid, bmax, bidx, bnan, st); break;
    case 16: err = launch_argmax<16, true>(a, n_valid, bmax, bidx, bnan, st); break;
    case 32: err = launch_argmax<32, true>(a, n_valid, bmax, bidx, bnan, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int nblk = d_out / TILE_COLS;
  const int n_tiles = nblk / tile_blocks;
  argmax_fold_kernel<<<M, 32, n_tiles * 8, st>>>(bmax, bidx, bnan, nblk,
                                                 tile_blocks, n_valid, out_idx,
                                                 out_max);
  return (int)cudaGetLastError();
}

// x (M, d_in) f32 with M = 8 (X' numerics; the wrapper pads 1..8 rows) or
// 16 / 32 (dequant-then-dot; pads 9..32); out (M, d_out) f32; gmax
// (M, d_out/128) f32.
extern "C" int bgt_lm_head_logits_gmax(const float* x, const float* ln_w,
                                       const float* ln_b, float eps,
                                       const uint8_t* lv, const void* sc,
                                       const void* mn, int M, int d_in,
                                       int d_out, int offset, int bits,
                                       int n_valid,
                                       float* out, float* gmax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GemvArgs a = lm_head_args(x, ln_w, ln_b, eps, lv, sc, mn, d_in,
                                  d_out, offset, bits);
  switch (M) {
    case 8: return (int)launch_logits<8, false>(a, n_valid, out, gmax, st);
    case 16: return (int)launch_logits<16, true>(a, n_valid, out, gmax, st);
    case 32: return (int)launch_logits<32, true>(a, n_valid, out, gmax, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
