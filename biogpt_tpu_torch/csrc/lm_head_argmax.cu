// Greedy tail: argmax over the first n_valid columns of
// LayerNorm(x) @ dequant(lm_head), M <= 8 rows, packed Q4_0 / Q4_1.
//
// Replaces biogpt_tpu/ops/pallas_qmatmul.py::lm_head_argmax_pallas
// (`_argmax_kernel` + `_ln_lmhead_tile`, X' numerics). Bound on an H100:
// bytes -- the 1024 x 42496 packed lm_head (21.8 MB of levels, 2.7 MB of
// bf16 scales) is read once; the logits never reach device memory. The
// TPU kernel walked vocab tiles in order carrying a running best in VMEM;
// here each of the d_out/128 blocks (332 at BioGPT-347M, enough to fill
// the card) recomputes the LayerNorm, computes its 128 logits over the
// full d_in and writes one (max, lowest index, any-NaN) triple per row; a
// second one-warp-per-row kernel folds them in column order with the TPU
// kernel's rules, tile by tile (T = its lane tile, 512 columns at 347M):
//   - a tile holding a NaN yields (NaN, n_valid - 1) (jnp.max propagates
//     NaN and no column then satisfies `logits >= tmax`; the id clamps);
//   - tiles fold with a strict `>` from tile 0, so ties keep the lowest
//     index and a NaN first tile pins the result (the health lane's probe).
#include "qgemv.cuh"

using namespace bgt;

namespace {

template <int M, bool HAS_MIN>
__global__ void __launch_bounds__(GEMV_THREADS)
lm_head_block_kernel(GemvArgs a, int n_valid, float* bmax, int* bidx,
                     int* bnan) {
  __shared__ float xs[XS_BYTES_MAX / 4];
  __shared__ float red[GEMV_WARPS * TILE_COLS];
  __shared__ float logits[M * TILE_COLS];
  __shared__ float scratch[32];
  __shared__ float wmax[GEMV_WARPS];
  __shared__ int widx[GEMV_WARPS];
  stage_x<M>(a, xs, 0, a.gpb * QK, scratch);
  __syncthreads();
  float acc[M][4];
  gemv_accumulate<M, false, HAS_MIN>(a, xs, blockIdx.x, 0, acc);
  warp_tile_reduce<M>(acc, red, logits, TILE_COLS);
  __syncthreads();

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

template <int M>
void launch_blocks(const GemvArgs& a, int n_valid, float* bmax, int* bidx,
                   int* bnan, cudaStream_t st) {
  dim3 grid(a.d_out / TILE_COLS);
  if (a.mn != nullptr)
    lm_head_block_kernel<M, true><<<grid, GEMV_THREADS, 0, st>>>(a, n_valid, bmax, bidx, bnan);
  else
    lm_head_block_kernel<M, false><<<grid, GEMV_THREADS, 0, st>>>(a, n_valid, bmax, bidx, bnan);
}

}  // namespace

// x (M, d_in) f32; ln_w/ln_b (d_in) f32; scratch bmax/bidx/bnan hold
// M * d_out/128 entries each; out_idx (M,) i32, out_max (M,) f32.
extern "C" int bgt_lm_head_argmax(const float* x, const float* ln_w,
                                  const float* ln_b, float eps,
                                  const uint8_t* lv, const void* sc,
                                  const void* mn, int M, int d_in, int d_out,
                                  int offset, int n_valid, int tile_blocks,
                                  float* bmax, int* bidx, int* bnan,
                                  int* out_idx, float* out_max, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  a.gpb = d_in / (2 * QK);   // one block covers the whole of d_in
  switch (M) {
    case 1: launch_blocks<1>(a, n_valid, bmax, bidx, bnan, st); break;
    case 2: launch_blocks<2>(a, n_valid, bmax, bidx, bnan, st); break;
    case 3: launch_blocks<3>(a, n_valid, bmax, bidx, bnan, st); break;
    case 4: launch_blocks<4>(a, n_valid, bmax, bidx, bnan, st); break;
    case 5: launch_blocks<5>(a, n_valid, bmax, bidx, bnan, st); break;
    case 6: launch_blocks<6>(a, n_valid, bmax, bidx, bnan, st); break;
    case 7: launch_blocks<7>(a, n_valid, bmax, bidx, bnan, st); break;
    case 8: launch_blocks<8>(a, n_valid, bmax, bidx, bnan, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nblk = d_out / TILE_COLS;
  const int n_tiles = nblk / tile_blocks;
  argmax_fold_kernel<<<M, 32, n_tiles * 8, st>>>(bmax, bidx, bnan, nblk,
                                                 tile_blocks, n_valid, out_idx,
                                                 out_max);
  return (int)cudaGetLastError();
}
