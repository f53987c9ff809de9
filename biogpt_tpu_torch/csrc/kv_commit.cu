// Batched KV commits: slot b's new row of every layer lands at its own
// position past[b] of the bf16 caches (kv_commit_kernel) or of the int8
// levels and their f32 scale planes (kv_commit_quant_kernel), in place, in
// one launch.
//
// Replaces biogpt_tpu/ops/pallas_decode.py::kv_commit_pallas. Contract:
// caches (L,B,S,D) bf16, rows slot-major (B,L,D) bf16 (any row strides --
// the caller's transpose of the decode step's (L,B,D) rows is a view),
// past (B,) int32 on the device. A position outside [0, S) is clamped into
// it, as the per-slot dynamic_update_slice of the JAX package clamps.
// Bound on an H100: bytes -- 2*L*B*D bf16 read and written once (6.29 MB
// moved at 347M, B=32: 0.00188 ms at 3.35 TB/s). A copy this small is
// latency-bound: an empty kernel's launch alone measured 0.0048-0.0049 ms
// of device time on the H100 and this kernel 0.0060-0.0062 ms
// (chip_smoke.py's kv_commit_rule record). So: one block per (slot,
// layer), 128 threads each moving 16 bytes of the K and of the V row,
// __restrict__ pointers and read-only loads, so that each thread issues
// both loads before either store (without __restrict__ the V load waited
// for the K store), and past[b] read once. Grouping 2, 4 or 8 layers per
// block (all loads first) was slower: fewer, longer blocks only lengthen
// the tail. Hopper's bulk copy (cp.async.bulk of a 2 KB row through
// shared memory, completion on an mbarrier) would add a barrier round
// trip and a shared-memory hop to a copy whose bytes are all in flight at
// once. The TPU kernel's 8-row aligned read-modify-write existed for
// Mosaic's tiled DMAs; a GPU store of one row needs none.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// grid (B, L), block 128; D % 8 == 0, row strides in elements % 8 == 0.
__global__ void __launch_bounds__(128)
kv_commit_kernel(__nv_bfloat16* __restrict__ kc, __nv_bfloat16* __restrict__ vc,
                 const __nv_bfloat16* __restrict__ kr,
                 const __nv_bfloat16* __restrict__ vr, long long stride_b,
                 long long stride_l, const int* __restrict__ past, int S,
                 int D) {
  const int b = blockIdx.x, l = blockIdx.y, B = gridDim.x;
  const int p = min(max(__ldg(past + b), 0), S - 1);
  const size_t dst = ((size_t)(l * B + b) * S + p) * D;
  const size_t src = (size_t)b * stride_b + (size_t)l * stride_l;
  for (int i = threadIdx.x * 8; i < D; i += blockDim.x * 8) {
    const uint4 k = __ldg(reinterpret_cast<const uint4*>(kr + src + i));
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(vr + src + i));
    *reinterpret_cast<uint4*>(kc + dst + i) = k;
    *reinterpret_cast<uint4*>(vc + dst + i) = v;
  }
}

// Replaces biogpt_tpu/ops/pallas_decode.py::kv_commit_quant_pallas.
// Contract: levels (L,B,S,D) int8, scale planes (L,B,1,S) f32; rows
// slot-major (B,L,D) int8 and scales (B,L,1) f32 (any strides, rows
// contiguous), past (B,) int32, clamped into [0, S). Bound: bytes -- 2*L*B
// (D + 4) read and written once (1.6 MB at 347M, B=32). One block per
// (slot, layer): D/16 threads move the level row 16 bytes each, thread 0
// the two scales. The TPU's 8-row and 128-lane aligned read-modify-writes
// existed for Mosaic's tiled DMAs and are not ported.
// grid (B, L), block 64; D % 16 == 0, level row strides % 16 == 0.
__global__ void kv_commit_quant_kernel(int8_t* kc, int8_t* vc, float* ks,
                                       float* vs, const int8_t* kr,
                                       const int8_t* vr, long long stride_b,
                                       long long stride_l, const float* ksr,
                                       const float* vsr, long long sstride_b,
                                       long long sstride_l, const int* past,
                                       int S, int D) {
  const int b = blockIdx.x, l = blockIdx.y, B = gridDim.x;
  const int p = min(max(past[b], 0), S - 1);
  const size_t row = (size_t)(l * B + b) * S + p;
  const size_t src = (size_t)b * stride_b + (size_t)l * stride_l;
  for (int i = threadIdx.x * 16; i < D; i += blockDim.x * 16) {
    *reinterpret_cast<uint4*>(kc + row * D + i) =
        *reinterpret_cast<const uint4*>(kr + src + i);
    *reinterpret_cast<uint4*>(vc + row * D + i) =
        *reinterpret_cast<const uint4*>(vr + src + i);
  }
  if (threadIdx.x == 0) {
    const size_t s = (size_t)b * sstride_b + (size_t)l * sstride_l;
    ks[row] = ksr[s];
    vs[row] = vsr[s];
  }
}

}  // namespace

extern "C" int bgt_kv_commit_quant(
    void* k_cache, void* v_cache, void* k_scales, void* v_scales,
    const void* k_rows, const void* v_rows, long long stride_b,
    long long stride_l, const float* k_row_scales, const float* v_row_scales,
    long long sstride_b, long long sstride_l, const int* past, int L, int B,
    int S, int D, void* stream) {
  if (D % 16 != 0 || stride_b % 16 != 0 || stride_l % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kv_commit_quant_kernel<<<dim3(B, L), 64, 0, st>>>(
      static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),
      static_cast<float*>(k_scales), static_cast<float*>(v_scales),
      static_cast<const int8_t*>(k_rows), static_cast<const int8_t*>(v_rows),
      stride_b, stride_l, k_row_scales, v_row_scales, sstride_b, sstride_l,
      past, S, D);
  return (int)cudaGetLastError();
}

extern "C" int bgt_kv_commit(void* k_cache, void* v_cache, const void* k_rows,
                             const void* v_rows, long long stride_b,
                             long long stride_l, const int* past, int L, int B,
                             int S, int D, void* stream) {
  if (D % 8 != 0 || stride_b % 8 != 0 || stride_l % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kv_commit_kernel<<<dim3(B, L), 128, 0, st>>>(
      static_cast<__nv_bfloat16*>(k_cache), static_cast<__nv_bfloat16*>(v_cache),
      static_cast<const __nv_bfloat16*>(k_rows),
      static_cast<const __nv_bfloat16*>(v_rows), stride_b, stride_l, past, S,
      D);
  return (int)cudaGetLastError();
}
