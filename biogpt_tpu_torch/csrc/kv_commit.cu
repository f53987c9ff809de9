// Batched KV commits: slot b's new row of every layer lands at its own
// position past[b] of the bf16 caches (kv_commit_kernel) or of the int8
// levels and their f32 scale planes, from int8 rows (kv_commit_quant_kernel)
// or from the step's f32 rows, quantized on the way
// (kv_commit_quant_rows_kernel), in place, in one launch.
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
//
// All three kernels launch in the ordinary way (<<<>>>) and never trigger their
// dependents early: the batched steps' attention (attn_batched.cuh) copies
// its cache rows in before it waits on the kernel before it, which is safe
// only because every writer of the caches has finished by the time any
// later kernel in the stream starts. Keep it so
// (tests/test_torch_attn_split.py checks this file's launches).
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

// Replaces biogpt_tpu/ops/pallas_decode.py::kv_commit_quant_pallas, the
// int8-row entry (the TP body's commit: its halves quantize with the ranks'
// all-reduced absmax). Contract: levels (L,B,S,D) int8, scale planes
// (L,B,1,S) f32; rows slot-major (B,L,D) int8 and scales (B,L,1) f32 (any
// strides, rows contiguous), past (B,) int32, clamped into [0, S). Bound:
// bytes -- 2*L*B (D + 4) read and written once (1.6 MB at 347M, B=32), an
// empty launch's latency in practice. One block per (slot, layer): D/16
// threads move the level row 16 bytes each, thread 0 the two scales; as in
// kv_commit_kernel, __restrict__ pointers and read-only loads, every load
// (the scales' too) issued before any store, and past[b] read once. The
// TPU's 8-row and 128-lane aligned read-modify-writes existed for Mosaic's
// tiled DMAs and are not ported.
// grid (B, L), block 64; D % 16 == 0, level row strides % 16 == 0.
__global__ void __launch_bounds__(64)
kv_commit_quant_kernel(int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                       float* __restrict__ ks, float* __restrict__ vs,
                       const int8_t* __restrict__ kr,
                       const int8_t* __restrict__ vr, long long stride_b,
                       long long stride_l, const float* __restrict__ ksr,
                       const float* __restrict__ vsr, long long sstride_b,
                       long long sstride_l, const int* __restrict__ past,
                       int S, int D) {
  const int b = blockIdx.x, l = blockIdx.y, B = gridDim.x;
  const int p = min(max(__ldg(past + b), 0), S - 1);
  const size_t row = (size_t)(l * B + b) * S + p;
  const size_t src = (size_t)b * stride_b + (size_t)l * stride_l;
  float ksv = 0.f, vsv = 0.f;
  if (threadIdx.x == 0) {
    const size_t s = (size_t)b * sstride_b + (size_t)l * sstride_l;
    ksv = __ldg(ksr + s);
    vsv = __ldg(vsr + s);
  }
  for (int i = threadIdx.x * 16; i < D; i += blockDim.x * 16) {
    const uint4 k = __ldg(reinterpret_cast<const uint4*>(kr + src + i));
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(vr + src + i));
    *reinterpret_cast<uint4*>(kc + row * D + i) = k;
    *reinterpret_cast<uint4*>(vc + row * D + i) = v;
  }
  if (threadIdx.x == 0) {
    ks[row] = ksv;
    vs[row] = vsv;
  }
}

// The same commit with the rows' quantization folded in: the step's f32 K
// and V rows (L,B,D), as decode_step_fused returns them in the int8 mode,
// quantized exactly as runtime/cache.py::quantize_rows does -- amax = max
// |x| over D (a NaN in the row makes it NaN, as torch.amax), scale = amax /
// 127 (an IEEE f32 divide), safe = max(scale, 1e-12) (NaN stays NaN, as
// torch.clamp), level = clamp(rint(x / safe), -127, 127) rounding half to
// even (a NaN level is 0, as the cast of a NaN to int8 gives on the card)
// -- and committed at each slot's clamped position: the levels and the
// scale (not `safe`). Before it, the int8 steps ran the quantization as
// ~16 elementwise torch launches and this commit as a 17th. past: (B,)
// int32 on the device, or null and the host's position `past_host` (the
// single stream's, B = 1). Bound: bytes, 2*L*B*D*4 read and 2*L*B*(D + 4)
// written (7.9 MB at 347M, B=32: 0.0024 ms at 3.35 TB/s); at B=1 launch
// latency. One warp per (row, K|V): lane l holds the 16 floats
// [16 (l + 32 j), +16) of each chunk j < CH (CH * 512 >= D), issues all
// its loads before the shuffle max, then stores 16 levels with one 16-byte
// store a chunk; lane 0 writes the scale.
// grid ceil(2 L B / QR_WARPS), block 32 * QR_WARPS; D % 16 == 0.
constexpr int QR_WARPS = 4;

template <int CH>
__global__ void __launch_bounds__(32 * QR_WARPS)
kv_commit_quant_rows_kernel(int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                            float* __restrict__ ks, float* __restrict__ vs,
                            const float* __restrict__ kr,
                            const float* __restrict__ vr,
                            const int* __restrict__ past, int past_host,
                            int rows, int B, int S, int D) {
  const int w = blockIdx.x * QR_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= 2 * rows) return;
  const int r = w >> 1;   // l * B + b
  const bool is_v = (w & 1) != 0;
  const float* __restrict__ src = (is_v ? vr : kr) + (size_t)r * D;
  float4 x[CH][4];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = 16 * (lane + 32 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[j][i] = c < D ? __ldg(reinterpret_cast<const float4*>(src + c) + i)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int pos = past != nullptr ? __ldg(past + r % B) : past_host;
  float m = 0.f;
  bool nan = false;
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = x[j][i];
      m = fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))),
                fmaxf(fabsf(v.z), fabsf(v.w)));
      nan = nan || isnan(v.x) || isnan(v.y) || isnan(v.z) || isnan(v.w);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float amax = __any_sync(0xffffffffu, nan) ? __int_as_float(0x7fc00000)
                                                  : m;
  const float scale = __fdiv_rn(amax, 127.0f);
  const float safe = isnan(scale) ? scale : fmaxf(scale, 1e-12f);
  const size_t row = (size_t)r * S + min(max(pos, 0), S - 1);
  int8_t* __restrict__ dst = (is_v ? vc : kc) + row * D;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = 16 * (lane + 32 * j);
    if (c >= D) continue;
    uint32_t q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e[4] = {x[j][i].x, x[j][i].y, x[j][i].z, x[j][i].w};
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float t = rintf(__fdiv_rn(e[k], safe));
        const int lv = isnan(t) ? 0 : (int)fminf(fmaxf(t, -127.f), 127.f);
        word |= (uint32_t)(lv & 0xFF) << (8 * k);
      }
      q[i] = word;
    }
    *reinterpret_cast<uint4*>(dst + c) = make_uint4(q[0], q[1], q[2], q[3]);
  }
  if (lane == 0) (is_v ? vs : ks)[row] = scale;
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

// k_rows, v_rows (L, B, D) f32 contiguous; past (B,) int32 on the device,
// or null and the host's position past_host.
extern "C" int bgt_kv_commit_quant_rows(void* k_cache, void* v_cache,
                                        void* k_scales, void* v_scales,
                                        const float* k_rows,
                                        const float* v_rows, const int* past,
                                        int past_host, int L, int B, int S,
                                        int D, void* stream) {
  if (D % 16 != 0 || D <= 0 || D > 2048) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = L * B;
  const dim3 grid((2 * rows + QR_WARPS - 1) / QR_WARPS);
  auto* kc = static_cast<int8_t*>(k_cache);
  auto* vc = static_cast<int8_t*>(v_cache);
  auto* ks = static_cast<float*>(k_scales);
  auto* vs = static_cast<float*>(v_scales);
  if (D <= 512)
    kv_commit_quant_rows_kernel<1><<<grid, 32 * QR_WARPS, 0, st>>>(
        kc, vc, ks, vs, k_rows, v_rows, past, past_host, rows, B, S, D);
  else if (D <= 1024)
    kv_commit_quant_rows_kernel<2><<<grid, 32 * QR_WARPS, 0, st>>>(
        kc, vc, ks, vs, k_rows, v_rows, past, past_host, rows, B, S, D);
  else
    kv_commit_quant_rows_kernel<4><<<grid, 32 * QR_WARPS, 0, st>>>(
        kc, vc, ks, vs, k_rows, v_rows, past, past_host, rows, B, S, D);
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
