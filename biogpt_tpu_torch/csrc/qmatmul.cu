// y = x @ dequant(W) for the Q4_0 / Q4_1 / Q5_0 / Q5_1 (packed) and Q8_0
// (unpacked int8) planes of qgemv.cuh, M <= 32 rows:
//   bgt_qmatmul       M <= 8, XPRIME numerics
//   bgt_qmatmul_wide  8 < M <= 32, WIDE numerics
//
// Replaces biogpt_tpu/ops/pallas_qmatmul.py::qmatmul_pallas (M <= 8) and
// ::qmatmul_pallas_wide (8 < M <= 32). Bound on an H100: bytes -- every
// weight byte (0.5, 0.625 or 1 B/weight of levels + 1/16 B/weight of bf16
// scales [+ 1/16 of mins]) is read once per call and the product does 2*M
// flops per weight, below the card's ~295 flop/byte balance point.
//   - M <= 8 (qgemv.cuh): each level row read with one u32 load per lane
//     (128 contiguous bytes per warp; a Q5 row adds one load of its
//     fifth-bit row), the levels unpacked in registers and multiplied with
//     scalar f32 FMAs, d_in split over warps and blocks so that even the
//     1024-column projections put ~100 blocks on the card; a second pass
//     sums the per-block partials in a fixed order;
//   - 8 < M <= 32 (qgemv_stream.cuh): one launch of the streaming
//     tensor-core GEMV on the real M rows, its grid chosen by the wrapper
//     (persistent blocks at vocab width, a cluster split of d_in at the
//     projections), every partial sum in shared memory.
#include "qgemv_stream.cuh"

using namespace bgt;

// bits: the level format (4, 5 or 8; qgemv.cuh).
extern "C" int bgt_qmatmul(const float* x, const uint8_t* lv,
                           const void* sc, const void* mn, int M, int d_in,
                           int d_out, int offset, int bits, float* part,
                           float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GemvArgs a;
  a.x = x;
  a.ln_w = nullptr;
  a.ln_b = nullptr;
  a.eps = 0.f;
  a.lv = lv;
  a.sc = static_cast<const __nv_bfloat16*>(sc);
  a.mn = static_cast<const __nv_bfloat16*>(mn);
  a.d_in = d_in;
  a.d_out = d_out;
  a.offset = offset;
  a.bits = bits;
  a.gpb = pick_gpb(d_in);
  bool ok = false;
  switch (M) {
    case 1: ok = launch_partial_fmt<1>(a, part, st); break;
    case 2: ok = launch_partial_fmt<2>(a, part, st); break;
    case 3: ok = launch_partial_fmt<3>(a, part, st); break;
    case 4: ok = launch_partial_fmt<4>(a, part, st); break;
    case 5: ok = launch_partial_fmt<5>(a, part, st); break;
    case 6: ok = launch_partial_fmt<6>(a, part, st); break;
    case 7: ok = launch_partial_fmt<7>(a, part, st); break;
    case 8: ok = launch_partial_fmt<8>(a, part, st); break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int splits = d_in / (2 * QK) / a.gpb;
  launch_partial_sum(part, splits, M, d_out, nullptr, 0, nullptr, y, st);
  return (int)cudaGetLastError();
}

// Number of partial-sum blocks along d_in (the wrapper sizes `part` as
// splits * M * d_out floats).
extern "C" int bgt_qmatmul_splits(int d_in) {
  return d_in / (2 * QK) / pick_gpb(d_in);
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
