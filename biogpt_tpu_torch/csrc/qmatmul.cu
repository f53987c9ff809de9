// y = x @ dequant(W) for the Q4_0 / Q4_1 / Q5_0 / Q5_1 (packed) and Q8_0
// (unpacked int8) planes of qgemv.cuh, M <= 32 rows.
//
// Replaces biogpt_tpu/ops/pallas_qmatmul.py::qmatmul_pallas (M <= 8,
// XPRIME numerics) and ::qmatmul_pallas_wide (8 < M <= 32, WIDE numerics);
// the device code is qgemv.cuh. Bound on an H100: bytes -- every weight
// byte (0.5, 0.625 or 1 B/weight of levels + 1/16 B/weight of bf16
// scales [+ 1/16 of mins]) is read once per call and the product does 2*M
// flops per weight, far below the card's ~295 flop/byte balance point. The
// design reads each level row with one u32 load per lane (128 contiguous
// bytes per warp; a Q5 row adds one load of its fifth-bit row), unpacks
// the levels in registers, and splits d_in over warps and blocks so that even the
// 1024-column projections put ~100 blocks on the card; a second pass sums
// the per-block partials in a fixed order.
#include "qgemv.cuh"

using namespace bgt;

// bits: the level format (4, 5 or 8; qgemv.cuh).
extern "C" int bgt_qmatmul(const float* x, const uint8_t* lv,
                           const void* sc, const void* mn, int M, int d_in,
                           int d_out, int offset, int bits, int wide,
                           float* part, float* y, void* stream) {
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
  if (wide) {
    switch (M) {
      case 16: ok = launch_partial_fmt<16, true>(a, part, st); break;
      case 32: ok = launch_partial_fmt<32, true>(a, part, st); break;
    }
  } else {
    switch (M) {
      case 1: ok = launch_partial_fmt<1, false>(a, part, st); break;
      case 2: ok = launch_partial_fmt<2, false>(a, part, st); break;
      case 3: ok = launch_partial_fmt<3, false>(a, part, st); break;
      case 4: ok = launch_partial_fmt<4, false>(a, part, st); break;
      case 5: ok = launch_partial_fmt<5, false>(a, part, st); break;
      case 6: ok = launch_partial_fmt<6, false>(a, part, st); break;
      case 7: ok = launch_partial_fmt<7, false>(a, part, st); break;
      case 8: ok = launch_partial_fmt<8, false>(a, part, st); break;
    }
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
