// y = x @ dequant(W) for packed Q4_0 / Q4_1 planes, M <= 32 rows.
//
// Replaces biogpt_tpu/ops/pallas_qmatmul.py::qmatmul_pallas (M <= 8,
// XPRIME numerics) and ::qmatmul_pallas_wide (8 < M <= 32, WIDE numerics);
// the device code is qgemv.cuh. Bound on an H100: bytes -- every weight
// byte (0.5 B/weight + 1/16 B/weight of bf16 scales) is read once per call
// and the product does 2*M flops per weight, far below the card's ~295
// flop/byte balance point. The design reads each packed row with one u32
// load per lane (128 contiguous bytes per warp), unpacks nibbles in
// registers, and splits d_in over warps and blocks so that even the
// 1024-column projections put ~100 blocks on the card; a second pass sums
// the per-block partials in a fixed order.
#include "qgemv.cuh"

using namespace bgt;

namespace {

template <int M, bool WIDE>
void launch_m(const GemvArgs& a, float* part, cudaStream_t st) {
  if (a.mn != nullptr) launch_partial<M, WIDE, true>(a, part, st);
  else launch_partial<M, WIDE, false>(a, part, st);
}

}  // namespace

extern "C" int bgt_qmatmul(const float* x, const uint8_t* lv,
                           const void* sc, const void* mn, int M, int d_in,
                           int d_out, int offset, int wide, float* part,
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
  a.gpb = pick_gpb(d_in);
  if (wide) {
    switch (M) {
      case 16: launch_m<16, true>(a, part, st); break;
      case 32: launch_m<32, true>(a, part, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (M) {
      case 1: launch_m<1, false>(a, part, st); break;
      case 2: launch_m<2, false>(a, part, st); break;
      case 3: launch_m<3, false>(a, part, st); break;
      case 4: launch_m<4, false>(a, part, st); break;
      case 5: launch_m<5, false>(a, part, st); break;
      case 6: launch_m<6, false>(a, part, st); break;
      case 7: launch_m<7, false>(a, part, st); break;
      case 8: launch_m<8, false>(a, part, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
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
