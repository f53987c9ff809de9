// Fresh-cache prompt forward of a serving refill group: R prompts padded to
// T tokens through all L layers, Q4_0 / Q4_1 / Q5_0 / Q5_1 (packed) or Q8_0
// (unpacked) weights.
//
// Replaces biogpt_tpu/ops/pallas_prefill.py::prefill_fused (body
// `_make_prefill_kernel`). Contract: (x0 (R*T, D) f32, layers) -> (x
// (R*T, D) f32 before the final LN, k_rows, v_rows (L, R*T, D) bf16);
// position t of prompt p is row p*T + t. The cache starts empty, so
// attention is causal within each prompt.
//
// Bound on an H100: operations at the large refill shapes (2*R*T*(12 D^2
// ... ) ~ 6.2e11 at 32 prompts x 32 tokens, 0.63 ms at the bf16 tensor
// rate), bytes (the layer planes: ~170 MB in Q4_0, ~321 MB in Q8_0) at the
// small ones. Per layer, seven kernels, each a programmatic dependent of
// the one before (async_copy.cuh):
//   ln_rows_kernel (qgemv_mma.cuh): LayerNorm-0 -> bf16 rows
//   prefill_gemm_kernel, qkv: q * (1/sqrt(Dk)) to bf16, the K/V rows of
//     layer l (bf16)
//   causal_attn_kernel: the causal attention of each (prompt, head)
//   prefill_gemm_kernel, o: the residual (x + y) + bias
//   ln_rows_kernel: LayerNorm-1
//   prefill_gemm_kernel, fc1: bias + exact-erf GELU to bf16
//   prefill_gemm_kernel, fc2: the residual
// The GEMM (prefill_gemm_kernel) is warp-specialised around wgmma (bf16
// in, f32 accumulation, both operands in shared memory, 128-byte swizzle):
//   - a block owns a 128-row tile of the output, 256 columns wide for qkv
//     and fc1 (m64n256k16) and 128 for o and fc2, or where 256 does not
//     divide d_out (m64n128k16; see Tile), and walks d_in in k-steps of one packed group (32 packed rows: the
//     level rows k0 + i, "low", and d_in/2 + k0 + i, "high"; k-slots 0..31
//     and 32..63);
//   - two consumer warpgroups load each k-step two steps ahead by 16-byte
//     cp.async into a ring of four slots: each its own 64 activation rows
//     (64 bf16 columns), and between them the group's raw level bytes
//     (with the fifth-bit rows for Q5, the high level rows for Q8_0),
//     scales and mins, whose landing an mbarrier tracks;
//   - the producer warpgroups only dequantize: the raw bytes of a step, with
//     qgemv_mma.cuh's format-generic `weight_pair`, into one of two weight
//     tiles in wgmma's K-major layout, each weight once per 128-row block
//     (_qmm_dq's rounding: (level - offset) * scale [+ min] in f32, one
//     rounding to bf16), handed over through an mbarrier;
//   - the consumers run 4 wgmma per k-step, each on its 64 rows, free a
//     step's slot and tile when the next step's products are issued, and
//     end with the epilogue: the bf16 outputs (q, k, v; GELU) staged in
//     shared memory and stored in 16-byte pieces of rows, the residual
//     with its loads issued before its stores, the bias from shared memory;
//   - where the tiles of a 512-row group would not fill the card (every
//     projection of 347M), the host splits d_in over a thread block
//     cluster of up to 8 blocks, which sum their partial tiles in split
//     order through distributed shared memory (no atomics), then apply the
//     epilogue. The split count is a function of the weight's widths,
//     never of R*T, so a refill row's bits do not depend on how many rows
//     share its group.
// Attention (causal_attn_kernel) computes Q.K^T and P.V on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulation): a block takes up
// to 64 query rows of one (prompt, head), 16 a warp, keys and values
// staged in 64-row chunks by cp.async (the first K and V chunks together);
// each row's f32 scores over its whole causal span stay in shared memory
// (at most 64 x 520 floats), so its softmax is the full one, normalised
// before p rounds to bf16 (the TPU kernel's order).
// The products are exact in f32, so only the summation order differs from
// the plain version; it is one order for every format, so Q4 weights
// re-encoded exactly in Q5/Q8 give the same bits. Rows past a prompt's
// length compute causal padding values, as in the TPU kernel and the plain
// version.
#include <cooperative_groups.h>

#include "decode_layers.cuh"

using namespace bgt;

namespace {

constexpr int GBM = 128;                 // GEMM block rows
constexpr int GBK = 2 * QK;              // k-slots per step (one group)
constexpr int GCONSUMERS = 256;          // two consumer warpgroups
constexpr int MAX_SPLITS = 8;            // a portable cluster
constexpr int AQ = 64;                   // query rows per attention block
constexpr int AKC = 64;                  // keys per staged chunk
constexpr int AKS = DK + 8;              // staged key row stride (bf16)
constexpr int ATHREADS = 2 * AQ;         // the widest attention block
constexpr int MAX_T = 512;               // longest prompt (the routing caps' too)

enum { EPI_QKV = 0, EPI_RESID = 1, EPI_GELU = 2 };

struct Epi {
  const float* bias;      // (d_out) f32
  float* x;               // EPI_RESID: (M, d_out) residual stream, updated
  __nv_bfloat16* out;     // EPI_QKV: q (M, D); EPI_GELU: (M, d_out)
  __nv_bfloat16* k;       // EPI_QKV: (M, D) rows of this layer
  __nv_bfloat16* v;
  int D;
  float scale;
};

struct GemmArgs {
  const __nv_bfloat16* A;     // (M, d_in) bf16 activations
  int M, d_in, d_out;
  const uint8_t* lv;          // level plane of format BITS (qgemv.cuh)
  const __nv_bfloat16* sc;    // (d_in/32, d_out)
  const __nv_bfloat16* mn;    // (d_in/32, d_out) or null
  float off;                  // level offset
  int splits;                 // blocks along d_in: one cluster
  Epi e;
};

// The GEMM's shape per tile width BN: 256 output columns a block with one
// producer warpgroup, for qkv and fc1 (each weight dequantized once per
// 128 x 256 tile, the activation tile read d_out / 256 times); 128 with
// two, for the residual projections (o, fc2, d_out 1024: twice the blocks,
// fewer d_in splits) and for any d_out that 256 does not divide (tile_bn).
template <int BN_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int PRODUCERS = BN == 256 ? 128 : 256;
  static constexpr int THREADS = GCONSUMERS + PRODUCERS;
  static constexpr int RAW_ROW = BN + 16;   // raw level row stride (bytes)
  static constexpr int RED_ROW = BN + 4;    // split-K partial row (f32)
};

// The shared-memory ring of a GEMM block: STAGES slots of each k-step's
// loads (the activation tile, 128 rows of 128 bytes; the raw level rows;
// the scale and min rows), filled LAG steps ahead of the dequantization,
// and BSTAGES weight tiles (BN rows of 128 bytes) it writes; the tiles
// 1024-byte aligned for the swizzle.
template <int BITS, int BN>
struct Ring {
  static constexpr int STAGES = 4, BSTAGES = 2, LAG = 2;
  static constexpr int A_BYTES = GBM * GBK * 2;
  static constexpr int B_BYTES = BN * GBK * 2;
  static constexpr int RAW_ROWS = BITS == 4 ? QK : 2 * QK;
  static constexpr int RAW_BYTES = RAW_ROWS * (BN + 16);
  static constexpr int R_BYTES = RAW_BYTES + 4 * BN * 2;
  static constexpr int A = 0;
  static constexpr int B = A + STAGES * A_BYTES;
  static constexpr int R = B + BSTAGES * B_BYTES;
  static constexpr int BAR = R + STAGES * R_BYTES;
  static constexpr int BIAS = BAR + 3 * STAGES * 8;   // the tile's bias
  static constexpr int SMEM = 1024 + BIAS + BN * 4;
};

// Raw row of packed row r (< 32) of a group: rows 8c + i sit at 4i + c, so
// the producer's lanes (one per c) read four rows on distinct banks.
__device__ __forceinline__ int raw_slot(int r) { return (r & 7) * 4 + (r >> 3); }

// Level plane row of raw row r (< RAW_ROWS) of the group at packed row k0:
// packed row k0 + r, then (r >= 32) its fifth-bit plane row (Q5) or the
// high level row d_in/2 + k0 + r - 32 (Q8_0).
template <int BITS>
__device__ __forceinline__ size_t raw_row(int r, int k0, int d_in) {
  if (r < QK) return (size_t)k0 + r;
  if (BITS == 8) return (size_t)d_in / 2 + k0 + r - QK;
  int j, q;
  FifthBit(k0, d_in).at(r - QK, j, q);
  return (size_t)d_in / 2 + j;
}

// wgmma's shared-memory descriptor of a K-major tile of 128-byte rows,
// 128-byte swizzle (8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, this thread's 64 f32) += A (64 x 16) . B (16 x 128)
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t desc_a,
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 256, this thread's 128 f32) += A (64 x 16) . B (16 x 256)
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t desc_a,
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The epilogue of N (2 or 4) consecutive columns col.. of row `row`, from
// their sums v, the bias b and (EPI_RESID) the residual xr, both loaded by
// the caller before any store.
template <int EPI, int N>
__device__ __forceinline__ void store_out(const Epi& e, int row, int col,
                                          int d_out, const float* v,
                                          const float* b, const float* xr) {
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (EPI == EPI_RESID) {
      y[i] = (xr[i] + v[i]) + b[i];   // the TPU kernel's (x + proj) + bias
    } else {
      y[i] = v[i] + b[i];
      if (EPI == EPI_GELU)
        y[i] = 0.5f * y[i] * (1.0f + erff(y[i] * 0.70710678118654752f));
    }
  }
  if (EPI == EPI_RESID) {
    float* dst = e.x + (size_t)row * d_out + col;
    if (N == 4) *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
    else *reinterpret_cast<float2*>(dst) = make_float2(y[0], y[1]);
    return;
  }
  __nv_bfloat16* dst;
  if (EPI == EPI_GELU) {
    dst = e.out + (size_t)row * d_out + col;
  } else if (col < e.D) {
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] *= e.scale;
    dst = e.out + (size_t)row * e.D + col;
  } else if (col < 2 * e.D) {
    dst = e.k + (size_t)row * e.D + col - e.D;
  } else {
    dst = e.v + (size_t)row * e.D + col - 2 * e.D;
  }
  const uint32_t lo = pack2_bf16(y[0], y[1]);
  if (N == 4)
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo, pack2_bf16(y[2], y[3]));
  else
    *reinterpret_cast<uint32_t*>(dst) = lo;
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t desc_a,
                                         uint64_t desc_b) {
  if constexpr (BN == 256) wgmma_256(d, desc_a, desc_b);
  else wgmma_128(d, desc_a, desc_b);
}

// Consumer warpgroup wg's loads of its 64 activation rows of packed group
// grp into ring slot s, thread ct of 128: k-slot 8c + i of row m is
// column k0 + 8c + i (c < 4) or d_in/2 + k0 + 8(c - 4) + i; chunk c of row
// m at m*128 + (c ^ (m & 7))*16; rows past M zero.
template <int BITS, int BN>
__device__ __forceinline__ void load_a(const GemmArgs& a, unsigned char* ring,
                                       int s, int grp, int m0, int wg,
                                       int ct) {
  using Rg = Ring<BITS, BN>;
  const int half = a.d_in / 2, k0 = grp * QK;
  unsigned char* As = ring + Rg::A + s * Rg::A_BYTES;
  for (int i = ct; i < 64 * 8; i += 128) {
    const int m = 64 * wg + (i >> 3), c = i & 7;
    const int col = c < 4 ? k0 + 8 * c : half + k0 + 8 * (c - 4);
    const int gm = m0 + m;
    cp_async16_zfill(As + m * 128 + ((c ^ (m & 7)) << 4),
                     a.A + (size_t)min(gm, a.M - 1) * a.d_in + col,
                     gm < a.M ? 16 : 0);
  }
}

// Consumer thread p's (of the 256) loads of packed group grp's weights
// into ring slot s: the raw level rows (packed row r at raw_slot(r); its
// fifth-bit plane row, Q5, or high level row, Q8_0, at 32 + raw_slot(r)),
// and the scale rows (low, high) and min rows of its two level blocks.
template <int BN_, int BITS, bool HAS_MIN>
__device__ __forceinline__ void load_raw(const GemmArgs& a,
                                         unsigned char* ring, int s, int grp,
                                         int n0, int p) {
  using Tl = Tile<BN_>;
  using Rg = Ring<BITS, Tl::BN>;
  constexpr int BN = Tl::BN, P = GCONSUMERS;
  const int groups = a.d_in / GBK, k0 = grp * QK;
  unsigned char* raw = ring + Rg::R + s * Rg::R_BYTES;
  for (int i = p; i < Rg::RAW_ROWS * (BN / 16); i += P) {
    const int r = i / (BN / 16), u = i % (BN / 16);
    const int slot = r < QK ? raw_slot(r) : QK + raw_slot(r - QK);
    cp_async16(raw + slot * Tl::RAW_ROW + u * 16,
               a.lv + raw_row<BITS>(r, k0, a.d_in) * a.d_out + n0 + u * 16);
  }
  unsigned char* scs = raw + Rg::RAW_BYTES;
  for (int i = p; i < (HAS_MIN ? 4 : 2) * (BN / 8); i += P) {
    const int r = i / (BN / 8), u = i % (BN / 8);
    const __nv_bfloat16* src = (r >= 2 ? a.mn : a.sc)
                               + (size_t)(grp + (r & 1) * groups) * a.d_out
                               + n0 + u * 8;
    cp_async16(scs + r * BN * 2 + u * 16, src);
  }
}

// NR (4 or 8) packed rows 8c + r0 .. of the column octet j (columns 8j ..
// 8j+7), low or high levels (k chunk ch = c + 4 high), dequantized into
// rows n = 8j + t of the weight tile Bs (K-major, 128 bytes a row, chunk
// ch at (ch ^ (n & 7))*16, the rows at + 2 r0 bytes in it).
template <int BITS, bool HAS_MIN, int NR, int RAW_ROW, int BN>
__device__ __forceinline__ void dequant_unit(const GemmArgs& a,
                                             const unsigned char* raw,
                                             const unsigned char* scs,
                                             unsigned char* Bs,
                                             const FifthBit& fb, int ch,
                                             int j, int r0) {
  const int c = ch & 3;
  const bool high = ch >= 4;
  const int h = high ? 1 : 0;
  uint64_t wlo[NR], whi[NR];
  int q5[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = 8 * c + r0 + i;
    const int slot = raw_slot(r);
    wlo[i] = *reinterpret_cast<const uint64_t*>(raw + slot * RAW_ROW + 8 * j);
    whi[i] = BITS == 4 ? 0ull
                       : *reinterpret_cast<const uint64_t*>(
                             raw + (QK + slot) * RAW_ROW + 8 * j);
    int jr = 0, q = 0;
    if (BITS == 5) fb.at(r, jr, q);
    q5[i] = q;
  }
  const uint4 s4 = *reinterpret_cast<const uint4*>(scs + h * BN * 2 + 16 * j);
  uint4 m4 = make_uint4(0u, 0u, 0u, 0u);
  if (HAS_MIN)
    m4 = *reinterpret_cast<const uint4*>(scs + (2 + h) * BN * 2 + 16 * j);
  const uint32_t off2 = bf162_bits(__floats2bfloat162_rn(128.f + a.off,
                                                         128.f + a.off));
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const uint32_t sb = bf16_bits(s4, t);
    const uint32_t s2 = sb | (sb << 16);
    const float s = __uint_as_float(sb << 16);
    const float mn = __uint_as_float(bf16_bits(m4, t) << 16);
    uint32_t w[NR / 2];
#pragma unroll
    for (int e = 0; e < NR / 2; ++e)
      w[e] = weight_pair<BITS, HAS_MIN>(wlo[2 * e], wlo[2 * e + 1],
                                        whi[2 * e], whi[2 * e + 1],
                                        q5[2 * e], q5[2 * e + 1], high, t,
                                        a.off, s, mn, s2, off2);
    unsigned char* dst = Bs + (8 * j + t) * 128 + ((ch ^ t) << 4) + 2 * r0;
    if constexpr (NR == 8)
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
}

// Producer thread p dequantizes its share of a step's weight tile Bs from
// the raw rows and scales of ring slot s: k
// chunk ch = p & 7 of each (chunk, column octet) unit; 256 columns and 128
// producers: the octets (p >> 3) + 16 jh whole; 128 columns and 256
// producers: octet p >> 4, half (p >> 3) & 1 of its rows.
template <int BN_, int BITS, bool HAS_MIN>
__device__ __forceinline__ void dequant_stage(const GemmArgs& a,
                                              unsigned char* ring, int s,
                                              unsigned char* Bs, int grp,
                                              int p) {
  using Tl = Tile<BN_>;
  using Rg = Ring<BITS, Tl::BN>;
  const unsigned char* raw = ring + Rg::R + s * Rg::R_BYTES;
  const unsigned char* scs = raw + Rg::RAW_BYTES;
  const FifthBit fb(grp * QK, a.d_in);
  const int ch = p & 7;
  if constexpr (Tl::BN == 256) {
#pragma unroll 1
    for (int jh = 0; jh < 2; ++jh)
      dequant_unit<BITS, HAS_MIN, 8, Tl::RAW_ROW, Tl::BN>(
          a, raw, scs, Bs, fb, ch, (p >> 3) + 16 * jh, 0);
  } else {
    dequant_unit<BITS, HAS_MIN, 4, Tl::RAW_ROW, Tl::BN>(
        a, raw, scs, Bs, fb, ch, p >> 4, 4 * ((p >> 3) & 1));
  }
}

// y = A (M, d_in) bf16 @ dequant(planes) (d_in, d_out), epilogue EPI.
// grid (d_out / BN, ceil(M / 128), splits), block Tile<BN>::THREADS,
// cluster (1, 1, splits): block z of a tile's cluster walks groups [z, z +
// 1) * d_in / 64 / splits. Dynamic shared memory Ring<BITS, BN>::SMEM.
template <int EPI, int BN_, int BITS, bool HAS_MIN>
__global__ void __launch_bounds__(Tile<BN_>::THREADS, 1)
prefill_gemm_kernel(GemmArgs a) {
  using Tl = Tile<BN_>;
  using Rg = Ring<BITS, Tl::BN>;
  constexpr int BN = Tl::BN, STAGES = Rg::STAGES, LAG = Rg::LAG;
  constexpr int RED_ROW = Tl::RED_ROW;
  extern __shared__ unsigned char gemm_smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gemm_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Rg::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* raw_full = empty + STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * GBM;
  const int steps = a.d_in / GBK / a.splits;
  const int g0 = blockIdx.z * steps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], Tl::PRODUCERS);   // the producers' threads
      mbar_init(&empty[s], 8);              // the consumers' warps
      mbar_init(&raw_full[s], GCONSUMERS);  // the consumers' copies
    }
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroups: step d's raw bytes (the consumers load them)
    // dequantized into weight tile d % BSTAGES once step d - BSTAGES is
    // consumed
    const int p = threadIdx.x - GCONSUMERS;
    // the first stages' weight rows into L2 while the kernel before runs
    for (int i = p; i < min(steps, STAGES) * Rg::RAW_ROWS; i += Tl::PRODUCERS) {
      const uint8_t* row =
          a.lv + raw_row<BITS>(i % Rg::RAW_ROWS,
                               (g0 + i / Rg::RAW_ROWS) * QK, a.d_in) * a.d_out
          + n0;
      for (int u = 0; u < BN; u += 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(row + u));
    }
    for (int d = 0; d < steps; ++d) {
      if (d >= Rg::BSTAGES) {
        const int x = d - Rg::BSTAGES;
        mbar_wait(&empty[x % STAGES], (x / STAGES) & 1);
      }
      mbar_wait(&raw_full[d % STAGES], (d / STAGES) & 1);
      dequant_stage<BN, BITS, HAS_MIN>(
          a, ring, d % STAGES, ring + Rg::B + (d % Rg::BSTAGES) * Rg::B_BYTES,
          g0 + d, p);
      fence_proxy_async();
      mbar_arrive(&full[d % STAGES]);
    }
    pdl_trigger();
  } else {
    // consumer warpgroups: rows 64 wg .. 64 wg + 63 of the tile, which
    // each loads itself LAG steps ahead (the slot it reuses held its own
    // step it - 2, whose products are done), and between them each step's
    // raw weight bytes for the producers (step it - 2's were dequantized
    // before step it - 1 was handed over)
    const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
    const int ct = threadIdx.x & 127;
    float* bias_s = reinterpret_cast<float*>(ring + Rg::BIAS);
    for (int i = threadIdx.x; i < BN; i += GCONSUMERS)
      bias_s[i] = a.e.bias[n0 + i];
    named_barrier(2, GCONSUMERS);
    pdl_wait();
    for (int it = 0; it < LAG; ++it) {
      if (it < steps) {
        load_a<BITS, BN>(a, ring, it % STAGES, g0 + it, m0, wg, ct);
        load_raw<BN, BITS, HAS_MIN>(a, ring, it % STAGES, g0 + it, n0,
                                     threadIdx.x);
        cp_async_mbar_arrive(&raw_full[it % STAGES]);
      }
      cp_async_commit();
    }
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    for (int it = 0; it < steps; ++it) {
      const int s = it % STAGES;
      if (it + LAG < steps) {
        const int x = it + LAG;
        load_a<BITS, BN>(a, ring, x % STAGES, g0 + x, m0, wg, ct);
        load_raw<BN, BITS, HAS_MIN>(a, ring, x % STAGES, g0 + x, n0,
                                     threadIdx.x);
        cp_async_mbar_arrive(&raw_full[x % STAGES]);
      }
      cp_async_commit();
      cp_async_wait<LAG>();
      fence_proxy_async();
      named_barrier(3 + wg, 128);   // the warpgroup's rows of step it landed
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned abase =
          smem_addr(ring + Rg::A + s * Rg::A_BYTES) + wg * 64 * 128;
      const unsigned bbase =
          smem_addr(ring + Rg::B + (it % Rg::BSTAGES) * Rg::B_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bn<BN>(d, wgmma_desc(abase + 32 * kk),
                     wgmma_desc(bbase + 32 * kk));
      wgmma_commit();
      if (it > 0) {
        wgmma_wait<1>();   // step it - 1's products are done: free its stage
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
    pdl_trigger();
    // accumulator i: row 16 w4 + g + 8 ((i & 3) >> 1), column 8 (i >> 2) +
    // 2t + (i & 1) of this warpgroup's 64 rows
    const int r0 = wg * 64 + w4 * 16 + g;
    if (EPI != EPI_RESID && a.splits == 1) {
      // the bf16 outputs: staged as a (128, BN) tile in shared memory (both
      // warpgroups done with the ring), then stored in 16-byte rows pieces
      constexpr int SROW = BN + 8;   // staged row (bf16): other banks a row
      __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring);
      named_barrier(2, GCONSUMERS);
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const int row = r0 + 8 * ((i & 3) >> 1), lc = 8 * (i >> 2) + 2 * t;
        float y0 = d[i] + bias_s[lc], y1 = d[i + 1] + bias_s[lc + 1];
        if (EPI == EPI_GELU) {
          y0 = 0.5f * y0 * (1.0f + erff(y0 * 0.70710678118654752f));
          y1 = 0.5f * y1 * (1.0f + erff(y1 * 0.70710678118654752f));
        } else if (n0 + lc < a.e.D) {
          y0 *= a.e.scale;
          y1 *= a.e.scale;
        }
        *reinterpret_cast<uint32_t*>(tile + row * SROW + lc) =
            pack2_bf16(y0, y1);
      }
      named_barrier(2, GCONSUMERS);
      for (int e = threadIdx.x; e < GBM * (BN / 8); e += GCONSUMERS) {
        const int row = e / (BN / 8), lc = 8 * (e % (BN / 8));
        const int grow = m0 + row, col = n0 + lc;
        if (grow >= a.M) continue;
        __nv_bfloat16* dst;
        if (EPI == EPI_GELU)
          dst = a.e.out + (size_t)grow * a.d_out + col;
        else if (col < a.e.D)
          dst = a.e.out + (size_t)grow * a.e.D + col;
        else if (col < 2 * a.e.D)
          dst = a.e.k + (size_t)grow * a.e.D + col - a.e.D;
        else
          dst = a.e.v + (size_t)grow * a.e.D + col - 2 * a.e.D;
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(tile + row * SROW + lc);
      }
      return;
    }
    if (a.splits == 1) {
      // the residual: column blocks of 32 at a time, their residual loads
      // all issued before the first store
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) {
        float b[4][2], xr[4][2][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int lc = 8 * (4 * q + jj) + 2 * t, col = n0 + lc;
          const float2 bv = *reinterpret_cast<const float2*>(bias_s + lc);
          b[jj][0] = bv.x;
          b[jj][1] = bv.y;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = m0 + r0 + 8 * hh;
            float2 xv = make_float2(0.f, 0.f);
            if (EPI == EPI_RESID && row < a.M)
              xv = *reinterpret_cast<const float2*>(
                  a.e.x + (size_t)row * a.d_out + col);
            xr[jj][hh][0] = xv.x;
            xr[jj][hh][1] = xv.y;
          }
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = m0 + r0 + 8 * hh, i = 4 * (4 * q + jj) + 2 * hh;
            if (row < a.M)
              store_out<EPI, 2>(a.e, row, n0 + 8 * (4 * q + jj) + 2 * t,
                                a.d_out, &d[i], b[jj], xr[jj][hh]);
          }
      }
      return;
    }
    named_barrier(2, GCONSUMERS);   // both warpgroups are done with the ring
    float* red = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int row = r0 + 8 * ((i & 3) >> 1);
      *reinterpret_cast<float2*>(red + row * RED_ROW + 8 * (i >> 2) + 2 * t) =
          make_float2(d[i], d[i + 1]);
    }
  }
  if (a.splits == 1) return;

  // the splits of a tile are one cluster: block z sums rows [z, z + 1) *
  // 128 / splits of the tile over the blocks 0, 1, ... in order
  // (distributed shared memory), 4 columns a thread, then applies the
  // epilogue (the producers too: they wait here for the kernel before)
  pdl_wait();
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float* red = reinterpret_cast<float*>(ring);
  const int rows = GBM / a.splits;
  for (int e = threadIdx.x; e < rows * BN / 4; e += Tl::THREADS) {
    const int row = blockIdx.z * rows + e / (BN / 4), col = 4 * (e % (BN / 4));
    float4* mine = reinterpret_cast<float4*>(red + row * RED_ROW + col);
    float4 part[MAX_SPLITS];
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < a.splits) part[k] = *cluster.map_shared_rank(mine, k);
    const bool live = m0 + row < a.M;
    const float4 bv = *reinterpret_cast<const float4*>(
        ring + Rg::BIAS + col * sizeof(float));
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (EPI == EPI_RESID && live)
      xv = *reinterpret_cast<const float4*>(
          a.e.x + (size_t)(m0 + row) * a.d_out + n0 + col);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < a.splits) {
        v[0] += part[k].x;
        v[1] += part[k].y;
        v[2] += part[k].z;
        v[3] += part[k].w;
      }
    const float b[4] = {bv.x, bv.y, bv.z, bv.w};
    const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
    if (live) store_out<EPI, 4>(a.e, m0 + row, n0 + col, a.d_out, v, b, xr);
  }
  cluster.sync();   // the other blocks read this one's partials until here
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 (lo in the low half) as one fragment register
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Stage rows [c0, c0 + 64) of one head of k or v (row stride D) into buf
// (64 rows of AKS bf16) by cp.async, uncommitted; rows at or past nk zero.
__device__ __forceinline__ void stage_keys(__nv_bfloat16* buf,
                                           const __nv_bfloat16* src, int D,
                                           int c0, int nk) {
  for (int i = threadIdx.x; i < AKC * 8; i += blockDim.x) {
    const int r = i >> 3, u = i & 7;
    __nv_bfloat16* dst = buf + r * AKS + u * 8;
    if (c0 + r < nk)
      cp_async16(dst, src + (size_t)(c0 + r) * D + u * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Score row stride (floats) for prompts of T tokens: the causal span
// rounded up to 16 keys, plus 8 so that rows fall on other banks.
__host__ __device__ inline int score_row(int T) { return (T + 15) / 16 * 16 + 8; }

// Query rows per attention block: 16 a warp, at most AQ, no more than the
// prompt needs.
inline int attn_rows(int T) {
  const int r = (T + 15) / 16 * 16;
  return r < AQ ? r : AQ;
}

// Causal attention of `rows` (attn_rows(T)) query rows of one (prompt,
// head): grid (ceil(T/rows), H, R), block 2 * rows (warp w: rows 16w ..
// 16w+15), dynamic shared memory rows * score_row(T) floats + two staged K
// and two staged V chunks. q: (M, D) bf16 pre-scaled queries; k, v: (M, D)
// bf16 rows of this layer; ctx (M, D) bf16.
__global__ void __launch_bounds__(ATHREADS)
causal_attn_kernel(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, int T, int D,
                   __nv_bfloat16* ctx) {
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const int SR = score_row(T), rows = blockDim.x / 2;
  float* S = reinterpret_cast<float*>(attn_smem);          // (rows, SR) f32
  __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(S + rows * SR);
  __nv_bfloat16* vbuf = kbuf + 2 * AKC * AKS;
  const int t0 = blockIdx.x * rows, h = blockIdx.y;
  const size_t base = (size_t)blockIdx.z * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nk = min(t0 + rows, T);          // keys any row here sees
  const int nk16 = (nk + 15) / 16 * 16;
  // keys this warp's rows see, rounded up to the k16 steps
  const int nkw = min(nk16, (min(t0 + 16 * warp + 16, T) + 15) / 16 * 16);
  const __nv_bfloat16* kh = k + base * D + h * DK;
  const __nv_bfloat16* vh = v + base * D + h * DK;
  pdl_trigger();
  pdl_wait();

  // the first K and V chunks in flight, then this warp's query fragments
  // (A of m16n8k16) over the head's 4 k16 steps
  const int chunks = (nk + AKC - 1) / AKC;
  stage_keys(kbuf, kh, D, 0, nk);
  stage_keys(vbuf, vh, D, 0, nk);
  cp_async_commit();
  uint32_t qa[4][4];
  {
    const int r0 = t0 + 16 * warp + g, r1 = r0 + 8;
    const __nv_bfloat16* q0 = q + (base + r0) * D + h * DK + 2 * t;
    const __nv_bfloat16* q1 = q + (base + r1) * D + h * DK + 2 * t;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      qa[kc][0] = r0 < T ? ld32(q0 + 16 * kc) : 0u;
      qa[kc][1] = r1 < T ? ld32(q1 + 16 * kc) : 0u;
      qa[kc][2] = r0 < T ? ld32(q0 + 16 * kc + 8) : 0u;
      qa[kc][3] = r1 < T ? ld32(q1 + 16 * kc + 8) : 0u;
    }
  }

  // scores: S[row][key] = q . k in f32 for the keys this warp's rows see
  for (int chn = 0; chn < chunks; ++chn) {
    if (chn + 1 < chunks) {
      stage_keys(kbuf + ((chn + 1) & 1) * AKC * AKS, kh, D, (chn + 1) * AKC,
                 nk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kb = kbuf + (chn & 1) * AKC * AKS;
    const int c0 = chn * AKC;
#pragma unroll
    for (int nt = 0; nt < AKC / 8; ++nt) {
      const int key0 = c0 + nt * 8;
      if (key0 >= nkw) break;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const __nv_bfloat16* bp = kb + (nt * 8 + g) * AKS + kc * 16 + 2 * t;
        mma_bf16_16816(c, qa[kc], ld32(bp), ld32(bp + 8));
      }
      float* sp = S + (16 * warp + g) * SR + key0 + 2 * t;
      *reinterpret_cast<float2*>(sp) = make_float2(c[0], c[1]);
      *reinterpret_cast<float2*>(sp + 8 * SR) = make_float2(c[2], c[3]);
    }
    __syncthreads();   // the buffer is restaged two chunks on
  }

  // the full softmax of each row over its keys s <= t, normalised, then
  // rounded to bf16 in place (the row's first nkw bf16 slots); keys past
  // t weigh 0. A lane keeps its 16 values in registers across the rewrite.
  constexpr int PER_LANE = MAX_T / 32;
  for (int i = 0; i < 16; ++i) {
    const int row = 16 * warp + i, tq = t0 + row;
    if (tq >= T) break;
    const float* sr = S + row * SR;
    float mx = -INFINITY;
    for (int s = lane; s <= tq; s += 32) mx = fmaxf(mx, sr[s]);
    mx = warp_max(mx);
    float p[PER_LANE], l = 0.f;
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int s = lane + 32 * u;
      p[u] = s <= tq ? expf(sr[s] - mx) : 0.f;
      l += p[u];
    }
    l = warp_sum(l);
    __syncwarp();
    __nv_bfloat16* pr = reinterpret_cast<__nv_bfloat16*>(S + row * SR);
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int s = lane + 32 * u;
      if (s < nkw) pr[s] = __float2bfloat16(s <= tq ? p[u] / l : 0.f);
    }
  }
  __syncwarp();

  // P.V: this warp's 16 rows x 64 columns, keys in 64-row chunks (the
  // first staged with the first K chunk)
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nt][c] = 0.f;
  const __nv_bfloat16* p0 =
      reinterpret_cast<const __nv_bfloat16*>(S + (16 * warp + g) * SR);
  const __nv_bfloat16* p1 =
      reinterpret_cast<const __nv_bfloat16*>(S + (16 * warp + g + 8) * SR);
  for (int chn = 0; chn < chunks; ++chn) {
    if (chn + 1 < chunks) {
      stage_keys(vbuf + ((chn + 1) & 1) * AKC * AKS, vh, D, (chn + 1) * AKC,
                 nk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* vb = vbuf + (chn & 1) * AKC * AKS;
    const int c0 = chn * AKC;
#pragma unroll
    for (int kk = 0; kk < AKC; kk += 16) {
      const int key = c0 + kk;
      if (key >= nkw) break;
      uint32_t pa[4];
      pa[0] = ld32(p0 + key + 2 * t);
      pa[1] = ld32(p1 + key + 2 * t);
      pa[2] = ld32(p0 + key + 8 + 2 * t);
      pa[3] = ld32(p1 + key + 8 + 2 * t);
      const __nv_bfloat16* v0 = vb + (kk + 2 * t) * AKS + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* vp = v0 + nt * 8;
        const uint32_t b0 = pack2(vp[0], vp[AKS]);
        const uint32_t b1 = pack2(vp[8 * AKS], vp[9 * AKS]);
        mma_bf16_16816(o[nt], pa, b0, b1);
      }
    }
    __syncthreads();
  }
  const int r0 = t0 + 16 * warp + g, r1 = r0 + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = h * DK + nt * 8 + 2 * t;
    if (r0 < T)
      *reinterpret_cast<__nv_bfloat162*>(ctx + (base + r0) * D + col) =
          __floats2bfloat162_rn(o[nt][0], o[nt][1]);
    if (r1 < T)
      *reinterpret_cast<__nv_bfloat162*>(ctx + (base + r1) * D + col) =
          __floats2bfloat162_rn(o[nt][2], o[nt][3]);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Blocks along d_in: doubled while the tiles (bn columns wide) of a
// SPLIT_ROWS-row group fill at most half the card, up to a cluster of 8,
// each split a whole number of groups. The count, and with it the order of
// each output's f32 sums, is a function of the weight's widths alone: a
// refill row's results are the same whatever the number of rows beside it.
// 512 rows sits between the refill shapes this kernel takes (16 to 1024
// rows): 347M's splits (qkv, o, fc1, fc2) are 2, 4, 2, 4.
constexpr int SPLIT_ROWS = 512;

int gemm_splits(int d_in, int d_out, int bn) {
  const int tiles = (d_out / bn) * (SPLIT_ROWS / GBM);
  const int groups = d_in / GBK;
  int s = 1;
  while (2 * s <= MAX_SPLITS && tiles * 2 * s <= sm_count()
         && groups % (2 * s) == 0)
    s *= 2;
  return s;
}

template <int EPI, int BN, int BITS, bool HAS_MIN>
void launch_gemm_fmt(const GemmArgs& a, cudaStream_t st) {
  using Tl = Tile<BN>;
  constexpr int SMEM = Ring<BITS, BN>::SMEM;
  auto kernel = prefill_gemm_kernel<EPI, BN, BITS, HAS_MIN>;
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM);
    opted_in = true;
  }
  launch_dependent_ex(kernel,
                      dim3(a.d_out / Tl::BN, (a.M + GBM - 1) / GBM, a.splits),
                      dim3(Tl::THREADS), dim3(1, 1, a.splits), SMEM, st, a);
}

// The tile width of epilogue EPI at d_out (a multiple of 128): 256 where
// it divides a non-residual d_out, else 128.
int tile_bn(int epi, int d_out) {
  return epi != EPI_RESID && d_out % 256 == 0 ? 256 : 128;
}

// One projection of layer l at M rows of A through prefill_gemm_kernel.
template <int EPI>
void launch_gemm(const __nv_bfloat16* A, int M, int d_in, int d_out,
                 const Proj& p, int l, float off, const Epi& e,
                 cudaStream_t st) {
  const size_t lv_stride = level_rows(d_in, p.bits) * d_out;
  const size_t sc_stride = (size_t)(d_in / QK) * d_out;
  GemmArgs a;
  a.A = A;
  a.M = M;
  a.d_in = d_in;
  a.d_out = d_out;
  a.lv = p.lv + l * lv_stride;
  a.sc = p.sc + l * sc_stride;
  a.mn = p.mn != nullptr ? p.mn + l * sc_stride : nullptr;
  a.off = off;
  const int bn = tile_bn(EPI, d_out);
  a.splits = gemm_splits(d_in, d_out, bn);
  a.e = e;
  with_format(p.bits, a.mn != nullptr, [&](auto fmt) {
    using F = decltype(fmt);
    if constexpr (EPI == EPI_RESID)
      launch_gemm_fmt<EPI, 128, F::BITS, F::HAS_MIN>(a, st);
    else if (bn == 256)
      launch_gemm_fmt<EPI, 256, F::BITS, F::HAS_MIN>(a, st);
    else
      launch_gemm_fmt<EPI, 128, F::BITS, F::HAS_MIN>(a, st);
  });
}

// d_in whole groups; d_out whole tiles of 128 columns
bool gemm_widths_ok(int d_in, int d_out) {
  return d_in > 0 && d_in % GBK == 0 && d_out > 0 && d_out % 128 == 0;
}

}  // namespace

// x: (R*T, D) f32, updated in place to the final hidden state. Scratch the
// wrapper allocates: hb, qb, ctx (R*T, D) bf16, ff (R*T, F) bf16. n_gemm:
// a host int the entry adds its GEMM launches to, or null.
extern "C" int bgt_prefill(
    float* x, int R, int T, int L, int D, int F, int H, float eps, int offset,
    int bits, const float* ln0w, const float* ln0b, const float* ln1w,
    const float* ln1b,
    const uint8_t* qkv_lv, const void* qkv_sc, const void* qkv_mn, const float* qkv_b,
    const uint8_t* o_lv, const void* o_sc, const void* o_mn, const float* o_b,
    const uint8_t* fc1_lv, const void* fc1_sc, const void* fc1_mn, const float* fc1_b,
    const uint8_t* fc2_lv, const void* fc2_sc, const void* fc2_mn, const float* fc2_b,
    void* k_rows, void* v_rows, void* hb, void* qb, void* ctx, void* ff,
    int* n_gemm, void* stream) {
  if (D != H * DK || R < 1 || T < 1 || T > MAX_T
      || !gemm_widths_ok(D, 3 * D) || !gemm_widths_ok(D, F)
      || !gemm_widths_ok(F, D)
      || !with_format(bits, qkv_mn != nullptr, [](auto) {}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = R * T;
  const Proj qkv = make_proj(qkv_lv, qkv_sc, qkv_mn, qkv_b, bits);
  const Proj o = make_proj(o_lv, o_sc, o_mn, o_b, bits);
  const Proj fc1 = make_proj(fc1_lv, fc1_sc, fc1_mn, fc1_b, bits);
  const Proj fc2 = make_proj(fc2_lv, fc2_sc, fc2_mn, fc2_b, bits);
  __nv_bfloat16* kr = static_cast<__nv_bfloat16*>(k_rows);
  __nv_bfloat16* vr = static_cast<__nv_bfloat16*>(v_rows);
  __nv_bfloat16* h = static_cast<__nv_bfloat16*>(hb);
  __nv_bfloat16* qbuf = static_cast<__nv_bfloat16*>(qb);
  __nv_bfloat16* cbuf = static_cast<__nv_bfloat16*>(ctx);
  __nv_bfloat16* fbuf = static_cast<__nv_bfloat16*>(ff);
  const float scale = 1.0f / sqrtf((float)DK);
  const float off = (float)offset;
  const int att_rows = attn_rows(T);
  const int att_smem = att_rows * score_row(T) * (int)sizeof(float)
                       + 4 * AKC * AKS * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      causal_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      att_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 att_grid((T + att_rows - 1) / att_rows, H, R);

  for (int l = 0; l < L; ++l) {
    __nv_bfloat16* krl = kr + (size_t)l * M * D;
    __nv_bfloat16* vrl = vr + (size_t)l * M * D;
    launch_dependent(ln_rows_kernel<256>, dim3(M), dim3(256), 1, st, (const float*)x,
                     D, ln0w + (size_t)l * D, ln0b + (size_t)l * D, eps, h);
    Epi e{};
    e.bias = qkv.b + (size_t)l * 3 * D;
    e.out = qbuf;
    e.k = krl;
    e.v = vrl;
    e.D = D;
    e.scale = scale;
    launch_gemm<EPI_QKV>(h, M, D, 3 * D, qkv, l, off, e, st);
    launch_dependent_ex(causal_attn_kernel, att_grid, dim3(2 * att_rows),
                        dim3(1, 1, 1), att_smem, st,
                        (const __nv_bfloat16*)qbuf, (const __nv_bfloat16*)krl,
                        (const __nv_bfloat16*)vrl, T, D, cbuf);
    e = Epi{};
    e.bias = o.b + (size_t)l * D;
    e.x = x;
    launch_gemm<EPI_RESID>(cbuf, M, D, D, o, l, off, e, st);
    launch_dependent(ln_rows_kernel<256>, dim3(M), dim3(256), 1, st, (const float*)x,
                     D, ln1w + (size_t)l * D, ln1b + (size_t)l * D, eps, h);
    e = Epi{};
    e.bias = fc1.b + (size_t)l * F;
    e.out = fbuf;
    launch_gemm<EPI_GELU>(h, M, D, F, fc1, l, off, e, st);
    e = Epi{};
    e.bias = fc2.b + (size_t)l * D;
    e.x = x;
    launch_gemm<EPI_RESID>(fbuf, M, F, D, fc2, l, off, e, st);
  }
  if (n_gemm != nullptr) *n_gemm += 4 * L;
  return (int)cudaGetLastError();
}

// One projection alone through prefill_gemm_kernel: A (M, d_in) bf16, the
// planes of one (d_in, d_out) weight, bias (d_out) f32; epi 0: q (M, D)
// bf16 scaled by `scale`, k and v (M, D) bf16 (d_out = 3 D); 1: x (M,
// d_out) f32 updated to (x + y) + bias; 2: out (M, d_out) bf16 GELU(y +
// bias).
extern "C" int bgt_prefill_gemm(const void* A, int M, int d_in, int d_out,
                                const uint8_t* lv, const void* sc,
                                const void* mn, int offset, int bits, int epi,
                                const float* bias, float* x, void* out,
                                void* k, void* v, float scale, void* stream) {
  if (M < 1 || !gemm_widths_ok(d_in, d_out) || epi < 0 || epi > 2
      || (epi == EPI_QKV && d_out % 3 != 0)
      || !with_format(bits, mn != nullptr, [](auto) {}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Proj p = make_proj(lv, sc, mn, bias, bits);
  Epi e{};
  e.bias = bias;
  e.x = x;
  e.out = static_cast<__nv_bfloat16*>(out);
  e.k = static_cast<__nv_bfloat16*>(k);
  e.v = static_cast<__nv_bfloat16*>(v);
  e.D = d_out / 3;
  e.scale = scale;
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(A);
  const float off = (float)offset;
  if (epi == EPI_QKV)
    launch_gemm<EPI_QKV>(a, M, d_in, d_out, p, 0, off, e, st);
  else if (epi == EPI_RESID)
    launch_gemm<EPI_RESID>(a, M, d_in, d_out, p, 0, off, e, st);
  else
    launch_gemm<EPI_GELU>(a, M, d_in, d_out, p, 0, off, e, st);
  return (int)cudaGetLastError();
}
