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
// small ones. So the projections are a tiled tensor-core GEMM, unlike the
// decode GEMVs:
//   a 64-row x 128-column block tile; per k-step 32 packed rows, i.e. 32
//   low and 32 high level rows (the split-half nibbles, with their fifth
//   bits for Q5; the rows k and d_in/2 + k of the int8 plane for Q8_0;
//   qgemv.cuh's level fetch), dequantized into shared memory as bf16 with
//   `_qmm_dq`'s
//   rounding ((level - offset) * scale [+ min] in f32, one rounding), the
//   matching 64 activation columns staged beside them; four warps of
//   mma.sync m16n8k16 (bf16 in, f32 accumulation), each 32 x 64; bias,
//   q scaling, GELU or the residual in the epilogue.
// The products are exact in f32, so only the summation order differs from
// the plain version. Per layer, one host call launching:
//   LayerNorm-0 -> bf16 rows
//   qkv GEMM: q * (1/sqrt(Dk)) to bf16, the K/V rows of layer l (bf16)
//   causal attention per (prompt, head, 16 query rows): f32 scores for the
//     whole causal row in shared memory (T <= 512: 32 KB), the full
//     softmax normalised before p rounds to bf16 (the TPU kernel's order,
//     which needs the whole row), then P.V against bf16 V
//   o GEMM + residual, LayerNorm-1, fc1 GEMM + exact-erf GELU (bf16 out),
//   fc2 GEMM + residual
// Rows past a prompt's length compute causal padding values, as in the
// TPU kernel and the plain version. No wgmma, TMA or persistent blocks yet.
#include "decode_layers.cuh"

using namespace bgt;

namespace {

constexpr int GBM = 64;                // GEMM block rows
constexpr int GBN = 128;               // GEMM block columns
constexpr int GPR = 32;                // packed level rows per k-step
constexpr int GKS = 2 * GPR + 8;       // shared row stride (bf16), padded
constexpr int GTHREADS = 128;
constexpr int AQ = 16;                 // query rows per attention block
constexpr int AKC = 64;                // keys staged per attention chunk
constexpr int ATHREADS = 128;
constexpr int MAX_T = 512;             // longest prompt (the routing caps' too)

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 rounded to bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// (level - offset) * scale [+ min] in f32; the caller rounds it to bf16
template <bool HAS_MIN>
__device__ __forceinline__ float dq(int lvl, float off, float s, float m) {
  float w = __fmul_rn((float)lvl - off, s);
  if (HAS_MIN) w = __fadd_rn(w, m);
  return w;
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int EPI>
__device__ __forceinline__ void epilogue(const Epi& e, int row, int col,
                                         int d_out, float acc) {
  if (EPI == EPI_RESID) {
    // residual order of the TPU kernel: (x + proj) + bias
    float* xp = e.x + (size_t)row * d_out + col;
    *xp = (*xp + acc) + e.bias[col];
    return;
  }
  const float y = acc + e.bias[col];
  if (EPI == EPI_GELU) {
    e.out[(size_t)row * d_out + col] =
        __float2bfloat16(0.5f * y * (1.0f + erff(y * 0.70710678118654752f)));
  } else if (col < e.D) {
    e.out[(size_t)row * e.D + col] = __float2bfloat16(y * e.scale);
  } else if (col < 2 * e.D) {
    e.k[(size_t)row * e.D + col - e.D] = __float2bfloat16(y);
  } else {
    e.v[(size_t)row * e.D + col - 2 * e.D] = __float2bfloat16(y);
  }
}

// y = A (M, d_in) bf16 @ dequant(planes) (d_in, d_out), epilogue EPI.
// grid (d_out / 128, ceil(M / 64)), block 128; d_in % 64 == 0.
// Shared k-slot j of a step at packed row p0: level row p0 + j (j < 32,
// low) or d_in/2 + p0 + j - 32 (high); both tiles use it. BITS: the level
// format of `lv` (qgemv.cuh).
template <int EPI, int BITS, bool HAS_MIN>
__global__ void __launch_bounds__(GTHREADS)
qgemm_kernel(const __nv_bfloat16* __restrict__ A, int M, int d_in, int d_out,
             const uint8_t* __restrict__ lv, const __nv_bfloat16* __restrict__ sc,
             const __nv_bfloat16* __restrict__ mn, float off, Epi e) {
  __shared__ __align__(16) __nv_bfloat16 As[GBM * GKS];
  __shared__ __align__(16) __nv_bfloat16 Bs[GBN * GKS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;        // warp tile 32 x 64
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int half = d_in / 2, nbh = d_in / (2 * QK);
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  for (int p0 = 0; p0 < half; p0 += GPR) {
    // activations: 8 pieces of 8 bf16 per row (4 low, 4 high columns)
    for (int i = tid; i < GBM * 8; i += GTHREADS) {
      const int m = i >> 3, c = i & 7;
      const int col = (c < 4 ? p0 : half + p0 - 4 * 8) + c * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + m < M)
        v = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + m) * d_in + col);
      *reinterpret_cast<uint4*>(As + m * GKS + c * 8) = v;
    }
    // weights: thread tid dequantizes column n0 + tid into Bs row tid
    {
      const int col = n0 + tid;
      const int blo = p0 / QK;
      const float slo = __bfloat162float(sc[(size_t)blo * d_out + col]);
      const float shi = __bfloat162float(sc[(size_t)(blo + nbh) * d_out + col]);
      float mlo = 0.f, mhi = 0.f;
      if (HAS_MIN) {
        mlo = __bfloat162float(mn[(size_t)blo * d_out + col]);
        mhi = __bfloat162float(mn[(size_t)(blo + nbh) * d_out + col]);
      }
      __nv_bfloat16* bp = Bs + tid * GKS;
      FifthBit fb(p0, d_in);
#pragma unroll
      for (int j = 0; j < GPR; j += 8) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int r = 0; r < 8; r += 2) {
          int l0, h0, l1, h1;
          fetch_levels1<BITS>(lv, fb, j + r, half, d_out, col, l0, h0);
          fetch_levels1<BITS>(lv, fb, j + r + 1, half, d_out, col, l1, h1);
          lo[r / 2] = pack_bf16(dq<HAS_MIN>(l0, off, slo, mlo),
                                dq<HAS_MIN>(l1, off, slo, mlo));
          hi[r / 2] = pack_bf16(dq<HAS_MIN>(h0, off, shi, mhi),
                                dq<HAS_MIN>(h1, off, shi, mhi));
        }
        *reinterpret_cast<uint4*>(bp + j) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(bp + GPR + j) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 2 * GPR; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* ap = As + (wm * 32 + mi * 16 + g) * GKS + kk + tg * 2;
        a[mi][0] = ld32(ap);
        a[mi][1] = ld32(ap + 8 * GKS);
        a[mi][2] = ld32(ap + 8);
        a[mi][3] = ld32(ap + 8 * GKS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const __nv_bfloat16* bq = Bs + (wn * 64 + ni * 8 + g) * GKS + kk + tg * 2;
        const uint32_t b0 = ld32(bq), b1 = ld32(bq + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma16816(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * 32 + mi * 16 + g + 8 * hh;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          epilogue<EPI>(e, row, n0 + wn * 64 + ni * 8 + tg * 2 + c, d_out,
                        acc[mi][ni][hh * 2 + c]);
    }
}

// LayerNorm of each row (the TPU kernels' `_ln`: mean, then the mean
// squared deviation) rounded to bf16. grid M, block 256.
__global__ void __launch_bounds__(256)
ln_rows_kernel(const float* x, int D, const float* w, const float* b,
               float eps, __nv_bfloat16* out) {
  __shared__ float scratch[32];
  const float* xr = x + (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) s += xr[i];
  const float mean = block_sum(s, scratch) / (float)D;
  float q = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float c = xr[i] - mean;
    q += c * c;
  }
  const float rstd = 1.0f / sqrtf(block_sum(q, scratch) / (float)D + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    out[(size_t)blockIdx.x * D + i] =
        __float2bfloat16((xr[i] - mean) * rstd * w[i] + b[i]);
}

// Causal attention of 16 query rows of one (prompt, head): grid
// (ceil(T/16), H, R), block 128, dynamic shared memory
// (16*64 + 64*65 + 16*T) floats. q: (M, D) bf16 pre-scaled queries; k, v:
// (M, D) bf16 rows of this layer; ctx (M, D) bf16.
__global__ void __launch_bounds__(ATHREADS)
prefill_attn_kernel(const __nv_bfloat16* q, const __nv_bfloat16* k,
                    const __nv_bfloat16* v, int T, int D,
                    __nv_bfloat16* ctx) {
  extern __shared__ float smem[];
  float* qs = smem;                       // (AQ, DK)
  float* kv = qs + AQ * DK;               // (AKC, DK + 1) staged K or V
  float* sc = kv + AKC * (DK + 1);        // (AQ, T) scores, then bf16 p
  const int t0 = blockIdx.x * AQ, h = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = min(AQ, T - t0);
  const int nk = t0 + nq;                 // keys any of these rows sees
  const size_t base = (size_t)r * T;
  for (int i = tid; i < AQ * DK; i += ATHREADS) {
    const int qi = i / DK, d = i % DK;
    qs[i] = qi < nq ? __bfloat162float(q[(base + t0 + qi) * D + h * DK + d])
                    : 0.f;
  }
  // scores: thread (key s, rows i0, i0 + 2, ...) over 64-key chunks
  const int s_l = tid % AKC, i0 = tid / AKC;
  for (int c0 = 0; c0 < nk; c0 += AKC) {
    const int nc = min(AKC, nk - c0);
    __syncthreads();
    for (int i = tid; i < nc * DK; i += ATHREADS) {
      const int s = i / DK, d = i % DK;
      kv[s * (DK + 1) + d] =
          __bfloat162float(k[(base + c0 + s) * D + h * DK + d]);
    }
    __syncthreads();
    if (s_l < nc)
      for (int qi = i0; qi < AQ; qi += ATHREADS / AKC) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < DK; ++d)
          dot += qs[qi * DK + d] * kv[s_l * (DK + 1) + d];
        sc[qi * T + c0 + s_l] = dot;
      }
  }
  __syncthreads();
  // the full softmax of each row over its keys s <= t, normalised, then
  // rounded to bf16; keys past t weigh 0
  for (int qi = warp; qi < nq; qi += ATHREADS / 32) {
    float* row = sc + qi * T;
    const int t = t0 + qi;
    float mx = -INFINITY;
    for (int s = lane; s <= t; s += 32) mx = fmaxf(mx, row[s]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s <= t; s += 32) {
      const float p = expf(row[s] - mx);
      row[s] = p;
      l += p;
    }
    l = warp_sum(l);
    for (int s = lane; s < nk; s += 32)
      row[s] = s <= t ? bf16r(row[s] / l) : 0.f;
  }
  // P.V: thread (column d, rows i0, i0 + 2, ...)
  const int d = tid % DK, j0 = tid / DK;
  float a[AQ / 2];
#pragma unroll
  for (int j = 0; j < AQ / 2; ++j) a[j] = 0.f;
  for (int c0 = 0; c0 < nk; c0 += AKC) {
    const int nc = min(AKC, nk - c0);
    __syncthreads();
    for (int i = tid; i < nc * DK; i += ATHREADS) {
      const int s = i / DK, dd = i % DK;
      kv[s * (DK + 1) + dd] =
          __bfloat162float(v[(base + c0 + s) * D + h * DK + dd]);
    }
    __syncthreads();
    for (int s = 0; s < nc; ++s) {
      const float vv = kv[s * (DK + 1) + d];
#pragma unroll
      for (int j = 0; j < AQ / 2; ++j)
        a[j] += sc[(j0 + 2 * j) * T + c0 + s] * vv;
    }
  }
#pragma unroll
  for (int j = 0; j < AQ / 2; ++j) {
    const int qi = j0 + 2 * j;
    if (qi < nq)
      ctx[(base + t0 + qi) * D + h * DK + d] = __float2bfloat16(a[j]);
  }
}

// Layer l's GEMM: the level plane's layer stride follows the format.
template <int EPI>
void launch_gemm(const __nv_bfloat16* A, int M, int d_in, int d_out,
                 const Proj& p, int l, float off, const Epi& e,
                 cudaStream_t st) {
  const size_t lv_stride = level_rows(d_in, p.bits) * d_out;
  const size_t sc_stride = (size_t)(d_in / QK) * d_out;
  const dim3 grid(d_out / GBN, (M + GBM - 1) / GBM);
  const uint8_t* lv = p.lv + l * lv_stride;
  const __nv_bfloat16* sc = p.sc + l * sc_stride;
  const __nv_bfloat16* mn = p.mn != nullptr ? p.mn + l * sc_stride : nullptr;
  with_format(p.bits, mn != nullptr, [&](auto fmt) {
    using T = decltype(fmt);
    qgemm_kernel<EPI, T::BITS, T::HAS_MIN><<<grid, GTHREADS, 0, st>>>(
        A, M, d_in, d_out, lv, sc, mn, off, e);
  });
}

}  // namespace

// x: (R*T, D) f32, updated in place to the final hidden state. Scratch the
// wrapper allocates: hb, qb, ctx (R*T, D) bf16, ff (R*T, F) bf16.
extern "C" int bgt_prefill(
    float* x, int R, int T, int L, int D, int F, int H, float eps, int offset,
    int bits, const float* ln0w, const float* ln0b, const float* ln1w,
    const float* ln1b,
    const uint8_t* qkv_lv, const void* qkv_sc, const void* qkv_mn, const float* qkv_b,
    const uint8_t* o_lv, const void* o_sc, const void* o_mn, const float* o_b,
    const uint8_t* fc1_lv, const void* fc1_sc, const void* fc1_mn, const float* fc1_b,
    const uint8_t* fc2_lv, const void* fc2_sc, const void* fc2_mn, const float* fc2_b,
    void* k_rows, void* v_rows, void* hb, void* qb, void* ctx, void* ff,
    void* stream) {
  if (D != H * DK || R < 1 || T < 1 || T > MAX_T || D % GBN != 0
      || F % GBN != 0 || (3 * D) % GBN != 0
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
  const int att_smem = (AQ * DK + AKC * (DK + 1) + AQ * T) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      att_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 att_grid((T + AQ - 1) / AQ, H, R);

  for (int l = 0; l < L; ++l) {
    __nv_bfloat16* krl = kr + (size_t)l * M * D;
    __nv_bfloat16* vrl = vr + (size_t)l * M * D;
    ln_rows_kernel<<<M, 256, 0, st>>>(x, D, ln0w + (size_t)l * D,
                                      ln0b + (size_t)l * D, eps, h);
    Epi e{};
    e.bias = qkv.b + (size_t)l * 3 * D;
    e.out = qbuf;
    e.k = krl;
    e.v = vrl;
    e.D = D;
    e.scale = scale;
    launch_gemm<EPI_QKV>(h, M, D, 3 * D, qkv, l, off, e, st);
    prefill_attn_kernel<<<att_grid, ATHREADS, att_smem, st>>>(qbuf, krl, vrl,
                                                              T, D, cbuf);
    e = Epi{};
    e.bias = o.b + (size_t)l * D;
    e.x = x;
    launch_gemm<EPI_RESID>(cbuf, M, D, D, o, l, off, e, st);
    ln_rows_kernel<<<M, 256, 0, st>>>(x, D, ln1w + (size_t)l * D,
                                      ln1b + (size_t)l * D, eps, h);
    e = Epi{};
    e.bias = fc1.b + (size_t)l * F;
    e.out = fbuf;
    launch_gemm<EPI_GELU>(h, M, D, F, fc1, l, off, e, st);
    e = Epi{};
    e.bias = fc2.b + (size_t)l * D;
    e.x = x;
    launch_gemm<EPI_RESID>(fbuf, M, F, D, fc2, l, off, e, st);
  }
  return (int)cudaGetLastError();
}
