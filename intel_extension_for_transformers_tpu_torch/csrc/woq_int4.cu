// K1: int4 weight-only-quantized GEMM for Hopper (sm_90a).
//
// Replaces intel_extension_for_transformers_tpu/ops/quant_matmul.py
// ::_woq_kernel_4bit (launched from _pallas_woq).
//
//   out (M, N) = x (M, K) . dequant(W)
//
// W is int8 (K/2, N) in the khalf layout: the low nibble holds rows
// [0, K/2), the high nibble rows [K/2, K), so x[:, :K/2] pairs with the low
// plane and x[:, K/2:] with the high plane. Scales (and asym zero points) are
// f32 (K/g, N); the high half's group rows start at G/2. Schemes: sym (signed
// nibbles), asym (unsigned nibbles minus zero points), codebook (nf4/fp4, a
// 16-entry table). Every shape the packing allows is taken: M, N and K/2 are
// masked at their edges here, so the caller pads nothing.
//
// Numerics follow the Pallas kernel. Compute is bf16 when x is bf16 and f32
// when x is f32. In bf16 the scale and zero point are rounded to bf16 and
// q*s (or (q-z)*s) is rounded to bf16 before the product; in f32 every step
// is f32 (no TF32). The accumulator is f32; the output is f32 or bf16.
//
// Bound on the H100: at the small M this kernel serves (M < 1024: decode,
// reranker pairs, single-query index scans) the packed weight, K*N/2 bytes,
// is the traffic that matters (a Llama-2-7B 4096 -> 11008 product: 22.5 MB,
// 6.7 us at 3.35 TB/s); as M grows the FMA rate takes over.
// Design:
//  * M <= 8, a split-K GEMV (woq_int4_gemv): a block owns 128 columns. Each
//    lane reads adjacent columns of a packed row as one word, 16 bytes
//    (8 lanes a row, 4 rows a warp) where N and the pointers allow, else 4
//    bytes (32 lanes a row), else byte by byte; a warp reads whole 128-byte
//    lines, 4 words in flight a lane. One word gives 2 x its bytes weights:
//    the low nibbles against x[r], the high against x[K/2 + r], with the
//    scale rows r/g and G/2 + r/g loaded once a group. The eight warps split
//    each group's packed rows; shuffles and a shared-memory sum end the
//    block. K/2 is split over blockIdx.y on group boundaries until the card
//    has about two blocks an SM; each block writes f32 partials and the last
//    block of a column strip to arrive (an int counter per strip,
//    __threadfence + atomicAdd) sums them in split order, writes out and
//    resets its counter to 0. One launch, no float atomics: every run gives
//    the same bits.
//  * 9 <= M < 1024, tiles: a block owns a BM x 64 output tile and walks K/2
//    in steps of 32 packed rows. Each step decodes every packed byte once,
//    both nibbles with their scales, into a float tile in shared memory that
//    all BM rows reuse, so the dequantized weight never reaches device
//    memory. The product is a SIMT FMA loop over a 4x4 (BM = 64) or 1x4
//    (BM = 16, for M <= 16) register tile per thread.
// Tensor cores (mma/wgmma) for the tiles are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBN = 64;        // output columns per block
constexpr int kTN = 4;         // output columns per thread
constexpr int kBKP = 32;       // packed rows per step (one lo and one hi K row each)

enum Scheme { kSym = 0, kAsym = 1, kCodebook = 2 };

// One nibble u in [0, 15] -> its dequantized value in the compute type. (The
// GEMV's dq below is the same rounding with s, z and the codebook rounded
// once a group.)
template <bool kBF16>
__device__ __forceinline__ float dequant(int u, float s, float z, const float* cb,
                                         int scheme) {
  float q;
  if (scheme == kCodebook) {
    q = kBF16 ? itx::round_bf16(cb[u]) : cb[u];
  } else if (scheme == kSym) {
    q = static_cast<float>(u >= 8 ? u - 16 : u);
  } else {
    q = static_cast<float>(u);
  }
  if (kBF16) s = itx::round_bf16(s);
  if (scheme == kAsym) {
    q = kBF16 ? itx::round_bf16(q - itx::round_bf16(z)) : q - z;
  }
  const float w = q * s;
  return kBF16 ? itx::round_bf16(w) : w;
}

// ---- M <= 8: split-K GEMV over 128-column strips --------------------------
constexpr int kGemvCols = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // weight words in flight per lane

// CPL columns a lane: 16 (one 16-byte word, 8 lanes a packed row) or 4 (one
// 4-byte word, 32 lanes a row); kVec false reads the CPL bytes one by one.
template <int CPL>
struct GemvShape {
  static constexpr int LPR = kGemvCols / CPL;  // lanes a packed row
  static constexpr int RPW = 32 / LPR;         // packed rows a warp reads at once
  static constexpr int RPB = kWarps * RPW;     // packed rows the block reads at once
};

template <int CPL, bool kVec>
__device__ __forceinline__ void load_words(const int8_t* w, size_t row, int n, int N,
                                           uint32_t word[CPL / 4]) {
  const int8_t* p = w + row * N + n;
  if constexpr (kVec && CPL == 16) {
    const uint4 t = n < N ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
    word[0] = t.x; word[1] = t.y; word[2] = t.z; word[3] = t.w;
  } else if constexpr (kVec) {
    word[0] = n < N ? __ldg(reinterpret_cast<const uint32_t*>(p)) : 0u;
  } else {
#pragma unroll
    for (int i = 0; i < CPL / 4; ++i) {
      word[i] = 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n + 4 * i + c < N) word[i] |= static_cast<uint32_t>(static_cast<uint8_t>(p[4 * i + c])) << (8 * c);
    }
  }
}

// CPL adjacent f32 values of row `row` of a (rows, N) array, 16-byte loads when kVec.
template <int CPL, bool kVec>
__device__ __forceinline__ void load_row(const float* a, size_t row, int n, int N, float v[CPL]) {
  const float* p = a + row * N + n;
#pragma unroll
  for (int i = 0; i < CPL / 4; ++i) {
    if constexpr (kVec) {
      const float4 t = n < N ? __ldg(reinterpret_cast<const float4*>(p) + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[4 * i + c] = n + 4 * i + c < N ? p[4 * i + c] : 0.f;
    }
  }
}

// dequant() with s, z (and cb) already rounded to the compute type.
template <bool kBF16>
__device__ __forceinline__ float dq(int u, float s, float z, const float* cb, int scheme) {
  float q;
  if (scheme == kCodebook) {
    q = cb[u];
  } else if (scheme == kSym) {
    q = static_cast<float>((u ^ 8) - 8);
  } else {
    q = kBF16 ? itx::round_bf16(static_cast<float>(u) - z) : static_cast<float>(u) - z;
  }
  const float w = q * s;
  return kBF16 ? itx::round_bf16(w) : w;
}

// a * b + c on bf16 pairs, rounded once (to nearest even) to bf16.
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
constexpr uint32_t kBf16x2One = 0x3F803F80u;
constexpr uint32_t kBf16x2NegZero = 0x80008000u;
constexpr uint32_t kBf16x2Sign = 0x80008000u;

template <typename TX, typename TO, int TM, int CPL, bool kVec>
__global__ void __launch_bounds__(kThreads)
woq_int4_gemv(const TX* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scales, const float* __restrict__ zeros,
              const float* __restrict__ codebook, TO* __restrict__ out, float* __restrict__ part,
              int* __restrict__ counters, int M, int N, int K, int group_size, int scheme,
              int k_chunk) {
  using Sh = GemvShape<CPL>;
  constexpr bool kBF16 = sizeof(TX) == 2;
  constexpr int NW = CPL / 4;  // 32-bit words a lane reads from a packed row
  __shared__ float red[kWarps][TM][kGemvCols];
  __shared__ float cbs[16];
  __shared__ int is_last;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int sub = lane / Sh::LPR;  // this lane's packed row among the warp's RPW
  const int c0 = (lane % Sh::LPR) * CPL;
  const int n = blockIdx.x * kGemvCols + c0;
  const int K2 = K / 2;
  const int G2 = K2 / group_size;  // groups per half
  const int r_begin = blockIdx.y * k_chunk;  // a multiple of group_size
  const int r_end = min(K2, r_begin + k_chunk);
  if (threadIdx.x < 16) {
    const float c = scheme == kCodebook ? codebook[threadIdx.x] : 0.f;
    cbs[threadIdx.x] = kBF16 ? itx::round_bf16(c) : c;
  }
  __syncthreads();

  float acc[TM][CPL];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[m][c] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += group_size) {
    const size_t glo = r0 / group_size;
    const size_t ghi = glo + G2;
    float slo[CPL], shi[CPL], zlo[CPL], zhi[CPL];
    load_row<CPL, kVec>(scales, glo, n, N, slo);
    load_row<CPL, kVec>(scales, ghi, n, N, shi);
    if (scheme == kAsym) {
      load_row<CPL, kVec>(zeros, glo, n, N, zlo);
      load_row<CPL, kVec>(zeros, ghi, n, N, zhi);
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (scheme != kAsym) zlo[c] = zhi[c] = 0.f;
      if (kBF16) {
        slo[c] = itx::round_bf16(slo[c]); shi[c] = itx::round_bf16(shi[c]);
        zlo[c] = itx::round_bf16(zlo[c]); zhi[c] = itx::round_bf16(zhi[c]);
      }
    }
    // bf16 sym / asym decode two weights at once: pair k = 2j + h of plane p
    // holds columns 4j + h and 4j + h + 2 (the nibbles a 32-bit word's view
    // (word >> 4v) & 0x000F000F picks, v = 2h + p); -z is kept negated
    uint32_t s2[2][CPL / 2], nz2[2][CPL / 2];
#pragma unroll
    for (int k = 0; k < CPL / 2; ++k) {
      const int ca = 4 * (k / 2) + k % 2;
      s2[0][k] = __byte_perm(__float_as_uint(slo[ca]), __float_as_uint(slo[ca + 2]), 0x7632);
      s2[1][k] = __byte_perm(__float_as_uint(shi[ca]), __float_as_uint(shi[ca + 2]), 0x7632);
      nz2[0][k] = kBf16x2Sign ^ __byte_perm(__float_as_uint(zlo[ca]), __float_as_uint(zlo[ca + 2]), 0x7632);
      nz2[1][k] = kBf16x2Sign ^ __byte_perm(__float_as_uint(zhi[ca]), __float_as_uint(zhi[ca + 2]), 0x7632);
    }
    const bool pairs = kBF16 && scheme != kCodebook;
    // 0x4300 | v is the bf16 128 + v: sym nibbles (flipped in bit 3) take off
    // 136, asym 128, both exact
    const uint32_t offset = kBf16x2Sign ^ (scheme == kSym ? 0x43084308u : 0x43004300u);
    for (int i = warp * Sh::RPW + sub; i < group_size; i += Sh::RPB * kUnroll) {
      uint32_t words[kUnroll][NW];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ii = i + Sh::RPB * u;
        if (ii < group_size) {
          load_words<CPL, kVec>(w, r0 + ii, n, N, words[u]);
        } else {
#pragma unroll
          for (int j = 0; j < NW; ++j) words[u][j] = 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ii = i + Sh::RPB * u;
        if (ii < group_size) {
          const int r = r0 + ii;
          float xl[TM], xh[TM];
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            const TX* row = x + static_cast<size_t>(m) * K;
            xl[m] = m < M ? itx::to_float(row[r]) : 0.f;
            xh[m] = m < M ? itx::to_float(row[K2 + r]) : 0.f;
          }
          if (pairs) {
#pragma unroll
            for (int j = 0; j < NW; ++j) {
              const uint32_t wd = scheme == kSym ? words[u][j] ^ 0x88888888u : words[u][j];
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                const int p = v & 1, k = 2 * j + (v >> 1), ca = 4 * j + (v >> 1);
                const uint32_t b = 0x43004300u | ((wd >> (4 * v)) & 0x000F000Fu);
                uint32_t q = bf16x2_fma(b, kBf16x2One, offset);         // exact
                if (scheme == kAsym) q = bf16x2_fma(q, kBf16x2One, nz2[p][k]);  // bf16(q - z)
                const uint32_t wv = bf16x2_fma(q, s2[p][k], kBf16x2NegZero);  // bf16(q * s)
                const float wa = __uint_as_float(wv << 16), wb = __uint_as_float(wv & 0xFFFF0000u);
#pragma unroll
                for (int m = 0; m < TM; ++m) {
                  const float xv = p ? xh[m] : xl[m];
                  acc[m][ca] = fmaf(xv, wa, acc[m][ca]);
                  acc[m][ca + 2] = fmaf(xv, wb, acc[m][ca + 2]);
                }
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < NW; ++j)
#pragma unroll
              for (int b = 0; b < 4; ++b) {
                const int c = 4 * j + b;
                const int byte = (words[u][j] >> (8 * b)) & 0xFF;
                const float lo = dq<kBF16>(byte & 0xF, slo[c], zlo[c], cbs, scheme);
                const float hi = dq<kBF16>(byte >> 4, shi[c], zhi[c], cbs, scheme);
#pragma unroll
                for (int m = 0; m < TM; ++m) {
                  acc[m][c] = fmaf(xl[m], lo, acc[m][c]);
                  acc[m][c] = fmaf(xh[m], hi, acc[m][c]);
                }
              }
          }
        }
      }
    }
  }

  // lanes of one warp that share columns (RPW > 1) sum by shuffles, then
  // the warps through shared memory, each in a fixed order
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      float v = acc[m][c];
#pragma unroll
      for (int off = Sh::LPR; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (sub == 0) red[warp][m][c0 + c] = v;
    }
  __syncthreads();
  const bool direct = gridDim.y == 1;
  const size_t MN = static_cast<size_t>(M) * N;
  for (int t = threadIdx.x; t < TM * kGemvCols; t += kThreads) {
    const int m = t / kGemvCols, c = t % kGemvCols;
    const int col = blockIdx.x * kGemvCols + c;
    if (m >= M || col >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum += red[wp][m][c];
    const size_t o = static_cast<size_t>(m) * N + col;
    if (direct) {
      out[o] = itx::from_float<TO>(sum);
    } else {
      part[blockIdx.y * MN + o] = sum;
    }
  }
  if (direct) return;

  // the last block of this column strip to arrive sums the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&counters[blockIdx.x], 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int t = threadIdx.x; t < TM * kGemvCols; t += kThreads) {
    const int m = t / kGemvCols, c = t % kGemvCols;
    const int col = blockIdx.x * kGemvCols + c;
    if (m >= M || col >= N) continue;
    const size_t o = static_cast<size_t>(m) * N + col;
    float sum = 0.f;
    for (unsigned s = 0; s < gridDim.y; ++s) sum += __ldcg(part + s * MN + o);
    out[o] = itx::from_float<TO>(sum);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// ---- 9 <= M < 1024: tiled SIMT GEMM ---------------------------------------
template <typename TX, typename TO, int TM>
__global__ void __launch_bounds__(kThreads)
woq_int4_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scales, const float* __restrict__ zeros,
                const float* __restrict__ codebook, TO* __restrict__ out, int M,
                int N, int K, int group_size, int scheme) {
  constexpr bool kBF16 = sizeof(TX) == 2;
  constexpr int BM = 16 * TM;
  constexpr int kXS = BM + 4;  // padded row: fewer bank conflicts, rows stay 16-byte aligned
  const int K2 = K / 2;
  const int G2 = K2 / group_size;  // groups per half

  __shared__ __align__(16) float xs[2][kBKP][kXS];
  __shared__ __align__(16) float ws[2][kBKP][kBN];
  __shared__ float cbs[16];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  if (tid < 16) cbs[tid] = scheme == kCodebook ? codebook[tid] : 0.f;

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int r0 = 0; r0 < K2; r0 += kBKP) {
    __syncthreads();  // the previous step's tiles are consumed (and cbs is set)
    for (int i = tid; i < kBKP * kBN; i += kThreads) {
      const int rr = i / kBN, c = i % kBN;
      const int r = r0 + rr, n = n0 + c;
      float lo = 0.f, hi = 0.f;
      if (r < K2 && n < N) {
        const int b = static_cast<uint8_t>(w[static_cast<size_t>(r) * N + n]);
        const size_t glo = static_cast<size_t>(r / group_size) * N + n;
        const size_t ghi = glo + static_cast<size_t>(G2) * N;
        const float zlo = scheme == kAsym ? zeros[glo] : 0.f;
        const float zhi = scheme == kAsym ? zeros[ghi] : 0.f;
        lo = dequant<kBF16>(b & 0xF, scales[glo], zlo, cbs, scheme);
        hi = dequant<kBF16>(b >> 4, scales[ghi], zhi, cbs, scheme);
      }
      ws[0][rr][c] = lo;
      ws[1][rr][c] = hi;
    }
    for (int i = tid; i < kBKP * BM; i += kThreads) {
      const int mm = i / kBKP, rr = i % kBKP;
      const int m = m0 + mm, r = r0 + rr;
      float lo = 0.f, hi = 0.f;
      if (m < M && r < K2) {
        const TX* row = x + static_cast<size_t>(m) * K;
        lo = itx::to_float(row[r]);
        hi = itx::to_float(row[K2 + r]);
      }
      xs[0][rr][mm] = lo;
      xs[1][rr][mm] = hi;
    }
    __syncthreads();

#pragma unroll 4
    for (int rr = 0; rr < kBKP; ++rr) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float a[TM];
        if constexpr (TM == 4) {
          const float4 va = *reinterpret_cast<const float4*>(&xs[p][rr][ty * 4]);
          a[0] = va.x; a[1] = va.y; a[2] = va.z; a[3] = va.w;
        } else {
          a[0] = xs[p][rr][ty];
        }
        const float4 vb = *reinterpret_cast<const float4*>(&ws[p][rr][tx * kTN]);
        const float b[kTN] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n < N) out[static_cast<size_t>(m) * N + n] = itx::from_float<TO>(acc[i][j]);
    }
  }
}

template <typename TX, typename TO>
void launch(const void* x, const void* w, const void* scales, const void* zeros,
            const void* codebook, void* out, void* part, void* counters, int M, int N, int K,
            int group_size, int scheme, int gemv, int k_chunk, int vec, cudaStream_t stream) {
  const dim3 block(kThreads);
  const auto* xp = static_cast<const TX*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  const auto* zp = static_cast<const float*>(zeros);
  const auto* cp = static_cast<const float*>(codebook);
  auto* op = static_cast<TO*>(out);
  if (gemv) {
    auto* pp = static_cast<float*>(part);
    auto* cnt = static_cast<int*>(counters);
    const dim3 grid((N + kGemvCols - 1) / kGemvCols, (K / 2 + k_chunk - 1) / k_chunk);
#define ITX_GEMV(TM, CPL, VEC) \
  woq_int4_gemv<TX, TO, TM, CPL, VEC><<<grid, block, 0, stream>>>( \
      xp, wp, sp, zp, cp, op, pp, cnt, M, N, K, group_size, scheme, k_chunk)
    if (M == 1 && vec == 2) {
      ITX_GEMV(1, 16, true);
    } else if (M == 1 && vec) {
      ITX_GEMV(1, 4, true);
    } else if (M == 1) {
      ITX_GEMV(1, 4, false);
    } else if (vec) {
      ITX_GEMV(8, 4, true);
    } else {
      ITX_GEMV(8, 4, false);
    }
#undef ITX_GEMV
    return;
  }
  const int gx = (N + kBN - 1) / kBN;
  if (M <= 16) {
    woq_int4_kernel<TX, TO, 1><<<dim3(gx, (M + 15) / 16), block, 0, stream>>>(
        xp, wp, sp, zp, cp, op, M, N, K, group_size, scheme);
  } else {
    woq_int4_kernel<TX, TO, 4><<<dim3(gx, (M + 63) / 64), block, 0, stream>>>(
        xp, wp, sp, zp, cp, op, M, N, K, group_size, scheme);
  }
}

}  // namespace

// x: (M, K) f32 or bf16 (x_bf16 = 1); w: int8 (K/2, N); scales, zeros: f32
// (K/g, N) (zeros unused unless scheme == 1); codebook: f32[16] (unused
// unless scheme == 2); out: (M, N) f32 or bf16 (out_bf16 = 1). gemv = 1
// (M <= 8) selects the split-K GEMV: k_chunk packed rows a split, a multiple
// of group_size; part is an f32 (splits, M, N) workspace and counters holds
// ceil(N / 128) ints that are 0, both unread with one split; vec = 2 when
// N % 16 == 0 and w, scales and zeros allow 16-byte loads, 1 when N % 4 == 0
// and w allows 4-byte and scales and zeros 16-byte loads, else 0. Returns
// cudaGetLastError() after the launch.
extern "C" int itx_woq_int4(const void* x, const void* w, const void* scales,
                            const void* zeros, const void* codebook, void* out, void* part,
                            void* counters, int M, int N, int K, int group_size, int scheme,
                            int gemv, int k_chunk, int vec, int x_bf16, int out_bf16,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, scales, zeros, codebook, out, part, counters, M, N, K, group_size, scheme, gemv, k_chunk, vec, s);
  } else if (x_bf16) {
    launch<__nv_bfloat16, float>(x, w, scales, zeros, codebook, out, part, counters, M, N, K, group_size, scheme, gemv, k_chunk, vec, s);
  } else if (out_bf16) {
    launch<float, __nv_bfloat16>(x, w, scales, zeros, codebook, out, part, counters, M, N, K, group_size, scheme, gemv, k_chunk, vec, s);
  } else {
    launch<float, float>(x, w, scales, zeros, codebook, out, part, counters, M, N, K, group_size, scheme, gemv, k_chunk, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
