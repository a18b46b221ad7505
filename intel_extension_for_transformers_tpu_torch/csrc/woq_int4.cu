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
// 6.7 us at 3.35 TB/s); as M grows the operations take over (989 TFLOP/s
// in bf16 on the tensor cores, 67 TFLOP/s in f32 on the SIMT tiles).
// Design:
//  * M <= K1_GEMV_MAX_M (ops/quant_matmul.py: 1, since the tiles below are
//    faster from M = 2 on the H100; the kernel takes up to 8 rows), a
//    split-K GEMV (woq_int4_gemv, on woq_gemv.cuh): a block owns 128 columns. Each
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
//  * Above it, bf16 x, g a multiple of 32: the tensor-core tiles of woq_tc.cuh
//    (Int4Tile below). A stage is 32 packed rows r0..: their bytes for 128
//    columns by cp.async, and two x slices, x[:, r0:] (low nibbles) and
//    x[:, K/2 + r0:] (high nibbles), so one stage feeds four k-steps. A
//    B-fragment register holds two K rows of one column: two bytes of
//    neighbouring packed rows, decoded two weights at a time with the
//    GEMV's bf16x2 arithmetic (128 + u from a bit pattern, an exact
//    offset, bf16(u - z), bf16(q * s); codebooks through a bf16 table), so
//    the tiles round exactly as the Pallas kernel and dq<true> do. The whole
//    stage is decoded once a block into a bf16 tile in shared memory that
//    the warps read by ldmatrix.trans (on the H100 faster at every shape
//    measured than each warp decoding its own columns from byte loads,
//    PERF.md). The tiles' partial sums move into the f32 accumulators once
//    a stage.
//  * Otherwise (f32 x, or g not a multiple of 32): tiled SIMT. A block owns
//    a BM x 64 output tile and walks K/2 in steps of 32 packed rows. Each
//    step decodes every packed byte once, both nibbles with their scales,
//    into a float tile in shared memory that all BM rows reuse. The product
//    is a SIMT FMA loop over a 4x4 (BM = 64) or 1x4 (BM = 16, for M <= 16)
//    register tile per thread.
// Later work (ROADMAP): wgmma + TMA for the tiles; f32 x on the tensor cores.

#include <stdint.h>

#include "common.cuh"
#include "woq_gemv.cuh"
#include "woq_tc.cuh"

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

// ---- M <= 8: split-K GEMV over 128-column strips (woq_gemv.cuh) ---------
constexpr int kGemvCols = itx_gemv::kCols;
constexpr int kWarps = itx_gemv::kWarps;
constexpr int kUnroll = itx_gemv::kUnroll;
using itx_gemv::load_row;
using itx_gemv::load_words;

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

using itx::bf16x2_fma;
using itx::kBf16x2NegZero;
using itx::kBf16x2One;
constexpr uint32_t kBf16x2Sign = 0x80008000u;

template <typename TX, typename TO, int TM, int CPL, bool kVec>
__global__ void __launch_bounds__(kThreads)
woq_int4_gemv(const TX* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scales, const float* __restrict__ zeros,
              const float* __restrict__ codebook, TO* __restrict__ out, float* __restrict__ part,
              int* __restrict__ counters, int M, int N, int K, int group_size, int scheme,
              int k_chunk) {
  using Sh = itx_gemv::Shape<CPL>;
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

  itx_gemv::finish<TM, CPL>(acc, red, &is_last, out, part, counters, M, N);
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


// ---- above the GEMV, bf16 x: tensor-core tiles (woq_tc.cuh) ---------------
// Two nibbles (bits 0-3 of each half of v) -> bf16x2 weights, rounded as
// dq<true>: s2 and -z2 are bf16 pairs, cbs the bf16 codebook.
__device__ __forceinline__ uint32_t tc_decode(uint32_t v, int scheme, uint32_t s2, uint32_t nz2,
                                              const uint16_t* cbs) {
  if (scheme == kCodebook) {
    const uint32_t q = cbs[v & 0xFu] | (static_cast<uint32_t>(cbs[v >> 16]) << 16);
    return itx::bf16x2_fma(q, s2, itx::kBf16x2NegZero);
  }
  // 0x4300 | v is the bf16 128 + v: sym nibbles (flipped in bit 3) take off
  // 136, asym 128, both exact
  if (scheme == kSym) v ^= 0x00080008u;
  uint32_t q = itx::bf16x2_fma(0x43004300u | v, itx::kBf16x2One,
                                  scheme == kSym ? 0xC308C308u : 0xC300C300u);
  if (scheme == kAsym) q = itx::bf16x2_fma(q, itx::kBf16x2One, nz2);  // bf16(u - z)
  return itx::bf16x2_fma(q, s2, itx::kBf16x2NegZero);                // bf16(q * s)
}

// B-fragment policy over the khalf bytes (woq_tc.cuh's ByteRowsTile): a
// stage is packed rows r0..r0+31 (rows past K/2 arrive as zeros). Slice 0 is
// the low plane (K rows r0..), slice 1 the high plane (K rows K/2 + r0..),
// both in group r0 / g of their half. begin_stage decodes the whole stage
// into the bf16 tile, both planes; k-step ks of a slice reads its B
// fragments from rows 16 ks.. of the slice's plane.
template <int BM>
struct Int4Tile : itx_tc::ByteRowsTile<BM, 2> {
  using Base = itx_tc::ByteRowsTile<BM, 2>;
  static constexpr int EXTRA_BYTES = 32 + Base::TILE_BYTES;

  uint16_t* cbs;  // the bf16 codebook (16 entries)
  int scheme;
  uint32_t sp[2][2], nzp[2][2];  // s and -z of columns (4c, 4c + 1) and (4c + 2, 4c + 3), each plane

  __device__ Int4Tile(const itx_tc::Params& p, unsigned char* extra, int, int wn_, int lane_)
      : Base(extra + 32, wn_, lane_), cbs(reinterpret_cast<uint16_t*>(extra)), scheme(p.scheme) {
    if (threadIdx.x < 16)
      cbs[threadIdx.x] = p.scheme == kCodebook ? __bfloat16_as_ushort(__float2bfloat16(p.codebook[threadIdx.x])) : 0;
  }

  __device__ static int x_col(const itx_tc::Params& p, int sl, int r0) { return sl ? p.K / 2 + r0 : r0; }
  __device__ static int x_limit(const itx_tc::Params& p, int sl) { return sl ? p.K : p.K / 2; }

  // s (and -z) of column n, group row g of the (K/g, N) arrays, rounded to bf16
  __device__ static void group_scale(const itx_tc::Params& p, size_t row, int n, uint16_t& s, uint16_t& nz) {
    const bool in = n < p.N;
    s = __bfloat16_as_ushort(__float2bfloat16(in ? p.scales[row + n] : 0.f));
    nz = p.scheme == kAsym ? __bfloat16_as_ushort(__float2bfloat16(in ? p.zeros[row + n] : 0.f)) ^ 0x8000u : 0;
  }

  __device__ void begin_stage(const itx_tc::Params& p, const unsigned char* ws, int r0) {
    const int g = p.group_size;
    const size_t glo = static_cast<size_t>(r0 / g), ghi = glo + static_cast<size_t>(p.span / g);
    const int n = blockIdx.x * itx_tc::kBN + 4 * Base::wcol();  // this thread's columns n..n+3
    if (r0 % g == 0) {  // a new group: its scales (and zero points) for this thread's columns
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint16_t s0, z0, s1, z1;
          group_scale(p, (pl ? ghi : glo) * p.N, n + 2 * h, s0, z0);
          group_scale(p, (pl ? ghi : glo) * p.N, n + 2 * h + 1, s1, z1);
          sp[pl][h] = s0 | (static_cast<uint32_t>(s1) << 16);
          nzp[pl][h] = z0 | (static_cast<uint32_t>(z1) << 16);
        }
    }
#pragma unroll
    for (int i = 0; i < Base::DWORDS; ++i) {
      const int r = Base::drow(i);
      const uint32_t word = Base::staged_word(ws, r);
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
        const uint32_t nib = (pl ? word >> 4 : word) & 0x0F0F0F0Fu;
        uint2 o;
        o.x = tc_decode(__byte_perm(nib, 0u, 0x4140), scheme, sp[pl][0], nzp[pl][0], cbs);  // columns 4c, 4c + 1
        o.y = tc_decode(__byte_perm(nib, 0u, 0x4342), scheme, sp[pl][1], nzp[pl][1], cbs);  // 4c + 2, 4c + 3
        this->put(pl, r, o);
      }
    }
    __syncthreads();  // the decoded stage is complete
  }
};

enum Route { kSimtTiles = 0, kGemv = 1, kTensorTiles = 2 };

template <typename TX, typename TO>
void launch(const void* x, const void* w, const void* scales, const void* zeros,
            const void* codebook, void* out, void* part, void* counters, int M, int N, int K,
            int group_size, int scheme, int route, int k_chunk, int vec, cudaStream_t stream) {
  const dim3 block(kThreads);
  const auto* xp = static_cast<const TX*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  const auto* zp = static_cast<const float*>(zeros);
  const auto* cp = static_cast<const float*>(codebook);
  auto* op = static_cast<TO*>(out);
  if (route == kGemv) {
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
// unless scheme == 2); out: (M, N) f32 or bf16 (out_bf16 = 1). route picks
// the kernel:
//  * 1 (M <= 8): the split-K GEMV, k_chunk packed rows a split, a multiple
//    of group_size; part is an f32 (splits, M, N) workspace and counters
//    holds ceil(N / 128) ints that are 0, both unread with one split; vec =
//    2 when N % 16 == 0 and w, scales and zeros allow 16-byte loads, 1 when
//    N % 4 == 0 and w allows 4-byte and scales and zeros 16-byte loads, else 0;
//  * 2: the tensor-core tiles (bf16 x, g % 32 == 0) with BM = bm rows,
//    split along K/2 into k_chunk
//    packed rows (a multiple of g) with part and counters as above, one
//    counter an output tile (ceil(M / bm) * ceil(N / 128)); vec = 1 when x
//    (and K) allow 16-byte copies, + 2 when w (and N) do;
//  * 0: the SIMT tiles.
// Returns the launch's CUDA error (cudaGetLastError()).
extern "C" int itx_woq_int4(const void* x, const void* w, const void* scales,
                            const void* zeros, const void* codebook, void* out, void* part,
                            void* counters, int M, int N, int K, int group_size, int scheme,
                            int route, int bm, int k_chunk, int vec, int x_bf16, int out_bf16,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (route == kTensorTiles) {
    if (!x_bf16) return static_cast<int>(cudaErrorInvalidValue);
    itx_tc::Params p{static_cast<const __nv_bfloat16*>(x), w, static_cast<const float*>(scales),
                     static_cast<const float*>(zeros), static_cast<const float*>(codebook), out,
                     static_cast<float*>(part), static_cast<int*>(counters), M, N, K, K / 2,
                     group_size, scheme, k_chunk, out_bf16, vec & 1, (vec >> 1) & 1};
    const cudaError_t err = itx_tc::launch_bm<Int4Tile>(p, bm, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (x_bf16 && out_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, scales, zeros, codebook, out, part, counters, M, N, K, group_size, scheme, route, k_chunk, vec, s);
  } else if (x_bf16) {
    launch<__nv_bfloat16, float>(x, w, scales, zeros, codebook, out, part, counters, M, N, K, group_size, scheme, route, k_chunk, vec, s);
  } else if (out_bf16) {
    launch<float, __nv_bfloat16>(x, w, scales, zeros, codebook, out, part, counters, M, N, K, group_size, scheme, route, k_chunk, vec, s);
  } else {
    launch<float, float>(x, w, scales, zeros, codebook, out, part, counters, M, N, K, group_size, scheme, route, k_chunk, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
