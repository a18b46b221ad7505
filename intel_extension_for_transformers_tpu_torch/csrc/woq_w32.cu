// K3: int4 weight-only-quantized GEMM over the w32 decode layout, for Hopper.
//
// Replaces intel_extension_for_transformers_tpu/ops/quant_matmul.py
// ::_woq_kernel_w32 (launched from _pallas_woq_w32).
//
//   out (M, N) = x (M, K) . dequant(W)
//
// W is int32 (Kp/8, N): word kw of each 512-row block (word rows 64b..64b+63)
// holds eight biased nibbles v' in [0, 15]; view j = (w >> 4j) & 0x000F000F
// carries row 512b + 128j + 2kw in its low half and row 512b + 128j + 2kw + 1
// in its high half (ops/packing.py::_khalf_to_w32). OR-ing 0x43004300 into a
// view makes two bf16 bit patterns whose values are exactly 128 + v'; each
// widens to f32 with one shift or mask, so a pair of nibbles costs four
// integer operations and no convert. The offset zc (136 for sym, whose
// nibbles carry +8; 128 + z for asym) is removed in f32, as the Pallas kernel
// removes it:
//
//  * m1 branch (g >= 128, or M <= 32): per-group dots of x with 128 + v',
//    accumulated in f32 and scaled after the dot; s * zc * sum(x_g) is then
//    subtracted in f32. The products of a bf16 x with 128 + v' are exact.
//  * fold branch (g < 128 and M > 32): ((128 + v') - zc) * s in f32, rounded
//    to the compute dtype, then the dot (K1's rounding of q * s).
//
// Scales are f32 (Kp/g, N); zeros f32 (Kp/g, N) for asym only. x is (M, K)
// f32 or bf16 with K <= Kp: rows K..Kp are read as zeros, so the caller pads
// nothing. Compute is bf16 when x is bf16, f32 when x is f32; the accumulator
// is f32; out is f32 or bf16. M and N are masked at their edges (ragged N =
// 32000 runs without padding the weights). group_size must be a multiple of
// 16, so a 16-row span of one plane never straddles a group.
//
// Bound on the H100: at decode (M = 1) the words, K*N/2 bytes, are all that
// matters; the bf16-pattern decode keeps the integer work per byte small so
// the loads, not the ALUs, bound it. As M grows the FMA rate takes over.
// Design: M <= 8 runs a GEMV kernel (one column per thread, eight warps
// splitting each 512-row block's 64 word rows, the next block's words loaded
// while the current one is summed, a shared-memory reduction across warps at
// the end). Larger M runs a tiled SIMT kernel: a 64 x 64 output tile per
// block, K walked in spans of 16 or 32 natural rows whose words are decoded
// once into shared memory and reused by all 64 rows, a 4 x 4 register tile
// per thread. Open (recorded in PERF.md): at M = 1 an 11008 -> 4096 product
// has 128 column blocks for 132 SMs, each walking all of K (no split-K);
// tensor cores (mma/wgmma) are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void decode_pair(uint32_t w, int j, float& lo, float& hi) {
  const uint32_t v = 0x43004300u | ((w >> (4 * j)) & 0x000F000Fu);
  lo = __uint_as_float(v << 16);          // 128 + v'(row 128j + 2kw)
  hi = __uint_as_float(v & 0xFFFF0000u);  // 128 + v'(row 128j + 2kw + 1)
}

template <typename TX>
__device__ __forceinline__ float load_x(const TX* x, int M, int K, int m, int k) {
  return (m < M && k < K) ? itx::to_float(x[static_cast<size_t>(m) * K + k]) : 0.f;
}

// ---- M <= 8: GEMV over column strips (m1 branch) --------------------------
constexpr int kGemvCols = 32;  // one warp's lanes

template <typename TX, typename TO, int TM>
__global__ void __launch_bounds__(kThreads)
woq_w32_gemv(const TX* __restrict__ x, const uint32_t* __restrict__ words,
             const float* __restrict__ scales, const float* __restrict__ zeros,
             TO* __restrict__ out, int M, int N, int K, int Kp, int group_size,
             int asym) {
  __shared__ float xs[TM][512];
  __shared__ float red[kThreads / 32][TM][kGemvCols];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;  // word rows 8 warp .. 8 warp + 7 of each block
  const int n = blockIdx.x * kGemvCols + lane;
  const bool col_ok = n < N;
  const int nblocks = Kp / 512;

  float acc[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) acc[m] = 0.f;

  uint32_t cur[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    cur[i] = col_ok ? words[static_cast<size_t>(warp * 8 + i) * N + n] : 0u;

  for (int b = 0; b < nblocks; ++b) {
    __syncthreads();  // the previous block's x is consumed
    for (int i = threadIdx.x; i < TM * 512; i += kThreads)
      xs[i / 512][i % 512] = load_x(x, M, K, i / 512, b * 512 + i % 512);
    uint32_t nxt[8];
    const bool more = b + 1 < nblocks;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      nxt[i] = (more && col_ok)
                   ? words[static_cast<size_t>((b + 1) * 64 + warp * 8 + i) * N + n]
                   : 0u;
    __syncthreads();

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float part[TM], xsum[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) part[m] = xsum[m] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float lo, hi;
        decode_pair(cur[i], j, lo, hi);
        const int r = 128 * j + 2 * (warp * 8 + i);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float x0 = xs[m][r], x1 = xs[m][r + 1];
          part[m] = fmaf(x0, lo, part[m]);
          part[m] = fmaf(x1, hi, part[m]);
          xsum[m] += x0 + x1;
        }
      }
      // the warp's 16 rows of plane j lie in one group
      const int grp = (b * 512 + 128 * j + 16 * warp) / group_size;
      if (col_ok) {
        const size_t gi = static_cast<size_t>(grp) * N + n;
        const float s = scales[gi];
        const float corr = s * (asym ? zeros[gi] + 128.f : 136.f);
#pragma unroll
        for (int m = 0; m < TM; ++m) acc[m] += part[m] * s - xsum[m] * corr;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) cur[i] = nxt[i];
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  for (int t = threadIdx.x; t < TM * kGemvCols; t += kThreads) {
    const int m = t / kGemvCols, c = t % kGemvCols;
    const int col = blockIdx.x * kGemvCols + c;
    if (m >= M || col >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += red[w][m][c];
    out[static_cast<size_t>(m) * N + col] = itx::from_float<TO>(sum);
  }
}

// ---- M > 8: tiled SIMT GEMM (both branches) -------------------------------
constexpr int kBM = 64;
constexpr int kBN = 64;

template <typename TX, typename TO, int KS>
__global__ void __launch_bounds__(kThreads)
woq_w32_tiled(const TX* __restrict__ x, const uint32_t* __restrict__ words,
              const float* __restrict__ scales, const float* __restrict__ zeros,
              TO* __restrict__ out, int M, int N, int K, int Kp, int group_size,
              int asym, int m1) {
  constexpr bool kBF16 = sizeof(TX) == 2;
  constexpr int kXS = kBM + 4;  // padded row, still 16-byte aligned
  __shared__ __align__(16) float xs[KS][kXS];
  __shared__ __align__(16) float ws[KS][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  float acc[4][4], part[4][4], xsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;
  }

  for (int r0 = 0; r0 < Kp; r0 += KS) {
    const int b = r0 / 512;
    const int j = (r0 % 512) / 128;
    const int kw0 = (r0 % 128) / 2;
    const int grp = r0 / group_size;  // the whole span lies in this group
    __syncthreads();  // the previous span's tiles are consumed
    for (int i = tid; i < (KS / 2) * kBN; i += kThreads) {
      const int wr = i / kBN, c = i % kBN;
      const int n = n0 + c;
      float lo = 0.f, hi = 0.f;
      if (n < N) {
        decode_pair(words[static_cast<size_t>(b * 64 + kw0 + wr) * N + n], j, lo, hi);
        if (!m1) {
          const size_t gi = static_cast<size_t>(grp) * N + n;
          const float s = scales[gi];
          const float zc = asym ? zeros[gi] + 128.f : 136.f;
          lo = (lo - zc) * s;
          hi = (hi - zc) * s;
          if (kBF16) {
            lo = itx::round_bf16(lo);
            hi = itx::round_bf16(hi);
          }
        }
      }
      ws[2 * wr][c] = lo;
      ws[2 * wr + 1][c] = hi;
    }
    for (int i = tid; i < KS * kBM; i += kThreads) {
      const int mm = i / KS, kk = i % KS;
      xs[kk][mm] = load_x(x, M, K, m0 + mm, r0 + kk);
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < KS; ++kk) {
      const float4 va = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 vb = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float a[4] = {va.x, va.y, va.z, va.w};
      const float w[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xsum[i] += a[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][c] = fmaf(a[i], w[c], part[i][c]);
      }
    }

    const bool group_ends = (r0 + KS) % group_size == 0 || r0 + KS == Kp;
    if (!m1) {
      // fold: the weights already carry offset and scale
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[i][c] += part[i][c];
          part[i][c] = 0.f;
        }
    } else if (group_ends) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + tx * 4 + c;
        float s = 0.f, corr = 0.f;
        if (n < N) {
          const size_t gi = static_cast<size_t>(grp) * N + n;
          s = scales[gi];
          corr = s * (asym ? zeros[gi] + 128.f : 136.f);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c] += part[i][c] * s - xsum[i] * corr;
          part[i][c] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) xsum[i] = 0.f;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n < N) out[static_cast<size_t>(m) * N + n] = itx::from_float<TO>(acc[i][c]);
    }
  }
}

template <typename TX, typename TO>
void launch(const void* x, const void* words, const void* scales, const void* zeros,
            void* out, int M, int N, int K, int Kp, int group_size, int asym, int m1,
            cudaStream_t stream) {
  const auto* xp = static_cast<const TX*>(x);
  const auto* wp = static_cast<const uint32_t*>(words);
  const auto* sp = static_cast<const float*>(scales);
  const auto* zp = static_cast<const float*>(zeros);
  auto* op = static_cast<TO*>(out);
  if (M <= 8 && m1) {
    const dim3 grid((N + kGemvCols - 1) / kGemvCols);
    if (M == 1) {
      woq_w32_gemv<TX, TO, 1><<<grid, kThreads, 0, stream>>>(xp, wp, sp, zp, op, M, N, K, Kp,
                                                             group_size, asym);
    } else {
      woq_w32_gemv<TX, TO, 8><<<grid, kThreads, 0, stream>>>(xp, wp, sp, zp, op, M, N, K, Kp,
                                                             group_size, asym);
    }
    return;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (group_size % 32 == 0) {
    woq_w32_tiled<TX, TO, 32><<<grid, kThreads, 0, stream>>>(xp, wp, sp, zp, op, M, N, K, Kp,
                                                             group_size, asym, m1);
  } else {
    woq_w32_tiled<TX, TO, 16><<<grid, kThreads, 0, stream>>>(xp, wp, sp, zp, op, M, N, K, Kp,
                                                             group_size, asym, m1);
  }
}

}  // namespace

// x: (M, K) f32 or bf16 (x_bf16 = 1), K <= Kp; words: int32 (Kp/8, N);
// scales: f32 (Kp/g, N); zeros: f32 (Kp/g, N), read only if asym; out: (M, N)
// f32 or bf16 (out_bf16 = 1); m1 selects the branch (see above). Returns
// cudaGetLastError() after the launch.
extern "C" int itx_woq_w32(const void* x, const void* words, const void* scales,
                           const void* zeros, void* out, int M, int N, int K, int Kp,
                           int group_size, int asym, int m1, int x_bf16, int out_bf16,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, words, scales, zeros, out, M, N, K, Kp, group_size, asym, m1, s);
  } else if (x_bf16) {
    launch<__nv_bfloat16, float>(x, words, scales, zeros, out, M, N, K, Kp, group_size, asym, m1, s);
  } else if (out_bf16) {
    launch<float, __nv_bfloat16>(x, words, scales, zeros, out, M, N, K, Kp, group_size, asym, m1, s);
  } else {
    launch<float, float>(x, words, scales, zeros, out, M, N, K, Kp, group_size, asym, m1, s);
  }
  return static_cast<int>(cudaGetLastError());
}
