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
// Bound on the H100: at the small M this kernel serves (M < 1024: reranker
// pairs, single-query index scans) the packed weight, K*N/2 bytes, is the
// traffic that matters; as M grows the FMA rate takes over.
// Design: a block owns a BM x 64 output tile and walks K/2 in steps of 32
// packed rows. Each step decodes every packed byte once, both nibbles with
// their scales, into a float tile in shared memory that all BM rows reuse,
// so the dequantized weight never reaches device memory. The product is a
// SIMT FMA loop over a 4x4 (BM = 64) or 1x4 (BM = 16, for M <= 16) register
// tile per thread. Tensor cores (mma/wgmma) are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBN = 64;        // output columns per block
constexpr int kTN = 4;         // output columns per thread
constexpr int kBKP = 32;       // packed rows per step (one lo and one hi K row each)

enum Scheme { kSym = 0, kAsym = 1, kCodebook = 2 };

// One nibble u in [0, 15] -> its dequantized value in the compute type.
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
            const void* codebook, void* out, int M, int N, int K, int group_size,
            int scheme, cudaStream_t stream) {
  const dim3 block(kThreads);
  const int gx = (N + kBN - 1) / kBN;
  const auto* xp = static_cast<const TX*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  const auto* zp = static_cast<const float*>(zeros);
  const auto* cp = static_cast<const float*>(codebook);
  auto* op = static_cast<TO*>(out);
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
// unless scheme == 2); out: (M, N) f32 or bf16 (out_bf16 = 1). Returns
// cudaGetLastError() after the launch.
extern "C" int itx_woq_int4(const void* x, const void* w, const void* scales,
                            const void* zeros, const void* codebook, void* out,
                            int M, int N, int K, int group_size, int scheme,
                            int x_bf16, int out_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, scales, zeros, codebook, out, M, N, K, group_size, scheme, s);
  } else if (x_bf16) {
    launch<__nv_bfloat16, float>(x, w, scales, zeros, codebook, out, M, N, K, group_size, scheme, s);
  } else if (out_bf16) {
    launch<float, __nv_bfloat16>(x, w, scales, zeros, codebook, out, M, N, K, group_size, scheme, s);
  } else {
    launch<float, float>(x, w, scales, zeros, codebook, out, M, N, K, group_size, scheme, s);
  }
  return static_cast<int>(cudaGetLastError());
}
