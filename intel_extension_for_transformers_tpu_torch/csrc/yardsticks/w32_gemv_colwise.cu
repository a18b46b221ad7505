// A yardstick, not a kernel of the port: the w32 GEMV that K3 ran at
// M <= 8 before its split-K GEMV (csrc/woq_w32.cu), kept so that the
// profiles and chip_smoke.py can time the earlier design beside the present
// one in the same run. One column a lane, eight warps splitting each
// 512-row block's 64 word rows, 4-byte words, no split of K (N / 32 blocks),
// x restaged in shared memory every 512 rows and sum(x) recomputed by each
// lane. Built on its own by ops/kernels.py::load_yardsticks, never by the
// port's paths; bf16 x and out at M = 1 only.

#include <stdint.h>

#include "../common.cuh"

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

constexpr int kGemvCols = 32;  // one warp's lanes

template <typename TX, typename TO, int TM>
__global__ void __launch_bounds__(kThreads)
w32_gemv_colwise(const TX* __restrict__ x, const uint32_t* __restrict__ words,
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

}  // namespace

// x: (1, K) bf16, K <= Kp; words: int32 (Kp/8, N); scales, zeros: f32
// (Kp/g, N) (zeros read only if asym); out: (1, N) bf16. Returns the
// launch's CUDA error.
extern "C" int itx_w32_gemv_colwise(const void* x, const void* words, const void* scales,
                                    const void* zeros, void* out, int N, int K, int Kp,
                                    int group_size, int asym, void* stream) {
  const dim3 grid((N + kGemvCols - 1) / kGemvCols);
  w32_gemv_colwise<__nv_bfloat16, __nv_bfloat16, 1><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(words),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<__nv_bfloat16*>(out), 1, N, K, Kp, group_size, asym);
  return static_cast<int>(cudaGetLastError());
}
