// The pieces of the split-K GEMVs of K1 (woq_int4.cu, khalf int4) and K2
// (woq_int8.cu, int8) at decode, M <= 8, sm_90a.
//
// A block of 8 warps owns a strip of 128 output columns. Each lane reads CPL
// adjacent columns of one weight row as one word: 16 bytes (8 lanes a row,
// 4 rows a warp) where N and the pointers allow, else 4 bytes (32 lanes a
// row), else byte by byte, so a warp reads whole 128-byte lines. The rows of
// a split (blockIdx.y takes k_chunk of them, on group boundaries) are shared
// out among the lanes and warps; `finish` sums a strip's lanes by shuffles
// and its warps through shared memory, each in a fixed order. With one
// split the block writes out; with several it writes f32 partials and the
// last block of the strip to arrive (an int counter a strip) sums them in
// split order, writes out and resets its counter to 0. One launch, no float
// atomics: every run gives the same bits.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace itx_gemv {

constexpr int kThreads = 256;
constexpr int kCols = 128;  // columns a block (a strip)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // weight words in flight a lane

// CPL columns a lane: 16 (one 16-byte word, 8 lanes a row) or 4 (one 4-byte
// word, 32 lanes a row).
template <int CPL>
struct Shape {
  static constexpr int LPR = kCols / CPL;  // lanes a row
  static constexpr int RPW = 32 / LPR;     // rows a warp reads at once
  static constexpr int RPB = kWarps * RPW;  // rows the block reads at once
};

// Columns n..n+CPL-1 of byte row `row` of w (rows, N), as CPL / 4 words; kVec
// false reads the bytes one by one (zeros past N).
template <int CPL, bool kVec>
__device__ __forceinline__ void load_words(const int8_t* w, size_t row, int n, int N, uint32_t word[CPL / 4]) {
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

// The end of a GEMV block (see above). acc[m][c] is this lane's sum for row
// m, column c0 + c of the strip; red is the block's __shared__
// float[kWarps][TM][kCols], is_last a __shared__ int.
template <int TM, int CPL, typename TO>
__device__ __forceinline__ void finish(float (&acc)[TM][CPL], float (*red)[TM][kCols], int* is_last, TO* out,
                                       float* part, int* counters, int M, int N) {
  using Sh = Shape<CPL>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = (lane % Sh::LPR) * CPL;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      float v = acc[m][c];
#pragma unroll
      for (int off = Sh::LPR; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < Sh::LPR) red[warp][m][c0 + c] = v;
    }
  __syncthreads();
  const bool direct = gridDim.y == 1;
  const size_t MN = static_cast<size_t>(M) * N;
  for (int t = threadIdx.x; t < TM * kCols; t += kThreads) {
    const int m = t / kCols, c = t % kCols;
    const int col = blockIdx.x * kCols + c;
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
  if (direct || !itx::last_to_arrive(&counters[blockIdx.x], gridDim.y, is_last)) return;
  for (int t = threadIdx.x; t < TM * kCols; t += kThreads) {
    const int m = t / kCols, c = t % kCols;
    const int col = blockIdx.x * kCols + c;
    if (m >= M || col >= N) continue;
    const size_t o = static_cast<size_t>(m) * N + col;
    float sum = 0.f;
    for (unsigned s = 0; s < gridDim.y; ++s) sum += __ldcg(part + s * MN + o);
    out[o] = itx::from_float<TO>(sum);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

}  // namespace itx_gemv
