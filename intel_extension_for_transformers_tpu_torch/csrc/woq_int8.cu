// K2: int8 weight-only-quantized GEMM for Hopper (sm_90a).
//
// Replaces intel_extension_for_transformers_tpu/ops/quant_matmul.py
// ::_woq_kernel_8bit (launched from _pallas_woq).
//
//   out (M, N) = x (M, K) . dequant(W)
//
// W is int8 (K, N), row-major. Scales (and asym zero points) are f32 (K/g, N):
// row k of W takes row k / g of each. sym: w = q * s with q the signed byte;
// asym: w = (q - z) * s with q = byte & 0xFF (stored as wrapped uint8). Any g
// that divides K and any N are taken: M and N are masked at their edges, so
// the caller pads nothing.
//
// Numerics follow the Pallas kernel. Compute is bf16 when x is bf16 and f32
// when x is f32. In bf16 the scale and zero point are rounded to bf16, q - z
// is exact, and q*s (or (q-z)*s) is rounded once to bf16 before the product;
// in f32 every step is f32 (no TF32). The accumulator is f32; the output is
// f32 or bf16.
//
// Bound on the H100: at decode (M <= 8) the weight, K*N bytes, is the traffic
// that matters (a Llama-2-7B 4096 -> 11008 product: 46.5 MB, 13.9 us at
// 3.35 TB/s); as M grows the FMA rate takes over.
// Design:
//  * M <= 8, a GEMV: a block owns 128 columns, each lane 4 adjacent columns
//    read as one 4-byte word, so a warp reads a whole 128-byte line of a
//    weight row; the eight warps split each scale group's rows, and a
//    shared-memory sum across warps ends the block. K is split on group
//    boundaries over blockIdx.y so that a 4096 x 4096 product has more
//    blocks than the card's 132 SMs.
//  * 9 <= M < 1024, tiles: a block owns a BM x 64 output tile (BM = 64, or 16
//    for M <= 16) and walks its K range in steps of 32 rows; each step
//    dequantizes a 32 x 64 weight slab once into shared memory, reused by all
//    BM rows. A SIMT FMA loop over a 4x4 (BM = 64) or 1x4 (BM = 16) register
//    tile per thread. K is split over blockIdx.z where the tiles alone do not
//    fill the card.
// Split-K partials go to an f32 workspace (k_splits, M, N) that a second
// kernel sums in split order: no float atomics, so every run gives the same
// bits. Tensor cores (mma/wgmma) and cp.async/TMA staging are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// q (the signed byte for sym, byte & 0xFF for asym) -> its dequantized value
// in the compute type. s and z are f32; in bf16 they are rounded first.
template <bool kBF16>
__device__ __forceinline__ float dequant8(int q, float s, float z, int asym) {
  float v = static_cast<float>(q);
  if (kBF16) s = itx::round_bf16(s);
  if (asym) v = kBF16 ? itx::round_bf16(v - itx::round_bf16(z)) : v - z;
  const float w = v * s;
  return kBF16 ? itx::round_bf16(w) : w;
}

__device__ __forceinline__ int byte_of(uint32_t word, int c, int asym) {
  const uint32_t b = (word >> (8 * c)) & 0xFFu;
  return asym ? static_cast<int>(b) : static_cast<int>(static_cast<int8_t>(b));
}

// ---- M <= 8: GEMV over 128-column strips ----------------------------------
constexpr int kGemvCols = 128;  // 32 lanes x 4 columns
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // weight words in flight per lane

// Four adjacent columns n..n+3 of row `row` of a (rows, N) array: one 16-byte
// load (f32) or 4-byte load (int8) when kVec, else element by element.
template <bool kVec>
__device__ __forceinline__ void load_f4(const float* p, size_t row, int n, int N, float v[4]) {
  if (kVec) {
    if (n < N) {
      const float4 t = *reinterpret_cast<const float4*>(p + row * N + n);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = n + c < N ? p[row * N + n + c] : 0.f;
  }
}

template <bool kVec>
__device__ __forceinline__ uint32_t load_w4(const int8_t* w, size_t row, int n, int N) {
  if (kVec) return n < N ? *reinterpret_cast<const uint32_t*>(w + row * N + n) : 0u;
  uint32_t word = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n + c < N) word |= static_cast<uint32_t>(static_cast<uint8_t>(w[row * N + n + c])) << (8 * c);
  return word;
}

template <typename TX, typename TO, int TM, bool kVec>
__global__ void __launch_bounds__(kThreads)
woq_int8_gemv(const TX* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scales, const float* __restrict__ zeros,
              TO* __restrict__ out, float* __restrict__ part, int M, int N, int K,
              int group_size, int asym, int k_chunk) {
  constexpr bool kBF16 = sizeof(TX) == 2;
  __shared__ float red[kWarps][TM][kGemvCols];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n = blockIdx.x * kGemvCols + lane * 4;
  const int k_begin = blockIdx.y * k_chunk;  // a multiple of group_size
  const int k_end = min(K, k_begin + k_chunk);

  float acc[TM][4];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int r0 = k_begin; r0 < k_end; r0 += group_size) {
    const size_t grp = r0 / group_size;
    float s[4], z[4] = {0.f, 0.f, 0.f, 0.f};
    load_f4<kVec>(scales, grp, n, N, s);
    if (asym) load_f4<kVec>(zeros, grp, n, N, z);
    for (int i = warp; i < group_size; i += kWarps * kUnroll) {
      uint32_t words[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ii = i + kWarps * u;
        words[u] = ii < group_size ? load_w4<kVec>(w, r0 + ii, n, N) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ii = i + kWarps * u;
        if (ii < group_size) {
          const int r = r0 + ii;
          float xv[TM];
#pragma unroll
          for (int m = 0; m < TM; ++m)
            xv[m] = m < M ? itx::to_float(x[static_cast<size_t>(m) * K + r]) : 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float wv = dequant8<kBF16>(byte_of(words[u], c, asym), s[c], z[c], asym);
#pragma unroll
            for (int m = 0; m < TM; ++m) acc[m][c] = fmaf(xv[m], wv, acc[m][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][m][lane * 4 + c] = acc[m][c];
  __syncthreads();
  const bool direct = gridDim.y == 1;
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
      part[static_cast<size_t>(blockIdx.y) * M * N + o] = sum;
    }
  }
}

// ---- 9 <= M < 1024: tiled SIMT GEMM ---------------------------------------
constexpr int kBN = 64;  // output columns per block
constexpr int kTN = 4;   // output columns per thread
constexpr int kTK = 32;  // K rows per step

template <typename TX, typename TO, int TM>
__global__ void __launch_bounds__(kThreads)
woq_int8_tiled(const TX* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scales, const float* __restrict__ zeros,
               TO* __restrict__ out, float* __restrict__ part, int M, int N, int K,
               int group_size, int asym, int k_chunk) {
  constexpr bool kBF16 = sizeof(TX) == 2;
  constexpr int BM = 16 * TM;
  constexpr int kXS = BM + 4;  // padded row: fewer bank conflicts, rows stay 16-byte aligned
  __shared__ __align__(16) float xs[kTK][kXS];
  __shared__ __align__(16) float ws[kTK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_chunk;  // a multiple of kTK
  const int k_end = min(K, k_begin + k_chunk);

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int r0 = k_begin; r0 < k_end; r0 += kTK) {
    __syncthreads();  // the previous step's tiles are consumed
    for (int i = tid; i < kTK * kBN; i += kThreads) {
      const int rr = i / kBN, c = i % kBN;
      const int r = r0 + rr, n = n0 + c;
      float v = 0.f;
      if (r < k_end && n < N) {
        const int b = w[static_cast<size_t>(r) * N + n];
        const size_t gi = static_cast<size_t>(r / group_size) * N + n;
        v = dequant8<kBF16>(asym ? (b & 0xFF) : b, scales[gi], asym ? zeros[gi] : 0.f, asym);
      }
      ws[rr][c] = v;
    }
    for (int i = tid; i < kTK * BM; i += kThreads) {
      const int mm = i / kTK, rr = i % kTK;
      const int m = m0 + mm, r = r0 + rr;
      xs[rr][mm] = (m < M && r < k_end) ? itx::to_float(x[static_cast<size_t>(m) * K + r]) : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int rr = 0; rr < kTK; ++rr) {
      float a[TM];
      if constexpr (TM == 4) {
        const float4 va = *reinterpret_cast<const float4*>(&xs[rr][ty * 4]);
        a[0] = va.x; a[1] = va.y; a[2] = va.z; a[3] = va.w;
      } else {
        a[0] = xs[rr][ty];
      }
      const float4 vb = *reinterpret_cast<const float4*>(&ws[rr][tx * kTN]);
      const float b[kTN] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  const bool direct = gridDim.z == 1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n >= N) continue;
      const size_t o = static_cast<size_t>(m) * N + n;
      if (direct) {
        out[o] = itx::from_float<TO>(acc[i][j]);
      } else {
        part[static_cast<size_t>(blockIdx.z) * M * N + o] = acc[i][j];
      }
    }
  }
}

// ---- split-K: sum the partials in split order -----------------------------
template <typename TO>
__global__ void __launch_bounds__(kThreads)
splitk_sum(const float* __restrict__ part, TO* __restrict__ out, size_t MN, int k_splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= MN) return;
  float sum = 0.f;
  for (int s = 0; s < k_splits; ++s) sum += part[static_cast<size_t>(s) * MN + i];
  out[i] = itx::from_float<TO>(sum);
}

template <typename TX, typename TO>
void launch(const void* x, const void* w, const void* scales, const void* zeros, void* out,
            void* part, int M, int N, int K, int group_size, int asym, int gemv, int k_chunk,
            int vec, cudaStream_t stream) {
  const auto* xp = static_cast<const TX*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  const auto* zp = static_cast<const float*>(zeros);
  auto* op = static_cast<TO*>(out);
  auto* pp = static_cast<float*>(part);
  const int k_splits = (K + k_chunk - 1) / k_chunk;
  const dim3 block(kThreads);
  if (gemv) {
    const dim3 grid((N + kGemvCols - 1) / kGemvCols, k_splits);
    if (M == 1 && vec) {
      woq_int8_gemv<TX, TO, 1, true><<<grid, block, 0, stream>>>(xp, wp, sp, zp, op, pp, M, N, K, group_size, asym, k_chunk);
    } else if (M == 1) {
      woq_int8_gemv<TX, TO, 1, false><<<grid, block, 0, stream>>>(xp, wp, sp, zp, op, pp, M, N, K, group_size, asym, k_chunk);
    } else if (vec) {
      woq_int8_gemv<TX, TO, 8, true><<<grid, block, 0, stream>>>(xp, wp, sp, zp, op, pp, M, N, K, group_size, asym, k_chunk);
    } else {
      woq_int8_gemv<TX, TO, 8, false><<<grid, block, 0, stream>>>(xp, wp, sp, zp, op, pp, M, N, K, group_size, asym, k_chunk);
    }
  } else if (M <= 16) {
    const dim3 grid((N + kBN - 1) / kBN, (M + 15) / 16, k_splits);
    woq_int8_tiled<TX, TO, 1><<<grid, block, 0, stream>>>(xp, wp, sp, zp, op, pp, M, N, K, group_size, asym, k_chunk);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + 63) / 64, k_splits);
    woq_int8_tiled<TX, TO, 4><<<grid, block, 0, stream>>>(xp, wp, sp, zp, op, pp, M, N, K, group_size, asym, k_chunk);
  }
  if (k_splits > 1) {
    if (cudaPeekAtLastError() != cudaSuccess) return;
    const size_t MN = static_cast<size_t>(M) * N;
    splitk_sum<TO><<<static_cast<unsigned>((MN + kThreads - 1) / kThreads), block, 0, stream>>>(pp, op, MN, k_splits);
  }
}

}  // namespace

// x: (M, K) f32 or bf16 (x_bf16 = 1); w: int8 (K, N); scales, zeros: f32
// (K/g, N) (zeros read only if asym); out: (M, N) f32 or bf16 (out_bf16 = 1);
// part: f32 (ceil(K / k_chunk), M, N) split-K workspace, unread when one
// split covers K. gemv = 1 selects the M <= 8 kernel, whose k_chunk must be
// a multiple of group_size; the tiled kernel's a multiple of 32. vec = 1
// when N % 4 == 0 and w, scales and zeros allow 4- and 16-byte loads.
// Returns cudaGetLastError() after the launches.
extern "C" int itx_woq_int8(const void* x, const void* w, const void* scales, const void* zeros,
                            void* out, void* part, int M, int N, int K, int group_size,
                            int asym, int gemv, int k_chunk, int vec, int x_bf16,
                            int out_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, scales, zeros, out, part, M, N, K, group_size, asym, gemv, k_chunk, vec, s);
  } else if (x_bf16) {
    launch<__nv_bfloat16, float>(x, w, scales, zeros, out, part, M, N, K, group_size, asym, gemv, k_chunk, vec, s);
  } else if (out_bf16) {
    launch<float, __nv_bfloat16>(x, w, scales, zeros, out, part, M, N, K, group_size, asym, gemv, k_chunk, vec, s);
  } else {
    launch<float, float>(x, w, scales, zeros, out, part, M, N, K, group_size, asym, gemv, k_chunk, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
