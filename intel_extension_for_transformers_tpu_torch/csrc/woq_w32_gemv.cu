// K3's split-K GEMV at decode (M <= 8) over the w32 layout, for Hopper.
//
// Replaces the m1 branch of intel_extension_for_transformers_tpu/ops/
// quant_matmul.py::_woq_kernel_w32 (launched from _pallas_woq_w32) at the
// rows ops/quant_matmul.py::k3_route gives it; woq_w32.cu holds K3's tiles
// and the layout's description.
//
// Bound on the H100: the words, K*N/2 bytes, at 3.35 TB/s (a Llama-2-7B
// 4096 -> 11008 product: 22.5 MB, 6.7 us). Near that rate the decode and
// its FMAs take most of the issue slots, so the design keeps the
// instructions a byte few, enough words in flight, and the fixed cost of a
// launch (x, scales, the split-K finish) off the loads' path.
// Design, on woq_gemv.cuh (the pieces of K1's and K2's GEMVs): a block of 8
// warps owns a strip of 128 columns. Each lane reads 4 adjacent columns of
// one word row as one 16-byte word where N and the pointers allow (else
// four 4-byte words), 32 lanes a row: word rows 8 warp .. 8 warp + 7 of
// each 512-row block, which hold the warp's 16-row span of each of the four
// planes, so a span never straddles a group. K is split on 512-row blocks
// until the card has about two blocks an SM (<= 128 registers a thread, so
// two fit). A block issues its first words and scales, then stages its
// split's x rows in shared memory once, with the sum of x over each 16-row
// span (a shuffle sum of 16 lanes), so no lane recomputes it and the walk
// has no barrier. At M = 1 a lane decodes a word row's four planes at once
// (two masks, then one prmt a value: the nibble under the exponent byte of
// 128.f is 128 + v', exact) and replaces it at once by the next block's
// (a predicated 16-byte load), so 8 words stay in flight; M > 1 walks plane
// by plane. Per span, the m1 arithmetic of the Pallas kernel: the f32 dot of
// x with 128 + v', scaled after the dot, minus sum(x) * s * zc in f32 (zc =
// 136 for sym, 128 + z for asym). The last block of a strip sums the f32
// partials in split order (woq_gemv.cuh::finish, arriving by one acq_rel
// atomic): one launch, no float atomics, the same bits every run.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "woq_gemv.cuh"

namespace {

// x values a block stages (TM rows of its split): the wrapper keeps
// TM * k_chunk at or below this (ops/quant_matmul.py::W32_GEMV_X_FLOATS)
constexpr int kXFloats = 8192;

// Columns n..n+3 of the word row at p (p points at column n): one 16-byte
// word (kVec: n < N always, see nl below), else four 4-byte words, zeros
// past N.
template <bool kVec>
__device__ __forceinline__ uint4 load_w4(const uint32_t* p, int n, int N) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    return make_uint4(n < N ? __ldg(p) : 0u, n + 1 < N ? __ldg(p + 1) : 0u, n + 2 < N ? __ldg(p + 2) : 0u,
                      n + 3 < N ? __ldg(p + 3) : 0u);
  }
}

// w = load_w4(p) where pred, else w unchanged: with kVec one predicated
// 16-byte load, no branch.
template <bool kVec>
__device__ __forceinline__ void load_w4_if(uint4& w, const uint32_t* p, int n, int N, bool pred) {
  if constexpr (kVec) {
    asm volatile(
        "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %4, 0;\n\t@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%5];\n\t}\n"
        : "+r"(w.x), "+r"(w.y), "+r"(w.z), "+r"(w.w)
        : "r"(static_cast<int>(pred)), "l"(p));
  } else if (pred) {
    w = load_w4<false>(p, n, N);
  }
}

// 128 + v' of plane j of a word (exact in f32): t = word & 0x0F0F0F0F for
// planes 0 and 2, (word >> 4) & 0x0F0F0F0F for 1 and 3, whose bytes are
// (lo row of plane j, lo of j + 2, hi of j, hi of j + 2); one prmt puts a
// nibble's byte under the exponent byte of 128.f.
template <int J>
__device__ __forceinline__ float plane_lo(uint32_t t) {
  return __uint_as_float(__byte_perm(t, 0x43000000u, 0x7054u | ((J >> 1) << 8)));  // row 128j + 2kw
}
template <int J>
__device__ __forceinline__ float plane_hi(uint32_t t) {
  return __uint_as_float(__byte_perm(t, 0x43000000u, 0x7254u | ((J >> 1) << 8)));  // row 128j + 2kw + 1
}

// d[j][c] += the dot of x rows (x[j].x, x[j].y) with plane j of word wc[c],
// for the four planes of one word row.
__device__ __forceinline__ void dot_row(float (&d)[4][4], const uint32_t (&wc)[4], const float2 (&x)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t t = wc[c] & 0x0F0F0F0Fu, u = (wc[c] >> 4) & 0x0F0F0F0Fu;
    d[0][c] = fmaf(x[0].y, plane_hi<0>(t), fmaf(x[0].x, plane_lo<0>(t), d[0][c]));
    d[1][c] = fmaf(x[1].y, plane_hi<1>(u), fmaf(x[1].x, plane_lo<1>(u), d[1][c]));
    d[2][c] = fmaf(x[2].y, plane_hi<2>(t), fmaf(x[2].x, plane_lo<2>(t), d[2][c]));
    d[3][c] = fmaf(x[3].y, plane_hi<3>(u), fmaf(x[3].x, plane_lo<3>(u), d[3][c]));
  }
}

// One plane's 128 + v' pair of a word, without the shared t/u (the TM > 1 walk).
template <int J>
__device__ __forceinline__ void decode_pair(uint32_t w, float& lo, float& hi) {
  const uint32_t t = ((J & 1) ? w >> 4 : w) & 0x0F0F0F0Fu;
  lo = plane_lo<J>(t);
  hi = plane_hi<J>(t);
}

template <typename TX, typename TO, int TM, bool kVec>
__global__ void __launch_bounds__(itx_gemv::kThreads, 2)  // <= 128 registers: two blocks an SM
woq_w32_gemv(const TX* __restrict__ x, const uint32_t* __restrict__ words,
             const float* __restrict__ scales, const float* __restrict__ zeros,
             TO* __restrict__ out, float* __restrict__ part, int* __restrict__ counters,
             int M, int N, int K, int group_size, int asym, int k_chunk) {
  // xs [TM][k_chunk] and its span sums [TM][k_chunk / 16]; after the walk,
  // finish's [kWarps][TM][kCols] reduction
  __shared__ __align__(16) float smem[kXFloats + kXFloats / 16];
  __shared__ int is_last;
  static_assert(itx_gemv::kWarps * TM * itx_gemv::kCols <= kXFloats + kXFloats / 16, "finish's reduction fits");
  float* xs = smem;
  float* xsum = smem + TM * k_chunk;
  const int spans = k_chunk / 16;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;  // word rows 8 warp .. 8 warp + 7 of each 512-row block
  const int n = blockIdx.x * itx_gemv::kCols + 4 * lane;
  // with 16-byte words (N % 4 == 0) a lane past N reads the last word, whose
  // sums finish never writes: no load is masked
  const int nl = kVec ? min(n, N - 4) : n;
  const int r_begin = blockIdx.y * k_chunk;  // a multiple of 512
  const int r_end = min(r_begin + k_chunk, (K + 511) / 512 * 512);
  const size_t ldw = N;
  const unsigned g = group_size;
  const uint32_t* wp = words + static_cast<size_t>(r_begin / 8 + 8 * warp) * ldw + nl;  // word row 8 warp of the block

  // plane j's scales (and zero points) of this warp's span in the 512-row
  // block at r0, columns n..n+3
  float s[4][4], z[4][4];
  auto load_scales = [&](int r0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t grp = static_cast<unsigned>(r0 + 128 * j + 16 * warp) / g;
      itx_gemv::load_row<4, kVec>(scales, grp, nl, N, s[j]);
      if (asym) {
        itx_gemv::load_row<4, kVec>(zeros, grp, nl, N, z[j]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) z[j][c] = 8.f;  // zc = 128 + 8 = 136
      }
    }
  };
  uint4 w[8];  // the first block's words and scales, in flight while x is staged
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = load_w4<kVec>(wp + i * ldw, n, N);
  load_scales(r_begin);

  // x rows r_begin.. of this split (zero past K and M), and each 16-row
  // span's sum: 16 adjacent threads hold a span (k_chunk is a multiple of
  // 512, so every thread runs the same count of iterations)
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    for (int k = threadIdx.x; k < k_chunk; k += itx_gemv::kThreads) {
      const int r = r_begin + k;
      float v = (m < M && r < K) ? itx::to_float(x[static_cast<size_t>(m) * K + r]) : 0.f;
      xs[m * k_chunk + k] = v;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (k % 16 == 0) xsum[(m * k_chunk + k) / 16] = v;
    }
  }
  __syncthreads();

  float acc[TM][4];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += 512) {
    const float* xr = xs + (r0 - r_begin) + 16 * warp;  // x row 0 of the warp's span of plane 0
    const uint32_t* next = wp + 64 * ldw;               // the next block's word rows
    if constexpr (TM == 1) {
      // i outer: each word row, once decoded for its four planes, is
      // replaced by the next block's, so 8 words stay in flight
      const bool more = r0 + 512 < r_end;
      float d[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) d[j][c] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t wc[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
        load_w4_if<kVec>(w[i], next + i * ldw, n, N, more);
        float2 xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = *reinterpret_cast<const float2*>(xr + 128 * j + 2 * i);
        dot_row(d, wc, xv);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rs = r0 + 128 * j + 16 * warp;  // the span: rows rs..rs + 15 of plane j
        if (rs >= K) continue;                    // x is zero there
        const float xsp = xsum[(rs - r_begin) / 16];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[0][c] += d[j][c] * s[j][c] - xsp * (s[j][c] * (z[j][c] + 128.f));
      }
    } else {
      // plane outer, TM rows a word: the block's words are loaded first
      if (r0 != r_begin) {
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = load_w4<kVec>(wp + i * ldw, n, N);
      }
      auto plane = [&](auto jc) {
        constexpr int j = decltype(jc)::value;
        const int rs = r0 + 128 * j + 16 * warp;
        if (rs >= K) return;
        float dm[TM][4];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) dm[m][c] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t wc[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
          float2 xv[TM];
#pragma unroll
          for (int m = 0; m < TM; ++m) xv[m] = *reinterpret_cast<const float2*>(xr + m * k_chunk + 128 * j + 2 * i);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float lo, hi;
            decode_pair<j>(wc[c], lo, hi);
#pragma unroll
            for (int m = 0; m < TM; ++m) dm[m][c] = fmaf(xv[m].y, hi, fmaf(xv[m].x, lo, dm[m][c]));
          }
        }
        const float* xsp = xsum + (rs - r_begin) / 16;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float corr = s[j][c] * (z[j][c] + 128.f);
#pragma unroll
          for (int m = 0; m < TM; ++m) acc[m][c] += dm[m][c] * s[j][c] - xsp[m * spans] * corr;
        }
      };
      plane(std::integral_constant<int, 0>());
      plane(std::integral_constant<int, 1>());
      plane(std::integral_constant<int, 2>());
      plane(std::integral_constant<int, 3>());
    }
    wp = next;
    if (r0 + 512 < r_end) load_scales(r0 + 512);
  }
  __syncthreads();  // xs and the span sums are consumed: finish reuses the memory
  itx_gemv::finish<TM, 4, TO, true>(acc, reinterpret_cast<float (*)[TM][itx_gemv::kCols]>(smem), &is_last, out,
                                    part, counters, M, N);
}

template <typename TX, typename TO>
void launch(const void* x, const void* words, const void* scales, const void* zeros, void* out, void* part,
            void* counters, int M, int N, int K, int group_size, int asym, int k_chunk, int vec,
            cudaStream_t stream) {
  const int k_splits = ((K + 511) / 512 * 512 + k_chunk - 1) / k_chunk;
  const dim3 grid((N + itx_gemv::kCols - 1) / itx_gemv::kCols, k_splits);
#define ITX_GEMV(TM, VEC)                                                                                   \
  woq_w32_gemv<TX, TO, TM, VEC><<<grid, itx_gemv::kThreads, 0, stream>>>(                                  \
      static_cast<const TX*>(x), static_cast<const uint32_t*>(words), static_cast<const float*>(scales),   \
      static_cast<const float*>(zeros), static_cast<TO*>(out), static_cast<float*>(part),                  \
      static_cast<int*>(counters), M, N, K, group_size, asym, k_chunk)
  if (M == 1 && vec) {
    ITX_GEMV(1, true);
  } else if (M == 1) {
    ITX_GEMV(1, false);
  } else if (vec) {
    ITX_GEMV(8, true);
  } else {
    ITX_GEMV(8, false);
  }
#undef ITX_GEMV
}

}  // namespace

// x: (M, K) f32 or bf16 (x_bf16 = 1), M <= 8; words: int32 (Kp/8, N) with
// Kp >= K rounded up to 512; scales: f32 (Kp/g, N); zeros: f32 (Kp/g, N),
// read only if asym; out: (M, N) f32 or bf16 (out_bf16 = 1). K rounded up
// to 512 is split into k_chunk rows (a multiple of 512, with TM * k_chunk <=
// kXFloats, TM = 1 at M = 1, else 8); with more than one split, part is an
// f32 (splits, M, N) workspace and counters holds one int a 128-column
// strip, all 0 (both unread with one split). vec = 1 when N % 4 == 0 and
// words, scales and zeros allow 16-byte loads. Returns the launch's CUDA
// error (cudaGetLastError()), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int itx_woq_w32_gemv(const void* x, const void* words, const void* scales, const void* zeros,
                                void* out, void* part, void* counters, int M, int N, int K, int group_size,
                                int asym, int k_chunk, int vec, int x_bf16, int out_bf16, void* stream) {
  if (M < 1 || M > 8 || group_size % 16 || k_chunk <= 0 || k_chunk % 512 ||
      (M == 1 ? 1 : 8) * k_chunk > kXFloats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, words, scales, zeros, out, part, counters, M, N, K, group_size, asym, k_chunk, vec, s);
  } else if (x_bf16) {
    launch<__nv_bfloat16, float>(x, words, scales, zeros, out, part, counters, M, N, K, group_size, asym, k_chunk, vec, s);
  } else if (out_bf16) {
    launch<float, __nv_bfloat16>(x, words, scales, zeros, out, part, counters, M, N, K, group_size, asym, k_chunk, vec, s);
  } else {
    launch<float, float>(x, words, scales, zeros, out, part, counters, M, N, K, group_size, asym, k_chunk, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
