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
// is rounded to bf16 (exact for integer zero points), and q*s (or (q-z)*s)
// is rounded once to bf16 before the product; in f32 every step is f32 (no
// TF32). The accumulator is f32; the output is f32 or bf16.
//
// Bound on the H100: at decode (M <= 8) the weight, K*N bytes, is the traffic
// that matters (a Llama-2-7B 4096 -> 11008 product: 46.5 MB, 13.9 us at
// 3.35 TB/s); as M grows the operations take over (989 TFLOP/s in bf16 on
// the tensor cores).
// Design, one launch a product at every M:
//  * M <= K2_GEMV_MAX_M (ops/quant_matmul.py; the kernel takes up to 8
//    rows): the split-K GEMV of woq_gemv.cuh (K1's). A lane reads 16 weight
//    bytes of a row as one word where N and the pointers allow (else 4, else
//    byte by byte); in bf16 a 4-byte word becomes four bf16 weights through
//    f32 2^23 + byte (exact), a bf16 pair and one bf16x2 fma with the
//    group's scales (bf16(q * s), rounded as the Pallas kernel). K is split on
//    group boundaries until the card has about two blocks an SM; the last
//    block of a strip sums the f32 partials in split order.
//  * Above it, bf16 x, g a multiple of 32: the tensor-core tiles of
//    woq_tc.cuh (Int8Tile below). A stage is 32 weight rows x 128 columns,
//    4 KB by 16-byte cp.async, decoded once a block with the GEMV's
//    arithmetic into a bf16 tile that the warps read by ldmatrix.trans.
//  * Otherwise (f32 x, or g not a multiple of 32): tiled SIMT. A block owns
//    a BM x 64 output tile (BM = 64, or 16 for M <= 16) and walks its K range
//    in steps of 32 rows; each step dequantizes a 32 x 64 weight slab once
//    into shared memory, reused by all BM rows, for a SIMT FMA loop over a
//    4x4 (BM = 64) or 1x4 (BM = 16) register tile per thread.
// The tiles split K as the GEMV does (the last block of an output tile sums
// the partials), where the tiles alone do not fill the card: no float
// atomics, so every run gives the same bits.

#include <stdint.h>

#include "common.cuh"
#include "woq_gemv.cuh"
#include "woq_tc.cuh"

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

// The four int8 weights of `word` (columns 0-3, one byte each) as bf16
// pairs, o.x columns 0 and 1, o.y 2 and 3 (low halves first), rounded as
// dequant8<true>: s01 and s23 are the columns' scales as bf16 pairs, zb their
// zero points rounded to bf16 (asym).
__device__ __forceinline__ uint2 decode_bf16(uint32_t word, int asym, uint32_t s01, uint32_t s23,
                                             const float (&zb)[4]) {
  uint32_t q01, q23;
  if (asym) {  // bf16(q - z), q = byte
    const float q0 = itx::byte_as_f32_2p23<0>(word) - 8388608.f;
    const float q1 = itx::byte_as_f32_2p23<1>(word) - 8388608.f;
    const float q2 = itx::byte_as_f32_2p23<2>(word) - 8388608.f;
    const float q3 = itx::byte_as_f32_2p23<3>(word) - 8388608.f;
    q01 = itx::cvt_bf16x2(q0 - zb[0], q1 - zb[1]);
    q23 = itx::cvt_bf16x2(q2 - zb[2], q3 - zb[3]);
  } else {  // the signed byte, flipped in its top bit: 2^23 + 128 + q
    word ^= 0x80808080u;
    q01 = itx::hi_halves(itx::byte_as_f32_2p23<0>(word) - 8388736.f, itx::byte_as_f32_2p23<1>(word) - 8388736.f);
    q23 = itx::hi_halves(itx::byte_as_f32_2p23<2>(word) - 8388736.f, itx::byte_as_f32_2p23<3>(word) - 8388736.f);
  }
  return make_uint2(itx::bf16x2_fma(q01, s01, itx::kBf16x2NegZero),  // bf16(q * s)
                    itx::bf16x2_fma(q23, s23, itx::kBf16x2NegZero));
}

// ---- M <= 8: split-K GEMV over 128-column strips (woq_gemv.cuh) ---------
template <typename TX, typename TO, int TM, int CPL, bool kVec>
__global__ void __launch_bounds__(itx_gemv::kThreads)
woq_int8_gemv(const TX* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scales, const float* __restrict__ zeros,
              TO* __restrict__ out, float* __restrict__ part, int* __restrict__ counters,
              int M, int N, int K, int group_size, int asym, int k_chunk) {
  using Sh = itx_gemv::Shape<CPL>;
  constexpr bool kBF16 = sizeof(TX) == 2;
  constexpr int NW = CPL / 4;  // 32-bit words a lane reads from a row
  __shared__ float red[itx_gemv::kWarps][TM][itx_gemv::kCols];
  __shared__ int is_last;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int sub = lane / Sh::LPR;  // this lane's row among the warp's RPW
  const int n = blockIdx.x * itx_gemv::kCols + (lane % Sh::LPR) * CPL;
  const int r_begin = blockIdx.y * k_chunk;  // a multiple of group_size
  const int r_end = min(K, r_begin + k_chunk);

  float acc[TM][CPL];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[m][c] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += group_size) {
    const size_t grp = r0 / group_size;
    float s[CPL], z[CPL];
    itx_gemv::load_row<CPL, kVec>(scales, grp, n, N, s);
    if (asym) {
      itx_gemv::load_row<CPL, kVec>(zeros, grp, n, N, z);
    } else {
#pragma unroll
      for (int c = 0; c < CPL; ++c) z[c] = 0.f;
    }
    uint32_t s2[CPL / 2];  // bf16 pairs of s (bf16 x)
    float zb[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) zb[c] = itx::round_bf16(z[c]);
#pragma unroll
    for (int k = 0; k < CPL / 2; ++k) s2[k] = itx::cvt_bf16x2(s[2 * k], s[2 * k + 1]);
    for (int i = warp * Sh::RPW + sub; i < group_size; i += Sh::RPB * itx_gemv::kUnroll) {
      uint32_t words[itx_gemv::kUnroll][NW];
#pragma unroll
      for (int u = 0; u < itx_gemv::kUnroll; ++u) {
        const int ii = i + Sh::RPB * u;
        if (ii < group_size) {
          itx_gemv::load_words<CPL, kVec>(w, r0 + ii, n, N, words[u]);
        } else {
#pragma unroll
          for (int j = 0; j < NW; ++j) words[u][j] = 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < itx_gemv::kUnroll; ++u) {
        const int ii = i + Sh::RPB * u;
        if (ii >= group_size) continue;
        const int r = r0 + ii;
        float xv[TM];
#pragma unroll
        for (int m = 0; m < TM; ++m) xv[m] = m < M ? itx::to_float(x[static_cast<size_t>(m) * K + r]) : 0.f;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          float wv[4];
          if (kBF16) {
            const float zj[4] = {zb[4 * j], zb[4 * j + 1], zb[4 * j + 2], zb[4 * j + 3]};
            const uint2 d = decode_bf16(words[u][j], asym, s2[2 * j], s2[2 * j + 1], zj);
            wv[0] = __uint_as_float(d.x << 16);
            wv[1] = __uint_as_float(d.x & 0xFFFF0000u);
            wv[2] = __uint_as_float(d.y << 16);
            wv[3] = __uint_as_float(d.y & 0xFFFF0000u);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              wv[c] = dequant8<false>(byte_of(words[u][j], c, asym), s[4 * j + c], z[4 * j + c], asym);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int m = 0; m < TM; ++m) acc[m][4 * j + c] = fmaf(xv[m], wv[c], acc[m][4 * j + c]);
        }
      }
    }
  }
  itx_gemv::finish<TM, CPL>(acc, red, &is_last, out, part, counters, M, N);
}

// ---- f32 x, or g % 32 != 0: tiled SIMT GEMM -------------------------------
constexpr int kBN = 64;  // output columns per block
constexpr int kTN = 4;   // output columns per thread
constexpr int kTK = 32;  // K rows per step

template <typename TX, typename TO, int TM>
__global__ void __launch_bounds__(kThreads)
woq_int8_tiled(const TX* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scales, const float* __restrict__ zeros,
               TO* __restrict__ out, float* __restrict__ part, int* __restrict__ counters, int M, int N,
               int K, int group_size, int asym, int k_chunk) {
  constexpr bool kBF16 = sizeof(TX) == 2;
  constexpr int BM = 16 * TM;
  constexpr int kXS = BM + 4;  // padded row: fewer bank conflicts, rows stay 16-byte aligned
  __shared__ __align__(16) float xs[kTK][kXS];
  __shared__ __align__(16) float ws[kTK][kBN];
  __shared__ int is_last;

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
  const size_t MN = static_cast<size_t>(M) * N;
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
        part[blockIdx.z * MN + o] = acc[i][j];
      }
    }
  }
  if (direct) return;

  // the last block of this output tile to arrive sums the partials in split order
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (!itx::last_to_arrive(&counters[tile], gridDim.z, &is_last)) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n >= N) continue;
      const size_t o = static_cast<size_t>(m) * N + n;
      float sum = 0.f;
      for (unsigned z = 0; z < gridDim.z; ++z) sum += __ldcg(part + z * MN + o);
      out[o] = itx::from_float<TO>(sum);
    }
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

// ---- above the GEMV, bf16 x, g % 32 == 0: tensor-core tiles (woq_tc.cuh) --
// A stage is weight rows r0..r0+31 of one group; begin_stage decodes it into
// the bf16 tile (each thread 4 columns of DWORDS rows) with decode_bf16.
template <int BM>
struct Int8Tile : itx_tc::ByteRowsTile<BM, 1> {
  using Base = itx_tc::ByteRowsTile<BM, 1>;
  static constexpr int EXTRA_BYTES = Base::TILE_BYTES;

  int asym;
  uint32_t s01, s23;  // bf16 scales of this thread's columns 4c..4c+3, as pairs
  float zb[4];        // their zero points rounded to bf16 (asym)

  __device__ Int8Tile(const itx_tc::Params& p, unsigned char* extra, int, int wn_, int lane_)
      : Base(extra, wn_, lane_), asym(p.scheme) {}

  __device__ static int x_col(const itx_tc::Params&, int, int r0) { return r0; }
  __device__ static int x_limit(const itx_tc::Params& p, int) { return p.K; }

  __device__ void begin_stage(const itx_tc::Params& p, const unsigned char* ws, int r0) {
    if (r0 % p.group_size == 0) {  // a new group: its scales (and zero points) for this thread's columns
      const int n = blockIdx.x * itx_tc::kBN + 4 * Base::wcol();
      const size_t row = static_cast<size_t>(r0 / p.group_size) * p.N;
      float s[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = n + c < p.N;
        s[c] = in ? p.scales[row + n + c] : 0.f;
        zb[c] = itx::round_bf16(asym && in ? p.zeros[row + n + c] : 0.f);
      }
      s01 = itx::cvt_bf16x2(s[0], s[1]);
      s23 = itx::cvt_bf16x2(s[2], s[3]);
    }
#pragma unroll
    for (int i = 0; i < Base::DWORDS; ++i) {
      const int r = Base::drow(i);
      this->put(0, r, decode_bf16(Base::staged_word(ws, r), asym, s01, s23, zb));
    }
    __syncthreads();  // the decoded stage is complete
  }
};

enum Route { kSimtTiles = 0, kGemv = 1, kTensorTiles = 2 };

template <typename TX, typename TO>
void launch(const void* x, const void* w, const void* scales, const void* zeros, void* out, void* part,
            void* counters, int M, int N, int K, int group_size, int asym, int route, int k_chunk, int vec,
            cudaStream_t stream) {
  const auto* xp = static_cast<const TX*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  const auto* zp = static_cast<const float*>(zeros);
  auto* op = static_cast<TO*>(out);
  auto* pp = static_cast<float*>(part);
  auto* cnt = static_cast<int*>(counters);
  const int k_splits = (K + k_chunk - 1) / k_chunk;
  if (route == kGemv) {
    const dim3 grid((N + itx_gemv::kCols - 1) / itx_gemv::kCols, k_splits);
#define ITX_GEMV(TM, CPL, VEC) \
  woq_int8_gemv<TX, TO, TM, CPL, VEC><<<grid, itx_gemv::kThreads, 0, stream>>>( \
      xp, wp, sp, zp, op, pp, cnt, M, N, K, group_size, asym, k_chunk)
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
  } else if (M <= 16) {
    const dim3 grid((N + kBN - 1) / kBN, (M + 15) / 16, k_splits);
    woq_int8_tiled<TX, TO, 1><<<grid, kThreads, 0, stream>>>(xp, wp, sp, zp, op, pp, cnt, M, N, K, group_size, asym, k_chunk);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + 63) / 64, k_splits);
    woq_int8_tiled<TX, TO, 4><<<grid, kThreads, 0, stream>>>(xp, wp, sp, zp, op, pp, cnt, M, N, K, group_size, asym, k_chunk);
  }
}

}  // namespace

// x: (M, K) f32 or bf16 (x_bf16 = 1); w: int8 (K, N); scales, zeros: f32
// (K/g, N) (zeros read only if asym); out: (M, N) f32 or bf16 (out_bf16 = 1).
// Every route splits K into ceil(K / k_chunk) splits; with more than one,
// part is an f32 (splits, M, N) workspace and counters holds one int a strip
// or output tile, all 0 (both unread with one split). route picks the kernel:
//  * 1 (M <= 8): the GEMV, k_chunk a multiple of group_size, one counter a
//    128-column strip; vec = 2 when N % 16 == 0 and w, scales and zeros
//    allow 16-byte loads, 1 when N % 4 == 0 and w allows 4-byte and scales
//    and zeros 16-byte loads, else 0;
//  * 2: the tensor-core tiles (bf16 x, g % 32 == 0) with BM = bm rows,
//    k_chunk a multiple of g, one counter a bm x 128 tile; vec = 1 when x
//    (and K) allow 16-byte copies, + 2 when w (and N) do;
//  * 0: the SIMT tiles, k_chunk a multiple of 32, one counter a 64-column
//    tile of 16 rows (M <= 16) or 64.
// Returns the launch's CUDA error (cudaGetLastError()).
extern "C" int itx_woq_int8(const void* x, const void* w, const void* scales, const void* zeros, void* out,
                            void* part, void* counters, int M, int N, int K, int group_size, int asym,
                            int route, int bm, int k_chunk, int vec, int x_bf16, int out_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (route == kTensorTiles) {
    if (!x_bf16) return static_cast<int>(cudaErrorInvalidValue);
    itx_tc::Params p{static_cast<const __nv_bfloat16*>(x), w, static_cast<const float*>(scales),
                     static_cast<const float*>(zeros), nullptr, out, static_cast<float*>(part),
                     static_cast<int*>(counters), M, N, K, K, group_size, asym, k_chunk, out_bf16, vec & 1,
                     (vec >> 1) & 1};
    const cudaError_t err = itx_tc::launch_bm<Int8Tile>(p, bm, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (x_bf16 && out_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, scales, zeros, out, part, counters, M, N, K, group_size, asym, route, k_chunk, vec, s);
  } else if (x_bf16) {
    launch<__nv_bfloat16, float>(x, w, scales, zeros, out, part, counters, M, N, K, group_size, asym, route, k_chunk, vec, s);
  } else if (out_bf16) {
    launch<float, __nv_bfloat16>(x, w, scales, zeros, out, part, counters, M, N, K, group_size, asym, route, k_chunk, vec, s);
  } else {
    launch<float, float>(x, w, scales, zeros, out, part, counters, M, N, K, group_size, asym, route, k_chunk, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
