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
//    (The tensor-core tiles take q = v' - 8 for sym: the same exact
//    products without the offset; see Design.)
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
// the loads, not the ALUs, bound it. As M grows the operations take over:
// 2 M K N at 989 TFLOP/s in bf16 on the tensor cores (0.069-0.543 ms for
// the Llama-2-7B products at M = 2048), 67 TFLOP/s in f32 on the SIMT tiles.
// Design, one launch a product (the route is ops/quant_matmul.py::k3_route):
//  * "gemv" (M <= K3_GEMV_MAX_M; f32 x or g not a multiple of 32 up to 8
//    rows; always the m1 branch): the split-K GEMV of woq_w32_gemv.cu.
//  * "tiles" (bf16 x, g a multiple of 32, above K3_GEMV_MAX_M rows): the
//    tensor-core tiles of woq_tc.cuh (W32Tile below). A stage is 64 natural
//    rows of one 128-row plane (32 when g % 64 != 0): 32 word rows x 128
//    columns by cp.async, and the 64 x columns. One word view is the
//    B-fragment register of mma.m16n8k16 as it stands (rows 2kw and 2kw + 1
//    of one column, low half first), so a B register costs one shift, AND
//    and OR. m1: each group's k-steps sum into a per-group f32 fragment,
//    scaled after the dot. For asym, B is 128 + v' (exact) and
//    acc += part * s - sum(x_g) * s * zc in f32, s * zc formed in f32 and
//    sum(x_g) per row from one more mma of the staged x with a B of ones
//    (exact products, f32 sums): the Pallas kernel's order. For sym, B is
//    q = v' - 8, exact in bf16 (one more bf16x2 FMA, 128 + v' - 136), and
//    acc += part * s: the same exact products without the 136 * sum(x_g)
//    that the Pallas order cancels, and no mma of ones.
//    fold: ((128 + v') - zc) * s in f32, rounded to bf16, two to a register.
//    The walk stops at K rounded up to g (the padding's groups hold zeros).
//    Re-reading a word for each of its 4 planes costs L2 traffic, not
//    device-memory traffic: the stages of one column block walk the planes
//    of a 512-row block one after the other.
//  * "simt" above 8 rows otherwise (f32 x: HIGHEST precision has no
//    tensor-core route of equal accuracy here; or g not a multiple of 32):
//    a tiled SIMT kernel, a 64 x 64 output tile per block, K walked in spans
//    of 16 or 32 natural rows whose words are decoded once into shared
//    memory and reused by all 64 rows, a 4 x 4 register tile per thread.
// Later work (ROADMAP): wgmma + TMA for the tiles; f32 x on the tensor cores.

#include <stdint.h>

#include "common.cuh"
#include "woq_tc.cuh"

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


// ---- M > 8, bf16 x: tensor-core tiles (woq_tc.cuh) ------------------------
// B-fragment policy over the w32 words: a stage is BK natural rows r0.. of
// plane j = (r0 % 512) / 128 (BK = 64 when g % 64 == 0, else 32, so a
// stage lies in one group), i.e. word rows (r0 / 512) * 64 + (r0 % 128) / 2
// onwards, BK / 2 of them. k-step ks of the stage reads, for lane (g, t)
// and the column of n8 fragment ni, word rows 8 ks + t (b0) and
// 8 ks + t + 4 (b1).
template <int BM, bool FOLD, int BK_, bool SYM = false>
struct W32Tile {
  static constexpr bool XSUM = !FOLD && !SYM;  // m1 asym: sum(x_g) a row, removed times s * zc
  using S = itx_tc::Shape<BM>;
  static constexpr int BK = BK_, SLICES = 1;
  static constexpr int WROW = itx_tc::kBN + 8;  // words a staged row (padded: no bank conflicts)
  static constexpr int W_BYTES = (BK / 2) * WROW * 4;
  static constexpr int EXTRA_BYTES = 0;

  int wcol;     // this lane's B column in the tile (n8 fragment 0)
  int nb;       // the same, absolute
  int nc;       // this lane's first accumulator column, absolute (n8 fragment 0)
  int t;        // lane % 4
  int shift;    // 4 j for this stage's plane j
  float xs[S::MT][4];            // m1: sum of x over the group, rows g (e < 2) and g + 8
  float sb[S::NT], zb[S::NT];    // fold: s and zc of the B columns for this stage's group
  float sc[S::NT][2], cc[S::NT][2];  // m1: s and s * zc of the accumulator columns, the group ending here

  __device__ W32Tile(const itx_tc::Params&, unsigned char*, int n0, int wn, int lane)
      : wcol(wn + lane / 4), nb(n0 + wn + lane / 4), nc(n0 + wn + 2 * (lane % 4)), t(lane % 4), shift(0) {
#pragma unroll
    for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[mi][e] = 0.f;
  }

  __device__ static int x_col(const itx_tc::Params&, int, int r0) { return r0; }
  __device__ static int x_limit(const itx_tc::Params& p, int) { return p.K; }

  __device__ static void load_w(unsigned char* ws, const itx_tc::Params& p, int r0, int n0) {
    const auto* words = static_cast<const uint32_t*>(p.w) +
                        static_cast<size_t>((r0 / 512) * 64 + (r0 % 128) / 2) * p.N;  // the stage's first word row
    constexpr int CPR = itx_tc::kBN / 4;  // 16-byte pieces a row
    auto* d0 = reinterpret_cast<uint32_t*>(ws);
    if (p.w_aligned && n0 + itx_tc::kBN <= p.N) {
      itx_tc::for_each_piece<(BK / 2) * CPR, S::THREADS>([&](int i) {
        const int r = i / CPR, c = (i % CPR) * 4;
        itx::cp_async16(d0 + r * WROW + c, words + static_cast<size_t>(r) * p.N + n0 + c, true);
      });
      return;
    }
    itx_tc::for_each_piece<(BK / 2) * CPR, S::THREADS>([&](int i) {
      const int r = i / CPR, c = (i % CPR) * 4;
      const int n = n0 + c;
      uint32_t* d = d0 + r * WROW + c;
      if (n >= p.N) {
        itx::cp_async16(d, words, false);
      } else {
        const uint32_t* src = words + static_cast<size_t>(r) * p.N + n;
        if (p.w_aligned && n + 4 <= p.N) {
          itx::cp_async16(d, src, true);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] = n + e < p.N ? src[e] : 0u;
        }
      }
    });
  }

  __device__ void begin_stage(const itx_tc::Params& p, const unsigned char*, int r0) {
    shift = 4 * ((r0 % 512) / 128);
    const size_t row = static_cast<size_t>(r0 / p.group_size) * p.N;
    if (FOLD && r0 % p.group_size == 0) {
#pragma unroll
      for (int ni = 0; ni < S::NT; ++ni) {
        const int n = nb + 8 * ni;
        sb[ni] = n < p.N ? p.scales[row + n] : 0.f;
        zb[ni] = p.scheme ? (n < p.N ? p.zeros[row + n] : 0.f) + 128.f : 136.f;
      }
    }
    if (!FOLD && (r0 + BK) % p.group_size == 0) {  // the group ends with this stage: its scales, loaded
#pragma unroll                                    // before the stage's math
      for (int ni = 0; ni < S::NT; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = nc + 8 * ni + c;
          sc[ni][c] = n < p.N ? p.scales[row + n] : 0.f;
          if (XSUM) cc[ni][c] = sc[ni][c] * ((n < p.N ? p.zeros[row + n] : 0.f) + 128.f);
        }
    }
  }

  __device__ void a_hook(const uint32_t (&a)[S::MT][4]) {
    if (XSUM) {  // sum(x) of each row over these 16 columns: one mma with a B of ones
#pragma unroll
      for (int mi = 0; mi < S::MT; ++mi) itx::mma_bf16(xs[mi], a[mi], itx::kBf16x2One, itx::kBf16x2One);
    }
  }

  __device__ uint32_t fold(uint32_t v, int ni) const {
    const float lo = __uint_as_float(v << 16), hi = __uint_as_float(v & 0xFFFF0000u);
    return itx::cvt_bf16x2((lo - zb[ni]) * sb[ni], (hi - zb[ni]) * sb[ni]);
  }

  __device__ void b_frag(const unsigned char* ws, int, int ks, int ni, uint32_t& b0, uint32_t& b1) const {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(ws) + (8 * ks + t) * WROW + wcol + 8 * ni;
    b0 = 0x43004300u | ((w[0] >> shift) & 0x000F000Fu);  // 128 + v', rows 2kw and 2kw + 1
    b1 = 0x43004300u | ((w[4 * WROW] >> shift) & 0x000F000Fu);
    if (!FOLD && SYM) {  // q = 128 + v' - 136, exact
      b0 = itx::bf16x2_fma(b0, itx::kBf16x2One, 0xC308C308u);
      b1 = itx::bf16x2_fma(b1, itx::kBf16x2One, 0xC308C308u);
    }
    if (FOLD) {
      b0 = fold(b0, ni);
      b1 = fold(b1, ni);
    }
  }

  __device__ void end_stage(const itx_tc::Params& p, float (&acc)[S::MT][S::NT][4],
                            float (&part)[S::MT][S::NT][4], int r0) {
    if (FOLD) {
#pragma unroll
      for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < S::NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mi][ni][e] += part[mi][ni][e];
            part[mi][ni][e] = 0.f;
          }
      return;
    }
    if ((r0 + BK) % p.group_size) return;  // the group goes on
#pragma unroll
    for (int ni = 0; ni < S::NT; ++ni)
#pragma unroll
      for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mi][ni][e] += XSUM ? part[mi][ni][e] * sc[ni][e & 1] - xs[mi][e & 2] * cc[ni][e & 1]
                                 : part[mi][ni][e] * sc[ni][e & 1];
          part[mi][ni][e] = 0.f;
        }
#pragma unroll
    for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[mi][e] = 0.f;
  }
};

template <int BM>
using W32TileM1Asym = W32Tile<BM, false, 64>;
template <int BM>
using W32TileM1AsymG32 = W32Tile<BM, false, 32>;
template <int BM>
using W32TileM1Sym = W32Tile<BM, false, 64, true>;
template <int BM>
using W32TileM1SymG32 = W32Tile<BM, false, 32, true>;
template <int BM>
using W32TileFold = W32Tile<BM, true, 64>;
template <int BM>
using W32TileFoldG32 = W32Tile<BM, true, 32>;

template <typename TX, typename TO>
void launch(const void* x, const void* words, const void* scales, const void* zeros, void* out, int M, int N,
            int K, int Kp, int group_size, int asym, int m1, cudaStream_t stream) {
  const auto* xp = static_cast<const TX*>(x);
  const auto* wp = static_cast<const uint32_t*>(words);
  const auto* sp = static_cast<const float*>(scales);
  const auto* zp = static_cast<const float*>(zeros);
  auto* op = static_cast<TO*>(out);
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
// f32 or bf16 (out_bf16 = 1); m1 selects the branch (see above). bm = 0
// takes the SIMT tiles; bm in {16, 32, 64, 128} the tensor-core tiles (bf16
// x, g % 32 == 0), split along K into k_chunk rows (a multiple of g; part
// is an f32 (splits, M, N) workspace and counters holds ceil(M / bm) *
// ceil(N / 128) ints that are 0, both unread with one split); vec = 1 when
// x (and K) allow 16-byte copies, + 2 when words (and N) do. The GEMV is
// woq_w32_gemv.cu's. Returns the launch's CUDA error (cudaGetLastError()).
extern "C" int itx_woq_w32(const void* x, const void* words, const void* scales,
                           const void* zeros, void* out, void* part, void* counters, int M,
                           int N, int K, int Kp, int group_size, int asym, int m1, int bm,
                           int k_chunk, int vec, int x_bf16, int out_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bm) {
    if (!x_bf16) return static_cast<int>(cudaErrorInvalidValue);
    itx_tc::Params p{static_cast<const __nv_bfloat16*>(x), words, static_cast<const float*>(scales),
                     static_cast<const float*>(zeros), nullptr, out, static_cast<float*>(part),
                     static_cast<int*>(counters), M, N, K,
                     (K + group_size - 1) / group_size * group_size, group_size, asym, k_chunk,
                     out_bf16, vec & 1, (vec >> 1) & 1};
    const bool g64 = group_size % 64 == 0;  // 64-row stages, else 32
    cudaError_t err;
    if (!m1) {
      err = g64 ? itx_tc::launch_bm<W32TileFold>(p, bm, s) : itx_tc::launch_bm<W32TileFoldG32>(p, bm, s);
    } else if (asym) {
      err = g64 ? itx_tc::launch_bm<W32TileM1Asym>(p, bm, s) : itx_tc::launch_bm<W32TileM1AsymG32>(p, bm, s);
    } else {
      err = g64 ? itx_tc::launch_bm<W32TileM1Sym>(p, bm, s) : itx_tc::launch_bm<W32TileM1SymG32>(p, bm, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
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
