// One tensor-core tile GEMM for the WOQ kernels K1 (woq_int4.cu, khalf int4),
// K2 (woq_int8.cu, int8) and K3 (woq_w32.cu, w32 int4), bf16 x, sm_90a.
//
//   out (M, N) = x (M, K) . dequant(W), f32 accumulators
//
// Skeleton (tile_kernel below); the weight decoder is the template policy P:
//  * a block owns a BM x 128 output tile, BM in {16, 32, 64, 128}; 4 warps
//    (BM <= 32) or 8 (2 x 4), each a warp tile of m16n8 fragments (16 x 32,
//    32 x 32 or 64 x 32; at BM = 128 on the H100, 8 warps of 64 x 32 were
//    faster than 16 of 32 x 32);
//  * the block walks its rows of K (all of them, or one split of them) in
//    stages of P::BK rows; x (bf16, P::SLICES column slices a stage) and the
//    packed weight arrive by 16-byte cp.async into a ring of 3 or 4 stages,
//    the next stage's copies issued before the current stage's math; rows
//    and columns past the edges arrive as zeros;
//  * A fragments come from the x stage by ldmatrix; B fragments come from
//    P::b_frag, which decodes the staged weight (K3 in registers; K1 and K2
//    from a bf16 tile decoded once a stage into shared memory,
//    ByteRowsTile); mma.sync m16n8k16 bf16 ->
//    f32 into `part`, which P::end_stage folds into `acc` (K3's m1 branch:
//    once a group, part * s minus sum(x_g) * s * zc);
//  * split K: blockIdx.z takes k_chunk rows of the walk (a multiple of the
//    group size); each split writes f32 partials and the last block of an
//    output tile to arrive (an int counter a tile, __threadfence +
//    atomicAdd) sums them in split order, writes out and resets its counter
//    to 0. One launch, no float atomics: every run gives the same bits.
// Later work: wgmma with TMA-fed stages and warp specialisation.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace itx_tc {

constexpr int kBN = 128;  // output columns a block
constexpr int kXPad = 8;  // bf16 a staged x row is padded by (ldmatrix without bank conflicts)

template <int BM_>
struct Shape {
  static constexpr int BM = BM_;
  static constexpr int WARPS_M = BM >= 64 ? 2 : 1;
  static constexpr int WARPS_N = 4;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M;  // warp tile rows
  static constexpr int WN = kBN / WARPS_N;  // warp tile columns (32)
  static constexpr int MT = WM / 16;        // m16 fragments a warp
  static constexpr int NT = WN / 8;         // n8 fragments a warp
  // BM = 128 keeps its accumulators (and K3's per-group partials) in
  // registers, one block an SM; the smaller tiles at most 128 registers a thread
  static constexpr int MIN_BLOCKS = BM == 128 ? 1 : 512 / THREADS;
  // depth of the cp.async ring: the small tiles' split walks are short and
  // fill a shallower ring sooner (on the H100, 3 stages were faster than 4
  // at M = 16, 4 faster than 3 from M = 512)
  static constexpr int STAGES = BM <= 32 ? 3 : 4;
};

struct Params {
  const __nv_bfloat16* x;  // (M, K)
  const void* w;           // the packed weight
  const float* scales;
  const float* zeros;     // asym only
  const float* codebook;  // K1's nf4/fp4 only
  void* out;              // (M, N), f32 or bf16
  float* part;            // (splits, M, N) when split
  int* counters;          // one int a tile, all 0, when split
  int M, N, K;
  int span;        // rows of the walk: K1 K/2 packed rows, K3 K rounded up to g
  int group_size;  // a multiple of 32
  int scheme;      // K1: 0 sym, 1 asym, 2 codebook; K3: 0 sym, 1 asym
  int k_chunk;     // rows of the walk a split takes, a multiple of group_size
  int out_bf16;
  int x_aligned;  // x's base, K and the slices' first columns allow 16-byte copies
  int w_aligned;  // the weight's base and row length allow 16-byte copies
};

using itx::cp_async16;
using itx::cp_async_commit;
using itx::cp_async_wait;
using itx::ldsm_x4;
using itx::mma_bf16;

using itx::for_each_piece;

// Stage x[m0 + r][k0 + c] (r < BM, c < BK) into dst, rows BK + kXPad apart;
// zero where m >= M or k >= klimit.
template <int BM, int BK, int THREADS>
__device__ __forceinline__ void load_x(__nv_bfloat16* dst, const Params& p, int m0, int k0, int klimit) {
  itx::stage_rows<BM, BK, kXPad, THREADS>(dst, p.x, p.M, p.K, m0, k0, klimit, p.x_aligned);
}

template <class P>
__global__ void __launch_bounds__(P::S::THREADS, P::S::MIN_BLOCKS) tile_kernel(const Params p) {
  using S = typename P::S;
  constexpr int BM = S::BM, BK = P::BK, SL = P::SLICES, MT = S::MT, NT = S::NT, kStages = S::STAGES;
  constexpr int XROW = BK + kXPad;
  constexpr int X_BYTES = SL * BM * XROW * 2;
  constexpr int STAGE = X_BYTES + P::W_BYTES;
  static_assert(X_BYTES % 16 == 0 && P::W_BYTES % 16 == 0, "stages keep 16-byte alignment");
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __shared__ int is_last;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / S::WARPS_N) * S::WM;
  const int wn = (warp % S::WARPS_N) * S::WN;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int r_begin = blockIdx.z * p.k_chunk;
  const int r_end = min(p.span, r_begin + p.k_chunk);
  const int steps = (r_end - r_begin + BK - 1) / BK;

  P pol(p, tc_smem + kStages * STAGE, n0, wn, lane);  // the decoder's state for this thread

  auto load = [&](int s) {
    unsigned char* st = tc_smem + (s % kStages) * STAGE;
    const int r0 = r_begin + s * BK;
#pragma unroll
    for (int sl = 0; sl < SL; ++sl)
      load_x<BM, BK, S::THREADS>(reinterpret_cast<__nv_bfloat16*>(st) + sl * BM * XROW, p, m0,
                                 P::x_col(p, sl, r0), P::x_limit(p, sl));
    P::load_w(st + X_BYTES, p, r0, n0);
  };

  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = part[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s has landed; stage s - 1 is consumed by every warp
    if (s + kStages - 1 < steps) load(s + kStages - 1);
    cp_async_commit();
    const unsigned char* st = tc_smem + (s % kStages) * STAGE;
    const int r0 = r_begin + s * BK;
    pol.begin_stage(p, st + X_BYTES, r0);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
      for (int sl = 0; sl < SL; ++sl) {
        const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st) + sl * BM * XROW;
        uint32_t a[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          ldsm_x4(xs + (wm + 16 * mi + lane % 16) * XROW + 16 * ks + (lane / 16) * 8, a[mi]);
        pol.a_hook(a);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          uint32_t b0, b1;
          pol.b_frag(st + X_BYTES, sl, ks, ni, b0, b1);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) mma_bf16(part[mi][ni], a[mi], b0, b1);
        }
      }
    }
    pol.end_stage(p, acc, part, r0);
  }

  // epilogue: fragment (mi, ni) element e is row g (+8 for e >= 2), column 2t + (e & 1)
  const int fr = m0 + wm + lane / 4, fc = n0 + wn + 2 * (lane % 4);
  const size_t MN = static_cast<size_t>(p.M) * p.N;
  const bool split = gridDim.z > 1;
  auto store = [&](size_t o, float v) {
    if (p.out_bf16) {
      static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16(v);
    } else {
      static_cast<float*>(p.out)[o] = v;
    }
  };
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = fr + 16 * mi + 8 * (e >> 1), n = fc + 8 * ni + (e & 1);
        if (m >= p.M || n >= p.N) continue;
        const size_t o = static_cast<size_t>(m) * p.N + n;
        if (split) {
          p.part[blockIdx.z * MN + o] = acc[mi][ni][e];
        } else {
          store(o, acc[mi][ni][e]);
        }
      }
  if (!split) return;

  // the last block of this output tile to arrive sums the partials in split order
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (!itx::last_to_arrive(&p.counters[tile], gridDim.z, &is_last)) return;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = fr + 16 * mi + 8 * (e >> 1), n = fc + 8 * ni + (e & 1);
        if (m >= p.M || n >= p.N) continue;
        const size_t o = static_cast<size_t>(m) * p.N + n;
        float sum = 0.f;
        for (unsigned z = 0; z < gridDim.z; ++z) sum += __ldcg(p.part + z * MN + o);
        store(o, sum);
      }
  if (threadIdx.x == 0) p.counters[tile] = 0;
}

// One launch of tile_kernel<P>: ceil(N / 128) x ceil(M / BM) tiles, split
// into ceil(span / k_chunk) along K.
template <class P>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int X_BYTES = P::SLICES * P::S::BM * (P::BK + kXPad) * 2;
  constexpr size_t bytes = static_cast<size_t>(P::S::STAGES) * (X_BYTES + P::W_BYTES) + P::EXTRA_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(tile_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + P::S::BM - 1) / P::S::BM,
                  (p.span + p.k_chunk - 1) / p.k_chunk);
  tile_kernel<P><<<grid, P::S::THREADS, bytes, stream>>>(p);
  return cudaSuccess;
}

// The part of a policy shared by weights that arrive as rows of bytes (K1's
// khalf int4, K2's int8): a stage is BK rows of 128 bytes, one byte a column,
// copied by 16-byte cp.async (rows past the walk or columns past N arrive as
// zeros); the derived policy's begin_stage decodes it once a block into the
// bf16 tile bs[plane][row][column], each thread the 4-byte words of one word
// column (wcol(), columns 4 wcol()..+3) in rows drow(0..DWORDS-1); the warps
// take their B fragments from bs by ldmatrix.trans.
template <int BM, int PLANES>
struct ByteRowsTile {
  using S = Shape<BM>;
  static constexpr int BK = 32, SLICES = PLANES;
  static constexpr int PROW = kBN + 16;  // bytes a staged row (padded)
  static constexpr int W_BYTES = BK * PROW;
  static constexpr int BROW = kBN + 8;  // bf16 a decoded row (padded: ldmatrix without bank conflicts)
  static constexpr int TILE_BYTES = PLANES * BK * BROW * 2;
  static constexpr int DWORDS = BK * (kBN / 4) / S::THREADS;  // 4-byte words a thread decodes a stage

  __nv_bfloat16* bs;  // [PLANES][BK][BROW], the decoded stage
  int wn, lane;
  uint32_t tw[S::NT][2];  // B fragments of the current k-step (two n8 fragments an ldmatrix)

  __device__ ByteRowsTile(unsigned char* tile, int wn_, int lane_)
      : bs(reinterpret_cast<__nv_bfloat16*>(tile)), wn(wn_), lane(lane_) {}

  __device__ static int wcol() { return threadIdx.x % 32; }
  __device__ static int drow(int i) { return threadIdx.x / 32 + (S::THREADS / 32) * i; }

  __device__ static void load_w(unsigned char* ws, const Params& p, int r0, int n0) {
    const auto* w = static_cast<const uint8_t*>(p.w);
    constexpr int CPR = kBN / 16;  // 16-byte pieces a row
    if (p.w_aligned && n0 + kBN <= p.N && r0 + BK <= p.span) {
      const uint8_t* src = w + static_cast<size_t>(r0) * p.N + n0;
      for_each_piece<BK * CPR, S::THREADS>([&](int i) {
        const int r = i / CPR, c = (i % CPR) * 16;
        cp_async16(ws + r * PROW + c, src + static_cast<size_t>(r) * p.N + c, true);
      });
      return;
    }
    for_each_piece<BK * CPR, S::THREADS>([&](int i) {
      const int r = r0 + i / CPR, c = (i % CPR) * 16;
      const int n = n0 + c;
      unsigned char* d = ws + (i / CPR) * PROW + c;
      if (r >= p.span || n >= p.N) {
        cp_async16(d, w, false);
      } else {
        const uint8_t* src = w + static_cast<size_t>(r) * p.N + n;
        if (p.w_aligned && n + 16 <= p.N) {
          cp_async16(d, src, true);
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) d[e] = n + e < p.N ? src[e] : 0;
        }
      }
    });
  }

  // the 4-byte word of staged row r in this thread's word column
  __device__ static uint32_t staged_word(const unsigned char* ws, int r) {
    return *reinterpret_cast<const uint32_t*>(ws + r * PROW + 4 * wcol());
  }
  // columns 4 wcol().. of decoded row r of plane pl: o.x columns 0, 1; o.y 2, 3
  __device__ void put(int pl, int r, uint2 o) {
    *reinterpret_cast<uint2*>(bs + (pl * BK + r) * BROW + 4 * wcol()) = o;
  }

  __device__ void a_hook(const uint32_t (&)[S::MT][4]) {}

  __device__ void b_frag(const unsigned char*, int sl, int ks, int ni, uint32_t& b0, uint32_t& b1) {
    // one ldmatrix.x4.trans gives fragments ni and ni + 1: matrix q of lane
    // i is k rows 16 ks + 8 (q & 1).., columns 8 (q >> 1)..
    if (ni % 2 == 0) {
      const int q = lane / 8;
      const __nv_bfloat16* src = bs + (sl * BK + 16 * ks + 8 * (q & 1) + lane % 8) * BROW + wn + 8 * ni +
                                 8 * (q >> 1);
      uint32_t r[4];
      itx::ldsm_x4_trans(src, r);
      tw[ni][0] = r[0];
      tw[ni][1] = r[1];
      tw[ni + 1][0] = r[2];
      tw[ni + 1][1] = r[3];
    }
    b0 = tw[ni][0];
    b1 = tw[ni][1];
  }

  __device__ void end_stage(const Params&, float (&acc)[S::MT][S::NT][4], float (&part)[S::MT][S::NT][4], int) {
#pragma unroll
    for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < S::NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mi][ni][e] += part[mi][ni][e];
          part[mi][ni][e] = 0.f;
        }
  }
};

// launch<Policy<BM>> for the BM the caller planned (16, 32, 64 or 128).
template <template <int> class Policy>
cudaError_t launch_bm(const Params& p, int bm, cudaStream_t stream) {
  switch (bm) {
    case 16: return launch<Policy<16>>(p, stream);
    case 32: return launch<Policy<32>>(p, stream);
    case 64: return launch<Policy<64>>(p, stream);
    case 128: return launch<Policy<128>>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace itx_tc
