// K4: flash attention (online softmax, O(T) memory) for Hopper (sm_90a).
//
// Replaces intel_extension_for_transformers_tpu/ops/flash_attention.py
// ::_flash_kernel (launched from flash_attention).
//
//   out (B, T, H, D) = softmax(scale * q k^T + mask) v
//
// q is (B, T, H, D); k and v are (B, S, Hkv, D), contiguous, all f32 or all
// bf16; out has q's dtype. Query head h reads KV head h / (H / Hkv) by index
// (GQA without repeating K/V in memory). Masks follow the Pallas kernel: key
// ki is valid when ki < S and, if causal, ki <= qi + q_offset; a masked logit
// is -1e30 (not -inf), the running max starts at -1e30, and the output is
// acc / max(l, 1e-30). The wrapper requires q_offset >= 0 and S >= 1, so key
// 0 is valid for every row: the first tile sets a real max and every masked
// logit's exp underflows to exactly 0, as in the Pallas kernel. Exponentials
// use expf (full f32 accuracy, not __expf). Every D <= 256 that is a
// multiple of 8 is taken. One launch per call; the dtype picks the kernel.
//
// Bound on the H100: at the path's shape (B = 1, T = S = 2048, H = 32,
// D = 128, causal) the operations bound it: ~34 GFLOP, 0.0348 ms at the bf16
// tensor-core peak, against 50 MB of Q, K, V and out (0.015 ms).
//
// bf16, on the tensor cores (flash_tc_kernel; the FlashAttention-2 shape):
//  * a block of 4 warps owns 64 query rows of one (b, h), each warp 16 rows;
//    the grid issues every head's longest causal rows first (balancing the
//    SMs' load, as a longest-job-first schedule does). Q is staged once,
//    unscaled, and kept in registers as mma A fragments (ldmatrix; for
//    D > 128 it stays in shared memory and is read per tile, to keep the
//    registers for O).
//  * K/V tiles of 64 keys (32 for D > 128) stay bf16 in a two-stage cp.async
//    ring (16-byte cp.async.cg; the next tile loads while this one is
//    computed). Rows are padded with zeros to the next size of 64, 128 or
//    256 and their 16-byte chunks XOR-swizzled, so ldmatrix is free of bank
//    conflicts; the mma steps past the next multiple of 16 of D are skipped.
//  * S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate), then times
//    `scale` in f32, as the Pallas kernel scales. Online softmax on the
//    accumulator fragments in registers (row max and sum across the quad by
//    __shfl_xor); only tiles on the diagonal or the ragged end of S mask;
//    tiles past the diagonal are skipped.
//  * O += P V with P straight from registers (the accumulator layout repacks
//    pairwise into A fragments) and V through ldmatrix.trans. P keeps ~16
//    bits as the Pallas kernel's f32 P does: P_hi = p truncated to bf16 and
//    P_lo = bf16(p - P_hi), two mmas into one f32 accumulator (1.5x the mma
//    work of a bf16 P, which missed the 2e-3 bar at the window on the H100).
//  * Tried on the H100 at the window and slower (PERF.md): two 16-row tiles
//    a warp, 8 warps a block, 32- or 128-key tiles, 3 blocks an SM, query
//    blocks fastest in the grid; and a runtime test for the mma steps past
//    D, so D == DP takes a variant where the count is a constant.
// f32 (flash_kernel, the first version, on test paths only): SIMT FMA. A
// block owns 64 query rows, stages them once (scaled) in shared memory, and
// walks key tiles of 64 (32 for D > 128) rows; 256 threads as 16 x 16, a
// thread holding 4 query rows x (BK / 16) keys of the score tile and 4 rows
// x (D / 16) columns of the output.
// Later work: wgmma with TMA-fed K/V and warp specialisation.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;
constexpr float kNegInf = -1e30f;

template <int DC>
struct Tile {
  static constexpr int BK = DC <= 8 ? 64 : 32;  // keys per tile
  static constexpr int NC = BK / 16;            // keys per thread
};

template <int DC>
size_t smem_bytes(int D) {
  constexpr int BK = Tile<DC>::BK;
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) + static_cast<size_t>(BK) * (D + 1) +
                          static_cast<size_t>(BK) * D + static_cast<size_t>(kBQ) * BK);
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int T_, int S, int H, int Hkv, int D, float scale,
             int causal, int q_offset) {
  constexpr int BK = Tile<DC>::BK;
  constexpr int NC = Tile<DC>::NC;
  extern __shared__ float smem[];
  const int Ds = D + 1;  // odd stride: conflict-free column reads of Q and K
  float* Qs = smem;                 // [kBQ][Ds]
  float* Ks = Qs + kBQ * Ds;        // [BK][Ds]
  float* Vs = Ks + BK * Ds;         // [BK][D]
  float* Ps = Vs + BK * D;          // [kBQ][BK]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);

  const size_t q_row = static_cast<size_t>(H) * D;     // stride of t in q and out
  const size_t kv_row = static_cast<size_t>(Hkv) * D;  // stride of s in k and v
  const T* qb = q + static_cast<size_t>(b) * T_ * q_row + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(hk) * D;
  const T* vb = v + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(hk) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    Qs[r * Ds + d] = t < T_ ? itx::to_float(qb[t * q_row + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (S + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + kBQ, T_) - 1 + q_offset;  // the block's diagonal
    n_tiles = min(n_tiles, last_row / BK + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q is staged; the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int s = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        kv = itx::to_float(kb[s * kv_row + d]);
        vv = itx::to_float(vb[s * kv_row + d]);
      }
      Ks[r * Ds + d] = kv;
      Vs[r * D + d] = vv;
    }
    __syncthreads();

    float sc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) sc[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], kk[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * Ds + d];
#pragma unroll
      for (int c = 0; c < NC; ++c) kk[c] = Ks[(tx + 16 * c) * Ds + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) sc[i][c] = fmaf(a[i], kk[c], sc[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int ki = k0 + tx + 16 * c;
        const bool valid = ki < S && (!causal || ki <= qi);
        sc[i][c] = valid ? sc[i][c] : kNegInf;
        mx = fmaxf(mx, sc[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float p = expf(sc[i][c] - m_new);
        Ps[(ty * 4 + i) * BK + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * BK + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float vv = Vs[kk * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= T_) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + (static_cast<size_t>(b) * T_ + t) * q_row + static_cast<size_t>(h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = itx::from_float<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int DC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int T_,
                   int S, int H, int Hkv, int D, float scale, int causal, int q_offset,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes<DC>(D);
  auto kernel = flash_kernel<T, DC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((T_ + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), T_, S, H, Hkv, D, scale, causal, q_offset);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int B, int T_,
                     int S, int H, int Hkv, int D, float scale, int causal, int q_offset,
                     cudaStream_t stream) {
  if (D <= 64) return launch<T, 4>(q, k, v, out, B, T_, S, H, Hkv, D, scale, causal, q_offset, stream);
  if (D <= 128) return launch<T, 8>(q, k, v, out, B, T_, S, H, Hkv, D, scale, causal, q_offset, stream);
  return launch<T, 16>(q, k, v, out, B, T_, S, H, Hkv, D, scale, causal, q_offset, stream);
}

// ---- bf16: tensor cores (mma.sync m16n8k16) -------------------------------
// DP: the head dim padded to 64, 128 or 256; BK: keys per tile; QREG: Q
// fragments kept in registers, else read from shared memory each tile; FULL:
// D == DP, so the mma steps past D are known at compile time (none).
template <int DP_, int BK_, bool QREG_, bool FULL_>
struct TcCfg {
  static constexpr int DP = DP_, BK = BK_;
  static constexpr bool QREG = QREG_, FULL = FULL_;
  static constexpr int THREADS = 128;  // 4 warps of 16 query rows
  static constexpr int BQ = 64;        // query rows a block
  static constexpr int CH = DP / 8;    // 16-byte chunks a row
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * static_cast<size_t>(BQ + 4 * BK) * DP;
};

// Element offset of chunk c (8 bf16) of row r: chunks XOR-swizzled by r % 8.
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DP + ((c ^ (r & 7)) << 3);
}

using itx::cp_async16;
using itx::cp_async_commit;
using itx::cp_async_wait;
using itx::cvt_bf16x2;
using itx::ldsm_x4;
using itx::ldsm_x4_trans;
using itx::mma_bf16;
using itx::smem_u32;

// Two f32 probabilities -> the bf16x2 operands of P V: hi holds p truncated
// to bf16 (one byte permute), lo the remainder p - hi (exact in f32) rounded
// to bf16, so hi + lo keeps ~16 bits of p.
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(p0), b1 = __float_as_uint(p1);
  hi = __byte_perm(b0, b1, 0x7632);  // the high 16 bits of each
  lo = cvt_bf16x2(p0 - __uint_as_float(b0 & 0xFFFF0000u), p1 - __uint_as_float(b1 & 0xFFFF0000u));
}

template <class C>
__global__ void __launch_bounds__(C::THREADS)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int T_,
                int S, int H, int Hkv, int D, float scale, int causal, int q_offset) {
  constexpr int DP = C::DP;
  constexpr int BK = C::BK;
  constexpr int CH = C::CH;
  constexpr int NT = BK / 8;   // score tiles (8 keys) a warp
  constexpr int KS = DP / 16;  // mma steps over the head dim
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [BQ][DP]
  __nv_bfloat16* Ks = Qs + C::BQ * DP;                              // [2][BK][DP]
  __nv_bfloat16* Vs = Ks + 2 * BK * DP;                             // [2][BK][DP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int tq = lane & 3;  // accumulator column pair
  // heads vary fastest in the grid, so every head's longest causal rows run first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int dch = D / 8;                                  // chunks that hold data
  const int steps = C::FULL ? KS : (D + 15) / 16;         // mma steps that meet data
  const int qrow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;  // this lane's Q row for ldmatrix

  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * T_ * q_row + static_cast<size_t>(h) * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(hk) * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(hk) * D;

  for (int i = tid; i < C::BQ * CH; i += C::THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < T_ && c < dch;
    cp_async16(smem_u32(Qs + swz<DP>(r, c)), ok ? qb + (q0 + r) * q_row + c * 8 : qb, ok);
  }
  cp_async_commit();

  auto load_kv = [&](int kt, int st) {
    __nv_bfloat16* kd = Ks + st * BK * DP;
    __nv_bfloat16* vd = Vs + st * BK * DP;
    for (int i = tid; i < BK * CH; i += C::THREADS) {
      const int r = i / CH, c = i % CH;
      const int key = kt * BK + r;
      const bool ok = key < S && c < dch;
      const size_t off = ok ? key * kv_row + c * 8 : 0;
      cp_async16(smem_u32(kd + swz<DP>(r, c)), kb + off, ok);
      cp_async16(smem_u32(vd + swz<DP>(r, c)), vb + off, ok);
    }
  };

  int n_tiles = (S + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + C::BQ, T_) - 1 + q_offset;  // the block's diagonal
    n_tiles = min(n_tiles, last_row / BK + 1);
  }
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[C::QREG ? KS : 1][4];
  if constexpr (C::QREG) {
    cp_async_wait<1>();  // Q has landed
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      if (ks < steps) ldsm_x4(smem_u32(Qs + swz<DP>(qrow, ks * 2 + (lane >> 4))), qf[ks]);
  }

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int qi0 = q0 + warp * 16 + g + q_offset;  // the row of c0, c1 (c2, c3: qi0 + 8)

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) load_kv(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed; tile kt + 1 is in flight
    __syncthreads();
    const __nv_bfloat16* kt_s = Ks + st * BK * DP;
    const __nv_bfloat16* vt_s = Vs + st * BK * DP;

    // S = Q K^T
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks < steps) {
        uint32_t a[4];
        if constexpr (C::QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
        } else {
          ldsm_x4(smem_u32(Qs + swz<DP>(qrow, ks * 2 + (lane >> 4))), a);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(smem_u32(kt_s + swz<DP>(key, ks * 2 + ((lane >> 3) & 1))), bf);
          mma_bf16(s[2 * np], a, bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }

    // online softmax on the fragments: rows g and g + 8, a row's values
    // spread over the quad's 4 lanes
    const int k0 = kt * BK;
    const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > q0 + q_offset);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked) {
          const int ki = k0 + j * 8 + tq * 2 + (e & 1);
          const bool valid = ki < S && (!causal || ki <= qi0 + (e >> 1) * 8);
          x = valid ? x : kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_r[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + sum[i];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }

    // O += P V, P from the accumulators as a bf16 pair
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        if (dp < steps) {
          uint32_t bv[4];
          ldsm_x4_trans(smem_u32(vt_s + swz<DP>(key, dp * 2 + (lane >> 4))), bv);
          mma_bf16(o[2 * dp], ph, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], ph, bv[2], bv[3]);
          mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next load overwrites it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int t = q0 + warp * 16 + g + 8 * i;
    if (t >= T_) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = out + (static_cast<size_t>(b) * T_ + t) * q_row + static_cast<size_t>(h) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + tq * 2;
      if (d < D) *reinterpret_cast<uint32_t*>(orow + d) = cvt_bf16x2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

template <class C>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int B, int T_, int S,
                      int H, int Hkv, int D, float scale, int causal, int q_offset,
                      cudaStream_t stream) {
  auto kernel = flash_tc_kernel<C>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (T_ + C::BQ - 1) / C::BQ, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), T_, S, H, Hkv, D,
      scale, causal, q_offset);
  return cudaSuccess;
}

template <int DP, int BK, bool QREG>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* out, int B, int T_, int S,
                      int H, int Hkv, int D, float scale, int causal, int q_offset,
                      cudaStream_t stream) {
  if (D == DP) {
    return launch_tc<TcCfg<DP, BK, QREG, true>>(q, k, v, out, B, T_, S, H, Hkv, D, scale, causal, q_offset, stream);
  }
  return launch_tc<TcCfg<DP, BK, QREG, false>>(q, k, v, out, B, T_, S, H, Hkv, D, scale, causal, q_offset, stream);
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* out, int B, int T_,
                        int S, int H, int Hkv, int D, float scale, int causal, int q_offset,
                        cudaStream_t stream) {
  if (D <= 64) return launch_dp<64, 64, true>(q, k, v, out, B, T_, S, H, Hkv, D, scale, causal, q_offset, stream);
  if (D <= 128) return launch_dp<128, 64, true>(q, k, v, out, B, T_, S, H, Hkv, D, scale, causal, q_offset, stream);
  return launch_dp<256, 32, false>(q, k, v, out, B, T_, S, H, Hkv, D, scale, causal, q_offset, stream);
}

}  // namespace

// q: (B, T, H, D); k, v: (B, S, Hkv, D); out: (B, T, H, D); all f32, or all
// bf16 (bf16 = 1; q, k, v and out 16-byte aligned). D <= 256 and a multiple
// of 8, H a multiple of Hkv, q_offset >= 0, S >= 1 (the wrapper checks). Returns the first CUDA error
// of the launch (cudaGetLastError() after it).
extern "C" int itx_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int B, int T, int S, int H, int Hkv, int D, float scale,
                                   int causal, int q_offset, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_tc(q, k, v, out, B, T, S, H, Hkv, D, scale, causal, q_offset, s)
           : dispatch<float>(q, k, v, out, B, T, S, H, Hkv, D, scale, causal, q_offset, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
