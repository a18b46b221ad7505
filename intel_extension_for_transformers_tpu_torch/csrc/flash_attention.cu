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
// use expf (full f32 accuracy, not __expf). Scores, softmax and the PV
// product are f32; bf16 inputs widen to f32 as they are staged.
//
// Bound on the H100: at the path's shape (T = S = 2048, D = 128, causal)
// the FLOPs (~34 GFLOP per layer) bound it; the Q, K, V reads are 50 MB per
// layer in bf16. Design: a block owns 64 query rows of one (b, h), stages
// them once (scaled) in shared memory, and walks key tiles of 64 (32 for
// D > 128) rows staged in shared memory; causal mode stops at the last tile
// that meets the block's diagonal. 256 threads as 16 x 16: a thread holds 4
// query rows x (BK / 16) keys of the score tile and 4 rows x (D / 16) columns
// of the output; row max and row sum are shuffles across the 16 threads of a
// row group. Every D <= 256 that is a multiple of 8 is taken. SIMT FMA only:
// tensor cores (mma/wgmma), TMA and split-KV are later work.

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

}  // namespace

// q: (B, T, H, D); k, v: (B, S, Hkv, D); out: (B, T, H, D); all f32, or all
// bf16 (bf16 = 1). D <= 256 and a multiple of 8, H a multiple of Hkv,
// q_offset >= 0, S >= 1 (the wrapper checks). Returns the first CUDA error
// of the launch (cudaGetLastError() after it).
extern "C" int itx_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int B, int T, int S, int H, int Hkv, int D, float scale,
                                   int causal, int q_offset, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, B, T, S, H, Hkv, D, scale, causal, q_offset, s)
           : dispatch<float>(q, k, v, out, B, T, S, H, Hkv, D, scale, causal, q_offset, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
