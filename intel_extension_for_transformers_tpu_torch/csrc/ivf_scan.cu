// K6 and K7: IVF scans over packed residual lists (sm_90a).
//
// K6 replaces intel_extension_for_transformers_tpu/ops/ivf_scan.py
// ::_ivf_scan_kernel (:178, launched by ivf_scan_topk); K7 replaces
// ::_ivf_candidates_kernel (:511, launched by ivf_scan_candidates).
//
// A list is L rows of W bytes of codes (int8, or two int4 per byte: column
// 2w in the low nibble of byte w, 2w+1 in the high one), G bf16 group scales
// and an int32 row id (-1 = empty). A row's residual value for column c is
// bf16(code * code_mult + code_offset) * scale, rounded to bf16; its score is
// the sum of bf16(q) * residual in f32, plus the (query, list) base q.centroid
// where one is given. On equal scores the highest id ranks first.
//
// itx_ivf_scan_lists: one block per (query, probe slot). It walks its list's
// rows in tiles of kTile, one warp per row (lanes take 32-bit words of codes,
// 4 int8 or 8 int4 columns each; the query sits in shared memory as f32),
// and merges each tile into a best-first top-k kept in shared memory by a
// bitonic sort of the k best so far and the tile, skipped when no row of the
// tile beats the k-th. A slot whose list is -1 writes (-inf, -1) only: K6's
// wrapper sets a query's repeated probes to -1, so a list counts once. K6
// calls it with the base and ids, then itx_ivf_merge_topk (one block per
// query, the same tile merge) reduces each query's nprobe * k candidates to
// its top k. K7 calls it with no base and flat storage positions as ids.
//
// Bound on the H100: the bytes of the probed lists' codes, scales and row
// ids (a 1536-row int8 list of dim 768 is 1.26 MB). Each block streams its
// list once with coalesced 32-bit loads and decodes in registers, so no
// decoded residual and no (query, candidate) score reaches device memory;
// the TPU kernel's running top-k across a sequential grid becomes a top-k
// per block plus a second pass. Not done here: reading a list once for all
// the queries that probe it, cp.async/TMA staging, tensor cores.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;  // rows (or candidates) merged at a time

// (v, i) ranks above (w, j): higher score, or equal score and higher id.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i > j);
}

// Sort the P (a power of two) entries of (s, id) in shared memory, best first.
__device__ void sort_best_first(float* s, int* id, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int j = i ^ stride;
        if (j <= i) continue;
        const float a = s[i], b = s[j];
        const int ia = id[i], ib = id[j];
        const bool best_first = (i & size) == 0;  // the final pass has size == P: all best first
        if (best_first ? better(b, ib, a, ia) : better(a, ia, b, ib)) {
          s[i] = b;
          s[j] = a;
          id[i] = ib;
          id[j] = ia;
        }
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void clear(float* s, int* id, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s[i] = -INFINITY;
    id[i] = -1;
  }
}

// Column e of a 32-bit word of codes, sign-extended.
template <int BITS>
__device__ __forceinline__ int code_at(uint32_t word, int e) {
  return BITS == 4 ? static_cast<int>(word << (28 - 4 * e)) >> 28
                   : static_cast<int>(word << (24 - 8 * e)) >> 24;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
ivf_scan_lists_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ packed,
                      const __nv_bfloat16* __restrict__ scales, const int* __restrict__ row_ids,
                      const int* __restrict__ lists, const float* __restrict__ base,
                      float* __restrict__ out_s, int* __restrict__ out_i, int nprobe, int D,
                      int L, int G, int group_size, int k, int P, int code_mult,
                      int code_offset, int track_positions) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // D (a multiple of 4)
  float* cs = qs + D;                          // P candidate scores
  int* ci = reinterpret_cast<int*>(cs + P);    // P candidate ids

  constexpr int kPerWord = BITS == 4 ? 8 : 4;
  const int pair = blockIdx.x;  // query * nprobe + probe slot
  const int b = pair / nprobe;
  const int list = lists[pair];
  float* os = out_s + static_cast<size_t>(pair) * k;
  int* oi = out_i + static_cast<size_t>(pair) * k;
  if (list < 0) {
    clear(os, oi, k);
    return;
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    qs[d] = __bfloat162float(q[static_cast<size_t>(b) * D + d]);
  }
  clear(cs, ci, P);
  __syncthreads();

  const float bias = base != nullptr ? base[pair] : 0.f;
  const int W = BITS == 4 ? D / 2 : D;
  const int words = W / 4;
  const bool word_in_group = group_size % kPerWord == 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row0 = static_cast<size_t>(list) * L;

  for (int r0 = 0; r0 < L; r0 += kTile) {
    const float kth_s = cs[k - 1];  // a row must beat the k-th best to enter
    const int kth_i = ci[k - 1];
    bool enters = false;
    for (int rr = warp; rr < kTile; rr += kWarps) {
      const int r = r0 + rr;
      float score = -INFINITY;
      int id = -1;
      const size_t row = row0 + r;
      const int rid = r < L ? row_ids[row] : -1;
      if (rid >= 0) {
        const uint32_t* codes = reinterpret_cast<const uint32_t*>(packed + row * W);
        const __nv_bfloat16* srow = scales + row * G;
        float acc = 0.f;
        for (int w = lane; w < words; w += 32) {
          const uint32_t word = __ldg(codes + w);
          const int c0 = w * kPerWord;
          float s = word_in_group ? __bfloat162float(srow[c0 / group_size]) : 0.f;
#pragma unroll
          for (int h = 0; h < kPerWord; h += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + c0 + h);
            const float qe[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = c0 + h + e;
              if (!word_in_group) s = __bfloat162float(srow[c / group_size]);
              const int v = code_at<BITS>(word, h + e) * code_mult + code_offset;
              // v (|v| < 2^11) times a bf16 scale is exact in f32: one rounding to bf16
              acc = fmaf(qe[e], itx::round_bf16(static_cast<float>(v) * s), acc);
            }
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        score = acc + bias;
        id = track_positions ? static_cast<int>(row) : rid;
      }
      if (lane == 0) {
        cs[k + rr] = score;
        ci[k + rr] = id;
        enters |= id >= 0 && better(score, id, kth_s, kth_i);
      }
    }
    if (__syncthreads_or(enters)) sort_best_first(cs, ci, P);
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    os[i] = cs[i];
    oi[i] = ci[i];
  }
}

// Each query's R candidates (score, id) → its best k, best first.
__global__ void __launch_bounds__(kThreads)
ivf_merge_topk_kernel(const float* __restrict__ in_s, const int* __restrict__ in_i,
                      float* __restrict__ out_s, int* __restrict__ out_i, int R, int k, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  int* ci = reinterpret_cast<int*>(cs + P);
  const size_t b = blockIdx.x;
  clear(cs, ci, P);
  __syncthreads();
  for (int r0 = 0; r0 < R; r0 += kTile) {
    const float kth_s = cs[k - 1];
    const int kth_i = ci[k - 1];
    bool enters = false;
    for (int rr = threadIdx.x; rr < kTile; rr += blockDim.x) {
      const int r = r0 + rr;
      const float s = r < R ? in_s[b * R + r] : -INFINITY;
      const int id = r < R ? in_i[b * R + r] : -1;
      cs[k + rr] = s;
      ci[k + rr] = id;
      enters |= id >= 0 && better(s, id, kth_s, kth_i);
    }
    if (__syncthreads_or(enters)) sort_best_first(cs, ci, P);
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    out_s[b * k + i] = cs[i];
    out_i[b * k + i] = ci[i];
  }
}

int slots_for(int k) {
  int P = 1;
  while (P < k + kTile) P <<= 1;
  return P;
}

}  // namespace

// q: bf16 (B, D); packed: int8 (C, L, W); scales: bf16 (C, L, G); row_ids:
// int32 (C, L); lists: int32 (B, nprobe), -1 = skip the slot; base: f32
// (B, nprobe) or null; out_s: f32 (B, nprobe, k); out_i: int32 (B, nprobe, k),
// row ids or (track_positions) flat positions list * L + row. Returns
// cudaGetLastError() after the launch.
extern "C" int itx_ivf_scan_lists(const void* q, const void* packed, const void* scales,
                                  const void* row_ids, const void* lists, const void* base,
                                  void* out_s, void* out_i, int B, int nprobe, int D, int L,
                                  int G, int group_size, int bits, int k, int code_mult,
                                  int code_offset, int track_positions, void* stream) {
  const int P = slots_for(k);
  const size_t smem = static_cast<size_t>(D) * sizeof(float) + static_cast<size_t>(P) * 8;
  const dim3 grid(B * nprobe);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* pp = static_cast<const int8_t*>(packed);
  const auto* sp = static_cast<const __nv_bfloat16*>(scales);
  const auto* rp = static_cast<const int*>(row_ids);
  const auto* lp = static_cast<const int*>(lists);
  const auto* bp = static_cast<const float*>(base);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  if (bits == 4) {
    ivf_scan_lists_kernel<4><<<grid, kThreads, smem, st>>>(qp, pp, sp, rp, lp, bp, os, oi, nprobe,
                                                          D, L, G, group_size, k, P, code_mult,
                                                          code_offset, track_positions);
  } else {
    ivf_scan_lists_kernel<8><<<grid, kThreads, smem, st>>>(qp, pp, sp, rp, lp, bp, os, oi, nprobe,
                                                          D, L, G, group_size, k, P, code_mult,
                                                          code_offset, track_positions);
  }
  return static_cast<int>(cudaGetLastError());
}

// in_s/in_i: (B, R) candidates; out_s/out_i: (B, k) best first, (-inf, -1)
// where a query has fewer than k. Returns cudaGetLastError() after the launch.
extern "C" int itx_ivf_merge_topk(const void* in_s, const void* in_i, void* out_s, void* out_i,
                                  int B, int R, int k, void* stream) {
  const int P = slots_for(k);
  ivf_merge_topk_kernel<<<B, kThreads, static_cast<size_t>(P) * 8,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in_s), static_cast<const int*>(in_i), static_cast<float*>(out_s),
      static_cast<int*>(out_i), R, k, P);
  return static_cast<int>(cudaGetLastError());
}
