// K5: fused similarity scan + per-tile top-2 for flat search (sm_90a).
//
// Replaces intel_extension_for_transformers_tpu/ops/scan_topk.py
// ::_scan_top2_kernel (launched by scan_top2).
//
// Queries (B, D) and docs (N, D) are bf16. For each tile of n_tile docs and
// each query the kernel scores q . doc from bf16 products with an f32
// accumulator, masks columns >= size, and keeps the tile's top-2 (score,
// global doc id); on equal scores the highest id wins, and a tile with no
// valid column gives (-inf, -1). vals (B, 2T) f32 and ids (B, 2T) int32 come
// out in tile-major order: tile0-top1, tile0-top2, tile1-top1, ...
//
// Bound on the H100: at B = 4096 the scan is 2*B*N*D flops against 2*N*D
// bytes of docs, so it is compute-bound; writing the (B, N) score matrix
// would add 4*B*N bytes of traffic, which is what this kernel exists to avoid.
// Design: a block owns 64 queries x one doc tile. It walks the tile in
// 64-doc sub-tiles, staging 32-dim slices of queries and docs in shared
// memory as f32 (a bf16 product is exact in f32), with a 4x4 register tile
// of scores per thread (SIMT FMA). After each sub-tile every thread folds its
// 16 scores into a running top-2 per query held in registers; at the end the
// 16 threads that share a query merge their lists with warp shuffles. No
// score leaves the SM. Blocks that share a doc tile are adjacent in the grid,
// so the tile is read from L2 rather than device memory by all but the first.
// Tensor cores (mma/wgmma) are later work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // queries per block (4 per thread row)
constexpr int kBD = 64;        // docs per sub-tile (4 per thread column)
constexpr int kBK = 32;        // dims per shared-memory step
constexpr int kPad = kBQ + 4;  // padded row, still 16-byte aligned
static_assert(kBQ == kBD, "one staging loop fills both tiles");

// (v, i) ranks above (w, j): higher score, or equal score and higher id.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i > j);
}

__device__ __forceinline__ void insert(float v, int i, float& v1, int& i1, float& v2,
                                       int& i2) {
  if (better(v, i, v1, i1)) {
    v2 = v1;
    i2 = i1;
    v1 = v;
    i1 = i;
  } else if (better(v, i, v2, i2)) {
    v2 = v;
    i2 = i;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_top2_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ docs,
                 float* __restrict__ vals, int* __restrict__ ids, int B, int N, int D,
                 int size, int n_tile) {
  __shared__ __align__(16) float qs[kBK][kPad];
  __shared__ __align__(16) float ds[kBK][kPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // docs tx*4 .. tx*4+3 of a sub-tile
  const int ty = tid / 16;  // queries ty*4 .. ty*4+3 of the block
  const int b0 = blockIdx.x * kBQ;
  const int t = blockIdx.y;
  const int T = gridDim.y;
  const int tile_start = t * n_tile;
  const int tile_end = min(tile_start + n_tile, N);
  const int valid_end = min(tile_end, size);

  float v1[4], v2[4];
  int i1[4], i2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v1[i] = v2[i] = -INFINITY;
    i1[i] = i2[i] = -1;
  }

  for (int c0 = tile_start; c0 < tile_end; c0 += kBD) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += kBK) {
      __syncthreads();  // the previous slices are consumed
      for (int e = tid; e < kBK * kBQ; e += kThreads) {
        const int row = e / kBK, kk = e % kBK;
        const int k = k0 + kk;
        const int b = b0 + row;
        const int c = c0 + row;
        qs[kk][row] = (b < B && k < D) ? __bfloat162float(q[static_cast<size_t>(b) * D + k]) : 0.f;
        ds[kk][row] = (c < tile_end && k < D) ? __bfloat162float(docs[static_cast<size_t>(c) * D + k]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[kk][ty * 4]);
        const float4 d = *reinterpret_cast<const float4*>(&ds[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx * 4 + j;
      if (col >= valid_end) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) insert(acc[i][j], col, v1[i], i1[i], v2[i], i2[i]);
    }
  }

  // merge the 16 lists of each query row: lanes that differ in their low 4 bits
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov1 = __shfl_xor_sync(0xffffffffu, v1[i], off);
      const int oi1 = __shfl_xor_sync(0xffffffffu, i1[i], off);
      const float ov2 = __shfl_xor_sync(0xffffffffu, v2[i], off);
      const int oi2 = __shfl_xor_sync(0xffffffffu, i2[i], off);
      insert(ov1, oi1, v1[i], i1[i], v2[i], i2[i]);
      insert(ov2, oi2, v1[i], i1[i], v2[i], i2[i]);
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + ty * 4 + i;
      if (b >= B) continue;
      const size_t o = static_cast<size_t>(b) * 2 * T + 2 * t;
      vals[o] = v1[i];
      vals[o + 1] = v2[i];
      ids[o] = i1[i];
      ids[o + 1] = i2[i];
    }
  }
}

}  // namespace

// q: bf16 (B, D); docs: bf16 (N, D); vals: f32 (B, 2T); ids: int32 (B, 2T)
// with T = ceil(N / n_tile). Returns cudaGetLastError() after the launch.
extern "C" int itx_scan_top2(const void* q, const void* docs, void* vals, void* ids, int B,
                             int N, int D, int size, int n_tile, void* stream) {
  const int T = (N + n_tile - 1) / n_tile;
  const dim3 grid((B + kBQ - 1) / kBQ, T);
  scan_top2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(docs),
      static_cast<float*>(vals), static_cast<int*>(ids), B, N, D, size, n_tile);
  return static_cast<int>(cudaGetLastError());
}
