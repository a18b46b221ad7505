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
// bytes of docs, so it is compute-bound (989 TFLOP/s in bf16 on the tensor
// cores); writing the (B, N) score matrix would add 4*B*N bytes of traffic,
// which is what this kernel exists to avoid.
// Design (scan_top2_tc, rows of 16-byte-aligned bf16 with D % 8 == 0; the
// wrapper's k5_route): a block of 8 warps owns 64 queries x one doc tile. It
// walks the tile's docs below `size` in sub-tiles of 128, each over D in
// stages of 64 dims: queries (64 x 64) and docs (128 x 64), both K-contiguous,
// arrive by 16-byte cp.async into a 3-stage ring that runs on across
// sub-tiles. A fragments come from the query stage and B fragments from the
// doc stage by ldmatrix (docs rows are the .col operand as they stand), into
// mma.sync m16n8k16 bf16 -> f32; a warp owns 32 queries x 32 docs. After a
// sub-tile each thread folds its accumulators (4 query rows, 8 docs each)
// into a running top-2 a row in registers. At the tile's end the four
// lanes of a quad merge by shuffles and the four warps that share a row
// through shared memory. No score leaves the SM. Blocks that share a doc tile
// are adjacent in the grid, so the tile is read from L2 rather than device
// memory by all but the first.
// Otherwise (scan_top2_kernel): SIMT, a block of 64 queries x one doc tile
// in 64-doc sub-tiles, 32-dim slices staged as f32 (a bf16 product is exact
// in f32), a 4x4 register tile of scores per thread, the 16 threads that
// share a query merging by warp shuffles.
// Later work: wgmma with TMA-fed stages.

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

// (v, i) into a running top-2 (v1, i1) >= (v2, i2) of one row
__device__ __forceinline__ void insert(float v, int i, float& v1, int& i1, float& v2,
                                       int& i2) {
  if (!better(v, i, v2, i2)) return;  // the common case once a list fills
  if (better(v, i, v1, i1)) {
    v2 = v1;
    i2 = i1;
    v1 = v;
    i1 = i;
  } else {
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

// ---- tensor cores (mma.sync) ---------------------------------------------
namespace tc {

constexpr int kThreads = 256;         // 8 warps: 2 along queries x 4 along docs
constexpr int kBD = 128;              // docs a sub-tile
// 64 queries a block (two blocks an SM), 64 dims a stage in a ring of 3: on
// the H100 faster than 32 dims in a ring of 4 (half the barriers a
// sub-tile) and as fast as 128 queries (PERF.md)
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kRow = kBK + 8;         // bf16 a staged row (padded: ldmatrix without bank conflicts)
constexpr int kStages = 3;
constexpr int kWM = kBQ / 2;          // queries a warp (32)
constexpr int kWN = kBD / 4;          // docs a warp (32)
constexpr int kMT = kWM / 16;         // m16 fragments a warp
constexpr int kNT = kWN / 8;          // n8 fragments a warp
constexpr int kStageBytes = (kBQ + kBD) * kRow * 2;  // a stage of the ring: kBQ query rows, then kBD doc rows
constexpr int kSmemBytes = kStages * kStageBytes;
static_assert(4 * kBQ * 16 <= kSmemBytes, "the cross-warp merge fits in the ring");

__global__ void __launch_bounds__(kThreads, 2)
scan_top2_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ docs,
             float* __restrict__ vals, int* __restrict__ ids, int B, int N, int D, int size, int n_tile) {
  extern __shared__ __align__(128) unsigned char smem[];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wq = warp / 4, wd = warp % 4;  // this warp's query half and doc quarter
  const int b0 = blockIdx.x * kBQ;
  const int t = blockIdx.y;
  const int T = gridDim.y;
  const int tile_start = t * n_tile;
  const int valid_end = min(min(tile_start + n_tile, N), size);  // docs at or past it are never scored
  const int ksteps = (D + kBK - 1) / kBK;
  const int subs = valid_end > tile_start ? (valid_end - tile_start + kBD - 1) / kBD : 0;
  const int steps = subs * ksteps;

  auto load = [&](int s) {
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + (s % kStages) * kStageBytes);
    const int k0 = (s % ksteps) * kBK;
    itx::stage_rows<kBQ, kBK, kRow - kBK, kThreads>(qs, q, B, D, b0, k0, D, true);
    itx::stage_rows<kBD, kBK, kRow - kBK, kThreads>(qs + kBQ * kRow, docs, valid_end, D,
                                                     tile_start + (s / ksteps) * kBD, k0, D, true);
  };

  // running top-2 of this thread's rows wq*kWM + 16 mi + lane/4 + 8 h
  float v1[kMT][2], v2[kMT][2];
  int i1[kMT][2], i2[kMT][2];
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v1[mi][h] = v2[mi][h] = -INFINITY;
      i1[mi][h] = i2[mi][h] = -1;
    }
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    itx::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    itx::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s has landed; stage s - 1 is consumed by every warp
    if (s + kStages - 1 < steps) load(s + kStages - 1);
    itx::cp_async_commit();
    const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(smem + (s % kStages) * kStageBytes);
    const __nv_bfloat16* ds = qs + kBQ * kRow;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
        itx::ldsm_x4(qs + (wq * kWM + 16 * mi + lane % 16) * kRow + 16 * ks + (lane / 16) * 8, a[mi]);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        // matrices: docs 16 np.. (k 16 ks.., 16 ks + 8..), docs 16 np + 8.. (the same)
        uint32_t b[4];
        itx::ldsm_x4(ds + (wd * kWN + 16 * np + (lane & 7) + ((lane >> 4) << 3)) * kRow + 16 * ks +
                         ((lane >> 3) & 1) * 8,
                     b);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          itx::mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          itx::mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (s % ksteps == ksteps - 1) {  // the sub-tile is scored: fold it into the running top-2
      const int c0 = tile_start + (s / ksteps) * kBD + wd * kWN + 2 * (lane % 4);
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * ni + (e & 1);
            const int h = e >> 1;
            if (col < valid_end) insert(acc[mi][ni][e], col, v1[mi][h], i1[mi][h], v2[mi][h], i2[mi][h]);
            acc[mi][ni][e] = 0.f;
          }
    }
  }

  // merge the four lanes of a quad (the same rows, other columns)
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov1 = __shfl_xor_sync(0xffffffffu, v1[mi][h], off);
        const int oi1 = __shfl_xor_sync(0xffffffffu, i1[mi][h], off);
        const float ov2 = __shfl_xor_sync(0xffffffffu, v2[mi][h], off);
        const int oi2 = __shfl_xor_sync(0xffffffffu, i2[mi][h], off);
        insert(ov1, oi1, v1[mi][h], i1[mi][h], v2[mi][h], i2[mi][h]);
        insert(ov2, oi2, v1[mi][h], i1[mi][h], v2[mi][h], i2[mi][h]);
      }

  // then the four warps that share a row, through shared memory (the ring is done)
  itx::cp_async_wait<0>();
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(smem);  // [4][kBQ]: v1, i1, v2, i2 (ids as bits)
  if (lane % 4 == 0) {
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        red[wd * kBQ + wq * kWM + 16 * mi + lane / 4 + 8 * h] =
            make_float4(v1[mi][h], __int_as_float(i1[mi][h]), v2[mi][h], __int_as_float(i2[mi][h]));
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int b = b0 + r;
    if (b >= B) continue;
    float w1 = -INFINITY, w2 = -INFINITY;
    int j1 = -1, j2 = -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 o = red[k * kBQ + r];
      insert(o.x, __float_as_int(o.y), w1, j1, w2, j2);
      insert(o.z, __float_as_int(o.w), w1, j1, w2, j2);
    }
    const size_t o = static_cast<size_t>(b) * 2 * T + 2 * t;
    vals[o] = w1;
    vals[o + 1] = w2;
    ids[o] = j1;
    ids[o + 1] = j2;
  }
}

cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* docs, float* vals, int* ids, int B, int N, int D,
                   int size, int n_tile, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(scan_top2_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kBQ - 1) / kBQ, (N + n_tile - 1) / n_tile);
  scan_top2_tc<<<grid, kThreads, kSmemBytes, stream>>>(q, docs, vals, ids, B, N, D, size, n_tile);
  return cudaSuccess;
}

}  // namespace tc

}  // namespace

// q: bf16 (B, D); docs: bf16 (N, D); vals: f32 (B, 2T); ids: int32 (B, 2T)
// with T = ceil(N / n_tile). route 1 takes the tensor cores (16-byte-aligned
// q and docs, D % 8 == 0), route 0 the SIMT kernel. Returns the launch's CUDA
// error (cudaGetLastError()).
extern "C" int itx_scan_top2(const void* q, const void* docs, void* vals, void* ids, int B, int N, int D,
                             int size, int n_tile, int route, void* stream) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* dp = static_cast<const __nv_bfloat16*>(docs);
  auto* vp = static_cast<float*>(vals);
  auto* ip = static_cast<int*>(ids);
  auto s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const cudaError_t err = tc::launch(qp, dp, vp, ip, B, N, D, size, n_tile, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const int T = (N + n_tile - 1) / n_tile;
  const dim3 grid((B + kBQ - 1) / kBQ, T);
  scan_top2_kernel<<<grid, kThreads, 0, s>>>(qp, dp, vp, ip, B, N, D, size, n_tile);
  return static_cast<int>(cudaGetLastError());
}
