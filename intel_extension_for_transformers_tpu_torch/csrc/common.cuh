// Small helpers shared by the port's CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace itx {

// Round an f32 value to the nearest bf16 (ties to even) and widen it back.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---- PTX helpers of the tensor-core kernels (sm_80 and later) -------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !valid (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  cp_async16(smem_u32(dst), src, valid);
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t r[4]) { ldsm_x4(smem_u32(p), r); }
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(const void* p, uint32_t r[4]) { ldsm_x4_trans(smem_u32(p), r); }

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (p0, p1) rounded to bf16 and packed, p0 in the low half.
__device__ __forceinline__ uint32_t cvt_bf16x2(float p0, float p1) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(p1), "f"(p0));
  return d;
}

// a * b + c on bf16 pairs, rounded once (to nearest even) to bf16.
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
constexpr uint32_t kBf16x2One = 0x3F803F80u;
constexpr uint32_t kBf16x2NegZero = 0x80008000u;

// Byte c of `word` as the f32 2^23 + byte (exact): subtract 2^23 (+ 128 for
// a signed byte flipped in its top bit) for the integer.
template <int C>
__device__ __forceinline__ float byte_as_f32_2p23(uint32_t word) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7650 | C));
}

// The high halves of two f32 values, packed as a bf16 pair (a in the low
// half): exact where each is an integer of at most 8 significant bits.
__device__ __forceinline__ uint32_t hi_halves(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// Calls f(i) for i = threadIdx.x, + THREADS, ... below COUNT: a loop whose
// trip count the compiler knows, so it unrolls.
template <int COUNT, int THREADS, class F>
__device__ __forceinline__ void for_each_piece(F f) {
#pragma unroll
  for (int j = 0; j < (COUNT + THREADS - 1) / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (COUNT % THREADS == 0 || i < COUNT) f(i);
  }
}

// Stage src[r0 + r][k0 + c] (r < ROWS, c < BK) of a row-major bf16 (rows,
// ld) array into dst, rows BK + PAD apart; zero where r0 + r >= rows or
// k0 + c >= klimit. A stage inside the edges takes one 16-byte cp.async a
// piece and no tests; `aligned`: src and ld allow 16-byte copies.
template <int ROWS, int BK, int PAD, int THREADS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int rows, int ld,
                                           int r0, int k0, int klimit, bool aligned) {
  constexpr int CPR = BK / 8;  // 16-byte pieces a row
  if (aligned && r0 + ROWS <= rows && k0 + BK <= klimit) {
    const __nv_bfloat16* s0 = src + static_cast<size_t>(r0) * ld + k0;
    for_each_piece<ROWS * CPR, THREADS>([&](int i) {
      const int r = i / CPR, c = (i % CPR) * 8;
      cp_async16(dst + r * (BK + PAD) + c, s0 + static_cast<size_t>(r) * ld + c, true);
    });
    return;
  }
  for_each_piece<ROWS * CPR, THREADS>([&](int i) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int m = r0 + r, k = k0 + c;
    __nv_bfloat16* d = dst + r * (BK + PAD) + c;
    if (m >= rows || k >= klimit) {
      cp_async16(d, src, false);
    } else {
      const __nv_bfloat16* s = src + static_cast<size_t>(m) * ld + k;
      if (aligned && k + 8 <= klimit) {
        cp_async16(d, s, true);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = k + e < klimit ? s[e] : __float2bfloat16(0.f);
      }
    }
  });
}

// Split K without float atomics: after a block has written its f32 partials,
// it counts itself in at `counter`; true in every thread of the block that
// arrives last of `splits`, which then sums the partials in split order,
// writes out and sets the counter back to 0. `flag` is a __shared__ int.
__device__ __forceinline__ bool last_to_arrive(int* counter, int splits, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// last_to_arrive with one thread's acq_rel atomic in place of a fence in
// every thread: the barrier orders the block's partial stores before the
// atomic, its release publishes them, and the acquire of the block that
// arrives last sees every split's (the pattern of a grid-wide barrier).
__device__ __forceinline__ bool last_to_arrive_acq_rel(int* counter, int splits, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(prev) : "l"(counter) : "memory");
    *flag = prev == splits - 1;
  }
  __syncthreads();
  return *flag;
}

}  // namespace itx
