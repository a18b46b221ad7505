// K6 and K7: the IVF scans over packed residual lists, for Hopper (sm_90a).
//
// K6 (ivf_topk_kernel) replaces intel_extension_for_transformers_tpu/ops/
// ivf_scan.py::_ivf_scan_kernel (:178, launched by ivf_scan_topk :390
// through pl.pallas_call :473; its decode is _tile_scores :243, its work
// gate _scan_work :295): the global top-k of the probed lists. K7
// (ivf_slot_topk_kernel) replaces ::_ivf_candidates_kernel (:511, launched
// by ivf_scan_candidates :647 through pl.pallas_call :720): each probe
// slot's top-t. The list layout and the arithmetic are those of
// ivf_scan.cu: a row's score is the f32 sum of bf16(q) * bf16(code *
// code_mult + code_offset) * scale, the residual rounded to bf16 once, plus
// q.centroid (the base) for K6; on equal scores the highest id ranks first.
//
// Bound on the H100: the bytes of the probed lists' occupied rows (codes and
// scales) and all their row ids, at 3.35 TB/s. One query probes a list in a
// batch almost always (1.04 queries a list at the 10M configuration), so
// each (query, list) pair streams its list once, as a GEMV does. Near that
// rate the decode takes most of the issue slots (~8.8 lane instructions a
// byte at 3.35 TB/s over 132 SMs), so the design keeps the instructions a
// value few and the loads wide. Both kernels share every step up to the
// selection (stage_range, score_rows, radix_select, emit_selected):
//
// - One block of 256 threads a (query, probe slot, row range); in K6 a slot
//   whose list the query probed at an earlier slot writes only (-inf, -1),
//   so a list counts once (K7 scans a repeat again, as the JAX wrapper's
//   probe-slot mapping does). The block reads the range's row ids at once
//   (<= 8 a thread), compacts the occupied slots in order into shared
//   memory, so empty slots cost neither loads nor a pass of the walk, and
//   stages q there as f32, each lane's columns together in the order in
//   which it decodes them (a lane's block of kStride float4s, an odd count:
//   the lanes of a row read 16-byte chunks free of bank conflicts).
// - The plan (ops/ivf_scan.py::k6_plan): a row is `words` words, read by a
//   fixed group of `lanes` lanes (a power of two, at most a warp), each
//   taking WPL words a pass (word p * lanes * WPL + lane + lanes * j of pass
//   p), in as many passes as the row needs; a word past the row's end is
//   masked (not loaded, its q zero). So a lane always meets the same columns.
//   The next (row, pass)'s words are issued before the current one is
//   decoded. Register-bound at 4 blocks an SM (64 registers; the 16-byte
//   cases spill nothing).
// - Two compile-time cases. WIDE: 16-byte words, each inside one scale group
//   (g a multiple of the word's 16 or 32 codes), one scale a word, loaded
//   with the words. Otherwise 4-byte words and a scale for each value, by a
//   group index staged beside q: a group smaller than a word, or one that a
//   word straddles, costs loads but no division in the loop.
// - Decode as bf16 pairs, rounded as the reference: int8 bytes (cols c, c+2
//   and c+1, c+3 of a 32-bit word) become the exact bf16 integer by one
//   lop3 each for 128 + low 7 bits and for -128 - 128 * top bit, then one
//   bf16x2 fma; int4 nibbles (flipped in bit 3) go under the exponent byte of
//   bf16 128 by one prmt a pair, then x - 136 by one bf16x2 fma. Then one
//   fma(v, mult * s, offset * s) rounds (v * mult + offset) * s to bf16 once
//   (mult and offset are powers of two, so both products are exact). Each
//   pair is dotted with f32 q by two FFMAs after a shift and a mask; a row's
//   lanes sum by shuffles in a fixed order.
// - One selection a range, not a sort a tile: the scores stay in shared
//   memory; a radix select over the 64-bit key (score, id) finds the k-th
//   best in 8-bit digits (it stops once the digits fix the set, usually
//   after the score's 4). K6 writes the k best unordered, in slot order, and
//   itx_ivf_merge_topk (ivf_scan.cu) ranks each query's candidates. K7
//   selects by the residual dot alone (ivf_scan.py adds the base after),
//   with flat storage positions as ids, and writes its t <= 256 best first:
//   a key's place is the count of chosen keys above it (the keys are
//   unique), one thread a key, no sort. Where a list is cut into ranges,
//   itx_ivf_merge_topk ranks each slot's ranges' candidates.
// - K7 takes what K6 takes: the plan's rows of whole 4-byte words, codes
//   whose code * mult + offset bf16 holds exactly with mult and offset
//   powers of two (ops/ivf_scan.py::k6_check_codes; the callers pass (1, 0)
//   and the refine hi plane's (16, 8)), 1 <= t <= 256.

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;
constexpr int kMaxSplitRows = kThreads * kRowsPerThread;  // ops/ivf_scan.py K6_MAX_SPLIT_ROWS

// The words of one case: WIDE, 16-byte words a scale each; else 4-byte words.
template <int BITS, bool WIDE>
struct Words {
  static constexpr int kVec = WIDE ? 4 : 1;                  // 32-bit words in a word
  static constexpr int kVPW = kVec * (BITS == 4 ? 8 : 4);    // codes in a word
  static constexpr int kCh = kVPW / 4;                       // float4 chunks of q a word
  static constexpr int kWPL = WIDE ? 3 : 4;                  // words a lane a pass (ops/ivf_scan.py K6_WORDS_PER_LANE)
  static constexpr int kStride = kWPL * kCh + 1;             // float4s of q a (pass, lane): odd
};

// Dynamic shared memory of a block: q, the word table, the group table
// (4-byte words only), then the range's scores, ids and slots.
template <int BITS, bool WIDE>
size_t smem_bytes(int lanes, int passes, int split_rows) {
  using W = Words<BITS, WIDE>;
  const size_t q4 = static_cast<size_t>(passes) * lanes * W::kStride;
  return q4 * 16 + static_cast<size_t>(passes) * lanes * W::kWPL * 4 + (WIDE ? 0 : q4 * 8) +
         static_cast<size_t>(split_rows) * 12;
}

__device__ __forceinline__ float lo_f32(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f32(uint32_t p) { return __uint_as_float(p & 0xFFFF0000u); }

// a += q . the 4 int8 residuals of x; qa holds q at columns (0, 2, 1, 3), ms
// and os are mult * s and offset * s as bf16 pairs for columns (0, 2) and
// (1, 3).
__device__ __forceinline__ void dot_int8(uint32_t x, float4 qa, const uint32_t ms[2], const uint32_t os[2],
                                         float& a0, float& a1) {
  const uint32_t y = x >> 8;
  // bytes 0 and 2 (1 and 3): 128 + low 7 bits, plus -128 - 128 * bit 7
  const uint32_t v02 = itx::bf16x2_fma((x & 0x007F007Fu) | 0x43004300u, itx::kBf16x2One,
                                       (x & 0x00800080u) | 0xC300C300u);
  const uint32_t v13 = itx::bf16x2_fma((y & 0x007F007Fu) | 0x43004300u, itx::kBf16x2One,
                                       (y & 0x00800080u) | 0xC300C300u);
  const uint32_t r02 = itx::bf16x2_fma(v02, ms[0], os[0]);
  const uint32_t r13 = itx::bf16x2_fma(v13, ms[1], os[1]);
  a0 = fmaf(qa.x, lo_f32(r02), a0);
  a1 = fmaf(qa.y, hi_f32(r02), a1);
  a0 = fmaf(qa.z, lo_f32(r13), a0);
  a1 = fmaf(qa.w, hi_f32(r13), a1);
}

// a += q . the 8 int4 residuals of x; qa holds q at columns (0, 2, 4, 6),
// qb at (1, 3, 5, 7); ms and os for the column pairs (0, 2), (4, 6), (1, 3),
// (5, 7).
__device__ __forceinline__ void dot_int4(uint32_t x, float4 qa, float4 qb, const uint32_t ms[4],
                                         const uint32_t os[4], float& a0, float& a1) {
  constexpr uint32_t kExp = 0x43434343u;   // the exponent byte of bf16 128
  constexpr uint32_t kMinus136 = 0xC308C308u;
  const uint32_t t = (x & 0x0F0F0F0Fu) ^ 0x08080808u;         // low nibbles + 8
  const uint32_t u = ((x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // high nibbles + 8
  const uint32_t v0 = itx::bf16x2_fma(__byte_perm(t, kExp, 0x4140), itx::kBf16x2One, kMinus136);
  const uint32_t v1 = itx::bf16x2_fma(__byte_perm(t, kExp, 0x4342), itx::kBf16x2One, kMinus136);
  const uint32_t v2 = itx::bf16x2_fma(__byte_perm(u, kExp, 0x4140), itx::kBf16x2One, kMinus136);
  const uint32_t v3 = itx::bf16x2_fma(__byte_perm(u, kExp, 0x4342), itx::kBf16x2One, kMinus136);
  const uint32_t r0 = itx::bf16x2_fma(v0, ms[0], os[0]), r1 = itx::bf16x2_fma(v1, ms[1], os[1]);
  const uint32_t r2 = itx::bf16x2_fma(v2, ms[2], os[2]), r3 = itx::bf16x2_fma(v3, ms[3], os[3]);
  a0 = fmaf(qa.x, lo_f32(r0), a0);
  a1 = fmaf(qa.y, hi_f32(r0), a1);
  a0 = fmaf(qa.z, lo_f32(r1), a0);
  a1 = fmaf(qa.w, hi_f32(r1), a1);
  a0 = fmaf(qb.x, lo_f32(r2), a0);
  a1 = fmaf(qb.y, hi_f32(r2), a1);
  a0 = fmaf(qb.z, lo_f32(r3), a0);
  a1 = fmaf(qb.w, hi_f32(r3), a1);
}

// (mult * s, offset * s) as bf16 pairs from a pair of bf16 scales s.
__device__ __forceinline__ void scale_pair(uint32_t s2, uint32_t mult2, uint32_t offset2, uint32_t& ms,
                                           uint32_t& os) {
  ms = itx::bf16x2_fma(mult2, s2, itx::kBf16x2NegZero);
  os = offset2 != 0u ? itx::bf16x2_fma(offset2, s2, itx::kBf16x2NegZero) : itx::kBf16x2NegZero;
}

// This thread's rank among the block's threads with f set, in thread order;
// *total: how many have it set. Every thread of the block calls it.
__device__ __forceinline__ int block_rank(bool f, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, f);
  if (lane == 0) warp_tot[warp] = __popc(bal);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_tot[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();  // warp_tot is free again
  return before + __popc(bal & ((1u << lane) - 1u));
}

// The sum of v over threads 0..threadIdx.x. Every thread of the block calls it.
__device__ __forceinline__ int block_inclusive_sum(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? warp_tot[w] : 0;
  __syncthreads();
  return v + before;
}

// (score, id) as one unsigned key that orders as the ranking does: higher
// score, then higher id (ids are >= 0).
__device__ __forceinline__ unsigned long long rank_key(float s, int id) {
  const uint32_t u = __float_as_uint(s);
  const uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) | static_cast<uint32_t>(id);
}

// What every block of a launch takes of the plan and the storage. lanes: a
// power of two <= 32; words: the row's words; a list of L rows is cut into
// `splits` ranges of `split_rows`.
struct Layout {
  int D, L, G, group_size, lanes, passes, words, splits, split_rows;
  uint32_t mult2, offset2;  // code_mult and code_offset as bf16 pairs
};

// A block's dynamic shared memory (smem_bytes): q, the word table, the group
// table (4-byte words only), then the range's scores, ids and slots.
template <int BITS, bool WIDE>
struct Range {
  float4* qs;
  int* wt;    // a word's group (WIDE) or 0; -1: masked
  uint2* gq;  // 4-byte words: each value's group
  float* sc;
  int* ids;
  int* slots;
};

template <int BITS, bool WIDE>
__device__ __forceinline__ Range<BITS, WIDE> carve(unsigned char* smem, const Layout& lo) {
  using Wd = Words<BITS, WIDE>;
  const int n_lane_blocks = lo.passes * lo.lanes;
  Range<BITS, WIDE> rg;
  rg.qs = reinterpret_cast<float4*>(smem);
  rg.wt = reinterpret_cast<int*>(rg.qs + n_lane_blocks * Wd::kStride);
  rg.gq = reinterpret_cast<uint2*>(rg.wt + n_lane_blocks * Wd::kWPL);
  rg.sc = reinterpret_cast<float*>(WIDE ? reinterpret_cast<unsigned char*>(rg.gq)
                                        : reinterpret_cast<unsigned char*>(rg.gq + n_lane_blocks * Wd::kStride));
  rg.ids = reinterpret_cast<int*>(rg.sc + lo.split_rows);
  rg.slots = rg.ids + lo.split_rows;
  return rg;
}

// Rows [r_lo, r_hi) of the list at row0: reads the range's row ids, all in
// flight at once; stages q (row qb) and the tables by the plan; compacts the
// occupied slots in order. An id is the row id, or (positions) the flat
// storage position row0 + slot. → the occupied rows n. Every thread calls it.
template <int BITS, bool WIDE>
__device__ __forceinline__ int stage_range(const Range<BITS, WIDE>& rg, const Layout& lo,
                                           const __nv_bfloat16* __restrict__ qb,
                                           const int* __restrict__ row_ids, size_t row0, int r_lo, int r_hi,
                                           bool positions, int* warp_tot) {
  using Wd = Words<BITS, WIDE>;
  constexpr int kVPW = Wd::kVPW, kCh = Wd::kCh, kWPL = Wd::kWPL, kStride = Wd::kStride;
  const int tid = threadIdx.x;
  const int lanes = lo.lanes, words = lo.words;
  const int n_lane_blocks = lo.passes * lanes;
  int rid[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = r_lo + tid + j * kThreads;
    rid[j] = r < r_hi ? __ldg(row_ids + row0 + r) : -1;
  }
  const int lshift = __ffs(lanes) - 1;
  float* qf = reinterpret_cast<float*>(rg.qs);
  uint16_t* gv = reinterpret_cast<uint16_t*>(rg.gq);
  for (int s = tid; s < n_lane_blocks * kStride * 4; s += kThreads) {
    // slot s: value e of chunk c of word j of (pass, lane) block s / 4 / kStride
    const int f4 = s >> 2, e = s & 3;
    const int lb = f4 / kStride, within = f4 % kStride;
    const int j = within / kCh, c = within % kCh;
    const int w = (lb >> lshift) * lanes * kWPL + (lb & (lanes - 1)) + lanes * j;
    float v = 0.f;
    int g = 0;
    if (j < kWPL && w < words) {
      // position t of a 4- (int8) or 8-value block decodes column order[t]:
      // (0, 2, 1, 3) or (0, 2, 4, 6, 1, 3, 5, 7)
      const int pos = c * 4 + e;
      const int t = BITS == 8 ? pos & 3 : pos & 7;
      const int col = BITS == 8 ? (((t & 1) << 1) | (t >> 1)) : (((t & 3) << 1) | (t >> 2));
      const int d = w * kVPW + (pos - t) + col;
      v = __bfloat162float(qb[d]);
      g = d / lo.group_size;
    }
    qf[s] = v;
    if (!WIDE) gv[s] = static_cast<uint16_t>(g);
  }
  for (int s = tid; s < n_lane_blocks * kWPL; s += kThreads) {
    const int lb = s / kWPL, j = s % kWPL;
    const int w = (lb >> lshift) * lanes * kWPL + (lb & (lanes - 1)) + lanes * j;
    rg.wt[s] = w >= words ? -1 : WIDE ? w * kVPW / lo.group_size : 0;
  }
  int n = 0;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (r_lo + j * kThreads >= r_hi) break;  // uniform
    const bool occ = rid[j] >= 0;
    int total;
    const int at = n + block_rank(occ, warp_tot, total);
    if (occ) {
      const int r = r_lo + tid + j * kThreads;
      rg.slots[at] = r;
      rg.ids[at] = positions ? static_cast<int>(row0 + r) : rid[j];
    }
    n += total;
  }
  __syncthreads();
  return n;
}

// The walk: group grp of `lanes` lanes scores rows grp, grp + groups, ...,
// each in `passes` steps; row i's score (its residual dot plus bias) goes
// to sc[i]. Every thread calls it.
template <int BITS, bool WIDE>
__device__ __forceinline__ void score_rows(const Range<BITS, WIDE>& rg, const Layout& lo, int n,
                                           const uint8_t* __restrict__ packed,
                                           const uint16_t* __restrict__ scales, size_t row0, float bias) {
  using Wd = Words<BITS, WIDE>;
  constexpr int kVec = Wd::kVec, kCh = Wd::kCh, kWPL = Wd::kWPL, kStride = Wd::kStride;
  const int tid = threadIdx.x;
  const int lanes = lo.lanes, passes = lo.passes, G = lo.G;
  const uint32_t mult2 = lo.mult2, offset2 = lo.offset2;
  const int lshift = __ffs(lanes) - 1;
  const int lig = tid & (lanes - 1);
  const int grp = tid >> lshift;
  const int groups = kThreads >> lshift;
  const int steps = (n + groups - 1) / groups * passes;  // uniform over the block
  const size_t row_bytes = static_cast<size_t>(lo.words) * kVec * 4;
  const float4* qs = rg.qs;
  const int* wt = rg.wt;
  const uint2* gq = rg.gq;
  const int* slots = rg.slots;

  int wv[kWPL];  // wt of the pass in `wv_pass`, for this lane
  int wv_pass = -1;
  auto load = [&](int i, int p, uint32_t(&w)[kWPL][kVec], uint16_t(&s)[kWPL]) {
    if (p != wv_pass) {  // with one pass, once
      wv_pass = p;
#pragma unroll
      for (int j = 0; j < kWPL; ++j) wv[j] = wt[((p << lshift) + lig) * kWPL + j];
    }
    const size_t row = row0 + slots[i];
    const uint8_t* rp = packed + row * row_bytes + static_cast<size_t>(p * lanes * kWPL + lig) * kVec * 4;
#pragma unroll
    for (int j = 0; j < kWPL; ++j) {
      const bool ok = wv[j] >= 0;
      if constexpr (WIDE) {
        const uint4 x = ok ? __ldg(reinterpret_cast<const uint4*>(rp) + lanes * j) : make_uint4(0, 0, 0, 0);
        w[j][0] = x.x;
        w[j][1] = x.y;
        w[j][2] = x.z;
        w[j][3] = x.w;
        s[j] = ok ? __ldg(scales + row * G + wv[j]) : 0;
      } else {
        w[j][0] = ok ? __ldg(reinterpret_cast<const uint32_t*>(rp) + lanes * j) : 0u;
      }
    }
  };

  uint32_t cur[kWPL][kVec], nxt[kWPL][kVec];
  uint16_t scur[kWPL], snxt[kWPL];
  int i_cur = grp, p_cur = 0;
  if (steps > 0) load(min(grp, n - 1), 0, cur, scur);
  float a0 = 0.f, a1 = 0.f;
  for (int st = 0; st < steps; ++st) {
    int i_nxt = i_cur, p_nxt = p_cur + 1;
    if (p_nxt == passes) {
      p_nxt = 0;
      i_nxt += groups;
    }
    load(min(i_nxt, n - 1), p_nxt, nxt, snxt);  // past the end: the last row again, no mask
    const float4* ql = qs + ((p_cur << lshift) + lig) * kStride;
    const uint16_t* sp = scales + (row0 + slots[min(i_cur, n - 1)]) * G;  // 4-byte words: a scale a value
#pragma unroll
    for (int j = 0; j < kWPL; ++j) {
      uint32_t ms[4], osf[4];
      if constexpr (WIDE) {
        uint32_t m, o;
        scale_pair(static_cast<uint32_t>(scur[j]) * 0x10001u, mult2, offset2, m, o);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          ms[h] = m;
          osf[h] = o;
        }
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if constexpr (BITS == 8) {
          if constexpr (!WIDE) {
            const uint2 g = gq[((p_cur << lshift) + lig) * kStride + j];
            scale_pair(__ldg(sp + (g.x & 0xFFFFu)) | (static_cast<uint32_t>(__ldg(sp + (g.x >> 16))) << 16),
                       mult2, offset2, ms[0], osf[0]);
            scale_pair(__ldg(sp + (g.y & 0xFFFFu)) | (static_cast<uint32_t>(__ldg(sp + (g.y >> 16))) << 16),
                       mult2, offset2, ms[1], osf[1]);
          }
          dot_int8(cur[j][e], ql[j * kCh + e], ms, osf, a0, a1);
        } else {
          if constexpr (!WIDE) {
            const uint2* g2 = gq + ((p_cur << lshift) + lig) * kStride + j * kCh;
            const uint2 ga = g2[0], gb = g2[1];
            const uint32_t gg[4] = {ga.x, ga.y, gb.x, gb.y};
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              scale_pair(__ldg(sp + (gg[h] & 0xFFFFu)) | (static_cast<uint32_t>(__ldg(sp + (gg[h] >> 16))) << 16),
                         mult2, offset2, ms[h], osf[h]);
            }
          }
          dot_int4(cur[j][e], ql[j * kCh + 2 * e], ql[j * kCh + 2 * e + 1], ms, osf, a0, a1);
        }
      }
    }
    if (p_cur == passes - 1) {
      float acc = a0 + a1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        if (off < lanes) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lig == 0 && i_cur < n) rg.sc[i_cur] = acc + bias;
      a0 = a1 = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kWPL; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) cur[j][e] = nxt[j][e];
      scur[j] = snxt[j];
    }
    i_cur = i_nxt;
    p_cur = p_nxt;
  }
  __syncthreads();
}

// Radix select of the k-th best key over n > k rows, 8 bits a pass from the
// top (it stops once the digits fix the set, usually after the score's 4).
// → need: the k best are every key whose bits under `mask` exceed `prefix`,
// then the first `need` equal to it. Every thread calls it.
__device__ __forceinline__ int radix_select(const float* sc, const int* ids, int n, int k, unsigned* hist,
                                            int* warp_tot, int* pick, unsigned long long& prefix,
                                            unsigned long long& mask) {
  const int tid = threadIdx.x;
  prefix = 0ull;
  mask = 0ull;
  int need = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    hist[tid] = 0u;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += kThreads) {  // uniform: the lanes of a digit add once
      const int i = i0 + tid;
      const unsigned long long key = i < n ? rank_key(sc[i], ids[i]) : 0ull;
      const bool in = i < n && (key & mask) == prefix;
      const unsigned digit = in ? static_cast<unsigned>(key >> shift) & 0xFFu : 256u;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (in && (threadIdx.x & 31) == __ffs(peers) - 1) {
        atomicAdd(&hist[digit], static_cast<unsigned>(__popc(peers)));
      }
    }
    __syncthreads();
    const int cnt = static_cast<int>(hist[255 - tid]);  // thread t: digit 255 - t
    const int incl = block_inclusive_sum(cnt, warp_tot);
    if (incl - cnt < need && incl >= need) {
      pick[0] = 255 - tid;
      pick[1] = incl - cnt;
      pick[2] = cnt;
    }
    __syncthreads();
    prefix |= static_cast<unsigned long long>(pick[0]) << shift;
    mask |= 0xFFull << shift;
    need -= pick[1];
    const bool done = pick[2] == need;
    __syncthreads();  // pick and hist are read before the next pass writes them
    if (done) break;
  }
  return need;
}

// emit(place, i) for each of the k best rows i that radix_select fixed:
// those above the prefix at places 0, 1, ... in row order, then the first
// `need` at it after them. Every thread calls it.
template <typename Emit>
__device__ __forceinline__ void emit_selected(const float* sc, const int* ids, int n, int k,
                                              unsigned long long prefix, unsigned long long mask, int need,
                                              int* warp_tot, Emit emit) {
  const int above = k - need;
  int n_gt = 0, n_eq = 0;
  for (int i0 = 0; i0 < n; i0 += kThreads) {  // uniform
    const int i = i0 + threadIdx.x;
    const unsigned long long key = i < n ? rank_key(sc[i], ids[i]) & mask : 0ull;
    const bool gt = i < n && key > prefix;
    const bool eq = i < n && key == prefix;
    int t_gt, t_eq;
    const int r_gt = n_gt + block_rank(gt, warp_tot, t_gt);
    const int r_eq = n_eq + block_rank(eq, warp_tot, t_eq);
    if (gt) {
      emit(r_gt, i);
    } else if (eq && r_eq < need) {
      emit(above + r_eq, i);
    }
    n_gt += t_gt;
    n_eq += t_eq;
  }
}

// K6. One block per (query * nprobe + probe slot) * splits + row range; base
// is (B, C) q.centroid. A slot whose list the query probed at an earlier
// slot writes only (-inf, -1); the others their range's k best, unordered.
template <int BITS, bool WIDE>
__global__ void __launch_bounds__(kThreads, 4)
ivf_topk_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ packed,
                const uint16_t* __restrict__ scales, const int* __restrict__ row_ids,
                const int* __restrict__ lists, const float* __restrict__ base,
                float* __restrict__ out_s, int* __restrict__ out_i, int C, int nprobe, int k,
                int track_positions, Layout lo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Range<BITS, WIDE> rg = carve<BITS, WIDE>(smem, lo);
  __shared__ int warp_tot[kWarps];
  __shared__ unsigned hist[256];
  __shared__ int pick[3];  // digit, count above it, count at it

  const int tid = threadIdx.x;
  const int pair = blockIdx.x / lo.splits;
  const int r_lo = (blockIdx.x % lo.splits) * lo.split_rows;
  const int r_hi = min(lo.L, r_lo + lo.split_rows);
  float* os = out_s + static_cast<size_t>(blockIdx.x) * k;
  int* oi = out_i + static_cast<size_t>(blockIdx.x) * k;
  const int b = pair / nprobe, slot = pair % nprobe;
  const int* probes = lists + static_cast<size_t>(b) * nprobe;
  const int list = probes[slot];
  bool repeat = list < 0;  // a list the query probed at an earlier slot counts once
  for (int j = 0; j < slot; ++j) repeat |= probes[j] == list;
  if (repeat) {
    for (int i = tid; i < k; i += kThreads) {
      os[i] = -INFINITY;
      oi[i] = -1;
    }
    return;
  }
  const size_t row0 = static_cast<size_t>(list) * lo.L;
  const int n = stage_range(rg, lo, q + static_cast<size_t>(b) * lo.D, row_ids, row0, r_lo, r_hi,
                            track_positions != 0, warp_tot);
  score_rows(rg, lo, n, packed, scales, row0, base[static_cast<size_t>(b) * C + list]);

  if (n <= k) {  // every occupied row, then (-inf, -1)
    for (int i = tid; i < k; i += kThreads) {
      os[i] = i < n ? rg.sc[i] : -INFINITY;
      oi[i] = i < n ? rg.ids[i] : -1;
    }
    return;
  }
  unsigned long long prefix, mask;
  const int need = radix_select(rg.sc, rg.ids, n, k, hist, warp_tot, pick, prefix, mask);
  emit_selected(rg.sc, rg.ids, n, k, prefix, mask, need, warp_tot, [&](int place, int i) {
    os[place] = rg.sc[i];
    oi[place] = rg.ids[i];
  });
}

// K7. One block per (query * nprobe + probe slot) * splits + row range: the
// range's t best rows by the residual dot alone (no base; a repeated probe
// is scanned again), ids the flat storage positions, written best first,
// then (-inf, -1). A slot of -1 writes only those.
template <int BITS, bool WIDE>
__global__ void __launch_bounds__(kThreads, 4)
ivf_slot_topk_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ packed,
                     const uint16_t* __restrict__ scales, const int* __restrict__ row_ids,
                     const int* __restrict__ lists, float* __restrict__ out_s, int* __restrict__ out_i,
                     int nprobe, int t, Layout lo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Range<BITS, WIDE> rg = carve<BITS, WIDE>(smem, lo);
  __shared__ int warp_tot[kWarps];
  __shared__ unsigned hist[256];  // the select's histogram, then the chosen scores' bits
  __shared__ int pick[3];

  const int tid = threadIdx.x;
  const int pair = blockIdx.x / lo.splits;
  const int r_lo = (blockIdx.x % lo.splits) * lo.split_rows;
  const int r_hi = min(lo.L, r_lo + lo.split_rows);
  float* os = out_s + static_cast<size_t>(blockIdx.x) * t;
  int* oi = out_i + static_cast<size_t>(blockIdx.x) * t;
  const int list = lists[pair];
  if (list < 0) {
    for (int i = tid; i < t; i += kThreads) {
      os[i] = -INFINITY;
      oi[i] = -1;
    }
    return;
  }
  const size_t row0 = static_cast<size_t>(list) * lo.L;
  const int n = stage_range(rg, lo, q + static_cast<size_t>(pair / nprobe) * lo.D, row_ids, row0, r_lo,
                            r_hi, true, warp_tot);
  // bias +0: a score of -0 ranks as +0, as the plain version's compare takes it
  score_rows(rg, lo, n, packed, scales, row0, 0.f);

  // the chosen m <= t rows: all n, or the select's t, their (score, id)
  // compacted into hist and slots (free once the walk and the select end)
  const bool chose = n > t;
  if (chose) {
    unsigned long long prefix, mask;
    const int need = radix_select(rg.sc, rg.ids, n, t, hist, warp_tot, pick, prefix, mask);
    emit_selected(rg.sc, rg.ids, n, t, prefix, mask, need, warp_tot, [&](int place, int i) {
      hist[place] = __float_as_uint(rg.sc[i]);
      rg.slots[place] = rg.ids[i];
    });
    __syncthreads();
  }
  const int m = chose ? t : n;
  const unsigned* sel_s = chose ? hist : reinterpret_cast<const unsigned*>(rg.sc);
  const int* sel_i = chose ? rg.slots : rg.ids;
  // best first: a key's place is the number of chosen keys above it (the
  // keys are unique: positions differ); t <= kThreads
  for (int r = tid; r < t; r += kThreads) {
    if (r < m) {
      const float s = __uint_as_float(sel_s[r]);
      const int id = sel_i[r];
      const unsigned long long key = rank_key(s, id);
      int place = 0;
      for (int j = 0; j < m; ++j) place += rank_key(__uint_as_float(sel_s[j]), sel_i[j]) > key;
      os[place] = s;
      oi[place] = id;
    } else {
      os[r] = -INFINITY;
      oi[r] = -1;
    }
  }
}

// An integer that bf16 holds exactly, as a bf16 pair.
uint32_t bf16x2_of(int v) {
  const float f = static_cast<float>(v);
  uint32_t bits;
  memcpy(&bits, &f, sizeof(bits));
  bits >>= 16;
  return bits | (bits << 16);
}

// The layout of a plan (ops/ivf_scan.py::k6_plan, k6_splits), or words = 0
// where the plan does not fit the shape.
template <int BITS, bool WIDE>
Layout layout_of(int D, int L, int G, int group_size, int lanes, int words_per_lane, int passes, int splits,
                 int split_rows, int code_mult, int code_offset) {
  using Wd = Words<BITS, WIDE>;
  const int row_bytes = D * BITS / 8;
  const int words = row_bytes / (Wd::kVec * 4);
  Layout lo{D, L, G, group_size, lanes, passes, words, splits, split_rows, bf16x2_of(code_mult),
            code_offset != 0 ? bf16x2_of(code_offset) : 0u};
  if (words_per_lane != Wd::kWPL || row_bytes % (Wd::kVec * 4) || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || passes < 1 || passes * lanes * Wd::kWPL < words ||
      (passes - 1) * lanes * Wd::kWPL >= words || D % group_size || G != D / group_size || G > 65536 ||
      split_rows > kMaxSplitRows || split_rows * splits < L) {
    lo.words = 0;
  }
  return lo;
}

// Launch `kern` on one block a (pair, row range) with the layout's shared
// memory. → cudaGetLastError() after the launch, or cudaErrorInvalidValue.
template <int BITS, bool WIDE, typename Kernel, typename... Args>
int start(Kernel kern, int pairs, const Layout& lo, cudaStream_t st, Args... args) {
  if (lo.words == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<BITS, WIDE>(lo.lanes, lo.passes, lo.split_rows);
  if (smem > 48 * 1024) {  // opt in to more shared memory than the default
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(pairs * lo.splits), kThreads, smem, st>>>(args..., lo);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, bool WIDE>
int launch_topk(const void* q, const void* packed, const void* scales, const void* row_ids, const void* lists,
                const void* base, void* out_s, void* out_i, int B, int C, int nprobe, int k, int track_positions,
                const Layout& lo, cudaStream_t st) {
  return start<BITS, WIDE>(ivf_topk_kernel<BITS, WIDE>, B * nprobe, lo, st, static_cast<const __nv_bfloat16*>(q),
                           static_cast<const uint8_t*>(packed), static_cast<const uint16_t*>(scales),
                           static_cast<const int*>(row_ids), static_cast<const int*>(lists),
                           static_cast<const float*>(base), static_cast<float*>(out_s), static_cast<int*>(out_i),
                           C, nprobe, k, track_positions);
}

template <int BITS, bool WIDE>
int launch_slot_topk(const void* q, const void* packed, const void* scales, const void* row_ids,
                     const void* lists, void* out_s, void* out_i, int B, int nprobe, int t, const Layout& lo,
                     cudaStream_t st) {
  return start<BITS, WIDE>(ivf_slot_topk_kernel<BITS, WIDE>, B * nprobe, lo, st,
                           static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(packed),
                           static_cast<const uint16_t*>(scales), static_cast<const int*>(row_ids),
                           static_cast<const int*>(lists), static_cast<float*>(out_s), static_cast<int*>(out_i),
                           nprobe, t);
}

}  // namespace

// K6. q: bf16 (B, D); packed: int8 (C, L, W); scales: bf16 (C, L, G);
// row_ids: int32 (C, L); lists: int32 (B, nprobe), the probes as given (a
// list at an earlier slot of the same query, or -1, gives only (-inf, -1));
// base: f32 (B, C), q.centroid of every list; out_s/out_i: (B, nprobe,
// splits, k), each range's k best unordered, (-inf, -1) where it has fewer.
// wide, lanes_per_row, words_per_lane, passes, splits and split_rows come
// from ops/ivf_scan.py::k6_plan and k6_splits (split_rows <= 2048);
// code_mult is a power of two and code_offset 0 or a power of two
// (k6_check_codes). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan that does not fit the shape.
extern "C" int itx_ivf_scan_topk(const void* q, const void* packed, const void* scales,
                                 const void* row_ids, const void* lists, const void* base, void* out_s,
                                 void* out_i, int B, int C, int nprobe, int D, int L, int G, int group_size,
                                 int bits, int k, int wide, int lanes_per_row, int words_per_lane, int passes,
                                 int splits, int split_rows, int code_mult, int code_offset,
                                 int track_positions, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
#define ITX_K6_LAUNCH(BITS_, WIDE_)                                                                        \
  launch_topk<BITS_, WIDE_>(q, packed, scales, row_ids, lists, base, out_s, out_i, B, C, nprobe, k,       \
                            track_positions, layout_of<BITS_, WIDE_>(D, L, G, group_size, lanes_per_row,  \
                                                                     words_per_lane, passes, splits,      \
                                                                     split_rows, code_mult, code_offset), \
                            st)
  if (bits == 8) return wide ? ITX_K6_LAUNCH(8, true) : ITX_K6_LAUNCH(8, false);
  if (bits == 4) return wide ? ITX_K6_LAUNCH(4, true) : ITX_K6_LAUNCH(4, false);
#undef ITX_K6_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7. q, packed, scales, row_ids and the plan as for K6; lists: int32 (B,
// nprobe), each slot scanned as given (a repeat again; -1 gives only
// (-inf, -1)); out_s/out_i: (B, nprobe, splits, t), each range's t best by
// the residual dot alone (no base), best first, ids the flat positions
// list * L + slot, (-inf, -1) past the occupied rows; 1 <= t <= 256.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a plan that does not fit the shape.
extern "C" int itx_ivf_slot_topk(const void* q, const void* packed, const void* scales, const void* row_ids,
                                 const void* lists, void* out_s, void* out_i, int B, int nprobe, int D, int L,
                                 int G, int group_size, int bits, int t, int wide, int lanes_per_row,
                                 int words_per_lane, int passes, int splits, int split_rows, int code_mult,
                                 int code_offset, void* stream) {
  if (t < 1 || t > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define ITX_K7_LAUNCH(BITS_, WIDE_)                                                                        \
  launch_slot_topk<BITS_, WIDE_>(q, packed, scales, row_ids, lists, out_s, out_i, B, nprobe, t,           \
                                 layout_of<BITS_, WIDE_>(D, L, G, group_size, lanes_per_row,              \
                                                         words_per_lane, passes, splits, split_rows,      \
                                                         code_mult, code_offset),                         \
                                 st)
  if (bits == 8) return wide ? ITX_K7_LAUNCH(8, true) : ITX_K7_LAUNCH(8, false);
  if (bits == 4) return wide ? ITX_K7_LAUNCH(4, true) : ITX_K7_LAUNCH(4, false);
#undef ITX_K7_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
