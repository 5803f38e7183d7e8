// What the pull kernels (the pair-fused pairs_pull.cu and pairs_totals.cu,
// the single-pass m8_pull.cu and m8_totals.cu) share: the matched partner
// of a row, the diagonal-refreshed row load and the deficit sums (also of
// the packed u4r rung), the totals passes' pair body (on rows of 1-byte
// elements 16 bytes a step with SIMD byte sums) and the budgeted
// advance. Both passes of each
// two-pass form read w through these, so a totals pass sees the
// refreshed diagonal exactly as its pull does, and every pull applies the
// same arithmetic.
#pragma once

#include <stdint.h>

#include "common.cuh"

// Row i's partner under the grouped matching (gm, c): the TPU kernels'
// 8-row group pairing g <-> gm[g] with the within-pair rotation c[g],
// flattened to the row involution p (p[p[i]] == i).
__device__ __forceinline__ int partner_row(const int32_t* gm, const int32_t* c,
                                           int i) {
  const int g = i >> 3;
  return 8 * gm[g] + (((i & 7) - c[g]) & 7);
}

// Eight elements of row `row` from local column j0 (a multiple of 8) of
// a block whose column 0 is global owner col0 (0 for the whole width);
// with DIAG the owner diagonal, global owner `row`, reads as mv at its
// local column (the round's first sub-exchange refreshes it):
// refresh_row on eight loaded elements, ld8_row on a row of w. The
// element is picked with constant indices: a computed index into x8
// would put it in local memory.
template <typename WT, bool DIAG>
__device__ __forceinline__ Vec8<WT> refresh_row(Vec8<WT> x8, int row, int j0,
                                                const int32_t* mv, int col0 = 0) {
  const int g0 = col0 + j0;
  if (DIAG && row >= g0 && row < g0 + 8) {
    const WT v = static_cast<WT>(mv[row - col0]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (g0 + e == row) x8.v[e] = v;
    }
  }
  return x8;
}

template <typename WT, bool DIAG>
__device__ __forceinline__ Vec8<WT> ld8_row(const WT* w_row, int row, int j0,
                                            const int32_t* mv, int col0 = 0) {
  return refresh_row<WT, DIAG>(ld8(w_row + j0), row, j0, mv, col0);
}

// Adds eight columns' deficits of both directions: row i (x) pulling from
// p (y) where row i is valid (vi), and p pulling from i where row p is
// (vp).
template <typename WT>
__device__ __forceinline__ void add_deficits(const Vec8<WT>& x8,
                                             const Vec8<WT>& y8, bool vi,
                                             bool vp, long long& ti,
                                             long long& tp) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int32_t x = x8.v[e], y = y8.v[e];
    if (vi && y > x) ti += y - x;
    if (vp && x > y) tp += x - y;
  }
}

// The packed u4r rung: a row of w is n / 2 bytes, byte k holding owner 2k
// in its low nibble and owner 2k + 1 in its high nibble, each a saturating
// residual below the owner's max_version. Residual space is closed under
// the pull: a direction's deficit is max(r_recv - r_send, 0) and an
// advance shrinks the receiver's residual.

// Eight bytes (sixteen owners) of packed row `row` from byte column k0 (a
// multiple of 8) of a block whose column 0 is global owner col0 (even; 0
// for the whole width). With DIAG, the round's first sub-exchange's
// refresh (the reference's _refresh_packed): every residual rises by its
// owner's write bump (`bump`: the block's bumps as packed nibbles, each
// clipped to [0, 15], which keeps the saturating sum exact), saturating
// at 15, then the row's own owner, global owner `row`, reads 0:
// refresh_packed_row on eight loaded bytes, ld8_packed_row on a row.
template <bool DIAG>
__device__ __forceinline__ Vec8<uint8_t> refresh_packed_row(Vec8<uint8_t> x8, int row,
                                                            int k0, const uint8_t* bump,
                                                            int col0 = 0) {
  if (DIAG) {
    const Vec8<uint8_t> b8 = ld8(bump + k0);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int owner = col0 + 2 * (k0 + e);
      int lo = (x8.v[e] & 0xF) + (b8.v[e] & 0xF);
      int hi = (x8.v[e] >> 4) + (b8.v[e] >> 4);
      lo = lo < 15 ? lo : 15;
      hi = hi < 15 ? hi : 15;
      if (owner == row) lo = 0;
      if (owner + 1 == row) hi = 0;
      x8.v[e] = static_cast<uint8_t>(lo | (hi << 4));
    }
  }
  return x8;
}

template <bool DIAG>
__device__ __forceinline__ Vec8<uint8_t> ld8_packed_row(const uint8_t* w_row,
                                                        int row, int k0,
                                                        const uint8_t* bump,
                                                        int col0 = 0) {
  return refresh_packed_row<DIAG>(ld8(w_row + k0), row, k0, bump, col0);
}

// add_deficits on sixteen packed owners: row i (residuals x) pulling from
// p (y) where row i is valid, and p pulling from i where row p is.
__device__ __forceinline__ void add_deficits_packed(const Vec8<uint8_t>& x8,
                                                    const Vec8<uint8_t>& y8,
                                                    bool vi, bool vp,
                                                    long long& ti,
                                                    long long& tp) {
  int32_t si = 0, sp = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
#pragma unroll
    for (int h = 0; h < 8; h += 4) {
      const int32_t x = (x8.v[e] >> h) & 0xF, y = (y8.v[e] >> h) & 0xF;
      if (vi && x > y) si += x - y;
      if (vp && y > x) sp += y - x;
    }
  }
  ti += si;
  tp += sp;
}

// The 1-byte rows' totals (int8, and the packed u4r rung), 16 bytes a
// row a step: 16 int8 owners or 32 packed ones in four 32-bit words,
// summed with SIMD byte instructions instead of one owner at a time. A
// direction's deficit sum is (A + D) / 2 with A = sum |y - x| and D = sum
// (y - x) over the columns (|d| + d = 2 max(d, 0)), and the other
// direction's (A - D) / 2; each row's valid is uniform over its row, so
// the masks apply to the sums. int8: A by __vabsdiffs4 and __dp4a, D by
// signed __dp4a. Packed: each word splits into its low and high nibble
// lanes (a byte each), A by __vsadu4, D by __dp4a of the lanes' byte
// sums. All exact in int32 per thread (a step adds at most 16 * 255).
constexpr uint32_t kNibbles = 0x0F0F0F0Fu;  // the low nibble of every byte
constexpr uint32_t kByteOnes = 0x01010101u;

struct Step {
  uint32_t v[4];
};

// One step of a row of 1-byte elements from byte `b0` (a multiple of
// 16): one 16-byte load where the row is 16-byte aligned, else two 8-byte
// loads; `half` loads only the first 8 bytes (a row's last step when its
// length is 8 mod 16) and zeroes the rest.
__device__ __forceinline__ Step ld_step(const uint8_t* row, int b0, bool aligned, bool half) {
  Step s;
  if (aligned && !half) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + b0);
    s.v[0] = v.x;
    s.v[1] = v.y;
    s.v[2] = v.z;
    s.v[3] = v.w;
    return s;
  }
  const uint2 lo = *reinterpret_cast<const uint2*>(row + b0);
  const uint2 hi = half ? make_uint2(0u, 0u) : *reinterpret_cast<const uint2*>(row + b0 + 8);
  s.v[0] = lo.x;
  s.v[1] = lo.y;
  s.v[2] = hi.x;
  s.v[3] = hi.y;
  return s;
}

// min(a + b, 15) in every byte of two words of nibble lanes (bytes 0..15):
// a byte's sum is at most 30, so bit 4 marks the ones to clamp.
__device__ __forceinline__ uint32_t sat_nibbles(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return (s | (((s >> 4) & kByteOnes) * 15u)) & kNibbles;
}

// A step's int8 words of row `row` with the owner diagonal refreshed
// (DIAG): where the row's own global owner falls in the step's 16 owners,
// its byte reads mv as int8 (refresh_row's value). The word is picked
// with constant indices.
template <bool DIAG>
__device__ __forceinline__ void refresh_int8_step(Step& x, int row, int b0, const int32_t* mv,
                                                  int col0) {
  const int t = row - col0 - b0;  // the owner's column in the step
  if (DIAG && t >= 0 && t < 16) {
    const uint32_t v = static_cast<uint8_t>(static_cast<int8_t>(mv[row - col0]));
    const int sh = 8 * (t & 3);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q == (t >> 2)) x.v[q] = (x.v[q] & ~(0xFFu << sh)) | (v << sh);
    }
  }
}

// A step's packed words of row `row` split into nibble lanes (lo: owners
// 2k, hi: owners 2k + 1 of byte k), refreshed with DIAG as
// refresh_packed_row does (every residual plus its owner's bump,
// saturating at 15; then the row's own owner zeroed where it falls in the
// step's 32 owners), from the step's bump lanes (blo, bhi).
template <bool DIAG>
__device__ __forceinline__ void packed_step_lanes(const Step& x, const Step& blo,
                                                  const Step& bhi, int row, int b0, int col0,
                                                  Step& lo, Step& hi) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    lo.v[q] = x.v[q] & kNibbles;
    hi.v[q] = (x.v[q] >> 4) & kNibbles;
    if (DIAG) {
      lo.v[q] = sat_nibbles(lo.v[q], blo.v[q]);
      hi.v[q] = sat_nibbles(hi.v[q], bhi.v[q]);
    }
  }
  const int t = row - col0 - 2 * b0;  // the owner's nibble in the step
  if (DIAG && t >= 0 && t < 32) {
    const uint32_t keep = ~(0xFFu << (8 * ((t & 7) >> 1)));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q == (t >> 3)) {
        if (t & 1) {
          hi.v[q] &= keep;
        } else {
          lo.v[q] &= keep;
        }
      }
    }
  }
}

// Adds one step of rows i (x) and p (y) to the sums: `a` = sum |y - x|
// and `d` = sum (y - x) for int8, sum (x - y) of the residuals packed (the
// direction in which row i gains either way).
template <bool DIAG, bool PACKED>
__device__ __forceinline__ void narrow_step(Step x, Step y, const Step& blo, const Step& bhi,
                                            int i, int p, int b0, const void* mv, int col0,
                                            uint32_t& a, int32_t& d) {
  if constexpr (PACKED) {
    Step xl, xh, yl, yh;
    packed_step_lanes<DIAG>(x, blo, bhi, i, b0, col0, xl, xh);
    packed_step_lanes<DIAG>(y, blo, bhi, p, b0, col0, yl, yh);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a += __vsadu4(xl.v[q], yl.v[q]) + __vsadu4(xh.v[q], yh.v[q]);
      d = __dp4a(static_cast<int>(xl.v[q] + xh.v[q]), static_cast<int>(kByteOnes), d);
      d = __dp4a(static_cast<int>(yl.v[q] + yh.v[q]), -1, d);
    }
  } else {
    const int32_t* mv32 = static_cast<const int32_t*>(mv);
    refresh_int8_step<DIAG>(x, i, b0, mv32, col0);
    refresh_int8_step<DIAG>(y, p, b0, mv32, col0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a = __dp4a(__vabsdiffs4(x.v[q], y.v[q]), kByteOnes, a);
      d = __dp4a(static_cast<int>(y.v[q]), static_cast<int>(kByteOnes), d);
      d = __dp4a(static_cast<int>(x.v[q]), -1, d);
    }
  }
}

// The packed write bumps of a step, split into nibble lanes as
// packed_step_lanes takes them (zero lanes without BUMPS).
template <bool BUMPS>
__device__ __forceinline__ void bump_lanes(const uint8_t* bump, int b0, bool aligned, bool half,
                                           Step& blo, Step& bhi) {
  Step b = {{0u, 0u, 0u, 0u}};
  if (BUMPS) b = ld_step(bump, b0, aligned, half);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    blo.v[q] = b.v[q] & kNibbles;
    bhi.v[q] = (b.v[q] >> 4) & kNibbles;
  }
}

// The 1-byte rows' pair sums: each thread takes steps threadIdx.x +
// s * blockDim.x, two at a time, so that both rows' loads of two steps
// (and, packed with DIAG, the bump row's) are in flight before either is
// summed; the last odd step alone. Row bytes a multiple of 8: a row whose
// length is 8 mod 16 ends on a half step (and is not 16-byte aligned).
template <bool DIAG, bool PACKED>
__device__ __forceinline__ void narrow_pair_sums(const uint8_t* wi, const uint8_t* wp, int i,
                                                 int p, const void* mv, int row_bytes,
                                                 int col0, long long& ti, long long& tp,
                                                 bool vi, bool vp) {
  const bool aligned = (row_bytes & 15) == 0;
  const int steps = (row_bytes + 15) >> 4;
  const int last_half = aligned ? -1 : steps - 1;
  const uint8_t* bump = static_cast<const uint8_t*>(mv);
  constexpr bool bumps = PACKED && DIAG;
  uint32_t a = 0;
  int32_t d = 0;
  int k = threadIdx.x;
  for (; k + static_cast<int>(blockDim.x) < steps; k += 2 * blockDim.x) {
    const int k2 = k + blockDim.x;
    const Step xa = ld_step(wi, k << 4, aligned, k == last_half);
    const Step ya = ld_step(wp, k << 4, aligned, k == last_half);
    const Step xb = ld_step(wi, k2 << 4, aligned, k2 == last_half);
    const Step yb = ld_step(wp, k2 << 4, aligned, k2 == last_half);
    Step la, ha, lb, hb;
    bump_lanes<bumps>(bump, k << 4, aligned, k == last_half, la, ha);
    bump_lanes<bumps>(bump, k2 << 4, aligned, k2 == last_half, lb, hb);
    narrow_step<DIAG, PACKED>(xa, ya, la, ha, i, p, k << 4, mv, col0, a, d);
    narrow_step<DIAG, PACKED>(xb, yb, lb, hb, i, p, k2 << 4, mv, col0, a, d);
  }
  if (k < steps) {
    Step l, h;
    bump_lanes<bumps>(bump, k << 4, aligned, k == last_half, l, h);
    narrow_step<DIAG, PACKED>(ld_step(wi, k << 4, aligned, k == last_half),
                              ld_step(wp, k << 4, aligned, k == last_half), l, h, i, p,
                              k << 4, mv, col0, a, d);
  }
  // d sums the direction in which row i gains: y - x (int8), x - y
  // (packed residuals).
  const long long plus = (static_cast<long long>(a) + d) >> 1;
  const long long minus = (static_cast<long long>(a) - d) >> 1;
  if (vi) ti += plus;
  if (vp) tp += minus;
}

// The body of both totals passes (pairs_totals.cu, m8_totals.cu), run by
// the CTA of row i over an (n_rows, n_cols) block of w whose column 0 is
// global owner col0: where i leads its pair (i <= p[i]), stream rows i
// and p once, sum each direction's deficits exactly in int64 (masked by
// its own row's valid) and write totals[i] and totals[p] as float32,
// rounded once. A pair with no valid row, or a self-matched row, writes
// zeros without reading w. The branch depends on i alone, so the whole
// block takes it and the reductions' barriers stay uniform. PACKED: w is
// the u4r rung (WT uint8, n_cols bytes a row, two owners a byte from
// global owner col0) and `mv` the block's packed write-bump row; else
// `mv` is the block's owners' int32 max_version. Rows of 1-byte elements
// (int8, packed) take narrow_pair_sums (16 bytes a row a step, SIMD
// bytes); int16 and int32 rows stream 8 elements a step.
template <typename WT, bool DIAG, bool PACKED = false>
__device__ __forceinline__ void pair_totals(const WT* w, const int32_t* gm,
                                            const int32_t* c,
                                            const uint8_t* valid,
                                            const void* mv, float* totals,
                                            int i, int n_cols, int col0) {
  const int p = partner_row(gm, c, i);
  if (p < i) return;  // row p leads this pair
  const bool vi = valid[i] != 0;
  const bool vp = valid[p] != 0;
  long long ti = 0, tp = 0;
  if ((vi || vp) && p != i) {
    const size_t n = static_cast<size_t>(n_cols);
    const WT* wi = w + static_cast<size_t>(i) * n;
    const WT* wp = w + static_cast<size_t>(p) * n;
    if constexpr (sizeof(WT) == 1) {
      narrow_pair_sums<DIAG, PACKED>(reinterpret_cast<const uint8_t*>(wi),
                                     reinterpret_cast<const uint8_t*>(wp), i, p, mv, n_cols,
                                     col0, ti, tp, vi, vp);
    } else {
      const int32_t* mv32 = static_cast<const int32_t*>(mv);
      for (int k = threadIdx.x; k < (n_cols >> 3); k += blockDim.x) {
        const int j0 = k << 3;
        add_deficits(ld8_row<WT, DIAG>(wi, i, j0, mv32, col0),
                     ld8_row<WT, DIAG>(wp, p, j0, mv32, col0), vi, vp, ti, tp);
      }
    }
    ti = block_sum(ti);
    tp = block_sum(tp);
  }
  if (threadIdx.x == 0) {
    totals[i] = static_cast<float>(ti);
    if (p != i) totals[p] = static_cast<float>(tp);
  }
}

// How far a receiver advances on a deficit d of one owner: the
// proportional share d * scale rounded down, plus one where the hashed
// dither u falls below the fraction, never past d (the reference's
// _advance; -fmad=false keeps the product and difference unfused).
__device__ __forceinline__ int32_t advance(int32_t d, float scale, float u) {
  const float x = __fmul_rn(static_cast<float>(d), scale);
  const float fl = floorf(x);
  const int32_t bump = u < __fsub_rn(x, fl) ? 1 : 0;
  const int32_t a = static_cast<int32_t>(fl) + bump;
  return a < d ? a : d;
}

// The share of every deficit a row may take: min(1, budget / max(total,
// 1)) with the correctly rounded divide.
__device__ __forceinline__ float budget_scale(float budget, float total) {
  return fminf(1.0f, __fdiv_rn(budget, fmaxf(total, 1.0f)));
}
