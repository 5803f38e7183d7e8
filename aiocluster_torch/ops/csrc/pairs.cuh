// What the pull kernels (the pair-fused pairs_pull.cu and pairs_totals.cu,
// the single-pass m8_pull.cu and m8_totals.cu) share: the matched partner
// of a row, the diagonal-refreshed row load and the deficit sums (also of
// the packed u4r rung), the totals passes' pair body and the budgeted
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
// `mv` is the block's owners' int32 max_version.
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
    for (int k = threadIdx.x; k < (n_cols >> 3); k += blockDim.x) {
      const int j0 = k << 3;
      if constexpr (PACKED) {
        const uint8_t* bump = static_cast<const uint8_t*>(mv);
        add_deficits_packed(ld8_packed_row<DIAG>(wi, i, j0, bump, col0),
                            ld8_packed_row<DIAG>(wp, p, j0, bump, col0), vi,
                            vp, ti, tp);
      } else {
        const int32_t* mv32 = static_cast<const int32_t*>(mv);
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
