// What the pair-fused kernels (pairs_pull.cu, pairs_totals.cu) share: the
// matched partner of a row, the diagonal-refreshed row load and the
// deficit sums. Both passes of the two-pass form read w through these,
// so the totals pass sees the refreshed diagonal exactly as the pull
// does.
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

// Eight elements of row `row` from column j0 (a multiple of 8); with DIAG
// the owner diagonal w[row, row] reads as mv[row] (the round's first
// sub-exchange refreshes it). The element is picked with constant
// indices: a computed index into x8 would put it in local memory.
template <typename WT, bool DIAG>
__device__ __forceinline__ Vec8<WT> ld8_row(const WT* w_row, int row, int j0,
                                            const int32_t* mv) {
  Vec8<WT> x8 = ld8(w_row + j0);
  if (DIAG && row >= j0 && row < j0 + 8) {
    const WT v = static_cast<WT>(mv[row]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (j0 + e == row) x8.v[e] = v;
    }
  }
  return x8;
}

// Adds eight columns' deficits of both directions: row i (x) pulling from
// p (y) when its pair is valid (vi), and p pulling from i (vp).
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
