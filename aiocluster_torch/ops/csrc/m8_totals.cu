// Deficit row totals of one single-pass sub-exchange on Hopper: pass A of
// the sharded two-pass m8 form, which m8_pull.cu's TOTALS mode applies.
//
// Replaces: aiocluster_tpu/ops/pallas_pull.py::_m8_totals_kernel (the TPU
// kernel behind fused_pull_totals_m8) for int16 and int32 watermarks, over
// the whole width or a column block of the owners (col0, the reference's
// owner_offset).
//
// What bounds it: bytes. The function must read w once and write one
// float per row; this design reads each row twice, as itself and as its
// partner's peer (pairs_totals.cu visits each pair once instead). About
// three integer operations per element.
//
// Design: as m8_pull.cu, one CTA per row i of the matching's row
// involution p. The CTA streams rows i and p[i] in 8-element vector loads
// with the owner diagonal refreshed on load exactly as the pull sees it
// (pairs.cuh, at global owner col0 + j), sums row i's deficits exactly in
// int64 (one block reduction) and writes totals[i] as float32, rounded
// once: equal to the reference's float32 tile sums while a row total
// stays below 2^24. A block's totals summed over the blocks are the whole
// width's (integers below 2^24 add exactly in float32). A row whose pair
// is not alive writes 0 without reading. No shared memory but the
// reduction's, so any width that is a multiple of 8 runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "pairs.cuh"

namespace {

constexpr int kThreads = 256;

struct M8TotalsArgs {
  const void* w;          // (n_rows, n_cols) WT
  const int32_t* gm;      // (n_rows/8,) partner group of each group
  const int32_t* c;       // (n_rows/8,) within-pair row rotation
  const uint8_t* valid;   // (n_rows,) alive-pair mask per row
  const int32_t* mv;      // (n_cols,) owner max_version, or null
  float* totals;          // (n_rows,) written
  int32_t n_cols;
  int32_t col0;           // global owner of column 0
};

template <typename WT, bool DIAG>
__global__ void __launch_bounds__(kThreads) m8_totals_kernel(M8TotalsArgs a) {
  const int i = blockIdx.x;
  if (a.valid[i] == 0) {
    if (threadIdx.x == 0) a.totals[i] = 0.0f;
    return;
  }
  const int p = partner_row(a.gm, a.c, i);
  const size_t n = static_cast<size_t>(a.n_cols);
  const WT* wi = static_cast<const WT*>(a.w) + static_cast<size_t>(i) * n;
  const WT* wp = static_cast<const WT*>(a.w) + static_cast<size_t>(p) * n;
  long long t = 0;
  for (int k = threadIdx.x; k < (a.n_cols >> 3); k += blockDim.x) {
    const int j0 = k << 3;
    const Vec8<WT> x8 = ld8_row<WT, DIAG>(wi, i, j0, a.mv, a.col0);
    const Vec8<WT> y8 = ld8_row<WT, DIAG>(wp, p, j0, a.mv, a.col0);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int32_t x = x8.v[e], y = y8.v[e];
      if (y > x) t += y - x;
    }
  }
  t = block_sum(t);
  if (threadIdx.x == 0) a.totals[i] = static_cast<float>(t);
}

template <typename WT>
cudaError_t launch(const M8TotalsArgs& a, int n_rows, cudaStream_t stream) {
  if (a.mv != nullptr) {
    m8_totals_kernel<WT, true><<<n_rows, kThreads, 0, stream>>>(a);
  } else {
    m8_totals_kernel<WT, false><<<n_rows, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int aiocluster_m8_totals(const void* w, const void* gm,
                                    const void* c, const void* valid,
                                    const void* mv, void* totals, int n_rows,
                                    int n_cols, int col0, int w_code,
                                    void* stream) {
  M8TotalsArgs a;
  a.w = w;
  a.gm = static_cast<const int32_t*>(gm);
  a.c = static_cast<const int32_t*>(c);
  a.valid = static_cast<const uint8_t*>(valid);
  a.mv = static_cast<const int32_t*>(mv);
  a.totals = static_cast<float*>(totals);
  a.n_cols = n_cols;
  a.col0 = col0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_code == kInt16 ? launch<int16_t>(a, n_rows, s)
                          : launch<int32_t>(a, n_rows, s);
}

extern "C" const char* aiocluster_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
