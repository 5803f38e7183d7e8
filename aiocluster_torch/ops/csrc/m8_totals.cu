// Deficit row totals of one single-pass sub-exchange on Hopper: pass A of
// the sharded two-pass m8 form, which m8_pull.cu's TOTALS mode applies.
//
// Replaces: aiocluster_tpu/ops/pallas_pull.py::_m8_totals_kernel (the TPU
// kernel behind fused_pull_totals_m8) for int8, int16 and int32 watermarks
// (the reference's takes any itemsize and no packed codec), over
// the whole width or a column block of the owners (col0, the reference's
// owner_offset).
//
// What bounds it: bytes. The function must read w once and write one
// float per row, with about three integer operations per element. The
// reference's kernel reads each row twice, as itself and as its
// partner's peer; this one reads it once.
//
// Design: as pairs_totals.cu (the same pair body, pairs.cuh's
// pair_totals), one CTA per LEADER row i (i <= p[i]) of the matching's
// row involution p, so each matched pair is visited once and each row of
// the block read once. The CTA streams rows i and p[i] in 8-element
// vector loads with the owner diagonal refreshed on load exactly as the
// pull sees it (at global owner col0 + j), sums both directions'
// deficits exactly in int64 (one block reduction each), each masked by
// its own row's valid, and writes totals[i] and totals[p[i]] as float32,
// rounded once: equal to the reference's float32 tile sums while a row
// total stays below 2^24. A block's totals summed over the blocks are the
// whole width's (integers below 2^24 add exactly in float32). A pair with
// no valid row writes both zeros without reading; a self-matched row
// writes 0 once. Non-leader CTAs exit at once. No shared memory but the
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
  const uint8_t* valid;   // (n_rows,) per-row mask
  const int32_t* mv;      // (n_cols,) owner max_version, or null
  float* totals;          // (n_rows,) written
  int32_t n_cols;
  int32_t col0;           // global owner of column 0
};

template <typename WT, bool DIAG>
__global__ void __launch_bounds__(kThreads) m8_totals_kernel(M8TotalsArgs a) {
  pair_totals<WT, DIAG>(static_cast<const WT*>(a.w), a.gm, a.c, a.valid, a.mv,
                        a.totals, blockIdx.x, a.n_cols, a.col0);
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
  switch (w_code) {
    case kInt8:
      return launch<int8_t>(a, n_rows, s);
    case kInt16:
      return launch<int16_t>(a, n_rows, s);
    default:
      return launch<int32_t>(a, n_rows, s);
  }
}

extern "C" const char* aiocluster_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
