// Deficit row totals of one pair-fused sub-exchange on Hopper: pass A of
// the two-pass form, which the pull's TOTALS mode (pairs_pull.cu) applies.
//
// Replaces: aiocluster_tpu/ops/pallas_pull.py::_pairs_totals_kernel (the
// TPU kernel behind fused_pull_pairs_totals / pairs_totals) for int8,
// int16 and int32 watermarks and the packed u4r rung (PACKED, the
// reference's `packed` decode) over the full owner width (n_local == N),
// also over S sweep lanes in one launch (fused_pull_pairs_totals_lanes:
// blockIdx.y is the lane, every operand carries a leading lane axis and
// the CTA offsets its pointers to its lane's slice in size_t, as
// pairs_pull.cu does). Column shards (owner_offset) are not ported.
//
// What bounds it: bytes. It must read every row of w once (N^2 *
// sizeof(w), N^2 / 2 packed) and write N floats, with about three integer
// operations per element.
//
// Design: as in pairs_pull.cu, one CTA per LEADER row i (i <= p[i]) of
// the matching's row involution p, so each matched pair is visited once
// and each row read once (the reference's m8 totals pass reads each row
// twice). The CTA streams both rows in 8-element vector loads, with the
// owner diagonal refreshed on load exactly as the pull's pass sees it
// (pairs.cuh), sums both directions' deficits exactly in int64 (one
// block reduction each), and writes totals[i] and totals[p] as float32,
// rounded once: equal to the reference's float32 tile sums while a row
// total stays below 2^24 (the lean profile's is at most 16 * N =
// 1,605,632 at N = 100,352). A self-matched row (p == i) writes its
// total, 0, once. The pair body is pairs.cuh's pair_totals, which
// m8_totals.cu runs over column blocks. PACKED reads eight bytes (sixteen
// owners) a vector, and one row total spans both nibble halves; `mv` is
// then the packed write-bump row, exactly as the pull's pass sees it. No
// shared memory but the reduction's, so any width that is a multiple of 8
// (16 packed) runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "pairs.cuh"

namespace {

constexpr int kThreads = 256;

struct TotalsArgs {
  const void* w;         // (n, n) WT
  const int32_t* gm;     // (n/8,) partner group of each group
  const int32_t* c;      // (n/8,) within-pair row rotation
  const uint8_t* valid;  // (n,) alive-pair mask per row
  const void* mv;        // (n,) int32 owner max_version (PACKED: (n/2,)
                         // uint8 packed write bumps), or null (no refresh)
  float* totals;         // (n,) written
  int32_t n;             // owners (rows)
  int32_t lanes;         // sweep lanes (gridDim.y), 1 outside sweeps
};

template <typename WT, bool DIAG, bool PACKED>
__global__ void __launch_bounds__(kThreads) pairs_totals_kernel(TotalsArgs a) {
  const int n_cols = PACKED ? a.n >> 1 : a.n;
  const size_t s = blockIdx.y;
  const size_t vec = s * static_cast<size_t>(a.n);
  // The refresh row: PACKED bytes of write bumps, else int32 max_version.
  const void* mv = nullptr;
  if (a.mv != nullptr) {
    mv = PACKED ? static_cast<const void*>(static_cast<const uint8_t*>(a.mv) + (vec >> 1))
                : static_cast<const void*>(static_cast<const int32_t*>(a.mv) + vec);
  }
  pair_totals<WT, DIAG, PACKED>(
      static_cast<const WT*>(a.w) + vec * static_cast<size_t>(n_cols),
      a.gm + s * (a.n >> 3), a.c + s * (a.n >> 3), a.valid + vec, mv,
      a.totals + vec, blockIdx.x, n_cols, 0);
}

template <typename WT, bool PACKED = false>
cudaError_t launch(const TotalsArgs& a, cudaStream_t stream) {
  const dim3 grid(a.n, a.lanes);
  if (a.mv != nullptr) {
    pairs_totals_kernel<WT, true, PACKED><<<grid, kThreads, 0, stream>>>(a);
  } else {
    pairs_totals_kernel<WT, false, PACKED><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// `lanes` > 1 is the lane lift: every operand carries a leading lane axis.
extern "C" int aiocluster_pairs_totals(const void* w, const void* gm,
                                       const void* c, const void* valid,
                                       const void* mv, void* totals, int n,
                                       int w_code, int lanes, void* stream) {
  if (lanes < 1 || lanes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  TotalsArgs a;
  a.w = w;
  a.gm = static_cast<const int32_t*>(gm);
  a.c = static_cast<const int32_t*>(c);
  a.valid = static_cast<const uint8_t*>(valid);
  a.mv = mv;
  a.totals = static_cast<float*>(totals);
  a.n = n;
  a.lanes = lanes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_code) {
    case kU4:
      return launch<uint8_t, true>(a, s);
    case kInt8:
      return launch<int8_t>(a, s);
    case kInt16:
      return launch<int16_t>(a, s);
    default:
      return launch<int32_t>(a, s);
  }
}

extern "C" const char* aiocluster_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
