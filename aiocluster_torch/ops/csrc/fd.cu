// Standalone streaming phi-accrual failure-detector pass on Hopper.
//
// Replaces: aiocluster_tpu/ops/pallas_fd.py::_fd_kernel (fused_fd), the FD
// phase whenever it does not ride the pair-fused pull: in this port, a
// round whose pull runs as plain PyTorch ops (use_pallas=False) with
// use_pallas_fd=True, the reference's own A/B seam, and the m8 forms. It
// takes int8, int16 and int32 heartbeat matrices with int16 sample
// counters and a bool live view; the shrunk bookkeeping (int8 counters,
// the live bitmap) rides only the pair-fused epilogue, as in the
// reference. The matrices may be a column block of the owners (the
// reference's owner_offset, fused_fd(owner_offset=)): (n, n_cols) with
// column j global owner col0 + j, hbv the block's (n_cols,) slice; the
// self diagonal (live forced true, hb0 refreshed from hbv) lies where
// col0 + j == row. col0 is one runtime value, not a template mode.
//
// What bounds it: bytes. Per (observer, owner) pair it reads hb, hb0,
// last_change, imean and icount once and writes last_change, imean,
// icount and live once (17 bytes in the int16/bf16 profile) for ~25
// integer/float operations: far below the H100's operations-per-byte
// ratio, so it is a memory-rate kernel.
//
// Design: one elementwise pass, in place on last_change/imean/icount
// (each element is read once before it is written, by the same thread),
// writing live. Blocks stride over rows and threads over 8-column chunks,
// so every load and store is one 16-byte transaction for the 2-byte
// types (two for 4-byte types, eight bytes for live) and no index is
// divided. hb0's owner diagonal is refreshed on the fly from hbv, as the
// TPU kernel does. The arithmetic is fd_update.cuh, shared with the
// pair-fused pull's epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "fd_update.cuh"

namespace {

constexpr int kThreads = 256;

struct FdArgs {
  const void* hb;   // (n, n_cols) HT post-exchange heartbeat knowledge
  const void* hb0;  // (n, n_cols) HT round-start heartbeat knowledge
  const int32_t* hbv;  // (n_cols,) owner heartbeats (hb0's diagonal)
  void* lc;         // (n, n_cols) HT last_change, in place
  void* im;         // (n, n_cols) IMT interval mean, in place
  int16_t* ic;      // (n, n_cols) sample count, in place
  uint8_t* live;    // (n, n_cols) bool live view, written
  int32_t n;        // rows (all observers)
  int32_t n_cols;   // the block's owners
  int32_t col0;     // global owner of column 0
  int32_t tick;
  FdConsts fd;
};

template <typename HT, typename IMT>
__global__ void __launch_bounds__(kThreads) fd_kernel(FdArgs a) {
  const int n = a.n;
  const int chunks = a.n_cols >> 3;
  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * a.n_cols;
    for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
      const int j0 = k << 3;
      const size_t off = base + j0;
      const Vec8<HT> hb8 = ld8(static_cast<const HT*>(a.hb) + off);
      const Vec8<HT> h08 = ld8(static_cast<const HT*>(a.hb0) + off);
      HT* lcm = static_cast<HT*>(a.lc) + off;
      IMT* imm = static_cast<IMT*>(a.im) + off;
      Vec8<HT> lc8 = ld8(lcm);
      Vec8<IMT> im8 = ld8(imm);
      Vec8<int16_t> ic8 = ld8(a.ic + off);
      Vec8<uint8_t> lv8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = j0 + e;
        const bool self = a.col0 + j == row;  // the global self diagonal
        const int32_t h0 = self ? a.hbv[j] : static_cast<int32_t>(h08.v[e]);
        const FdResult r = fd_update(
            a.tick, static_cast<int32_t>(hb8.v[e]), h0,
            static_cast<int32_t>(lc8.v[e]), to_f32(im8.v[e]),
            static_cast<int32_t>(ic8.v[e]), a.fd);
        const bool live = r.live || self;
        lc8.v[e] = static_cast<HT>(r.last_change);
        im8.v[e] = from_f32<IMT>(live ? r.imean : 0.0f);
        ic8.v[e] = static_cast<int16_t>(live ? r.icount : 0);
        lv8.v[e] = live ? 1 : 0;
      }
      st8(lcm, lc8);
      st8(imm, im8);
      st8(a.ic + off, ic8);
      st8(a.live + off, lv8);
    }
  }
}

template <typename HT, typename IMT>
cudaError_t launch(const FdArgs& a, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int blocks = a.n < 8 * sms ? a.n : 8 * sms;
  fd_kernel<HT, IMT><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The matrices hold `n_cols` owners from global owner `col0` (n and 0: the
// whole width).
extern "C" int aiocluster_fd(const void* hb, const void* hb0, const void* hbv,
                             void* lc, void* im, void* ic, void* live, int n,
                             int n_cols, int col0, int tick, float max_interval, int window,
                             float prior_weight, float prior_wm, float phi,
                             int h_code, int im_code, void* stream) {
  FdArgs a;
  a.hb = hb;
  a.hb0 = hb0;
  a.hbv = static_cast<const int32_t*>(hbv);
  a.lc = lc;
  a.im = im;
  a.ic = static_cast<int16_t*>(ic);
  a.live = static_cast<uint8_t*>(live);
  a.n = n;
  a.n_cols = n_cols;
  a.col0 = col0;
  a.tick = tick;
  a.fd.max_interval = max_interval;
  a.fd.window = window;
  a.fd.prior_weight = prior_weight;
  a.fd.prior_wm = prior_wm;
  a.fd.phi = phi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h_code) {
    case kInt8:
      return im_code == kBf16 ? launch<int8_t, __nv_bfloat16>(a, s)
                              : launch<int8_t, float>(a, s);
    case kInt16:
      return im_code == kBf16 ? launch<int16_t, __nv_bfloat16>(a, s)
                              : launch<int16_t, float>(a, s);
    default:
      return im_code == kBf16 ? launch<int32_t, __nv_bfloat16>(a, s)
                              : launch<int32_t, float>(a, s);
  }
}

extern "C" const char* aiocluster_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
