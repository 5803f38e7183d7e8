// The phi-accrual failure-detector update of one (observer, owner) pair:
// THE single source of the arithmetic shared by the pair-fused pull's FD
// epilogue (pairs_pull.cu) and the standalone FD pass (fd.cu), as the
// reference's ops/pallas_pull.py::fd_update is for its two TPU kernels.
//
// Same f32 operations in the same order as the reference's XLA block
// (ops/gossip.py sim_step, failure-detection phase), each rounded once:
// the explicit _rn intrinsics (and the -fmad=false build) keep the
// compiler from contracting a multiply and an add into one FMA, and the
// divide is the correctly rounded one. Loads widen exactly; the caller
// rounds once when it stores.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct FdConsts {
  float max_interval;  // SimConfig.max_interval_ticks as f32
  int32_t window;      // SimConfig.window_ticks
  float prior_weight;  // SimConfig.prior_weight as f32
  float prior_wm;      // f32(prior_weight * prior_mean_ticks), folded in f64
  float phi;           // SimConfig.phi_threshold as f32
};

struct FdResult {
  int32_t last_change;
  float imean;
  int32_t icount;
  bool live;  // before the self diagonal and the death wipe
};

__device__ __forceinline__ FdResult fd_update(int32_t tick, int32_t hb, int32_t hb0, int32_t lc,
                           float imean, int32_t icount, const FdConsts& k) {
  const bool increased = hb > hb0;
  const bool never_seen = lc == 0;
  const float interval = static_cast<float>(tick - lc);
  const bool sampled = increased && !never_seen && interval <= k.max_interval;
  int32_t count = icount + (sampled ? 1 : 0);
  count = count < k.window ? count : k.window;
  const float count_f = static_cast<float>(count);
  const float denom = count_f > 1.0f ? count_f : 1.0f;
  const float mean =
      sampled ? __fadd_rn(imean, __fdiv_rn(__fsub_rn(interval, imean), denom))
              : imean;
  const int32_t lc2 = increased ? tick : lc;
  const float elapsed = static_cast<float>(tick - lc2);
  // live <=> elapsed / prior-weighted mean <= phi, cross-multiplied.
  const bool live =
      count >= 1 &&
      __fmul_rn(elapsed, __fadd_rn(count_f, k.prior_weight)) <=
          __fmul_rn(k.phi, __fadd_rn(__fmul_rn(mean, count_f), k.prior_wm));
  FdResult r;
  r.last_change = lc2;
  r.imean = mean;
  r.icount = count;
  r.live = live;
  return r;
}
