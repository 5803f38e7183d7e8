// Single-pass gossip sub-exchange on Hopper, out of place.
//
// Replaces: aiocluster_tpu/ops/pallas_pull.py::_m8_kernel (the TPU kernel
// behind fused_pull_m8) in every mode: the w+hb pull and the lean w-only
// pull, the owner-diagonal refresh (DIAG, the round's first
// sub-exchange), the rows' deficit totals given as an input (TOTALS, the
// two-pass form, with m8_totals.cu as pass A) and a column block of the
// owners (col0, the reference's owner_offset), on int8, int16 and int32
// matrices (the reference's m8 kernel carries no packed u4r codec, so the
// packed rung never reaches it). Also the arithmetic variants of
// benchmarks/records/_i16_kernel_experiment.py::_kernel_variant (ARITH):
// the same function with the deficits of both directions and the
// heartbeat absorb in int16 (two per 32-bit word, Hopper's packed SIMD
// instructions, no widening), and in the last variant the advance fed
// from int16 in float32 with no int32 stage.
//
// What bounds it: bytes on int16 and int32 rows. The function must read
// w (and hb) once and write w' (and hb') once; this design does exactly
// that. On int8 rows the per-element instructions (deficit, hash, dither,
// advance) bound it instead, as they bound the pairs pull there.
//
// Design: the m8 function is the pair-fused pull (pairs_pull.cu) computed
// out of place, so it runs in the same frame (pair_frame.cuh): one group
// of CTAs per LEADER row i (i <= p[i]) of the matching's row involution p
// reads rows i and p[i] once each and writes both output rows, w_out[i],
// w_out[p], hb_out[i] and hb_out[p]. The outputs are never the inputs,
// so no ordering between CTAs is needed. Three forms, by the one rule
// (gossip.kernel_pull_form, pairs_pull.pull_form's): staged by one CTA
// ("m8"), staged across a thread-block cluster of k in {2, 4, 8} CTAs with
// the slices' exact int64 totals added through distributed shared memory
// ("m8_cluster"), or fed the rows' totals and streaming both rows from
// global memory ("m8_two_pass": the column blocks and the rows too wide
// or too narrow-typed to stage). The body takes one hashed advance per
// column pair, to whichever row is behind (the receiver's valid masks the
// deficit; the advance of a zero deficit is 0 for every dither), and
// absorbs heartbeats both ways. Every output row is written: a
// self-matched row (p == i) gets its refreshed row (its exchange is a
// no-op), a pair with no valid row both refreshed rows, and the diagonal
// refresh of w and hb lands in the copy; the input hb (the FD phase's
// round-start matrix) stays untouched. The dither hashes (receiving row,
// global owner col0 + j), so a column block reproduces the whole width's
// bits. On a GPU any row gather is legal, so the TPU's 8-row groups and
// in-VMEM rotation reduce to p = 8 * gm[g] + (r - c[g]) mod 8 (pairs.cuh),
// and the draws, and so the trajectory, are the reference's.
//
// Bit parity with the reference and the plain PyTorch version: built with
// -fmad=false, the correctly rounded divide and the shared advance
// (pairs.cuh), exact int64 row totals rounded to f32 once, and hash.cuh's
// integer hash.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hash.cuh"
#include "pair_frame.cuh"
#include "pairs.cuh"

namespace {

using namespace pair_frame;

// ARITH: how the deficit, the advance and the absorb are computed.
enum : int {
  kI32 = 0,     // widened to int32 (the reference kernel)
  kI16 = 1,     // int16 deficit and absorb, int32 advance (variant b)
  kI16F32 = 2,  // int16 deficit and absorb, float32 advance (variant c)
};

struct M8Args {
  const void* w;          // (n, n_cols) WT, read only
  const void* hb;         // (n, n_cols) HT, read only; null when lean
  void* w_out;            // (n, n_cols) WT, written
  void* hb_out;           // (n, n_cols) HT, written; null when lean
  const int32_t* gm;      // (n/8,) partner group of each group
  const int32_t* c;       // (n/8,) within-pair row rotation
  const uint8_t* valid;   // (n,) alive-pair mask per row
  int32_t n;              // rows (all owners)
  int32_t n_cols;         // the block's owners (n: the whole width)
  int32_t col0;           // global owner of column 0
  uint32_t salt_mix;      // sub-exchange salt ^ run salt
  float budget;
  const float* totals;    // TOTALS: (n,) rows' global deficit totals
  const int32_t* mv;      // DIAG: (n_cols,) owner max_version
  const int32_t* hbv;     // DIAG: (n_cols,) owner heartbeat
  int32_t cluster;        // CTAs staging a pair (gridDim.x = n * cluster); 1 with TOTALS
};

// Both directions' deficits of eight int16 columns, two per 32-bit word
// (element 2q in the low half of word q): din = max(y - x, 0) masked by
// row i's valid, dout = max(x - y, 0) by row p's. Stored values are >= 0,
// so neither difference wraps.
__device__ __forceinline__ void deficits_i16(const Vec8<int16_t>& x8, const Vec8<int16_t>& y8,
                                             bool vi, bool vp, uint32_t (&din)[4],
                                             uint32_t (&dout)[4]) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(x8.v);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(y8.v);
  const uint32_t mi = vi ? 0xffffffffu : 0u, mp = vp ? 0xffffffffu : 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    din[q] = __vmaxs2(__vsub2(y[q], x[q]), 0u) & mi;
    dout[q] = __vmaxs2(__vsub2(x[q], y[q]), 0u) & mp;
  }
}

__device__ __forceinline__ int32_t half_of(uint32_t word, int e) {
  return static_cast<int16_t>((e & 1) ? (word >> 16) : (word & 0xffffu));
}

// The row codec: the unpacked one, whose pass-1 sums take the int16
// deficits in the experiment's variants.
template <typename WT, int ARITH>
struct M8Rows : UnpackedRows<WT> {
  static __device__ __forceinline__ void sums(const Vec8<WT>& x8, const Vec8<WT>& y8, bool vi,
                                              bool vp, long long& ti, long long& tp) {
    if constexpr (ARITH == kI32) {
      add_deficits(x8, y8, vi, vp, ti, tp);
    } else {
      uint32_t din[4], dout[4];
      deficits_i16(x8, y8, vi, vp, din, dout);
      int32_t si = 0, sp = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        si += half_of(din[e >> 1], e);
        sp += half_of(dout[e >> 1], e);
      }
      ti += si;
      tp += sp;
    }
  }
};

// The element body: one advance per column pair (to whichever row is
// behind) into w_out, and the heartbeat absorb both ways into hb_out,
// both rows of the pair written (one where the row is self-matched).
template <typename WT, typename HT, bool HB, bool DIAG, int ARITH>
struct M8Body {
  static __device__ __forceinline__ void apply(const M8Args& a, const Pair& r, int j0,
                                               const Vec8<WT>& x8, const Vec8<WT>& y8, bool&,
                                               bool&) {
    const size_t n = static_cast<size_t>(a.n_cols);  // elements a row
    const int i = r.i, p = r.p;
    Vec8<WT> nx8, ny8;
    if constexpr (ARITH == kI32) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // The receiving row first: row i gains where y > x, row p where
        // x > y; the deficit is masked by the receiver's valid.
        const int32_t x = x8.v[e], y = y8.v[e];
        const bool in = y > x;
        const int32_t d = in ? (r.vi ? y - x : 0) : (r.vp ? x - y : 0);
        const uint32_t owner = a.col0 + j0 + e;  // the dither's global owner
        const int32_t adv = advance(d, in ? r.scale_i : r.scale_p,
                                    dither24(hash_mix_u32(in ? i : p, owner, a.salt_mix)));
        nx8.v[e] = static_cast<WT>(in ? x + adv : x);
        ny8.v[e] = static_cast<WT>(in ? y : y + adv);
      }
    } else {
      uint32_t din[4], dout[4];
      deficits_i16(x8, y8, r.vi, r.vp, din, dout);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // At most one direction's masked deficit is positive; a zero
        // deficit advances neither row, whichever receives it.
        const int32_t di = half_of(din[e >> 1], e), dp = half_of(dout[e >> 1], e);
        const bool in = di > 0;
        const int32_t d = in ? di : dp;
        const float scale = in ? r.scale_i : r.scale_p;
        const uint32_t owner = a.col0 + j0 + e;
        const float u = dither24(hash_mix_u32(in ? i : p, owner, a.salt_mix));
        const WT recv = in ? x8.v[e] : y8.v[e];
        WT moved;
        if constexpr (ARITH == kI16) {
          moved = static_cast<WT>(recv + advance(d, scale, u));
        } else {
          // Every quantity is an integer below 2^15: exact in float32.
          const float df = static_cast<float>(d);
          const float xs = __fmul_rn(df, scale);
          const float fl = floorf(xs);
          const float adv = fminf(__fadd_rn(fl, u < __fsub_rn(xs, fl) ? 1.0f : 0.0f), df);
          moved = static_cast<WT>(__fadd_rn(static_cast<float>(recv), adv));
        }
        nx8.v[e] = in ? moved : x8.v[e];
        ny8.v[e] = in ? y8.v[e] : moved;
      }
    }
    WT* wo = static_cast<WT*>(a.w_out);
    st8(wo + static_cast<size_t>(i) * n + j0, nx8);
    if (!r.self) st8(wo + static_cast<size_t>(p) * n + j0, ny8);
    if constexpr (HB) {
      // The pre-exchange tiles (diagonal refreshed, in the stored dtype,
      // as the plain version refreshes them) and the absorbed ones.
      const HT* hbm = static_cast<const HT*>(a.hb);
      const Vec8<HT> hi8 = ld8_row<HT, DIAG>(hbm + static_cast<size_t>(i) * n, i, j0, a.hbv,
                                             a.col0);
      const Vec8<HT> hp8 = ld8_row<HT, DIAG>(hbm + static_cast<size_t>(p) * n, p, j0, a.hbv,
                                             a.col0);
      Vec8<HT> ni8, np8;
      if constexpr (ARITH == kI32) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int32_t hi = hi8.v[e], hp = hp8.v[e];
          const int32_t from_p = r.vi ? hp : 0;
          const int32_t from_i = r.vp ? hi : 0;
          ni8.v[e] = static_cast<HT>(hi > from_p ? hi : from_p);
          np8.v[e] = static_cast<HT>(hp > from_i ? hp : from_i);
        }
      } else {
        const uint32_t* h = reinterpret_cast<const uint32_t*>(hi8.v);
        const uint32_t* hp = reinterpret_cast<const uint32_t*>(hp8.v);
        uint32_t* oi = reinterpret_cast<uint32_t*>(ni8.v);
        uint32_t* op = reinterpret_cast<uint32_t*>(np8.v);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          oi[q] = __vmaxs2(h[q], r.vi ? hp[q] : 0u);
          op[q] = __vmaxs2(hp[q], r.vp ? h[q] : 0u);
        }
      }
      HT* ho = static_cast<HT*>(a.hb_out);
      st8(ho + static_cast<size_t>(i) * n + j0, ni8);
      if (!r.self) st8(ho + static_cast<size_t>(p) * n + j0, np8);
    }
  }
};

template <typename WT, typename HT, bool HB, bool DIAG, bool TOTALS, int ARITH>
__global__ void __launch_bounds__(kThreads) m8_kernel(M8Args a) {
  static_assert(ARITH == kI32 || (sizeof(WT) == 2 && sizeof(HT) == 2),
                "the int16 variants take int16 matrices");
  using Rows = M8Rows<WT, ARITH>;
  using Body = M8Body<WT, HT, HB, DIAG, ARITH>;
  if constexpr (TOTALS) {
    totals_frame<Rows, Body, DIAG, false>(a, a.n_cols);
  } else {
    staged_frame<Rows, Body, DIAG, false>(a, a.n_cols);
  }
}

template <typename WT, typename HT, bool HB, bool DIAG, bool TOTALS, int ARITH>
cudaError_t launch(const M8Args& a, cudaStream_t stream) {
  const size_t smem = TOTALS ? 0 : staged_smem(a.n_cols, sizeof(WT), a.cluster);
  return launch_pairs(m8_kernel<WT, HT, HB, DIAG, TOTALS, ARITH>, a, a.n, a.cluster, 1, smem,
                      stream);
}

template <typename WT, typename HT, bool HB>
cudaError_t launch_modes(const M8Args& a, cudaStream_t s) {
  const bool diag = a.mv != nullptr;
  if (a.totals != nullptr) {
    return diag ? launch<WT, HT, HB, true, true, kI32>(a, s)
                : launch<WT, HT, HB, false, true, kI32>(a, s);
  }
  return diag ? launch<WT, HT, HB, true, false, kI32>(a, s)
              : launch<WT, HT, HB, false, false, kI32>(a, s);
}

template <typename WT>
cudaError_t launch_hb(const M8Args& a, int h_code, cudaStream_t s) {
  if (a.hb == nullptr) return launch_modes<WT, WT, false>(a, s);
  switch (h_code) {
    case kInt8:
      return launch_modes<WT, int8_t, true>(a, s);
    case kInt16:
      return launch_modes<WT, int16_t, true>(a, s);
    default:
      return launch_modes<WT, int32_t, true>(a, s);
  }
}

}  // namespace

// arith: 0 int32 (every mode), 1 / 2 the int16 variants (int16 w and hb,
// no diagonal refresh, no totals), else cudaErrorInvalidValue. `cluster`
// is the CTAs that stage a pair (1, 2, 4 or 8; 1 with `totals`).
extern "C" int aiocluster_m8_pull(const void* w, const void* hb, void* w_out, void* hb_out,
                                  const void* gm, const void* c, const void* valid,
                                  int n_rows, int n_cols, int col0, unsigned int salt_mix,
                                  float budget, const void* totals, const void* mv,
                                  const void* hbv, int w_code, int h_code, int arith,
                                  int cluster, void* stream) {
  if (!cluster_ok(cluster, totals != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  M8Args a;
  a.w = w;
  a.hb = hb;
  a.w_out = w_out;
  a.hb_out = hb_out;
  a.gm = static_cast<const int32_t*>(gm);
  a.c = static_cast<const int32_t*>(c);
  a.valid = static_cast<const uint8_t*>(valid);
  a.n = n_rows;
  a.n_cols = n_cols;
  a.col0 = col0;
  a.salt_mix = salt_mix;
  a.budget = budget;
  a.totals = static_cast<const float*>(totals);
  a.mv = static_cast<const int32_t*>(mv);
  a.hbv = static_cast<const int32_t*>(hbv);
  a.cluster = cluster;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (arith != kI32) {
    const bool experiment_mode = w_code == kInt16 && h_code == kInt16 && hb != nullptr &&
                                 totals == nullptr && mv == nullptr;
    if (experiment_mode && arith == kI16) {
      return launch<int16_t, int16_t, true, false, false, kI16>(a, s);
    }
    if (experiment_mode && arith == kI16F32) {
      return launch<int16_t, int16_t, true, false, false, kI16F32>(a, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (w_code) {
    case kInt8:
      return launch_hb<int8_t>(a, h_code, s);
    case kInt16:
      return launch_hb<int16_t>(a, h_code, s);
    default:
      return launch_hb<int32_t>(a, h_code, s);
  }
}

// Static shared memory of the staged kernel (block_sum's partials), which
// pairs_pull.STATIC_SMEM states for the wrapper's width check. Returns a
// cudaError_t.
extern "C" int aiocluster_m8_pull_static_smem(int* bytes) {
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, m8_kernel<int16_t, int16_t, true, true, false, kI32>);
  *bytes = static_cast<int>(attr.sharedSizeBytes);
  return err;
}

extern "C" const char* aiocluster_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
