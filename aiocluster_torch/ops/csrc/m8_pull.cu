// Single-pass gossip sub-exchange on Hopper, out of place.
//
// Replaces: aiocluster_tpu/ops/pallas_pull.py::_m8_kernel (the TPU kernel
// behind fused_pull_m8) in every mode: the w+hb pull and the lean w-only
// pull, the owner-diagonal refresh (DIAG, the round's first
// sub-exchange), the rows' deficit totals given as an input (TOTALS, the
// sharded two-pass form, with m8_totals.cu as pass A) and a column block
// of the owners (col0, the reference's owner_offset), on int8, int16 and
// int32 matrices (the reference's m8 kernel carries no packed u4r codec,
// so the packed rung never reaches it). Also the arithmetic
// variants of benchmarks/records/_i16_kernel_experiment.py::
// _kernel_variant (ARITH): the same function with the deficit and the
// heartbeat absorb in int16 (two per 32-bit word, Hopper's packed SIMD
// instructions, no widening), and in the last variant the advance fed
// from int16 in float32 with no int32 stage.
//
// What bounds it: bytes. The function must read w (and hb) once and
// write w' (and hb') once; this design reads each row twice, as itself
// and as its partner's peer, so it moves 3 bytes per 2 the pair-fused
// pull moves. About 26 integer/float operations per element against >= 4
// bytes moved, far below the card's operations-per-byte ratio.
//
// Design: one CTA per row i. Row i of the outputs comes from rows i and
// p[i] of the inputs, and the inputs are never written, so the CTAs need
// no ordering (running in place would race: CTA p[i] writes the row CTA
// i reads as its peer). On a GPU any row gather is legal, so the TPU's
// 8-row groups and in-VMEM rotation reduce to the row involution p =
// 8 * gm[g] + (r - c[g]) mod 8 (pairs.cuh), and the draws, and so the
// trajectory, are the reference's. Without TOTALS the CTA stages both
// rows of w (diagonal refreshed) in shared memory, 2 * n_cols *
// sizeof(w) bytes, while it sums row i's deficits exactly in int64 (one
// block reduction, converted to f32 once: exact while a row total stays
// below 2^24); then it streams the staged rows and hb 8 elements per
// thread with 16-byte accesses. With TOTALS there is no staging and no
// dynamic shared memory: both rows stream from global memory and any
// width that is a multiple of 8 runs. The dither hashes (row, global
// owner col0 + j), so a column block reproduces the whole width's bits.
//
// Bit parity with the reference and the plain PyTorch version: built with
// -fmad=false, the correctly rounded divide and the shared advance
// (pairs.cuh), and hash.cuh's integer hash.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hash.cuh"
#include "pairs.cuh"

namespace {

constexpr int kThreads = 256;

// ARITH: how the deficit, the advance and the absorb are computed.
enum : int {
  kI32 = 0,     // widened to int32 (the reference kernel)
  kI16 = 1,     // int16 deficit and absorb, int32 advance (variant b)
  kI16F32 = 2,  // int16 deficit and absorb, float32 advance (variant c)
};

struct M8Args {
  const void* w;          // (n_rows, n_cols) WT, read only
  const void* hb;         // (n_rows, n_cols) HT, read only; null when lean
  void* w_out;            // (n_rows, n_cols) WT, written
  void* hb_out;           // (n_rows, n_cols) HT, written; null when lean
  const int32_t* gm;      // (n_rows/8,) partner group of each group
  const int32_t* c;       // (n_rows/8,) within-pair row rotation
  const uint8_t* valid;   // (n_rows,) alive-pair mask per row
  int32_t n_cols;
  int32_t col0;           // global owner of column 0
  uint32_t salt_mix;      // sub-exchange salt ^ run salt
  float budget;
  const float* totals;    // TOTALS: (n_rows,) rows' global deficit totals
  const int32_t* mv;      // DIAG: (n_cols,) owner max_version
  const int32_t* hbv;     // DIAG: (n_cols,) owner heartbeat
};

// max(y - x, 0) for the eight int16 columns of x8/y8, two per 32-bit
// word (element 2q in the low half of word q). Stored values are >= 0, so
// y - x cannot wrap.
__device__ __forceinline__ void deficits_i16(const Vec8<int16_t>& x8,
                                             const Vec8<int16_t>& y8,
                                             uint32_t (&d)[4]) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(x8.v);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(y8.v);
#pragma unroll
  for (int q = 0; q < 4; ++q) d[q] = __vmaxs2(__vsub2(y[q], x[q]), 0u);
}

__device__ __forceinline__ int16_t half_of(uint32_t word, int e) {
  return static_cast<int16_t>((e & 1) ? (word >> 16) : (word & 0xffffu));
}

template <typename WT, typename HT, bool HB, bool DIAG, bool TOTALS, int ARITH>
__global__ void __launch_bounds__(kThreads) m8_kernel(M8Args a) {
  static_assert(ARITH == kI32 || (sizeof(WT) == 2 && sizeof(HT) == 2),
                "the int16 variants take int16 matrices");
  const int i = blockIdx.x;
  const int p = partner_row(a.gm, a.c, i);
  const bool v = a.valid[i] != 0;
  const size_t n = static_cast<size_t>(a.n_cols);
  const int chunks = a.n_cols >> 3;
  const WT* wi = static_cast<const WT*>(a.w) + static_cast<size_t>(i) * n;
  const WT* wp = static_cast<const WT*>(a.w) + static_cast<size_t>(p) * n;
  WT* wo = static_cast<WT*>(a.w_out) + static_cast<size_t>(i) * n;

  extern __shared__ __align__(16) unsigned char smem[];
  WT* si = reinterpret_cast<WT*>(smem);
  WT* sp = si + n;

  // Row i's deficit total: given (TOTALS), or pass 1 stages both rows
  // (diagonal refreshed) and sums them.
  float total;
  if constexpr (TOTALS) {
    total = a.totals[i];
  } else {
    long long t = 0;
    for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
      const int j0 = k << 3;
      const Vec8<WT> x8 = ld8_row<WT, DIAG>(wi, i, j0, a.mv, a.col0);
      const Vec8<WT> y8 = ld8_row<WT, DIAG>(wp, p, j0, a.mv, a.col0);
      st8(si + j0, x8);
      st8(sp + j0, y8);
      if (!v) continue;
      if constexpr (ARITH == kI32) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int32_t x = x8.v[e], y = y8.v[e];
          if (y > x) t += y - x;
        }
      } else {
        uint32_t d[4];
        deficits_i16(x8, y8, d);
#pragma unroll
        for (int e = 0; e < 8; ++e) t += half_of(d[e >> 1], e);
      }
    }
    t = block_sum(t);  // its barriers also publish the staged rows
    total = static_cast<float>(t);
  }
  const float scale = budget_scale(a.budget, total);

  // Pass 2: row i's advance toward p, its heartbeat absorb.
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    const int j0 = k << 3;
    const Vec8<WT> x8 =
        TOTALS ? ld8_row<WT, DIAG>(wi, i, j0, a.mv, a.col0) : ld8(si + j0);
    const Vec8<WT> y8 =
        TOTALS ? ld8_row<WT, DIAG>(wp, p, j0, a.mv, a.col0) : ld8(sp + j0);
    Vec8<WT> nx8;
    if constexpr (ARITH == kI32) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t j = static_cast<uint32_t>(a.col0 + j0 + e);
        const int32_t x = x8.v[e], y = y8.v[e];
        const int32_t d = (v && y > x) ? y - x : 0;
        nx8.v[e] = static_cast<WT>(
            x + advance(d, scale, dither24(hash_mix_u32(i, j, a.salt_mix))));
      }
    } else {
      uint32_t d[4] = {0u, 0u, 0u, 0u};
      if (v) deficits_i16(x8, y8, d);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t j = static_cast<uint32_t>(a.col0 + j0 + e);
        const float u = dither24(hash_mix_u32(i, j, a.salt_mix));
        const int16_t d16 = half_of(d[e >> 1], e);
        if constexpr (ARITH == kI16) {
          nx8.v[e] = static_cast<WT>(x8.v[e] + advance(d16, scale, u));
        } else {
          // Every quantity is an integer below 2^15: exact in float32.
          const float df = static_cast<float>(d16);
          const float xs = __fmul_rn(df, scale);
          const float fl = floorf(xs);
          const float adv = fminf(
              __fadd_rn(fl, u < __fsub_rn(xs, fl) ? 1.0f : 0.0f), df);
          nx8.v[e] = static_cast<WT>(
              __fadd_rn(static_cast<float>(x8.v[e]), adv));
        }
      }
    }
    st8(wo + j0, nx8);
    if constexpr (HB) {
      const HT* hbm = static_cast<const HT*>(a.hb);
      const Vec8<HT> h8 = ld8_row<HT, DIAG>(
          hbm + static_cast<size_t>(i) * n, i, j0, a.hbv, a.col0);
      const Vec8<HT> hp8 = ld8_row<HT, DIAG>(
          hbm + static_cast<size_t>(p) * n, p, j0, a.hbv, a.col0);
      Vec8<HT> out;
      if constexpr (ARITH == kI32) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int32_t h = h8.v[e];
          const int32_t from_p = v ? static_cast<int32_t>(hp8.v[e]) : 0;
          out.v[e] = static_cast<HT>(h > from_p ? h : from_p);
        }
      } else {
        const uint32_t* h = reinterpret_cast<const uint32_t*>(h8.v);
        const uint32_t* hp = reinterpret_cast<const uint32_t*>(hp8.v);
        uint32_t* o = reinterpret_cast<uint32_t*>(out.v);
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q] = __vmaxs2(h[q], v ? hp[q] : 0u);
      }
      st8(static_cast<HT*>(a.hb_out) + static_cast<size_t>(i) * n + j0, out);
    }
  }
}

template <typename WT, typename HT, bool HB, bool DIAG, bool TOTALS, int ARITH>
cudaError_t launch(const M8Args& a, int n_rows, cudaStream_t stream) {
  auto kernel = m8_kernel<WT, HT, HB, DIAG, TOTALS, ARITH>;
  const size_t smem =
      TOTALS ? 0 : 2 * static_cast<size_t>(a.n_cols) * sizeof(WT);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_rows, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename WT, typename HT, bool HB>
cudaError_t launch_modes(const M8Args& a, int n_rows, cudaStream_t s) {
  const bool diag = a.mv != nullptr;
  if (a.totals != nullptr) {
    return diag ? launch<WT, HT, HB, true, true, kI32>(a, n_rows, s)
                : launch<WT, HT, HB, false, true, kI32>(a, n_rows, s);
  }
  return diag ? launch<WT, HT, HB, true, false, kI32>(a, n_rows, s)
              : launch<WT, HT, HB, false, false, kI32>(a, n_rows, s);
}

template <typename WT>
cudaError_t launch_hb(const M8Args& a, int n_rows, int h_code,
                      cudaStream_t s) {
  if (a.hb == nullptr) return launch_modes<WT, WT, false>(a, n_rows, s);
  switch (h_code) {
    case kInt8:
      return launch_modes<WT, int8_t, true>(a, n_rows, s);
    case kInt16:
      return launch_modes<WT, int16_t, true>(a, n_rows, s);
    default:
      return launch_modes<WT, int32_t, true>(a, n_rows, s);
  }
}

}  // namespace

// arith: 0 int32 (every mode), 1 / 2 the int16 variants (int16 w and hb,
// no diagonal refresh, no totals), else cudaErrorInvalidValue.
extern "C" int aiocluster_m8_pull(const void* w, const void* hb, void* w_out,
                                  void* hb_out, const void* gm, const void* c,
                                  const void* valid, int n_rows, int n_cols,
                                  int col0, unsigned int salt_mix,
                                  float budget, const void* totals,
                                  const void* mv, const void* hbv, int w_code,
                                  int h_code, int arith, void* stream) {
  M8Args a;
  a.w = w;
  a.hb = hb;
  a.w_out = w_out;
  a.hb_out = hb_out;
  a.gm = static_cast<const int32_t*>(gm);
  a.c = static_cast<const int32_t*>(c);
  a.valid = static_cast<const uint8_t*>(valid);
  a.n_cols = n_cols;
  a.col0 = col0;
  a.salt_mix = salt_mix;
  a.budget = budget;
  a.totals = static_cast<const float*>(totals);
  a.mv = static_cast<const int32_t*>(mv);
  a.hbv = static_cast<const int32_t*>(hbv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (arith != kI32) {
    const bool experiment_mode = w_code == kInt16 && h_code == kInt16 &&
                                 hb != nullptr && totals == nullptr &&
                                 mv == nullptr;
    if (experiment_mode && arith == kI16) {
      return launch<int16_t, int16_t, true, false, false, kI16>(a, n_rows, s);
    }
    if (experiment_mode && arith == kI16F32) {
      return launch<int16_t, int16_t, true, false, false, kI16F32>(a, n_rows,
                                                                   s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (w_code) {
    case kInt8:
      return launch_hb<int8_t>(a, n_rows, h_code, s);
    case kInt16:
      return launch_hb<int16_t>(a, n_rows, h_code, s);
    default:
      return launch_hb<int32_t>(a, n_rows, h_code, s);
  }
}

// Static shared memory of the staged kernel (block_sum's partials), which
// m8_pull.STATIC_SMEM states for the wrapper's width check. Returns a
// cudaError_t.
extern "C" int aiocluster_m8_pull_static_smem(int* bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, m8_kernel<int16_t, int16_t, true, true, false, kI32>);
  *bytes = static_cast<int>(attr.sharedSizeBytes);
  return err;
}

extern "C" const char* aiocluster_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
