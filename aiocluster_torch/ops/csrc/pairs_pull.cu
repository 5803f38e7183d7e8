// Pair-fused gossip sub-exchange on Hopper.
//
// Replaces: aiocluster_tpu/ops/pallas_pull.py::_pairs_kernel (the TPU
// kernel behind fused_pull_pairs / pairs_pull), in the modes the
// simulator's main path runs: the w+hb pull, the owner-diagonal refresh
// (DIAG, first sub-exchange), the all-converged check (CHECK, last), the
// fused phi-accrual FD epilogue (FD, last; with the round-start hb0
// streamed when fanout > 1) and the totals input (TOTALS: the rows'
// deficit totals come from pairs_totals.cu, the two-pass form for rows
// too wide to stage). The packed u4r, int8-icount, live-bitmap and lane
// modes are not ported.
//
// What bounds it: bytes. Each sub-exchange must read and write every row
// of w and hb once (4 bytes per pair per int16 matrix); the FD epilogue
// adds last_change/imean/icount in and out, hb0 in and live out. There
// are ~40 integer/float operations per element against >= 8 bytes moved,
// far below the H100's ratio of 3.35 TB/s to its integer/f32 rate.
//
// Design: the matching is an involution p (p[p[i]] == i), so one CTA per
// LEADER row i (i <= p[i]) owns both rows i and p[i]: no other CTA reads
// or writes them, which makes the update in place safe. On a GPU any row
// gather is legal, so the TPU's 8-row grouping and in-VMEM rotation
// reduce to the row involution p = 8 * gm[g] + (r - c[g]) mod 8; the
// draws (gm, c), and so the trajectory, are the reference's. The CTA
// stages both rows of w in shared memory (2 * N * sizeof(w) bytes: 40 KB
// at N = 10,240 int16), takes both rows' deficit totals in one exact
// integer block reduction (converted to f32 once: exact while a row's
// total stays below 2^24, which the headline config's 16 * N keeps),
// then streams hb (and the FD matrices) 8 elements per thread with
// 16-byte loads and writes every row once. A self-matched row (p == i)
// still gets the refresh, the check and the FD epilogue; its exchange is
// a no-op (d = 0, hb = max(hb, hb)).
//
// TOTALS mode: the staging takes 2 * N * sizeof(w) bytes of shared
// memory, which caps the staged form at N = 57,984 for int16. With the
// totals given, the kernel skips the staging and the totals pass, takes
// both scales from the totals and streams both rows of w from global
// memory in the apply pass (diagonal refreshed on load, pairs.cuh), with
// no dynamic shared memory: any width that is a multiple of 8 runs. Each
// thread reads and writes only its own 8-column chunks of the CTA's two
// rows, so the update stays in place without a barrier.
//
// Bit parity with the reference and the plain PyTorch version: built with
// -fmad=false, the scale and the running mean use the correctly rounded
// divide, bf16 stores round to nearest even (common.cuh), and the dither
// is hash.cuh's integer hash of global indices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "fd_update.cuh"
#include "hash.cuh"
#include "pairs.cuh"

namespace {

constexpr int kThreads = 256;

struct PairsArgs {
  void* w;                  // (n, n) WT, updated in place
  void* hb;                 // (n, n) HT, in place; null in the lean profile
  const int32_t* gm;        // (n/8,) partner group of each group
  const int32_t* c;         // (n/8,) within-pair row rotation
  const uint8_t* valid;     // (n,) alive-pair mask per row
  int32_t n;
  uint32_t salt_mix;        // sub-exchange salt ^ run salt
  float budget;
  const float* totals;      // TOTALS: (n,) rows' deficit totals
  const int32_t* mv;        // DIAG: (n,) owner max_version
  const int32_t* hbv;       // DIAG / FD: (n,) owner heartbeat
  const int32_t* need;      // CHECK: (n,) target, 0 for dead owners
  const uint8_t* alive;     // CHECK: (n,) row liveness
  int32_t* flag;            // CHECK: starts at 1, cleared by a failing row
  int32_t tick;             // FD: the round's tick
  void* lc;                 // FD: (n, n) HT last_change, in place
  void* im;                 // FD: (n, n) IMT interval mean, in place
  int16_t* ic;              // FD: (n, n) sample count, in place
  uint8_t* live;            // FD: (n, n) bool live view, written
  const void* hb0;          // FD: (n, n) HT round-start hb, or null
  FdConsts fd;
};

// The FD phase for eight (row, j0 + e) pairs: hb_new is the post-exchange
// knowledge, hb_old the refreshed pre-exchange tile (the round-start
// matrix at fanout == 1).
template <typename HT, typename IMT>
__device__ __forceinline__ void fd_chunk(const PairsArgs& a, int row, int j0,
                                         const int32_t (&hb_new)[8],
                                         const int32_t (&hb_old)[8]) {
  const size_t off = static_cast<size_t>(row) * a.n + j0;
  HT* lcm = static_cast<HT*>(a.lc) + off;
  IMT* imm = static_cast<IMT*>(a.im) + off;
  int16_t* icm = a.ic + off;
  Vec8<HT> lc8 = ld8(lcm);
  Vec8<IMT> im8 = ld8(imm);
  Vec8<int16_t> ic8 = ld8(icm);
  Vec8<HT> h08;
  if (a.hb0 != nullptr) h08 = ld8(static_cast<const HT*>(a.hb0) + off);
  Vec8<uint8_t> lv8;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int j = j0 + e;
    int32_t h0 = hb_old[e];
    if (a.hb0 != nullptr) {
      h0 = (j == row) ? a.hbv[j] : static_cast<int32_t>(h08.v[e]);
    }
    const FdResult r =
        fd_update(a.tick, hb_new[e], h0, static_cast<int32_t>(lc8.v[e]),
                  to_f32(im8.v[e]), static_cast<int32_t>(ic8.v[e]), a.fd);
    const bool live = r.live || j == row;
    lc8.v[e] = static_cast<HT>(r.last_change);
    im8.v[e] = from_f32<IMT>(live ? r.imean : 0.0f);
    ic8.v[e] = static_cast<int16_t>(live ? r.icount : 0);
    lv8.v[e] = live ? 1 : 0;
  }
  st8(lcm, lc8);
  st8(imm, im8);
  st8(icm, ic8);
  st8(a.live + off, lv8);
}

template <typename WT, typename HT, typename IMT, bool DIAG, bool CHECK,
          bool FD, bool TOTALS>
__global__ void __launch_bounds__(kThreads) pairs_kernel(PairsArgs a) {
  const int n = a.n;
  const int i = blockIdx.x;
  const int p = partner_row(a.gm, a.c, i);
  if (p < i) return;  // row p leads this pair
  const bool self = p == i;
  const bool vi = a.valid[i] != 0;
  const bool vp = a.valid[p] != 0;

  extern __shared__ __align__(16) unsigned char smem[];
  WT* si = reinterpret_cast<WT*>(smem);
  WT* sp = si + n;
  WT* wi = static_cast<WT*>(a.w) + static_cast<size_t>(i) * n;
  WT* wp = static_cast<WT*>(a.w) + static_cast<size_t>(p) * n;
  const int chunks = n >> 3;

  // Both directions' deficit totals: given (TOTALS), or pass 1 stages
  // both rows (diagonal refreshed) and sums them.
  float tot_i, tot_p;
  if constexpr (TOTALS) {
    tot_i = a.totals[i];
    tot_p = a.totals[p];
  } else {
    long long ti = 0, tp = 0;
    for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
      const int j0 = k << 3;
      const Vec8<WT> x8 = ld8_row<WT, DIAG>(wi, i, j0, a.mv);
      const Vec8<WT> y8 = ld8_row<WT, DIAG>(wp, p, j0, a.mv);
      st8(si + j0, x8);
      st8(sp + j0, y8);
      add_deficits(x8, y8, vi, vp, ti, tp);
    }
    ti = block_sum(ti);  // its barriers also publish the staged rows
    tp = block_sum(tp);
    tot_i = static_cast<float>(ti);
    tot_p = static_cast<float>(tp);
  }
  const float scale_i = budget_scale(a.budget, tot_i);
  const float scale_p = budget_scale(a.budget, tot_p);

  // Pass 2: apply both directions' advances, absorb heartbeats, and run
  // the check and the FD epilogue on the fresh values.
  HT* hbm = static_cast<HT*>(a.hb);
  bool ok_i = true, ok_p = true;
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    const int j0 = k << 3;
    const Vec8<WT> x8 =
        TOTALS ? ld8_row<WT, DIAG>(wi, i, j0, a.mv) : ld8(si + j0);
    const Vec8<WT> y8 =
        TOTALS ? ld8_row<WT, DIAG>(wp, p, j0, a.mv) : ld8(sp + j0);
    Vec8<WT> nx8, ny8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = j0 + e;
      const int32_t x = x8.v[e], y = y8.v[e];
      const int32_t di = (vi && y > x) ? y - x : 0;
      const int32_t dp = (vp && x > y) ? x - y : 0;
      const int32_t nx =
          x + advance(di, scale_i, dither24(hash_mix_u32(i, j, a.salt_mix)));
      const int32_t ny =
          y + advance(dp, scale_p, dither24(hash_mix_u32(p, j, a.salt_mix)));
      nx8.v[e] = static_cast<WT>(nx);
      ny8.v[e] = static_cast<WT>(ny);
      if (CHECK) {
        ok_i = ok_i && nx >= a.need[j];
        ok_p = ok_p && ny >= a.need[j];
      }
    }
    st8(wi + j0, nx8);
    if (!self) st8(wp + j0, ny8);
    if (hbm != nullptr) {
      HT* hi_row = hbm + static_cast<size_t>(i) * n + j0;
      HT* hp_row = hbm + static_cast<size_t>(p) * n + j0;
      const Vec8<HT> hi8 = ld8(hi_row);
      const Vec8<HT> hp8 = ld8(hp_row);
      int32_t hi[8], hp[8], nhi[8], nhp[8];
      Vec8<HT> out_i, out_p;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = j0 + e;
        hi[e] = hi8.v[e];
        hp[e] = hp8.v[e];
        if (DIAG) {
          if (j == i) hi[e] = a.hbv[j];
          if (j == p) hp[e] = a.hbv[j];
        }
        const int32_t from_p = vi ? hp[e] : 0;
        const int32_t from_i = vp ? hi[e] : 0;
        nhi[e] = hi[e] > from_p ? hi[e] : from_p;
        nhp[e] = hp[e] > from_i ? hp[e] : from_i;
        out_i.v[e] = static_cast<HT>(nhi[e]);
        out_p.v[e] = static_cast<HT>(nhp[e]);
      }
      st8(hi_row, out_i);
      if (!self) st8(hp_row, out_p);
      if (FD) {
        fd_chunk<HT, IMT>(a, i, j0, nhi, hi);
        if (!self) fd_chunk<HT, IMT>(a, p, j0, nhp, hp);
      }
    }
  }
  if (CHECK) {
    const bool row_ok =
        (ok_i || a.alive[i] == 0) && (self || ok_p || a.alive[p] == 0);
    if (!__syncthreads_and(row_ok) && threadIdx.x == 0) *a.flag = 0;
  }
}

template <typename WT, typename HT, typename IMT, bool DIAG, bool CHECK,
          bool FD, bool TOTALS>
cudaError_t launch_one(const PairsArgs& a, cudaStream_t stream) {
  auto kernel = pairs_kernel<WT, HT, IMT, DIAG, CHECK, FD, TOTALS>;
  const size_t smem = TOTALS ? 0 : 2 * static_cast<size_t>(a.n) * sizeof(WT);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.n, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename WT, typename HT, typename IMT, bool DIAG, bool CHECK,
          bool FD>
cudaError_t launch(const PairsArgs& a, cudaStream_t stream) {
  return a.totals != nullptr
             ? launch_one<WT, HT, IMT, DIAG, CHECK, FD, true>(a, stream)
             : launch_one<WT, HT, IMT, DIAG, CHECK, FD, false>(a, stream);
}

template <typename WT, typename HT, typename IMT>
cudaError_t launch_modes(const PairsArgs& a, bool diag, bool check, bool fd,
                         cudaStream_t s) {
  if (fd) {
    if (diag) {
      return check ? launch<WT, HT, IMT, true, true, true>(a, s)
                   : launch<WT, HT, IMT, true, false, true>(a, s);
    }
    return check ? launch<WT, HT, IMT, false, true, true>(a, s)
                 : launch<WT, HT, IMT, false, false, true>(a, s);
  }
  if (diag) {
    return check ? launch<WT, HT, float, true, true, false>(a, s)
                 : launch<WT, HT, float, true, false, false>(a, s);
  }
  return check ? launch<WT, HT, float, false, true, false>(a, s)
               : launch<WT, HT, float, false, false, false>(a, s);
}

template <typename WT, typename HT>
cudaError_t launch_im(const PairsArgs& a, int im_code, bool diag, bool check,
                      bool fd, cudaStream_t s) {
  if (im_code == kBf16) {
    return launch_modes<WT, HT, __nv_bfloat16>(a, diag, check, fd, s);
  }
  return launch_modes<WT, HT, float>(a, diag, check, fd, s);
}

}  // namespace

extern "C" int aiocluster_pairs_pull(
    void* w, void* hb, const void* gm, const void* c, const void* valid,
    int n, unsigned int salt_mix, float budget, const void* totals,
    const void* mv, const void* hbv, const void* need, const void* alive,
    void* flag, int tick, void* lc, void* im, void* ic, void* live,
    const void* hb0, float max_interval, int window, float prior_weight,
    float prior_wm, float phi, int w_code, int h_code, int im_code,
    void* stream) {
  PairsArgs a;
  a.w = w;
  a.hb = hb;
  a.gm = static_cast<const int32_t*>(gm);
  a.c = static_cast<const int32_t*>(c);
  a.valid = static_cast<const uint8_t*>(valid);
  a.n = n;
  a.salt_mix = salt_mix;
  a.budget = budget;
  a.totals = static_cast<const float*>(totals);
  a.mv = static_cast<const int32_t*>(mv);
  a.hbv = static_cast<const int32_t*>(hbv);
  a.need = static_cast<const int32_t*>(need);
  a.alive = static_cast<const uint8_t*>(alive);
  a.flag = static_cast<int32_t*>(flag);
  a.tick = tick;
  a.lc = lc;
  a.im = im;
  a.ic = static_cast<int16_t*>(ic);
  a.live = static_cast<uint8_t*>(live);
  a.hb0 = hb0;
  a.fd.max_interval = max_interval;
  a.fd.window = window;
  a.fd.prior_weight = prior_weight;
  a.fd.prior_wm = prior_wm;
  a.fd.phi = phi;
  const bool diag = mv != nullptr;
  const bool check = need != nullptr;
  const bool fd = lc != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_code == kInt16) {
    return h_code == kInt16
               ? launch_im<int16_t, int16_t>(a, im_code, diag, check, fd, s)
               : launch_im<int16_t, int32_t>(a, im_code, diag, check, fd, s);
  }
  return h_code == kInt16
             ? launch_im<int32_t, int16_t>(a, im_code, diag, check, fd, s)
             : launch_im<int32_t, int32_t>(a, im_code, diag, check, fd, s);
}

// Static shared memory of the staged kernel (every staged instantiation
// has the same: block_sum's partials), which pairs_pull.STATIC_SMEM states
// for the wrapper's width check. Returns a cudaError_t.
extern "C" int aiocluster_pairs_pull_static_smem(int* bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr,
      pairs_kernel<int16_t, int16_t, __nv_bfloat16, true, true, true, false>);
  *bytes = static_cast<int>(attr.sharedSizeBytes);
  return err;
}

extern "C" const char* aiocluster_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
