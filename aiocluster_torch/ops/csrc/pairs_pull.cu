// Pair-fused gossip sub-exchange on Hopper.
//
// Replaces: aiocluster_tpu/ops/pallas_pull.py::_pairs_kernel (the TPU
// kernel behind fused_pull_pairs / pairs_pull), in the modes the
// simulator's paths run: the w+hb pull and the lean w-only pull on int8,
// int16 and int32 matrices, the owner-diagonal refresh (DIAG, first
// sub-exchange), the all-converged check (CHECK, last), the fused
// phi-accrual FD epilogue (FD, last; with the round-start hb0 streamed
// when fanout > 1; int16 or int8 sample counters, a bool live view or the
// live bitmap), the totals input (TOTALS: the rows' deficit totals come
// from pairs_totals.cu, the two-pass form for rows too wide to stage) and
// the packed u4r rung (pairs_packed_kernel: the reference's nibble codec,
// lean profile only, as there), each also over S sweep lanes in one launch
// (LANES below: the reference's fused_pull_pairs_lanes). Column blocks
// (owner_offset) are not ported.
//
// What bounds it: on int16 and int32 rows, bytes: each sub-exchange must
// read and write every row of w and hb once (4 bytes per pair per int16
// matrix); the FD epilogue adds last_change/imean/icount in and out, hb0
// in and live out. On the narrow rungs (int8, packed u4r: 2 and 1 bytes
// per pair of w), the ~40 integer/float instructions a logical element
// (deficit, hash, dither, advance) bound it instead: the pull body runs
// at about the same rate per element on every rung.
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
// vector loads and writes every row once. A self-matched row (p == i)
// still gets the refresh, the check and the FD epilogue; its exchange is
// a no-op (d = 0, hb = max(hb, hb)).
//
// TOTALS mode: the staging takes 2 * N * sizeof(w) bytes of shared
// memory, which caps the staged form at N = 57,984 for int16 (116,096
// int8, 232,192 packed). With the totals given, the kernel skips the
// staging and the totals pass, takes both scales from the totals and
// streams both rows of w from global memory in the apply pass (diagonal
// refreshed on load, pairs.cuh), with no dynamic shared memory: any
// width that is a multiple of 8 (16 packed) runs. Each thread reads and
// writes only its own 8-column chunks of the CTA's two rows, so the
// update stays in place without a barrier.
//
// FD bookkeeping: the sample counters' dtype and the live view's form are
// runtime flags of the epilogue (a uniform branch per 8-column chunk), not
// template modes, so the shrunk rungs add no instances. A thread's 8
// columns are exactly one byte of the live bitmap (column j is bit j % 8
// of byte j / 8), so each thread writes whole bytes. Counters widen to
// int32 for the increment and the clamp to the window (<= 126 for int8),
// then narrow.
//
// PACKED (the u4r rung): a row is N / 2 bytes, byte k holding owners 2k
// (low nibble) and 2k + 1 (high nibble) as saturating residuals below the
// owner's max_version. A thread's 8-byte vector is sixteen owners; it
// widens each nibble, takes the deficit max(r_self - r_peer, 0), one row
// total over both halves, the advance with the dither of the nibble's
// own global owner, and repacks. `mv` is the owners' write bump as packed
// nibbles: the first sub-exchange raises every residual by it
// (saturating at 15), then zeroes the row's own owner; the check row
// holds one owner-alive bit per nibble (a zero residual is caught up).
// The packed kernel shares the unpacked one's frame (pair_frame: the
// leader row, the staging and totals, the check) and differs only in the
// row codec and the apply step.
//
// LANES (the lane lift of a sweep): the grid's second dimension is the
// lane, gridDim.y = S, and every operand carries a leading lane axis.
// At frame entry the CTA offsets each matrix pointer by lane * n * row_len
// elements and each vector by lane * its length (at_lane, in size_t: at
// the north star 2 * 100,352^2 passes 2^31), and reads its lane's
// salt_mix and phi from (S,) device arrays, which sweeps build once a
// chunk. A lane is a runtime value, not a template mode, so the lift adds
// no instance; S = 1 keeps its by-value scalars and needs no array. A lane
// whose valid mask is all 0 (a swept fanout below the static bound) still
// gets the refresh, the check and the FD epilogue, as in the reference.
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
  void* ic;                 // FD: (n, n) int16/int8 sample count, in place
  uint8_t* live;            // FD: (n, n) bool live view or (n, n/8) bitmap
  const void* hb0;          // FD: (n, n) HT round-start hb, or null
  bool ic_int8;             // FD: the sample counters are int8
  bool live_bits;           // FD: live is the bitmap
  const uint8_t* bump;      // PACKED + DIAG: (n/2,) packed write bumps
  const uint8_t* owner_ok;  // PACKED + CHECK: (n/2,) packed owner-alive bits
  FdConsts fd;
  int32_t lanes;            // LANES: sweep lanes (gridDim.y), 1 outside sweeps
  const uint32_t* lane_salt;  // LANES: (lanes,) salt_mix of each lane, or null
  const float* lane_phi;    // LANES + FD: (lanes,) phi of each lane, or null
};

template <typename T>
__device__ __forceinline__ T* shifted(T* p, size_t k) {
  return p == nullptr ? p : p + k;
}

// The operands of lane blockIdx.y: every pointer moved to the lane's slice
// (w of `row_len` stored elements a row; PACKED moves the packed bump and
// owner-alive rows instead of mv and need), the lane's salt and phi read
// from their arrays where given. Lane 0 is the operands as passed.
template <typename WT, typename HT, typename IMT, bool PACKED>
__device__ __forceinline__ PairsArgs at_lane(PairsArgs a, int row_len) {
  const size_t s = blockIdx.y;
  const size_t n = static_cast<size_t>(a.n);
  const size_t vec = s * n, mat = vec * n;
  a.w = static_cast<WT*>(a.w) + vec * static_cast<size_t>(row_len);
  a.gm += s * (n >> 3);
  a.c += s * (n >> 3);
  a.valid += vec;
  a.totals = shifted(a.totals, vec);
  a.alive = shifted(a.alive, vec);
  a.flag = shifted(a.flag, s);
  if (PACKED) {
    a.bump = shifted(a.bump, vec >> 1);
    a.owner_ok = shifted(a.owner_ok, vec >> 1);
  } else {
    a.hb = shifted(static_cast<HT*>(a.hb), mat);
    a.mv = shifted(a.mv, vec);
    a.hbv = shifted(a.hbv, vec);
    a.need = shifted(a.need, vec);
    if (a.lc != nullptr) {
      a.lc = static_cast<HT*>(a.lc) + mat;
      a.im = static_cast<IMT*>(a.im) + mat;
      a.ic = a.ic_int8 ? static_cast<void*>(static_cast<int8_t*>(a.ic) + mat)
                       : static_cast<void*>(static_cast<int16_t*>(a.ic) + mat);
      a.live += a.live_bits ? mat >> 3 : mat;
      a.hb0 = shifted(static_cast<const HT*>(a.hb0), mat);
    }
  }
  if (a.lane_salt != nullptr) a.salt_mix = a.lane_salt[s];
  if (a.lane_phi != nullptr) a.fd.phi = a.lane_phi[s];
  return a;
}

// The epilogue's sample counters of eight columns, widened to int32, and
// their narrowing store (int16, or int8 on the shrunk rungs).
__device__ __forceinline__ void load_counts(const PairsArgs& a, size_t off,
                                            int32_t (&ic)[8]) {
  if (a.ic_int8) {
    const Vec8<int8_t> v = ld8(static_cast<const int8_t*>(a.ic) + off);
#pragma unroll
    for (int e = 0; e < 8; ++e) ic[e] = v.v[e];
  } else {
    const Vec8<int16_t> v = ld8(static_cast<const int16_t*>(a.ic) + off);
#pragma unroll
    for (int e = 0; e < 8; ++e) ic[e] = v.v[e];
  }
}

__device__ __forceinline__ void store_counts(const PairsArgs& a, size_t off,
                                             const int32_t (&ic)[8]) {
  if (a.ic_int8) {
    Vec8<int8_t> v;
#pragma unroll
    for (int e = 0; e < 8; ++e) v.v[e] = static_cast<int8_t>(ic[e]);
    st8(static_cast<int8_t*>(a.ic) + off, v);
  } else {
    Vec8<int16_t> v;
#pragma unroll
    for (int e = 0; e < 8; ++e) v.v[e] = static_cast<int16_t>(ic[e]);
    st8(static_cast<int16_t*>(a.ic) + off, v);
  }
}

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
  Vec8<HT> lc8 = ld8(lcm);
  Vec8<IMT> im8 = ld8(imm);
  int32_t ic[8];
  load_counts(a, off, ic);
  Vec8<HT> h08;
  if (a.hb0 != nullptr) h08 = ld8(static_cast<const HT*>(a.hb0) + off);
  Vec8<uint8_t> lv8;
  uint32_t bits = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int j = j0 + e;
    int32_t h0 = hb_old[e];
    if (a.hb0 != nullptr) {
      h0 = (j == row) ? a.hbv[j] : static_cast<int32_t>(h08.v[e]);
    }
    const FdResult r =
        fd_update(a.tick, hb_new[e], h0, static_cast<int32_t>(lc8.v[e]),
                  to_f32(im8.v[e]), ic[e], a.fd);
    const bool live = r.live || j == row;
    lc8.v[e] = static_cast<HT>(r.last_change);
    im8.v[e] = from_f32<IMT>(live ? r.imean : 0.0f);
    ic[e] = live ? r.icount : 0;
    lv8.v[e] = live ? 1 : 0;
    bits |= (live ? 1u : 0u) << e;
  }
  st8(lcm, lc8);
  st8(imm, im8);
  store_counts(a, off, ic);
  if (a.live_bits) {
    a.live[off >> 3] = static_cast<uint8_t>(bits);  // byte j0 / 8 of the row
  } else {
    st8(a.live + off, lv8);
  }
}

// The stored form of a row of w: the unpacked rungs' WT elements (the
// diagonal refresh reads mv at the owner's column) or the packed u4r
// bytes (sixteen owners a vector; the refresh shifts by the write bumps).
template <typename WT>
struct UnpackedRows {
  using T = WT;
  template <bool DIAG>
  static __device__ __forceinline__ Vec8<T> load(const PairsArgs& a,
                                                 const T* row_ptr, int row,
                                                 int j0) {
    return ld8_row<WT, DIAG>(row_ptr, row, j0, a.mv);
  }
  static __device__ __forceinline__ void sums(const Vec8<T>& x8,
                                              const Vec8<T>& y8, bool vi,
                                              bool vp, long long& ti,
                                              long long& tp) {
    add_deficits(x8, y8, vi, vp, ti, tp);
  }
};

struct PackedRows {
  using T = uint8_t;
  template <bool DIAG>
  static __device__ __forceinline__ Vec8<T> load(const PairsArgs& a,
                                                 const T* row_ptr, int row,
                                                 int k0) {
    return ld8_packed_row<DIAG>(row_ptr, row, k0, a.bump);
  }
  static __device__ __forceinline__ void sums(const Vec8<T>& x8,
                                              const Vec8<T>& y8, bool vi,
                                              bool vp, long long& ti,
                                              long long& tp) {
    add_deficits_packed(x8, y8, vi, vp, ti, tp);
  }
};

// The pair a CTA owns, as its apply step sees it.
struct Pair {
  int i, p;
  bool self, vi, vp;
  float scale_i, scale_p;
};

// The frame both pull kernels share, over rows of `row_len` stored
// elements (Rows::T). One CTA per leader row i (i <= p[i]) owns rows i
// and p; other CTAs return. Both directions' deficit totals are given
// (TOTALS), or pass 1 stages both rows (diagonal refreshed) in shared
// memory and sums them. Pass 2 hands each thread's 8-element chunks of
// both rows, pre-exchange, to `apply(pair, j0, x8, y8, ok_i, ok_p)`,
// which writes them back (and what rides them) and, with CHECK, clears
// ok_i / ok_p where a row falls short. A row that fails the check
// clears the flag.
template <typename Rows, bool DIAG, bool CHECK, bool TOTALS, typename Apply>
__device__ __forceinline__ void pair_frame(const PairsArgs& a, int row_len,
                                           Apply apply) {
  using T = typename Rows::T;
  Pair r;
  r.i = blockIdx.x;
  r.p = partner_row(a.gm, a.c, r.i);
  if (r.p < r.i) return;  // row p leads this pair
  r.self = r.p == r.i;
  r.vi = a.valid[r.i] != 0;
  r.vp = a.valid[r.p] != 0;

  extern __shared__ __align__(16) unsigned char smem[];
  T* si = reinterpret_cast<T*>(smem);
  T* sp = si + row_len;
  const T* wi = static_cast<const T*>(a.w) + static_cast<size_t>(r.i) * row_len;
  const T* wp = static_cast<const T*>(a.w) + static_cast<size_t>(r.p) * row_len;
  const int chunks = row_len >> 3;

  float tot_i, tot_p;
  if constexpr (TOTALS) {
    tot_i = a.totals[r.i];
    tot_p = a.totals[r.p];
  } else {
    long long ti = 0, tp = 0;
    for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
      const int j0 = k << 3;
      const Vec8<T> x8 = Rows::template load<DIAG>(a, wi, r.i, j0);
      const Vec8<T> y8 = Rows::template load<DIAG>(a, wp, r.p, j0);
      st8(si + j0, x8);
      st8(sp + j0, y8);
      Rows::sums(x8, y8, r.vi, r.vp, ti, tp);
    }
    ti = block_sum(ti);  // its barriers also publish the staged rows
    tp = block_sum(tp);
    tot_i = static_cast<float>(ti);
    tot_p = static_cast<float>(tp);
  }
  r.scale_i = budget_scale(a.budget, tot_i);
  r.scale_p = budget_scale(a.budget, tot_p);

  bool ok_i = true, ok_p = true;
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    const int j0 = k << 3;
    const Vec8<T> x8 =
        TOTALS ? Rows::template load<DIAG>(a, wi, r.i, j0) : ld8(si + j0);
    const Vec8<T> y8 =
        TOTALS ? Rows::template load<DIAG>(a, wp, r.p, j0) : ld8(sp + j0);
    apply(r, j0, x8, y8, ok_i, ok_p);
  }
  if (CHECK) {
    const bool row_ok = (ok_i || a.alive[r.i] == 0) &&
                        (r.self || ok_p || a.alive[r.p] == 0);
    if (!__syncthreads_and(row_ok) && threadIdx.x == 0) *a.flag = 0;
  }
}

// The unpacked rungs: apply both directions' advances, absorb
// heartbeats, and run the check and the FD epilogue on the fresh values.
template <typename WT, typename HT, typename IMT, bool DIAG, bool CHECK,
          bool FD, bool TOTALS>
__global__ void __launch_bounds__(kThreads) pairs_kernel(PairsArgs args) {
  const int n = args.n;
  const PairsArgs a = at_lane<WT, HT, IMT, false>(args, n);
  pair_frame<UnpackedRows<WT>, DIAG, CHECK, TOTALS>(
      a, n,
      [&](const Pair& r, int j0, const Vec8<WT>& x8, const Vec8<WT>& y8,
          bool& ok_i, bool& ok_p) {
        const int i = r.i, p = r.p;
        Vec8<WT> nx8, ny8;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = j0 + e;
          const int32_t x = x8.v[e], y = y8.v[e];
          const int32_t di = (r.vi && y > x) ? y - x : 0;
          const int32_t dp = (r.vp && x > y) ? x - y : 0;
          const int32_t nx = x + advance(di, r.scale_i,
                                         dither24(hash_mix_u32(i, j, a.salt_mix)));
          const int32_t ny = y + advance(dp, r.scale_p,
                                         dither24(hash_mix_u32(p, j, a.salt_mix)));
          nx8.v[e] = static_cast<WT>(nx);
          ny8.v[e] = static_cast<WT>(ny);
          if (CHECK) {
            ok_i = ok_i && nx >= a.need[j];
            ok_p = ok_p && ny >= a.need[j];
          }
        }
        WT* w = static_cast<WT*>(a.w);
        st8(w + static_cast<size_t>(i) * n + j0, nx8);
        if (!r.self) st8(w + static_cast<size_t>(p) * n + j0, ny8);
        HT* hbm = static_cast<HT*>(a.hb);
        if (hbm == nullptr) return;
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
          const int32_t from_p = r.vi ? hp[e] : 0;
          const int32_t from_i = r.vp ? hi[e] : 0;
          nhi[e] = hi[e] > from_p ? hi[e] : from_p;
          nhp[e] = hp[e] > from_i ? hp[e] : from_i;
          out_i.v[e] = static_cast<HT>(nhi[e]);
          out_p.v[e] = static_cast<HT>(nhp[e]);
        }
        st8(hi_row, out_i);
        if (!r.self) st8(hp_row, out_p);
        if (FD) {
          fd_chunk<HT, IMT>(a, i, j0, nhi, hi);
          if (!r.self) fd_chunk<HT, IMT>(a, p, j0, nhp, hp);
        }
      });
}

// The packed u4r rung (lean profile: no hb, no FD): w is (n, n/2) uint8
// and each 8-byte vector holds sixteen owners' residuals; the check
// reads the packed owner-alive row (a residual of 0 is caught up).
template <bool DIAG, bool CHECK, bool TOTALS>
__global__ void __launch_bounds__(kThreads) pairs_packed_kernel(PairsArgs args) {
  const int nb = args.n >> 1;  // bytes a row
  const PairsArgs a = at_lane<uint8_t, uint8_t, float, true>(args, nb);
  pair_frame<PackedRows, DIAG, CHECK, TOTALS>(
      a, nb,
      [&](const Pair& r, int k0, const Vec8<uint8_t>& x8,
          const Vec8<uint8_t>& y8, bool& ok_i, bool& ok_p) {
        Vec8<uint8_t> ok8;
        if (CHECK) ok8 = ld8(a.owner_ok + k0);
        Vec8<uint8_t> nx8, ny8;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          uint32_t bx = 0, by = 0;
#pragma unroll
          for (int h = 0; h < 8; h += 4) {
            const uint32_t j = 2 * (k0 + e) + (h >> 2);
            const int32_t x = (x8.v[e] >> h) & 0xF, y = (y8.v[e] >> h) & 0xF;
            const int32_t di = (r.vi && x > y) ? x - y : 0;
            const int32_t dp = (r.vp && y > x) ? y - x : 0;
            const int32_t nx = x - advance(di, r.scale_i,
                                           dither24(hash_mix_u32(r.i, j, a.salt_mix)));
            const int32_t ny = y - advance(dp, r.scale_p,
                                           dither24(hash_mix_u32(r.p, j, a.salt_mix)));
            bx |= static_cast<uint32_t>(nx) << h;
            by |= static_cast<uint32_t>(ny) << h;
            if (CHECK) {
              const bool owner_alive = ((ok8.v[e] >> h) & 0xF) != 0;
              ok_i = ok_i && (nx == 0 || !owner_alive);
              ok_p = ok_p && (ny == 0 || !owner_alive);
            }
          }
          nx8.v[e] = static_cast<uint8_t>(bx);
          ny8.v[e] = static_cast<uint8_t>(by);
        }
        uint8_t* w = static_cast<uint8_t*>(a.w);
        st8(w + static_cast<size_t>(r.i) * nb + k0, nx8);
        if (!r.self) st8(w + static_cast<size_t>(r.p) * nb + k0, ny8);
      });
}

// Launches a kernel instance over one CTA per row and lane with `smem`
// bytes of dynamic shared memory (opted in above 48 KB).
template <typename Kernel>
cudaError_t launch_rows(Kernel kernel, const PairsArgs& a, size_t smem,
                        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.n, a.lanes), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool DIAG, bool CHECK>
cudaError_t launch_packed(const PairsArgs& a, cudaStream_t s) {
  if (a.totals != nullptr) {
    return launch_rows(pairs_packed_kernel<DIAG, CHECK, true>, a, 0, s);
  }
  // Both packed rows staged: 2 * (n / 2) bytes.
  return launch_rows(pairs_packed_kernel<DIAG, CHECK, false>, a,
                     static_cast<size_t>(a.n), s);
}

template <typename WT, typename HT, typename IMT, bool DIAG, bool CHECK,
          bool FD, bool TOTALS>
cudaError_t launch_one(const PairsArgs& a, cudaStream_t stream) {
  const size_t smem = TOTALS ? 0 : 2 * static_cast<size_t>(a.n) * sizeof(WT);
  return launch_rows(pairs_kernel<WT, HT, IMT, DIAG, CHECK, FD, TOTALS>, a,
                     smem, stream);
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

template <typename WT>
cudaError_t launch_hb(const PairsArgs& a, int h_code, int im_code, bool diag,
                      bool check, bool fd, cudaStream_t s) {
  switch (h_code) {
    case kInt8:
      return launch_im<WT, int8_t>(a, im_code, diag, check, fd, s);
    case kInt16:
      return launch_im<WT, int16_t>(a, im_code, diag, check, fd, s);
    default:
      return launch_im<WT, int32_t>(a, im_code, diag, check, fd, s);
  }
}

}  // namespace

// w_code kU4 is the packed u4r rung: `mv` is then the (n/2,) packed write
// bumps and `need` the (n/2,) packed owner-alive bits, and hb and the FD
// must be null (cudaErrorInvalidValue otherwise). `lanes` > 1 is the lane
// lift: every operand carries a leading lane axis, `flag` holds one flag a
// lane, and `lane_salt` ((lanes,) uint32 salt_mix) and `lane_phi`
// ((lanes,) float) replace `salt_mix` and `phi` where given.
extern "C" int aiocluster_pairs_pull(
    void* w, void* hb, const void* gm, const void* c, const void* valid,
    int n, unsigned int salt_mix, float budget, const void* totals,
    const void* mv, const void* hbv, const void* need, const void* alive,
    void* flag, int tick, void* lc, void* im, void* ic, void* live,
    const void* hb0, float max_interval, int window, float prior_weight,
    float prior_wm, float phi, int w_code, int h_code, int im_code,
    int ic_code, int live_bits, int lanes, const void* lane_salt,
    const void* lane_phi, void* stream) {
  if (lanes < 1 || lanes > 65535) return static_cast<int>(cudaErrorInvalidValue);
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
  a.ic = ic;
  a.live = static_cast<uint8_t*>(live);
  a.hb0 = hb0;
  a.ic_int8 = ic_code == kInt8;
  a.live_bits = live_bits != 0;
  a.bump = static_cast<const uint8_t*>(mv);
  a.owner_ok = static_cast<const uint8_t*>(need);
  a.fd.max_interval = max_interval;
  a.fd.window = window;
  a.fd.prior_weight = prior_weight;
  a.fd.prior_wm = prior_wm;
  a.fd.phi = phi;
  a.lanes = lanes;
  a.lane_salt = static_cast<const uint32_t*>(lane_salt);
  a.lane_phi = static_cast<const float*>(lane_phi);
  const bool diag = mv != nullptr;
  const bool check = need != nullptr;
  const bool fd = lc != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_code) {
    case kU4:
      if (hb != nullptr || fd) return static_cast<int>(cudaErrorInvalidValue);
      if (diag) {
        return check ? launch_packed<true, true>(a, s)
                     : launch_packed<true, false>(a, s);
      }
      return check ? launch_packed<false, true>(a, s)
                   : launch_packed<false, false>(a, s);
    case kInt8:
      return launch_hb<int8_t>(a, h_code, im_code, diag, check, fd, s);
    case kInt16:
      return launch_hb<int16_t>(a, h_code, im_code, diag, check, fd, s);
    default:
      return launch_hb<int32_t>(a, h_code, im_code, diag, check, fd, s);
  }
}

// Static shared memory of the staged kernels (every staged instantiation
// has the same: block_sum's partials; the larger of the unpacked and the
// packed kernel's), which pairs_pull.STATIC_SMEM states for the wrapper's
// width check. Returns a cudaError_t.
extern "C" int aiocluster_pairs_pull_static_smem(int* bytes) {
  cudaFuncAttributes attr{}, packed{};
  cudaError_t err = cudaFuncGetAttributes(
      &attr,
      pairs_kernel<int16_t, int16_t, __nv_bfloat16, true, true, true, false>);
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&packed,
                                pairs_packed_kernel<true, true, false>);
  }
  *bytes = static_cast<int>(attr.sharedSizeBytes > packed.sharedSizeBytes
                                ? attr.sharedSizeBytes
                                : packed.sharedSizeBytes);
  return err;
}

extern "C" const char* aiocluster_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
