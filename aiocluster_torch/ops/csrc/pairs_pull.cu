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
// from pairs_totals.cu: the two-pass form of column blocks and of rows
// too wide for a cluster to stage) and
// the packed u4r rung (pairs_packed_kernel: the reference's nibble codec,
// lean profile only, as there), each also over S sweep lanes in one launch
// (LANES below: the reference's fused_pull_pairs_lanes) and each on a
// column block of the owners (COLUMN BLOCKS below: the reference's
// owner_offset, the owner-sharded simulator's blocks).
//
// What bounds it: on int16 and int32 rows, bytes: each sub-exchange must
// read and write every row of w and hb once (4 bytes per pair per int16
// matrix); the FD epilogue adds last_change/imean/icount in and out, hb0
// in and live out. On the narrow rungs (int8, packed u4r: 2 and 1 bytes
// per pair of w) the per-element instructions (deficit, hash, dither,
// advance) bound it instead. Three things set how close a launch comes:
// whether the rows' deficit totals need a pass of their own (the
// two-pass form reads w twice), how many bytes are in flight while a
// pair is staged (the kernel's registers let two CTAs of 256 threads
// share an SM), and how many instructions a column pair costs.
//
// Design: the matching is an involution p (p[p[i]] == i), so the CTAs of
// one LEADER row i (i <= p[i]) own both rows i and p[i]: no other CTA
// reads or writes them, which makes the update in place safe. On a GPU
// any row gather is legal, so the TPU's 8-row grouping and in-VMEM
// rotation reduce to the row involution p = 8 * gm[g] + (r - c[g]) mod 8;
// the draws (gm, c), and so the trajectory, are the reference's.
//
// THE CLUSTER FRAME (the staged form): a pair is staged by a thread-block
// cluster of k CTAs (k = a.cluster, a launch value in {1, 2, 4, 8};
// pairs_pull.pull_form picks the smallest k that lets two CTAs share an
// SM), each CTA staging its slice of both rows with cp.async and the
// slices' exact int64 totals added through distributed shared memory.
// pair_frame.cuh holds the frame (staged_frame, totals_frame), which
// m8_pull.cu runs too; this file brings the in-place element bodies. The
// check, the FD epilogue, the diagonal refresh, the packed codec and the
// lane axis work per element or per CTA and carry over unchanged. A
// self-matched row (p == i) still gets the refresh, the check and the FD
// epilogue; its exchange is a no-op (d = 0, hb = max(hb, hb)). (A
// persistent grid that staged the next pair while applying this one, two
// buffers a CTA, was measured and dropped: its loop cost registers the
// FD instances spilled, and it ran slower; PERF.md.)
//
// ONE ADVANCE PER COLUMN PAIR: a column's deficit is positive in at most
// one direction (y > x for row i, x > y for row p; the packed residuals
// the other way round), and the advance of a zero deficit is 0 for any
// dither. So the body decides the receiving row first, masks the deficit
// by that row's valid flag, and computes one hash, one dither and one
// advance for the receiver only: half the two-direction body's work, the
// same bits. (A skip of the chunks whose deficits are all 0 was measured
// and dropped: a run leaves too few such chunks for it to pay for its
// test; PERF.md.)
//
// TOTALS mode (the two-pass form's pass B, pair_frame.cuh's totals
// frame, one CTA a pair): the column blocks of a mesh, whose own sums are
// not the rows' totals, and rows wider than a cluster of 8 stages. Each
// thread reads and writes only its own 8-column chunks of the CTA's two
// rows, so the update stays in place without a barrier.
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
// The packed kernel shares the unpacked one's frame (pair_frame.cuh: the
// leader row, the cluster's staging and totals, the check) and differs
// only in the row codec and the apply step.
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
// COLUMN BLOCKS (the owner-sharded round): w and the (n, n)-class matrices
// are (n, n_cols) blocks whose column j is global owner col0 + j; rows
// stay global (the pairing is over rows, so a CTA's partner row lies in
// the same block). col0 is one runtime value (no template mode): it keys
// the diagonal refresh (row i's own owner sits at local column i - col0,
// in one block only), the dither hash (global owner col0 + j), and the
// FD epilogue's self diagonal and hb0 refresh; mv, hbv and need are the
// block's (n_cols,) slices (packed: n_cols / 2 bytes; col0 even), the
// live bitmap's byte b covers local columns 8b .. 8b + 7 (col0 % 8 ==
// 0). The sharded round always feeds the rows' global totals (TOTALS),
// summed over the blocks' pairs_totals.cu shares; a block staged alone
// sums only its own columns, as the reference's kernel does. The check
// clears the flag from the block's columns; the round takes the min over
// the blocks. Every offset into a block is size_t (n * n_cols passes
// 2^31 at the north star's width).
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
#include "pair_frame.cuh"
#include "pairs.cuh"

namespace {

using namespace pair_frame;

struct PairsArgs {
  void* w;                  // (n, n_cols) WT, updated in place
  void* hb;                 // (n, n_cols) HT, in place; null when lean
  const int32_t* gm;        // (n/8,) partner group of each group
  const int32_t* c;         // (n/8,) within-pair row rotation
  const uint8_t* valid;     // (n,) alive-pair mask per row
  int32_t n;                // rows (all owners)
  int32_t n_cols;           // the block's owners (n: the whole width)
  int32_t col0;             // global owner of column 0
  uint32_t salt_mix;        // sub-exchange salt ^ run salt
  float budget;
  const float* totals;      // TOTALS: (n,) rows' deficit totals
  const int32_t* mv;        // DIAG: (n_cols,) owner max_version
  const int32_t* hbv;       // DIAG / FD: (n_cols,) owner heartbeat
  const int32_t* need;      // CHECK: (n_cols,) target, 0 for dead owners
  const uint8_t* alive;     // CHECK: (n,) row liveness
  int32_t* flag;            // CHECK: starts at 1, cleared by a failing row
  int32_t tick;             // FD: the round's tick
  void* lc;                 // FD: (n, n_cols) HT last_change, in place
  void* im;                 // FD: (n, n_cols) IMT interval mean, in place
  void* ic;                 // FD: (n, n_cols) int16/int8 sample count
  uint8_t* live;            // FD: (n, n_cols) bool or (n, n_cols/8) bitmap
  const void* hb0;          // FD: (n, n_cols) HT round-start hb, or null
  bool ic_int8;             // FD: the sample counters are int8
  bool live_bits;           // FD: live is the bitmap
  const uint8_t* bump;      // PACKED + DIAG: (n_cols/2,) packed write bumps
  const uint8_t* owner_ok;  // PACKED + CHECK: (n_cols/2,) packed alive bits
  FdConsts fd;
  int32_t lanes;            // LANES: sweep lanes (gridDim.y), 1 outside sweeps
  const uint32_t* lane_salt;  // LANES: (lanes,) salt_mix of each lane, or null
  const float* lane_phi;    // LANES + FD: (lanes,) phi of each lane, or null
  int32_t cluster;          // CTAs staging a pair (gridDim.x = n * cluster); 1 with TOTALS
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
  const size_t vec = s * n, mat = vec * static_cast<size_t>(a.n_cols);
  const size_t owners = s * static_cast<size_t>(a.n_cols);
  a.w = static_cast<WT*>(a.w) + vec * static_cast<size_t>(row_len);
  a.gm += s * (n >> 3);
  a.c += s * (n >> 3);
  a.valid += vec;
  a.totals = shifted(a.totals, vec);
  a.alive = shifted(a.alive, vec);
  a.flag = shifted(a.flag, s);
  if (PACKED) {
    a.bump = shifted(a.bump, owners >> 1);
    a.owner_ok = shifted(a.owner_ok, owners >> 1);
  } else {
    a.hb = shifted(static_cast<HT*>(a.hb), mat);
    a.mv = shifted(a.mv, owners);
    a.hbv = shifted(a.hbv, owners);
    a.need = shifted(a.need, owners);
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

// The FD phase for eight (row, local column j0 + e) pairs: hb_new is the
// post-exchange knowledge, hb_old the refreshed pre-exchange tile (the
// round-start matrix at fanout == 1).
template <typename HT, typename IMT>
__device__ __forceinline__ void fd_chunk(const PairsArgs& a, int row, int j0,
                                         const Vec8<HT>& hb_new, const Vec8<HT>& hb_old) {
  const size_t off = static_cast<size_t>(row) * a.n_cols + j0;
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
    const bool self = a.col0 + j == row;  // the global self diagonal
    int32_t h0 = hb_old.v[e];
    if (a.hb0 != nullptr) {
      h0 = self ? a.hbv[j] : static_cast<int32_t>(h08.v[e]);
    }
    const FdResult r =
        fd_update(a.tick, hb_new.v[e], h0, static_cast<int32_t>(lc8.v[e]),
                  to_f32(im8.v[e]), ic[e], a.fd);
    const bool live = r.live || self;
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

// The unpacked rungs' body: one advance per column pair (to whichever row
// is behind), absorb heartbeats, and run the check and the FD epilogue on
// the fresh values.
template <typename WT, typename HT, typename IMT, bool DIAG, bool CHECK, bool FD>
struct UnpackedBody {
  static __device__ __forceinline__ void apply(const PairsArgs& a, const Pair& r, int j0,
                                               const Vec8<WT>& x8, const Vec8<WT>& y8,
                                               bool& ok_i, bool& ok_p) {
    const int n = a.n_cols;  // elements a row
    const int i = r.i, p = r.p;
    Vec8<WT> nx8, ny8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // The receiving row first: row i gains where y > x, row p where
      // x > y; the deficit is masked by the receiver's valid.
      const int32_t x = x8.v[e], y = y8.v[e];
      const bool in = y > x;
      const int32_t d = in ? (r.vi ? y - x : 0) : (r.vp ? x - y : 0);
      const uint32_t owner = a.col0 + j0 + e;  // the dither's global owner
      const int32_t adv = advance(
          d, in ? r.scale_i : r.scale_p,
          dither24(hash_mix_u32(in ? i : p, owner, a.salt_mix)));
      nx8.v[e] = static_cast<WT>(in ? x + adv : x);
      ny8.v[e] = static_cast<WT>(in ? y : y + adv);
    }
    if (CHECK) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ok_i = ok_i && static_cast<int32_t>(nx8.v[e]) >= a.need[j0 + e];
        ok_p = ok_p && static_cast<int32_t>(ny8.v[e]) >= a.need[j0 + e];
      }
    }
    WT* w = static_cast<WT*>(a.w);
    st8(w + static_cast<size_t>(i) * n + j0, nx8);
    if (!r.self) st8(w + static_cast<size_t>(p) * n + j0, ny8);
    HT* hbm = static_cast<HT*>(a.hb);
    if (hbm == nullptr) return;
    HT* hi_row = hbm + static_cast<size_t>(i) * n + j0;
    HT* hp_row = hbm + static_cast<size_t>(p) * n + j0;
    // The pre-exchange tiles (diagonal refreshed, in the stored dtype, as
    // the plain version refreshes them) and the absorbed ones.
    Vec8<HT> hi8 = ld8(hi_row), hp8 = ld8(hp_row), ni8, np8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = j0 + e;
      if (DIAG) {
        if (a.col0 + j == i) hi8.v[e] = static_cast<HT>(a.hbv[j]);
        if (a.col0 + j == p) hp8.v[e] = static_cast<HT>(a.hbv[j]);
      }
      const int32_t hi = hi8.v[e], hp = hp8.v[e];
      const int32_t from_p = r.vi ? hp : 0;
      const int32_t from_i = r.vp ? hi : 0;
      ni8.v[e] = static_cast<HT>(hi > from_p ? hi : from_p);
      np8.v[e] = static_cast<HT>(hp > from_i ? hp : from_i);
    }
    st8(hi_row, ni8);
    if (!r.self) st8(hp_row, np8);
    if (FD) {
      fd_chunk<HT, IMT>(a, i, j0, ni8, hi8);
      if (!r.self) fd_chunk<HT, IMT>(a, p, j0, np8, hp8);
    }
  }
};

template <typename WT, typename HT, typename IMT, bool DIAG, bool CHECK,
          bool FD, bool TOTALS>
__global__ void __launch_bounds__(kThreads) pairs_kernel(PairsArgs args) {
  const PairsArgs a = at_lane<WT, HT, IMT, false>(args, args.n_cols);
  using Body = UnpackedBody<WT, HT, IMT, DIAG, CHECK, FD>;
  if constexpr (TOTALS) {
    totals_frame<UnpackedRows<WT>, Body, DIAG, CHECK>(a, a.n_cols);
  } else {
    staged_frame<UnpackedRows<WT>, Body, DIAG, CHECK>(a, a.n_cols);
  }
}

// The packed u4r rung's body (lean profile: no hb, no FD): w is (n, n/2)
// uint8 and each 8-byte vector holds sixteen owners' residuals; one
// advance per column pair shrinks the larger residual; the check reads
// the packed owner-alive row (a residual of 0 is caught up).
template <bool CHECK>
struct PackedBody {
  static __device__ __forceinline__ void apply(const PairsArgs& a, const Pair& r, int k0,
                                               const Vec8<uint8_t>& x8,
                                               const Vec8<uint8_t>& y8, bool& ok_i,
                                               bool& ok_p) {
    const int nb = a.n_cols >> 1;  // bytes a row
    Vec8<uint8_t> nx8, ny8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      uint32_t bx = 0, by = 0;
#pragma unroll
      for (int h = 0; h < 8; h += 4) {
        // Row i gains where its residual is the larger (x > y), row p
        // where y > x: the receiver's residual shrinks.
        const int32_t x = (x8.v[e] >> h) & 0xF, y = (y8.v[e] >> h) & 0xF;
        const bool in = x > y;
        const int32_t d = in ? (r.vi ? x - y : 0) : (r.vp ? y - x : 0);
        const uint32_t j = a.col0 + 2 * (k0 + e) + (h >> 2);  // global
        const int32_t adv = advance(
            d, in ? r.scale_i : r.scale_p,
            dither24(hash_mix_u32(in ? r.i : r.p, j, a.salt_mix)));
        bx |= static_cast<uint32_t>(in ? x - adv : x) << h;
        by |= static_cast<uint32_t>(in ? y : y - adv) << h;
      }
      nx8.v[e] = static_cast<uint8_t>(bx);
      ny8.v[e] = static_cast<uint8_t>(by);
    }
    if (CHECK) {
      const Vec8<uint8_t> ok8 = ld8(a.owner_ok + k0);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
#pragma unroll
        for (int h = 0; h < 8; h += 4) {
          // A residual of 0 is caught up; a dead owner is excused.
          const bool owner_alive = ((ok8.v[e] >> h) & 0xF) != 0;
          ok_i = ok_i && (((nx8.v[e] >> h) & 0xF) == 0 || !owner_alive);
          ok_p = ok_p && (((ny8.v[e] >> h) & 0xF) == 0 || !owner_alive);
        }
      }
    }
    uint8_t* w = static_cast<uint8_t*>(a.w);
    st8(w + static_cast<size_t>(r.i) * nb + k0, nx8);
    if (!r.self) st8(w + static_cast<size_t>(r.p) * nb + k0, ny8);
  }
};

template <bool DIAG, bool CHECK, bool TOTALS>
__global__ void __launch_bounds__(kThreads) pairs_packed_kernel(PairsArgs args) {
  const PairsArgs a = at_lane<uint8_t, uint8_t, float, true>(args, args.n_cols >> 1);
  if constexpr (TOTALS) {
    totals_frame<PackedRows, PackedBody<CHECK>, DIAG, CHECK>(a, a.n_cols >> 1);
  } else {
    staged_frame<PackedRows, PackedBody<CHECK>, DIAG, CHECK>(a, a.n_cols >> 1);
  }
}

// Launches a kernel instance over a.cluster CTAs a row (1 with TOTALS)
// and one grid row per lane (pair_frame.cuh).
template <typename Kernel>
cudaError_t launch_rows(Kernel kernel, const PairsArgs& a, size_t smem, cudaStream_t stream) {
  return launch_pairs(kernel, a, a.n, a.cluster, a.lanes, smem, stream);
}

template <bool DIAG, bool CHECK>
cudaError_t launch_packed(const PairsArgs& a, cudaStream_t s) {
  if (a.totals != nullptr) {
    return launch_rows(pairs_packed_kernel<DIAG, CHECK, true>, a, 0, s);
  }
  return launch_rows(pairs_packed_kernel<DIAG, CHECK, false>, a,
                     staged_smem(a.n_cols >> 1, 1, a.cluster), s);
}

template <typename WT, typename HT, typename IMT, bool DIAG, bool CHECK,
          bool FD, bool TOTALS>
cudaError_t launch_one(const PairsArgs& a, cudaStream_t stream) {
  const size_t smem = TOTALS ? 0 : staged_smem(a.n_cols, sizeof(WT), a.cluster);
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

// The matrices hold `n_cols` owners from global owner `col0` (n and 0: the
// whole width). w_code kU4 is the packed u4r rung: `mv` is then the
// (n_cols/2,) packed write bumps and `need` the (n_cols/2,) packed
// owner-alive bits, and hb and the FD must be null (cudaErrorInvalidValue
// otherwise). `lanes` > 1 is the lane lift: every operand carries a
// leading lane axis, `flag` holds one flag a lane, and `lane_salt`
// ((lanes,) uint32 salt_mix) and `lane_phi` ((lanes,) float) replace
// `salt_mix` and `phi` where given. `cluster` is the CTAs that stage a
// pair (1, 2, 4 or 8; 1 with `totals`).
extern "C" int aiocluster_pairs_pull(
    void* w, void* hb, const void* gm, const void* c, const void* valid,
    int n, int n_cols, int col0, unsigned int salt_mix, float budget, const void* totals,
    const void* mv, const void* hbv, const void* need, const void* alive,
    void* flag, int tick, void* lc, void* im, void* ic, void* live,
    const void* hb0, float max_interval, int window, float prior_weight,
    float prior_wm, float phi, int w_code, int h_code, int im_code,
    int ic_code, int live_bits, int lanes, const void* lane_salt,
    const void* lane_phi, int cluster, void* stream) {
  if (lanes < 1 || lanes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (!cluster_ok(cluster, totals != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  PairsArgs a;
  a.w = w;
  a.hb = hb;
  a.gm = static_cast<const int32_t*>(gm);
  a.c = static_cast<const int32_t*>(c);
  a.valid = static_cast<const uint8_t*>(valid);
  a.n = n;
  a.n_cols = n_cols;
  a.col0 = col0;
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
  a.cluster = cluster;
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
