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
// THE CLUSTER FRAME (the staged form, staged_frame): a pair is staged by
// a thread-block cluster of k CTAs (k = a.cluster, a launch value in {1,
// 2, 4, 8}; pairs_pull.pull_form picks the smallest k that lets two CTAs
// share an SM). CTA rank r stages chunks [r * per, (r + 1) * per) of
// both rows (per = ceil(chunks / k), whole 8-element chunks: 16 owners
// when packed) in 2 * per * 8 * sizeof(w) bytes of shared memory. Each
// thread copies its own chunks with cp.async (every byte in flight at
// once, no register held) and reads back only the chunks it copied, so
// its own wait publishes them. Pass 1 sums the slice's deficits
// (diagonal refreshed on read) exactly in int64 in one block reduction.
// With k > 1 each CTA writes its two partials to its shared memory, the
// cluster syncs, and every CTA reads the k partials through distributed
// shared memory and sums them: the sum is exact, so the rows' totals,
// rounded to f32 once, equal a single CTA's (and the reference's, while
// a row's total stays below 2^24, which the configs' budgets and widths
// keep). A second cluster barrier, arrived on after the reads and waited
// on before the CTA exits, keeps every CTA's partials readable until all
// have read them. Pass 2 applies the slice from shared memory and
// streams hb (and the FD matrices) 8 elements per thread with vector
// loads, writing every row once. k = 1 launches without the cluster
// attribute and never touches the cluster barriers. The leader test
// depends on the row alone, so a whole cluster returns together. The
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
// TOTALS mode (the two-pass form's pass B, one CTA a pair): the column
// blocks of a mesh, whose own sums are not the rows' totals, and rows
// wider than a cluster of 8 stages. With the totals given, the kernel
// skips the staging and the totals pass, takes both scales from the
// totals and streams both rows of w from global memory in the apply pass
// (diagonal refreshed on load, pairs.cuh), with no dynamic shared
// memory: any width that is a multiple of 8 (16 packed) runs. Each
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
// The packed kernel shares the unpacked one's frame (pair_frame: the
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "fd_update.cuh"
#include "hash.cuh"
#include "pairs.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;  // the portable maximum of a thread-block cluster

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
    return ld8_row<WT, DIAG>(row_ptr, row, j0, a.mv, a.col0);
  }
  template <bool DIAG>
  static __device__ __forceinline__ Vec8<T> refresh(const PairsArgs& a, Vec8<T> x8,
                                                    int row, int j0) {
    return refresh_row<WT, DIAG>(x8, row, j0, a.mv, a.col0);
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
    return ld8_packed_row<DIAG>(row_ptr, row, k0, a.bump, a.col0);
  }
  template <bool DIAG>
  static __device__ __forceinline__ Vec8<T> refresh(const PairsArgs& a, Vec8<T> x8,
                                                    int row, int k0) {
    return refresh_packed_row<DIAG>(x8, row, k0, a.bump, a.col0);
  }
  static __device__ __forceinline__ void sums(const Vec8<T>& x8,
                                              const Vec8<T>& y8, bool vi,
                                              bool vp, long long& ti,
                                              long long& tp) {
    add_deficits_packed(x8, y8, vi, vp, ti, tp);
  }
};

// Copies eight elements (one 8-element chunk, 8 to 32 bytes) from global
// to shared memory asynchronously (cp.async; the 16-byte copies bypass
// L1); cp_async_wait_all waits for every copy the thread started.
template <typename T>
__device__ __forceinline__ void cp_async8(T* smem_dst, const T* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if constexpr (sizeof(T) == 1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem_src)
                 : "memory");
  } else {
#pragma unroll
    for (int h = 0; h < static_cast<int>(sizeof(T)) / 2; ++h) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16 * h),
                   "l"(gmem_src + h * (16 / static_cast<int>(sizeof(T))))
                   : "memory");
    }
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The cluster's deficit totals: every CTA's exact partials (ti, tp) are
// written to `part` in its shared memory, and after a cluster barrier each
// CTA sums the k partials in rank order through distributed shared
// memory. Then each thread arrives on a second cluster barrier, which
// cluster_wait() completes before the CTA exits: no CTA's shared memory
// goes while another may still read it.
__device__ __forceinline__ void cluster_totals(long long* part, int k, long long& ti,
                                               long long& tp) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    part[0] = ti;
    part[1] = tp;
  }
  cluster.sync();
  long long si = 0, sp = 0;
  for (int q = 0; q < k; ++q) {
    const long long* rp = cluster.map_shared_rank(part, q);
    si += rp[0];
    sp += rp[1];
  }
  ti = si;
  tp = sp;
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The pair a CTA works on, as its apply step sees it.
struct Pair {
  int i, p;
  bool self, vi, vp;
  float scale_i, scale_p;
};

__device__ __forceinline__ Pair pair_of(const PairsArgs& a, int i) {
  Pair r;
  r.i = i;
  r.p = partner_row(a.gm, a.c, i);
  r.self = r.p == i;
  r.vi = a.valid[i] != 0;
  r.vp = a.valid[r.p] != 0;
  return r;
}

// With CHECK, a CTA whose chunks of a pair fall short clears the flag.
template <bool CHECK>
__device__ __forceinline__ void check_pair(const PairsArgs& a, const Pair& r, bool ok_i,
                                           bool ok_p) {
  if (CHECK) {
    const bool row_ok = (ok_i || a.alive[r.i] == 0) &&
                        (r.self || ok_p || a.alive[r.p] == 0);
    if (!__syncthreads_and(row_ok) && threadIdx.x == 0) *a.flag = 0;
  }
}

// The two-pass form's pass B: one CTA per LEADER row i (i <= p[i]) owns
// rows i and p (other CTAs return), both directions' deficit totals
// given. Each thread streams its 8-element chunks of both rows from
// global memory (diagonal refreshed on load) to `Body::apply(a, pair, j0,
// x8, y8, ok_i, ok_p)`, which writes them back (and what rides them) and,
// with CHECK, clears ok_i / ok_p where a row falls short.
template <typename Rows, typename Body, bool DIAG, bool CHECK>
__device__ __forceinline__ void totals_frame(const PairsArgs& a, int row_len) {
  using T = typename Rows::T;
  if (partner_row(a.gm, a.c, blockIdx.x) < static_cast<int>(blockIdx.x)) return;
  Pair r = pair_of(a, blockIdx.x);
  r.scale_i = budget_scale(a.budget, a.totals[r.i]);
  r.scale_p = budget_scale(a.budget, a.totals[r.p]);
  const T* wi = static_cast<const T*>(a.w) + static_cast<size_t>(r.i) * row_len;
  const T* wp = static_cast<const T*>(a.w) + static_cast<size_t>(r.p) * row_len;
  bool ok_i = true, ok_p = true;
  for (int q = threadIdx.x; q < (row_len >> 3); q += blockDim.x) {
    const int j0 = q << 3;
    Body::apply(a, r, j0, Rows::template load<DIAG>(a, wi, r.i, j0),
                Rows::template load<DIAG>(a, wp, r.p, j0), ok_i, ok_p);
  }
  check_pair<CHECK>(a, r, ok_i, ok_p);
}

// Copies the thread's chunks of rows i and p[i] (chunks [q0, q1) of the
// CTA's slice, `per` a row) into `dst`, [row i | row p], with cp.async.
template <typename T>
__device__ __forceinline__ void stage_slice(const PairsArgs& a, int i, int row_len, int q0,
                                            int q1, int per, T* dst) {
  const T* wi = static_cast<const T*>(a.w) + static_cast<size_t>(i) * row_len;
  const T* wp =
      static_cast<const T*>(a.w) + static_cast<size_t>(partner_row(a.gm, a.c, i)) * row_len;
  for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
    const int off = (q - q0) << 3;
    cp_async8(dst + off, wi + (q << 3));
    cp_async8(dst + (per << 3) + off, wp + (q << 3));
  }
}

// The cluster frame (the staged form): the k = a.cluster CTAs of a
// leader row i (i <= p[i]) own rows i and p (other CTAs return; the test
// depends on the row alone, so a whole cluster returns together). CTA
// rank r stages chunks [r * per, (r + 1) * per) of both rows in its
// shared memory: each thread copies its own chunks with cp.async (every
// byte in flight, no register held) and reads back only those, so its own
// wait publishes them. Pass 1 sums the slice's deficits (diagonal
// refreshed on read) exactly in int64, the cluster adds the k slices'
// sums (cluster_totals), and pass 2 applies the slice through
// Body::apply as the totals frame does.
template <typename Rows, typename Body, bool DIAG, bool CHECK>
__device__ __forceinline__ void staged_frame(const PairsArgs& a, int row_len) {
  using T = typename Rows::T;
  const int k = a.cluster;
  const int i = blockIdx.x / k;
  if (partner_row(a.gm, a.c, i) < i) return;
  Pair r = pair_of(a, i);
  const int chunks = row_len >> 3;
  const int per = (chunks + k - 1) / k;
  const int q0 = (blockIdx.x - i * k) * per;
  const int q1 = min(chunks, q0 + per);
  const int base = q0 << 3;  // the slice's first stored column
  extern __shared__ __align__(16) unsigned char smem[];
  T* si = reinterpret_cast<T*>(smem);
  T* sp = si + (per << 3);
  stage_slice(a, i, row_len, q0, q1, per, si);
  cp_async_wait_all();
  long long ti = 0, tp = 0;
  for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
    const int j0 = q << 3;
    Rows::sums(Rows::template refresh<DIAG>(a, ld8(si + (j0 - base)), r.i, j0),
               Rows::template refresh<DIAG>(a, ld8(sp + (j0 - base)), r.p, j0),
               r.vi, r.vp, ti, tp);
  }
  ti = block_sum(ti);
  tp = block_sum(tp);
  if (k > 1) cluster_totals(reinterpret_cast<long long*>(sp + (per << 3)), k, ti, tp);
  r.scale_i = budget_scale(a.budget, static_cast<float>(ti));
  r.scale_p = budget_scale(a.budget, static_cast<float>(tp));
  bool ok_i = true, ok_p = true;
  for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
    const int j0 = q << 3;
    Body::apply(a, r, j0, Rows::template refresh<DIAG>(a, ld8(si + (j0 - base)), r.i, j0),
                Rows::template refresh<DIAG>(a, ld8(sp + (j0 - base)), r.p, j0), ok_i, ok_p);
  }
  check_pair<CHECK>(a, r, ok_i, ok_p);
  if (k > 1) cluster_wait();
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
// and one grid row per lane, with `smem` bytes of dynamic shared memory
// (opted in above 48 KB); a cluster of k > 1 CTAs rides the launch's
// cluster attribute.
template <typename Kernel>
cudaError_t launch_rows(Kernel kernel, const PairsArgs& a, size_t smem,
                        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.n) * a.cluster, a.lanes);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Dynamic shared memory of one staged CTA over rows of `row_len` stored
// elements of `elem` bytes: its slice of both rows (whole 8-element
// chunks) and, in a cluster, the two partial sums the others read.
size_t staged_smem(const PairsArgs& a, int row_len, size_t elem) {
  const int chunks = row_len >> 3;
  const size_t per = static_cast<size_t>((chunks + a.cluster - 1) / a.cluster);
  return 2 * per * 8 * elem + (a.cluster > 1 ? 2 * sizeof(long long) : 0);
}

template <bool DIAG, bool CHECK>
cudaError_t launch_packed(const PairsArgs& a, cudaStream_t s) {
  if (a.totals != nullptr) {
    return launch_rows(pairs_packed_kernel<DIAG, CHECK, true>, a, 0, s);
  }
  return launch_rows(pairs_packed_kernel<DIAG, CHECK, false>, a,
                     staged_smem(a, a.n_cols >> 1, 1), s);
}

template <typename WT, typename HT, typename IMT, bool DIAG, bool CHECK,
          bool FD, bool TOTALS>
cudaError_t launch_one(const PairsArgs& a, cudaStream_t stream) {
  const size_t smem = TOTALS ? 0 : staged_smem(a, a.n_cols, sizeof(WT));
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
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
      (totals != nullptr && cluster != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
