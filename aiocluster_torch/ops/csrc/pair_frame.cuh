// The pair frame that both pull kernels run (the in-place pairs_pull.cu
// and the out-of-place m8_pull.cu): one group of CTAs per LEADER row i
// (i <= p[i]) of the matching's row involution p owns rows i and p[i], in
// one of two forms.
//
// THE CLUSTER FRAME (the staged form, staged_frame): a pair is staged by
// a thread-block cluster of k CTAs (k = a.cluster, a launch value in {1,
// 2, 4, 8}). CTA rank r stages chunks [r * per, (r + 1) * per) of both
// rows (per = ceil(chunks / k), whole 8-element chunks: 16 owners when
// packed) in 2 * per * 8 * sizeof(w) bytes of shared memory. Each thread
// copies its own chunks with cp.async (every byte in flight at once, no
// register held) and reads back only the chunks it copied, so its own
// wait publishes them. Pass 1 sums the slice's deficits (diagonal
// refreshed on read) exactly in int64 in one block reduction. With k > 1
// each CTA writes its two partials to its shared memory, the cluster
// syncs, and every CTA reads the k partials through distributed shared
// memory and sums them: the sum is exact, so the rows' totals, rounded to
// f32 once, equal a single CTA's. A second cluster barrier, arrived on
// after the reads and waited on before the CTA exits, keeps every CTA's
// partials readable until all have read them. Pass 2 hands the slice,
// chunk by chunk, to the kernel's Body::apply. k = 1 launches without the
// cluster attribute and never touches the cluster barriers. The leader
// test depends on the row alone, so a whole cluster returns together.
//
// THE TOTALS FRAME (the two-pass form's pass B, totals_frame): with the
// rows' deficit totals given, one CTA a pair skips the staging and the
// sums and streams both rows of w from global memory to Body::apply
// (diagonal refreshed on load): no dynamic shared memory, any width that
// is a multiple of 8 (16 packed) runs.
//
// What a kernel brings: its argument struct (the fields the frames read:
// w, gm, c, valid, budget, totals, cluster, and the row codec's mv /
// bump and col0; with CHECK alive and flag), a row codec (UnpackedRows,
// PackedRows) and an element body, a struct with a force-inlined static
// apply(a, pair, j0, x8, y8, ok_i, ok_p) (a lambda body can go un-inlined
// and take a stack frame).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "pairs.cuh"

namespace pair_frame {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // every frame kernel's block

// The stored form of a row of w: the unpacked rungs' WT elements (the
// diagonal refresh reads mv at the owner's column) or the packed u4r
// bytes (sixteen owners a vector; the refresh shifts by the write bumps).
template <typename WT>
struct UnpackedRows {
  using T = WT;
  template <bool DIAG, typename Args>
  static __device__ __forceinline__ Vec8<T> load(const Args& a, const T* row_ptr, int row,
                                                 int j0) {
    return ld8_row<WT, DIAG>(row_ptr, row, j0, a.mv, a.col0);
  }
  template <bool DIAG, typename Args>
  static __device__ __forceinline__ Vec8<T> refresh(const Args& a, Vec8<T> x8, int row,
                                                    int j0) {
    return refresh_row<WT, DIAG>(x8, row, j0, a.mv, a.col0);
  }
  static __device__ __forceinline__ void sums(const Vec8<T>& x8, const Vec8<T>& y8, bool vi,
                                              bool vp, long long& ti, long long& tp) {
    add_deficits(x8, y8, vi, vp, ti, tp);
  }
};

struct PackedRows {
  using T = uint8_t;
  template <bool DIAG, typename Args>
  static __device__ __forceinline__ Vec8<T> load(const Args& a, const T* row_ptr, int row,
                                                 int k0) {
    return ld8_packed_row<DIAG>(row_ptr, row, k0, a.bump, a.col0);
  }
  template <bool DIAG, typename Args>
  static __device__ __forceinline__ Vec8<T> refresh(const Args& a, Vec8<T> x8, int row,
                                                    int k0) {
    return refresh_packed_row<DIAG>(x8, row, k0, a.bump, a.col0);
  }
  static __device__ __forceinline__ void sums(const Vec8<T>& x8, const Vec8<T>& y8, bool vi,
                                              bool vp, long long& ti, long long& tp) {
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

template <typename Args>
__device__ __forceinline__ Pair pair_of(const Args& a, int i) {
  Pair r;
  r.i = i;
  r.p = partner_row(a.gm, a.c, i);
  r.self = r.p == i;
  r.vi = a.valid[i] != 0;
  r.vp = a.valid[r.p] != 0;
  return r;
}

// With CHECK, a CTA whose chunks of a pair fall short clears the flag.
template <bool CHECK, typename Args>
__device__ __forceinline__ void check_pair(const Args& a, const Pair& r, bool ok_i, bool ok_p) {
  if constexpr (CHECK) {
    const bool row_ok = (ok_i || a.alive[r.i] == 0) &&
                        (r.self || ok_p || a.alive[r.p] == 0);
    if (!__syncthreads_and(row_ok) && threadIdx.x == 0) *a.flag = 0;
  }
}

// The two-pass form's pass B: one CTA per LEADER row i (i <= p[i]) owns
// rows i and p (other CTAs return), both directions' deficit totals
// given. Each thread streams its 8-element chunks of both rows from
// global memory (diagonal refreshed on load) to `Body::apply(a, pair, j0,
// x8, y8, ok_i, ok_p)`, which writes the new rows (and what rides them)
// and, with CHECK, clears ok_i / ok_p where a row falls short.
template <typename Rows, typename Body, bool DIAG, bool CHECK, typename Args>
__device__ __forceinline__ void totals_frame(const Args& a, int row_len) {
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
template <typename T, typename Args>
__device__ __forceinline__ void stage_slice(const Args& a, int i, int row_len, int q0, int q1,
                                            int per, T* dst) {
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
template <typename Rows, typename Body, bool DIAG, bool CHECK, typename Args>
__device__ __forceinline__ void staged_frame(const Args& a, int row_len) {
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

// Dynamic shared memory of one staged CTA over rows of `row_len` stored
// elements of `elem` bytes: its slice of both rows (whole 8-element
// chunks) and, in a cluster, the two partial sums the others read.
inline size_t staged_smem(int row_len, size_t elem, int cluster) {
  const int chunks = row_len >> 3;
  const size_t per = static_cast<size_t>((chunks + cluster - 1) / cluster);
  return 2 * per * 8 * elem + (cluster > 1 ? 2 * sizeof(long long) : 0);
}

// Launches a frame's kernel over `cluster` CTAs a row of `rows` (1 with
// TOTALS) and one grid row per lane, with `smem` bytes of dynamic shared
// memory (opted in above 48 KB); a cluster of k > 1 CTAs rides the
// launch's cluster attribute.
template <typename Kernel, typename Args>
cudaError_t launch_pairs(Kernel kernel, const Args& a, int rows, int cluster, int lanes,
                         size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * cluster, lanes);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// A cluster size the frame takes: 1, 2, 4 or 8 (the portable maximum of
// a thread-block cluster), and 1 with the totals given.
inline bool cluster_ok(int cluster, bool totals) {
  return cluster >= 1 && cluster <= 8 && (cluster & (cluster - 1)) == 0 &&
         !(totals && cluster != 1);
}

}  // namespace pair_frame
