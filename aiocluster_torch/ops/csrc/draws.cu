// The grouped-matching draws of a chunk of rounds on Hopper: every
// sub-exchange's group involution gm, rotation c and row involution p, bit
// for bit those of ops/prng.py's plain chunk_draws (jax.random's Threefry
// draws in the reference, which lowers them through XLA: no Pallas kernel).
//
// What bounds it: neither bytes nor arithmetic. A sub-exchange writes 40
// bytes a group and spends a few hundred integer operations a group (two
// or three Threefry blocks, the sort's compare-exchanges); the sort's
// ~log2(G)^2 / 2 barrier-separated stages set its time. Its plain version
// is ~1,700 small PyTorch operators a chunk, launched one by one from the
// host; this is one launch.
//
// Design: one CTA per (round, sub-exchange, lane), all independent.
//  - Key schedule (prng._round_keys, _sub_keys, grouped_matching, randint):
//    round_key = fold_in(key, tick); peer = split(round_key)[1]; sub =
//    fold_in(peer, c); (match, rot) = split(sub); the rotation's draw is
//    bits(split(rot)[1]) & 7 (randint at span 8, whose 2^32 % 8 multiplier
//    drops the higher word). Every thread derives the keys itself (a few
//    Threefry blocks), so no barrier broadcasts them. Native uint32: the
//    wrapping add and rotate are exact.
//  - The permutation of the G = n/8 groups (prng.permutation): per sort
//    round, split the key, fill 32-bit sort keys from bits of the counter,
//    sort (key, position) pairs and carry the indices through them. A slot
//    is one 64-bit word, key << 32 | position, so ordering the words is a
//    total order that equals the stable sort (torch.sort(stable=True),
//    lax.sort_key_val). The sort is bitonic over the slots padded to a
//    power of two S (pads: key 2^32 - 1 at their own positions, after every
//    real slot). A tile is the largest power of two of slots one block's
//    shared memory holds on the device (16,384 on the H100, 128 KB). Up to
//    a tile the whole sort runs in shared memory; past it the slots live in
//    a global scratch of the CTA's own (the wrapper's, 8 S bytes a CTA):
//    each tile is filled and sorted in shared memory, then each merge of
//    size k > tile takes its strides of a tile or more in global memory and
//    the strides below a tile in shared memory, a tile at a time.
//  - The carried indices between sort rounds alternate between this CTA's
//    slices of gm and c, so the last round's permutation lands in c. The
//    matching pairs its first half with the second (prng.random_matching)
//    into gm, then c is overwritten by the rotation rule and p[8g + r] =
//    8 gm[g] + (r - c[g]) % 8 written from them.
// Every phase is a block-stride loop between barriers, so any block size
// and any tile compute the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxGroups = 1 << 27;  // n = 8 G rows below 2^30: int32 row ids

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// Threefry-2x32 (20 rounds) of the counter (x0, x1) under key k: the
// rotations and key injection of prng.threefry2x32.
__device__ __forceinline__ Key threefry(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int step = 0; step < 5; ++step) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = x0 ^ rotl32(x1, rot[step & 1][i]);
    }
    x0 += ks[(step + 1) % 3];
    x1 += ks[(step + 2) % 3] + static_cast<uint32_t>(step + 1);
  }
  return {x0, x1};
}

// fold_in(k, d) and split(k)[d] are both the block of counter (0, d).
__device__ __forceinline__ Key derive(Key k, uint32_t d) { return threefry(k, 0u, d); }

// bits(k)[i] for a counter below 2^32: the block's two words xor-ed.
__device__ __forceinline__ uint32_t bits_at(Key k, uint32_t i) {
  const Key b = threefry(k, 0u, i);
  return b.k0 ^ b.k1;
}

struct DrawsArgs {
  const int64_t* keys;  // (lanes, 2) run keys, one 32-bit word each
  int32_t* gm;          // (rounds, fanout, lanes, G) written
  int32_t* c;           // (rounds, fanout, lanes, G) written
  int32_t* p;           // (rounds, fanout, lanes, 8 G) written
  uint64_t* scratch;    // (CTAs, slots) when slots > tile, else null
  uint32_t first_tick;  // the chunk's first tick, mod 2^32
  int32_t lanes;
  int32_t fanout;
  int32_t groups;       // G = n / 8
  int32_t slots;        // the sort's power of two >= G
  int32_t tile;         // slots of the shared-memory tile, <= slots
  int32_t sort_rounds;  // ceil(3 ln G / ln(2^32 - 1))
};

// One compare-exchange step of the bitonic sort, stride j of merge size k,
// over the `count` slots of v, whose first is slot `base` of the whole
// sort (the direction follows the whole sort's index); ends on a barrier.
__device__ __forceinline__ void exchange(uint64_t* v, int count, int j, int k, int base) {
  for (int t = threadIdx.x; t < (count >> 1); t += blockDim.x) {
    const int i = 2 * t - (t & (j - 1));
    const uint64_t a = v[i], b = v[i + j];
    if ((a > b) == (((base + i) & k) == 0)) {
      v[i] = b;
      v[i + j] = a;
    }
  }
  __syncthreads();
}

// Copy `count` slots from src to dst; ends on a barrier.
__device__ __forceinline__ void copy_slots(uint64_t* dst, const uint64_t* src, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// One sort round: fill the slots from the sort key and sort them. Returns
// the sorted slots (the tile, or the CTA's scratch past a tile).
__device__ const uint64_t* sort_round(const DrawsArgs& a, Key sort_key, uint64_t* tile,
                                      uint64_t* global) {
  const int width = a.tile;  // slots in shared memory at a time
  for (int base = 0; base < a.slots; base += width) {
    for (int i = threadIdx.x; i < width; i += blockDim.x) {
      const int g = base + i;
      const uint32_t key = g < a.groups ? bits_at(sort_key, static_cast<uint32_t>(g))
                                        : 0xFFFFFFFFu;
      tile[i] = static_cast<uint64_t>(key) << 32 | static_cast<uint32_t>(g);
    }
    __syncthreads();
    for (int k = 2; k <= width; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) exchange(tile, width, j, k, base);
    }
    if (width == a.slots) return tile;
    copy_slots(global + base, tile, width);
  }
  for (int k = width << 1; k <= a.slots; k <<= 1) {
    for (int j = k >> 1; j >= width; j >>= 1) exchange(global, a.slots, j, k, 0);
    for (int base = 0; base < a.slots; base += width) {
      copy_slots(tile, global + base, width);
      for (int j = width >> 1; j > 0; j >>= 1) exchange(tile, width, j, k, base);
      copy_slots(global + base, tile, width);
    }
  }
  return global;
}

__global__ void __launch_bounds__(kMaxThreads) draws_kernel(DrawsArgs a) {
  extern __shared__ uint64_t tile[];
  const int cta = blockIdx.x;  // (round * fanout + sub) * lanes + lane
  const int lane = cta % a.lanes;
  const int sub = (cta / a.lanes) % a.fanout;
  const int round = cta / (a.lanes * a.fanout);
  const int groups = a.groups;
  int32_t* gm = a.gm + static_cast<size_t>(cta) * groups;
  int32_t* cc = a.c + static_cast<size_t>(cta) * groups;
  int32_t* pp = a.p + static_cast<size_t>(cta) * groups * 8;
  uint64_t* global = a.scratch ? a.scratch + static_cast<size_t>(cta) * a.slots : nullptr;

  const Key run = {static_cast<uint32_t>(a.keys[2 * lane]),
                   static_cast<uint32_t>(a.keys[2 * lane + 1])};
  const Key peer = derive(derive(run, a.first_tick + static_cast<uint32_t>(round)), 1u);
  const Key sub_key = derive(peer, static_cast<uint32_t>(sub));
  const Key rot_lower = derive(derive(sub_key, 1u), 1u);
  Key perm_key = derive(sub_key, 0u);

  // The carried indices x' = x[order] (x the identity before round 0),
  // alternating between gm and c so that the last round writes c.
  for (int s = 0; s < a.sort_rounds; ++s) {
    const Key sort_key = derive(perm_key, 1u);
    perm_key = derive(perm_key, 0u);
    const uint64_t* sorted = sort_round(a, sort_key, tile, global);
    int32_t* dst = ((a.sort_rounds - 1 - s) & 1) ? gm : cc;
    const int32_t* src = dst == gm ? cc : gm;
    for (int i = threadIdx.x; i < groups; i += blockDim.x) {
      const int32_t pos = static_cast<int32_t>(static_cast<uint32_t>(sorted[i]));
      dst[i] = s == 0 ? pos : src[pos];
    }
    __syncthreads();
  }

  // c holds the permutation: pair its first half with its second (an odd
  // count leaves its last group self-matched) into gm.
  const int half = groups >> 1;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const int32_t x = cc[i], y = cc[half + i];
    gm[x] = y;
    gm[y] = x;
  }
  if ((groups & 1) && threadIdx.x == 0) {
    const int32_t x = cc[groups - 1];
    gm[x] = x;
  }
  __syncthreads();

  // The rotations: u = randint(0, 8); c = u toward a higher partner, the
  // partner's (8 - u) % 8 toward a lower one, 4 (u % 2) when self-matched.
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int m = gm[g];
    const uint32_t u = bits_at(rot_lower, static_cast<uint32_t>(g)) & 7u;
    uint32_t c;
    if (g < m) {
      c = u;
    } else if (g > m) {
      c = (8u - (bits_at(rot_lower, static_cast<uint32_t>(m)) & 7u)) & 7u;
    } else {
      c = 4u * (u & 1u);
    }
    cc[g] = static_cast<int32_t>(c);
  }
  __syncthreads();
  for (int64_t j = threadIdx.x; j < 8 * static_cast<int64_t>(groups); j += blockDim.x) {
    const int64_t g = j >> 3;
    pp[j] = 8 * gm[g] + static_cast<int32_t>((static_cast<uint32_t>(j & 7) - cc[g]) & 7u);
  }
}

int slots_of(int groups) {
  int slots = 1;
  while (slots < groups) slots <<= 1;
  return slots;
}

// The shared-memory tile on the current device: the largest power of two
// of 8-byte slots within one block's opt-in shared memory.
cudaError_t tile_of(int* out) {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  int tile = 1;
  while (tile <= bytes / 16) tile <<= 1;
  *out = tile;
  return cudaSuccess;
}

}  // namespace

// The global scratch slots one CTA of the current device needs at `groups`
// groups: 0 when its sort fits a shared-memory tile, else the sort's slots
// (8 bytes each). Returns a cudaError_t.
extern "C" int aiocluster_draws_scratch(int groups, long long* slots_out) {
  if (groups < 1 || groups > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  int tile = 0;
  const cudaError_t err = tile_of(&tile);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = slots_of(groups);
  *slots_out = slots > tile ? slots : 0;
  return static_cast<int>(cudaSuccess);
}

// The grouped matchings of rounds first_tick .. first_tick + rounds - 1
// (ticks mod 2^32), `fanout` sub-exchanges each, of `lanes` run keys, at
// n = 8 * groups nodes. `sort_rounds` is the permutation's round count;
// `scratch` holds aiocluster_draws_scratch(groups) slots a CTA (null when
// that is 0).
extern "C" int aiocluster_draws(const void* keys, int lanes, unsigned first_tick, int rounds,
                                int fanout, int groups, int sort_rounds, void* gm, void* c,
                                void* p, void* scratch, void* stream) {
  const long long ctas = static_cast<long long>(rounds) * fanout * lanes;
  if (groups < 1 || groups > kMaxGroups || sort_rounds < 1 || ctas < 1 || ctas > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tile = 0;
  cudaError_t err = tile_of(&tile);
  if (err != cudaSuccess) return static_cast<int>(err);
  DrawsArgs a;
  a.keys = static_cast<const int64_t*>(keys);
  a.gm = static_cast<int32_t*>(gm);
  a.c = static_cast<int32_t*>(c);
  a.p = static_cast<int32_t*>(p);
  a.slots = slots_of(groups);
  a.tile = a.slots < tile ? a.slots : tile;
  a.scratch = a.slots > a.tile ? static_cast<uint64_t*>(scratch) : nullptr;
  if (a.slots > a.tile && a.scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.first_tick = first_tick;
  a.lanes = lanes;
  a.fanout = fanout;
  a.groups = groups;
  a.sort_rounds = sort_rounds;
  const int smem = static_cast<int>(sizeof(uint64_t)) * a.tile;
  err = cudaFuncSetAttribute(draws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int half = a.tile >> 1;
  const int threads = half < 32 ? 32 : (half > kMaxThreads ? kMaxThreads : half);
  draws_kernel<<<static_cast<unsigned>(ctas), threads, smem,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* aiocluster_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
