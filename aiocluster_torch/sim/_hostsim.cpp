// Native host fast path for the matching gossip round (the port of the
// reference's sim/_hostsim.cpp, loaded by aiocluster_torch/sim/hostsim.py).
//
// Reproduces ops/gossip.py::sim_step's matching sub-exchange BIT-EXACTLY
// on its domain (int16 watermarks held here as lossless int8, see
// acg_hostsim_subexchange; no churn, proportional budget): pair (a, b) of
// the involution advances both rows toward each other under the budgeted
// watermark advance, including the f32 proportional scaling and the
// multiplicative-hash dithered rounding (bits=24). Every float operation
// below mirrors one elementwise op of the simulator's round:
//   d     = max(w_send - w_recv, 0)                    (int16 math)
//   total = sum(d)              exact: an integer < 2^24, so any f32
//                               summation order equals this int32 sum
//   scale = min(1f, (float)budget / max((float)total, 1f))
//   x     = (float)d * scale                           (one f32 rounding)
//   fl    = floorf(x); frac = x - fl                   (exact)
//   u     = clip((float)(int32)(h >> 8) * 2^-24, 1e-12f, 1 - 2^-24)
//   adv   = min((int32)fl + (u < frac), (int32)d)
//
// One deliberate difference from the reference's copy: the FD pass's
// liveness bound rounds mean * count + prior_weight * prior_mean ONCE
// (std::fmaf), as the simulator does (ops/fd.py's fma32, __fmaf_rn in
// csrc/fd_update.cuh: the reference's XLA CPU backend contracts that
// multiply-add under jit). -ffp-contract=off leaves every other multiply
// and add rounded on its own; fmaf is one correctly rounded operation
// whatever the flag.
//
// Single-threaded; the j-loops are written branch-light so the compiler
// can vectorize, with AVX2 intrinsics where the host has them.
//
// The round being simulated is jettify/aiocluster server.py:378-495
// (gossip round) with state.py:340-415's MTU-bounded delta collapsed into
// the budgeted watermark advance.

#include <cstdint>
#include <cmath>

#ifdef __AVX2__
#include <immintrin.h>
#endif

namespace {

// gossip.py::_hash_uniform constants (bits=24 path).
constexpr uint32_t K1 = 0x9E3779B1u;
constexpr uint32_t K2 = 0x85EBCA77u;
constexpr uint32_t K3 = 0xC2B2AE3Du;
constexpr uint32_t KM = 0x27D4EB2Fu;
constexpr float INV24 = 5.9604644775390625e-08f;  // 2^-24 (exact)

inline float hash_u24(uint32_t i, uint32_t j, uint32_t s) {
    uint32_t h = i * K1 ^ j * K2 ^ s * K3;
    h = (h ^ (h >> 15)) * KM;
    h = h ^ (h >> 13);
    // (h >> 8) fits 24 bits: the int32 cast and f32 convert are exact.
    float u = (float)(int32_t)(h >> 8) * INV24;
    // jnp.clip(u, 1e-12, 1 - 2^-24): upper clip is a no-op by
    // construction (max is exactly 1 - 2^-24); lower clip guards u == 0.
    if (u < 1e-12f) u = 1e-12f;
    return u;
}

// One budgeted direction for a single element (the scalar reference the
// vector path reproduces lane-for-lane; also the tail loop).
inline int8_t adv_scalar(int8_t orecv, int8_t osend, float scale,
                          uint32_t row, uint32_t j, uint32_t s) {
    int32_t d = (int32_t)osend - (int32_t)orecv;
    d = d > 0 ? d : 0;
    float x = (float)d * scale;
    float fl = std::floor(x);
    float u = hash_u24(row, j, s);
    int32_t adv = (int32_t)fl + (u < (x - fl) ? 1 : 0);
    adv = adv < d ? adv : d;
    return (int8_t)((int32_t)orecv + adv);
}

#ifdef __AVX2__
// 8-lane form of _budgeted_advance's elementwise tail. Every intrinsic
// is the IEEE-exact vector twin of the scalar op (cvtepi32_ps exact for
// |v| < 2^24, mul_ps round-to-nearest like the scalar multiply,
// floor_ps == floorf, cvttps_epi32 == the truncating C cast), so the
// lanes are bit-identical to the scalar path — asserted by the
// full-trajectory tests, which run whichever build the host produced.
struct Hash8 {
    __m256i iK1_s;  // row * K1 ^ s*K3, broadcast
    __m256i jK2;    // current j * K2 per lane
    __m256i stepK2; // 16 * K2 — each 16-wide iteration consumes one
                    // next() from the lo stream (j..j+7) and one from
                    // the hi stream (j+8..j+15)
    inline void init(uint32_t row, uint32_t s, uint32_t j0) {
        iK1_s = _mm256_set1_epi32((int32_t)(row * K1 ^ s * K3));
        __m256i j = _mm256_add_epi32(
            _mm256_set1_epi32((int32_t)j0),
            _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7));
        jK2 = _mm256_mullo_epi32(j, _mm256_set1_epi32((int32_t)K2));
        stepK2 = _mm256_set1_epi32((int32_t)(16u * K2));
    }
    inline __m256 next() {  // u for the current 8 columns, then advance
        __m256i h = _mm256_xor_si256(iK1_s, jK2);
        jK2 = _mm256_add_epi32(jK2, stepK2);  // (j+16)*K2 == j*K2 + 16*K2
        h = _mm256_mullo_epi32(
            _mm256_xor_si256(h, _mm256_srli_epi32(h, 15)),
            _mm256_set1_epi32((int32_t)KM));
        h = _mm256_xor_si256(h, _mm256_srli_epi32(h, 13));
        __m256 u = _mm256_mul_ps(
            _mm256_cvtepi32_ps(_mm256_srli_epi32(h, 8)),
            _mm256_set1_ps(INV24));
        return _mm256_max_ps(u, _mm256_set1_ps(1e-12f));
    }
};

// Budgeted advance for 8 int32 lanes: recv + min(floor(d*scale)+bump, d).
inline __m256i adv8(__m256i orecv, __m256i osend, __m256 scale,
                    Hash8& hash) {
    __m256i d = _mm256_max_epi32(_mm256_sub_epi32(osend, orecv),
                                 _mm256_setzero_si256());
    __m256 x = _mm256_mul_ps(_mm256_cvtepi32_ps(d), scale);
    __m256 fl = _mm256_floor_ps(x);
    __m256 frac = _mm256_sub_ps(x, fl);
    __m256 u = hash.next();
    // bump: lanes where u < frac have mask -1; subtracting the mask
    // adds 1 exactly there.
    __m256i bump = _mm256_castps_si256(_mm256_cmp_ps(u, frac, _CMP_LT_OQ));
    __m256i adv = _mm256_sub_epi32(_mm256_cvttps_epi32(fl), bump);
    adv = _mm256_min_epi32(adv, d);
    return _mm256_add_epi32(orecv, adv);
}

inline void widen16(const int8_t* p, __m256i& lo, __m256i& hi) {
    // 16 int8 -> two 8-lane int32 vectors.
    __m128i v = _mm_loadu_si128((const __m128i*)p);
    lo = _mm256_cvtepi8_epi32(v);
    hi = _mm256_cvtepi8_epi32(_mm_srli_si128(v, 8));
}

inline void store16(int8_t* p, __m256i lo, __m256i hi) {
    // Watermarks are 0..127 (hostsim.supported gates keys_per_node), so
    // the signed saturations never engage; packs_epi32 interleaves
    // 128-bit lanes, which the permute undoes before the int16->int8
    // pack.
    __m256i p16 = _mm256_permute4x64_epi64(
        _mm256_packs_epi32(lo, hi), 0xD8);
    __m128i p8 = _mm_packs_epi16(
        _mm256_castsi256_si128(p16), _mm256_extracti128_si256(p16, 1));
    _mm_storeu_si128((__m128i*)p, p8);
}
#endif  // __AVX2__

// Advance both directions of one pair in place. a_scale/b_scale == 1.0f
// means that direction saturates (recv = max(recv, send) — exactly what
// the budgeted formula degenerates to at scale 1, see the module
// comment); the flags let us skip the hash work for saturating sides.
inline void advance_pair(int8_t* __restrict ra, int8_t* __restrict rb,
                         int64_t n, uint32_t a, uint32_t b, uint32_t s,
                         float sa, float sb, bool a_sat, bool b_sat) {
    int64_t j = 0;
#ifdef __AVX2__
    Hash8 hash_a_lo, hash_a_hi, hash_b_lo, hash_b_hi;
    if (!a_sat) { hash_a_lo.init(a, s, 0); hash_a_hi.init(a, s, 8); }
    if (!b_sat) { hash_b_lo.init(b, s, 0); hash_b_hi.init(b, s, 8); }
    __m256 vsa = _mm256_set1_ps(sa), vsb = _mm256_set1_ps(sb);
    for (; j + 16 <= n; j += 16) {
        __m256i alo, ahi, blo, bhi;
        widen16(ra + j, alo, ahi);
        widen16(rb + j, blo, bhi);
        __m256i nalo, nahi, nblo, nbhi;
        if (a_sat) {
            nalo = _mm256_max_epi32(alo, blo);
            nahi = _mm256_max_epi32(ahi, bhi);
        } else {
            nalo = adv8(alo, blo, vsa, hash_a_lo);
            nahi = adv8(ahi, bhi, vsa, hash_a_hi);
        }
        if (b_sat) {
            nblo = _mm256_max_epi32(alo, blo);
            nbhi = _mm256_max_epi32(ahi, bhi);
        } else {
            nblo = adv8(blo, alo, vsb, hash_b_lo);
            nbhi = adv8(bhi, ahi, vsb, hash_b_hi);
        }
        store16(ra + j, nalo, nahi);
        store16(rb + j, nblo, nbhi);
    }
#endif
    for (; j < n; ++j) {
        const int8_t oa = ra[j], ob = rb[j];
        ra[j] = a_sat ? (oa > ob ? oa : ob)
                      : adv_scalar(oa, ob, sa, a, (uint32_t)j, s);
        rb[j] = b_sat ? (oa > ob ? oa : ob)
                      : adv_scalar(ob, oa, sb, b, (uint32_t)j, s);
    }
}

}  // namespace

extern "C" {

// Advance one matching sub-exchange over all pairs, in place.
//   w        : (n, n) int8, row-major — the watermark matrix. The sim
//              stores int16, but on the supported domain every
//              watermark is <= keys_per_node <= 127, so the int8
//              REPRESENTATION is lossless and the arithmetic (which
//              widens to int32/f32 exactly like the int16 path) is
//              unchanged — it just halves the DRAM traffic this
//              memory-bound loop is made of.
//   hb       : (n, n) int16 heartbeat-knowledge matrix, or nullptr on
//              the lean profile. A matched pair absorbs each other's
//              heartbeat rows with an elementwise max — gossip.py's
//              hb_absorb computes both rows' maxima from PRE-exchange
//              values in one vectorized op, and max is symmetric, so
//              writing max(ha, hb) to both sides is exact.
//   A, B     : pair index arrays (A[k] < B[k] = p[A[k]], each row of the
//              involution appears in exactly one pair; self-pairs are
//              excluded by the caller — they are no-ops)
//   salt     : gossip.py sub_salt(c, 0) for this sub-exchange
//   run_salt : random.bits(base_key) — the per-run hash salt
//   budget   : key-versions per exchange (the MTU analogue)
//   compute_min / row_min : when nonzero, write min(row) after the
//              update for every touched row (len-n int32 buffer) — the
//              convergence check rides the round's last sub-exchange.
// Returns the number of pairs that took the saturating fast path
// (total <= budget on both sides), for diagnostics.
long acg_hostsim_subexchange(int8_t* w, int16_t* hb, int64_t n,
                             const int32_t* A, const int32_t* B,
                             int64_t n_pairs,
                             int32_t salt, uint32_t run_salt,
                             int32_t budget,
                             int32_t compute_min,
                             int32_t* row_min) {
    const uint32_t s = (uint32_t)salt ^ run_salt;
    long fast = 0;
    for (int64_t k = 0; k < n_pairs; ++k) {
        const int64_t a = A[k], b = B[k];
        int8_t* __restrict ra = w + a * n;
        int8_t* __restrict rb = w + b * n;
        if (hb) {
            int16_t* __restrict ha = hb + a * n;
            int16_t* __restrict hbp = hb + b * n;
            for (int64_t j = 0; j < n; ++j) {
                int16_t m = ha[j] > hbp[j] ? ha[j] : hbp[j];
                ha[j] = m;
                hbp[j] = m;
            }
        }
        // Pass 1: both directions' total deficits (rows land in cache
        // for pass 2).
        int32_t tota = 0, totb = 0;
        for (int64_t j = 0; j < n; ++j) {
            int32_t da = (int32_t)rb[j] - (int32_t)ra[j];
            tota += da > 0 ? da : 0;
            totb += da < 0 ? -da : 0;
        }
        const bool fa = tota <= budget;  // scale == 1 exactly
        const bool fb = totb <= budget;
        if (fa && fb) {
            ++fast;
            if (tota | totb) {  // identical rows need no writes at all
                for (int64_t j = 0; j < n; ++j) {
                    int8_t m = ra[j] > rb[j] ? ra[j] : rb[j];
                    ra[j] = m;
                    rb[j] = m;
                }
            }
        } else {
            // total > budget on at least one side (scale < 1 there: the
            // f32 division can only equal 1.0f when total == budget,
            // which the fast path already took). BOTH directions read
            // the PRE-exchange rows — element j of one row only depends
            // on element j of the other, so the per-element
            // load-both-then-write-both in advance_pair keeps the
            // in-place update exact.
            const float sa = fa ? 1.0f : std::fmin(
                1.0f, (float)budget / std::fmax((float)tota, 1.0f));
            const float sb = fb ? 1.0f : std::fmin(
                1.0f, (float)budget / std::fmax((float)totb, 1.0f));
            advance_pair(ra, rb, n, (uint32_t)a, (uint32_t)b, s,
                         sa, sb, fa, fb);
        }
        if (compute_min) {
            int32_t ma = 32767, mb = 32767;
            for (int64_t j = 0; j < n; ++j) {
                if (ra[j] < ma) ma = ra[j];
                if (rb[j] < mb) mb = rb[j];
            }
            row_min[a] = ma;
            row_min[b] = mb;
        }
    }
    return fast;
}

namespace {

// Single-direction budgeted advance of one row toward a sender row,
// writing (or max-accumulating into) ``dst`` — the 'choice' twin of
// advance_pair. AVX2 16-lane main loop with the same IEEE-exact vector
// building blocks as the matching kernel (Hash8/adv8), scalar tail;
// the hash row index is the INITIATOR ``row`` for both directions.
inline void advance_row(int8_t* __restrict dst,
                        const int8_t* __restrict recv,
                        const int8_t* __restrict send,
                        int64_t n, uint32_t row, uint32_t s,
                        float scale, bool sat, bool accum_max) {
    int64_t j = 0;
#ifdef __AVX2__
    Hash8 hash_lo, hash_hi;
    if (!sat) { hash_lo.init(row, s, 0); hash_hi.init(row, s, 8); }
    __m256 vs = _mm256_set1_ps(scale);
    for (; j + 16 <= n; j += 16) {
        __m256i rlo, rhi, slo, shi;
        widen16(recv + j, rlo, rhi);
        widen16(send + j, slo, shi);
        __m256i vlo, vhi;
        if (sat) {
            vlo = _mm256_max_epi32(rlo, slo);
            vhi = _mm256_max_epi32(rhi, shi);
        } else {
            vlo = adv8(rlo, slo, vs, hash_lo);
            vhi = adv8(rhi, shi, vs, hash_hi);
        }
        if (accum_max) {
            __m256i dlo, dhi;
            widen16(dst + j, dlo, dhi);
            vlo = _mm256_max_epi32(vlo, dlo);
            vhi = _mm256_max_epi32(vhi, dhi);
        }
        store16(dst + j, vlo, vhi);
    }
#endif
    for (; j < n; ++j) {
        int8_t v = sat ? (recv[j] > send[j] ? recv[j] : send[j])
                       : adv_scalar(recv[j], send[j], scale, row,
                                    (uint32_t)j, s);
        dst[j] = accum_max && dst[j] > v ? dst[j] : v;
    }
}

}  // namespace

// One 'choice'-pairing sub-exchange (gossip.py sim_step's else-branch:
// every node independently samples a peer — the reference's
// server.py:699 semantics, inbound load varies). All reads come from
// ``w_pre``, the caller's pre-sub-exchange snapshot, exactly like the
// XLA form where both _budgeted_advance calls and the scatter operand
// derive from the loop-carry value:
//   pass A (initiator applies responder's delta):
//     w[i] = w_pre[i] + adv(recv=w_pre[i], send=w_pre[p[i]], row=i, salt0)
//   pass B (responder applies initiator's delta, scatter-max over
//     duplicate responders — max is associative+commutative, so the
//     sequential loop equals XLA's .at[p].max):
//     w[p[i]] = max(w[p[i]],
//                   w_pre[p[i]] + adv(recv=w_pre[p[i]], send=w_pre[i],
//                                     row=i, salt1))
// The dither hash row index is the INITIATOR i for BOTH directions
// (each _budgeted_advance's d matrix is indexed by initiator row).
void acg_hostsim_choice_subexchange(int8_t* w, const int8_t* w_pre,
                                    int64_t n, const int32_t* p,
                                    int32_t salt0, int32_t salt1,
                                    uint32_t run_salt, int32_t budget) {
    const uint32_t s0 = (uint32_t)salt0 ^ run_salt;
    const uint32_t s1 = (uint32_t)salt1 ^ run_salt;
    for (int64_t i = 0; i < n; ++i) {
        const int8_t* __restrict recv = w_pre + i * n;
        const int8_t* __restrict send = w_pre + p[i] * n;
        int32_t tot = 0;
        for (int64_t j = 0; j < n; ++j) {
            int32_t d = (int32_t)send[j] - (int32_t)recv[j];
            tot += d > 0 ? d : 0;
        }
        const float sc = tot <= budget ? 1.0f : std::fmin(
            1.0f, (float)budget / std::fmax((float)tot, 1.0f));
        advance_row(w + i * n, recv, send, n, (uint32_t)i, s0,
                    sc, tot <= budget, false);
    }
    for (int64_t i = 0; i < n; ++i) {
        const int8_t* __restrict recv = w_pre + p[i] * n;  // responder's pre
        const int8_t* __restrict send = w_pre + i * n;     // initiator's pre
        int32_t tot = 0;
        for (int64_t j = 0; j < n; ++j) {
            int32_t d = (int32_t)send[j] - (int32_t)recv[j];
            tot += d > 0 ? d : 0;
        }
        const float sc = tot <= budget ? 1.0f : std::fmin(
            1.0f, (float)budget / std::fmax((float)tot, 1.0f));
        advance_row(w + p[i] * n, recv, send, n, (uint32_t)i, s1,
                    sc, tot <= budget, true);
    }
}

// Row minima of w into row_min (the convergence check for paths whose
// last sub-exchange cannot carry it, e.g. 'choice' scatters).
void acg_hostsim_rowmin(const int8_t* w, int64_t n, int32_t* row_min) {
    for (int64_t i = 0; i < n; ++i) {
        const int8_t* __restrict row = w + i * n;
        int32_t m = 127;
        for (int64_t j = 0; j < n; ++j)
            if (row[j] < m) m = row[j];
        row_min[i] = m;
    }
}

// Refresh owner diagonals: w[i, i] = mv[i] (gossip.py's diagonal refresh
// — a no-op for write-free runs after init, kept for fidelity).
void acg_hostsim_diag(int8_t* w, int64_t n, const int32_t* mv) {
    for (int64_t i = 0; i < n; ++i) {
        int32_t v = mv[i];
        w[i * n + i] = (int8_t)v;
    }
}

// Heartbeat diagonal refresh: hb[i, i] = heartbeat[i] (the hbv_vec
// select in sim_step — runs BEFORE the round-start copy the FD reads).
void acg_hostsim_diag_hb(int16_t* hb, int64_t n, const int32_t* hbv) {
    for (int64_t i = 0; i < n; ++i) {
        hb[i * n + i] = (int16_t)hbv[i];
    }
}

namespace {

// XLA's f32 -> bf16 convert (round-to-nearest-even). Values here are
// finite interval means, so no NaN handling is needed.
inline uint16_t f32_to_bf16(float f) {
    uint32_t x;
    __builtin_memcpy(&x, &f, 4);
    uint32_t lsb = (x >> 16) & 1u;
    x += 0x7FFFu + lsb;
    return (uint16_t)(x >> 16);
}

inline float bf16_to_f32(uint16_t b) {
    uint32_t x = ((uint32_t)b) << 16;
    float f;
    __builtin_memcpy(&f, &x, 4);
    return f;
}

}  // namespace

// One full phi-accrual FD round — the elementwise twin of
// gossip.py sim_step's failure-detector block (the branch with no
// churn and no lifecycle: the host fast-path domain). Per element
// (observer row i, owner j), every op mirrors one XLA f32/int op in the
// same order, so the result is bit-identical:
//   increased  = hb > hb0                       (post vs round-start)
//   never_seen = lc == 0
//   interval   = (f32)(tick - lc)
//   sampled    = increased & !never_seen & interval <= max_interval
//   icount'    = min(icount + sampled, window)          (int16)
//   imean'     = sampled ? imean + (interval - imean)/max((f32)icount', 1)
//                        : imean                        (f32 math)
//   lc'        = increased ? tick : lc
//   elapsed    = (f32)(tick - lc')
//   live       = icount' >= 1 &&
//                elapsed * ((f32)icount' + pw)
//                  <= phi * fmaf(imean', (f32)icount', pw_pm)
//                (the multiply-add rounded once: the header's C3 note)
//   live      |= (i == j)                       (self-belief diagonal)
//   imean_out  = live ? imean' : 0    (stored at fd dtype: f32 or bf16,
//                                      rounded AFTER the live test, as
//                                      XLA's .astype does)
//   icount_out = live ? icount' : 0
// pw/phi are the f32 casts of the config floats; pw_pm is
// f32(double(prior_weight) * double(prior_mean_ticks)) — the exact
// value XLA folds for its `pw * pm` scalar.
void acg_hostsim_fd(const int16_t* hb, const int16_t* hb0,
                    int16_t* lc, void* imean, int32_t imean_is_bf16,
                    int16_t* icount, uint8_t* live_view,
                    int64_t n, int32_t tick,
                    int32_t max_interval, int32_t window,
                    float pw, float pw_pm, float phi) {
    const int16_t tick16 = (int16_t)tick;
    for (int64_t i = 0; i < n; ++i) {
        const int16_t* __restrict hrow = hb + i * n;
        const int16_t* __restrict h0row = hb0 + i * n;
        int16_t* __restrict lrow = lc + i * n;
        int16_t* __restrict crow = icount + i * n;
        uint8_t* __restrict vrow = live_view + i * n;
        float* __restrict mrow_f32 =
            imean_is_bf16 ? nullptr : (float*)imean + i * n;
        uint16_t* __restrict mrow_bf16 =
            imean_is_bf16 ? (uint16_t*)imean + i * n : nullptr;
        for (int64_t j = 0; j < n; ++j) {
            const bool increased = hrow[j] > h0row[j];
            const int32_t lc_old = lrow[j];
            const int32_t interval_i = tick - lc_old;
            const bool sampled = increased && lc_old != 0 &&
                                 interval_i <= max_interval;
            int32_t cnt = (int32_t)crow[j] + (sampled ? 1 : 0);
            cnt = cnt < window ? cnt : window;
            float mean = mrow_bf16 ? bf16_to_f32(mrow_bf16[j])
                                   : mrow_f32[j];
            if (sampled) {
                const float interval = (float)interval_i;
                float denom = (float)cnt;
                denom = denom > 1.0f ? denom : 1.0f;
                mean = mean + (interval - mean) / denom;
            }
            const int16_t lc_new = increased ? tick16 : (int16_t)lc_old;
            const float elapsed = (float)(tick - (int32_t)lc_new);
            const float cnt_f = (float)cnt;
            bool live = cnt >= 1 &&
                        elapsed * (cnt_f + pw) <=
                            phi * std::fmaf(mean, cnt_f, pw_pm);
            live = live || i == j;
            lrow[j] = lc_new;
            crow[j] = live ? (int16_t)cnt : (int16_t)0;
            vrow[j] = live ? 1 : 0;
            const float mean_out = live ? mean : 0.0f;
            if (mrow_bf16) {
                mrow_bf16[j] = f32_to_bf16(mean_out);
            } else {
                mrow_f32[j] = mean_out;
            }
        }
    }
}

}  // extern "C"
