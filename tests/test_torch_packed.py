"""The packed rungs' codec, the plain packed sub-exchange and the plain
FD epilogue on the shrunk bookkeeping (int8 sample counters, the live
bitmap) equal the reference: the codec helpers ``aiocluster_tpu.sim.packed``,
its byte-space XLA pieces, and its Pallas pairs kernels run in interpret
mode with ``packed`` w and ``fd_live_bits``. Tolerance 0 throughout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aiocluster_tpu.ops import gossip as ref_gossip
from aiocluster_tpu.ops.pallas_pull import fused_pull_pairs, fused_pull_pairs_totals
from aiocluster_tpu.sim import packed as ref_packed
from aiocluster_torch.ops import gossip, pairs_pull, pairs_totals, prng
from aiocluster_torch.ops.fd import FdParams
from aiocluster_torch.sim import packed

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)

SALT, RUN_SALT, TICK = 11, 0x9E3779B9, 31
N = 256  # the reference's packed kernel needs a 256-multiple width


class _State:
    """The fields the widen helpers read, as attributes."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


# -- the codec ------------------------------------------------------------------


@pytest.mark.parametrize("shape, hi", [((6, 10), 16), ((3, 4, 8), 40), ((1, 256), 99)])
def test_u4_codec_equals_reference(shape, hi):
    """pack_u4 (saturating above 15) and unpack_u4, byte for byte."""
    v = np.random.default_rng(hi).integers(-3, hi, shape, dtype=np.int32)
    got = packed.pack_u4(torch.from_numpy(v))
    want = np.asarray(ref_packed.pack_u4(jnp.asarray(v)))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(packed.unpack_u4(got).numpy(), np.asarray(ref_packed.unpack_u4(want)))
    assert packed.is_packed_w(got) and not packed.is_packed_w(torch.from_numpy(v))


@pytest.mark.parametrize("shape", [(5, 16), (2, 3, 64)])
def test_bit_codec_equals_reference(shape):
    m = np.random.default_rng(len(shape)).random(shape) < 0.5
    got = packed.pack_bits(torch.from_numpy(m))
    want = np.asarray(ref_packed.pack_bits(jnp.asarray(m)))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(packed.unpack_bits(got).numpy(), m)
    assert np.array_equal(packed.unpack_bits(got).numpy(), np.asarray(ref_packed.unpack_bits(want)))
    assert packed.is_packed_live(got) and not packed.is_packed_live(torch.from_numpy(m))


def test_widen_helpers_equal_reference():
    rng = np.random.default_rng(4)
    n = 64
    mv = rng.integers(0, 16, n).astype(np.int32)
    r = np.minimum(rng.integers(0, 16, (n, n)), mv[None, :]).astype(np.int32)
    w = np.asarray(ref_packed.pack_u4(jnp.asarray(r)))
    live = np.asarray(ref_packed.pack_bits(jnp.asarray(rng.random((n, n)) < 0.5)))
    im = rng.random((n, n)).astype(np.float32)
    ref = _State(w=jnp.asarray(w), max_version=jnp.asarray(mv), live_view=jnp.asarray(live))
    port = _State(w=torch.from_numpy(w.copy()), max_version=torch.from_numpy(mv),
                  live_view=torch.from_numpy(live.copy()))
    assert np.array_equal(packed.watermarks_i32(port).numpy(),
                          np.asarray(ref_packed.watermarks_i32(ref)))
    assert np.array_equal(packed.watermarks_i32(port, rows=slice(3, 9)).numpy(),
                          np.asarray(ref_packed.watermarks_i32(ref))[3:9])
    assert np.array_equal(packed.residuals_u4(port).numpy(), np.asarray(ref_packed.residuals_u4(ref)))
    assert np.array_equal(packed.live_view_bool(port).numpy(),
                          np.asarray(ref_packed.live_view_bool(ref)))
    assert np.array_equal(packed.imean_f32(torch.from_numpy(im).to(torch.bfloat16)).numpy(),
                          np.asarray(ref_packed.imean_f32(jnp.asarray(im, jnp.bfloat16))))
    with pytest.raises(ValueError):
        packed.residuals_u4(_State(w=torch.zeros((2, 2), dtype=torch.int16)))


# -- the byte-space pieces --------------------------------------------------------


@pytest.mark.parametrize("budget", [1, 9, 64, 4096])
def test_packed_math_equals_reference(budget):
    """_packed_adv_halves, _packed_apply, _packed_diag_zero and
    _packed_writes_shift on random residual rows."""
    n = 128
    rng = np.random.default_rng(budget)
    r = rng.integers(0, 256, (n, n // 2)).astype(np.uint8)
    r_peer = rng.integers(0, 256, (n, n // 2)).astype(np.uint8)
    valid = rng.random(n) < 0.8
    bump = rng.integers(0, 20, n).astype(np.int32)
    owners = jnp.arange(n, dtype=jnp.int32)
    a_lo, a_hi = ref_gossip._packed_adv_halves(
        jnp.asarray(r), jnp.asarray(r_peer), budget, jnp.asarray(valid), None,
        jnp.asarray(SALT, jnp.int32), owners, jnp.asarray(RUN_SALT, jnp.uint32),
    )
    t = torch.from_numpy
    g_lo, g_hi = gossip.packed_adv_halves(
        t(r), t(r_peer), budget, t(valid), SALT, torch.arange(n), RUN_SALT,
    )
    assert np.array_equal(g_lo.numpy(), np.asarray(a_lo))
    assert np.array_equal(g_hi.numpy(), np.asarray(a_hi))
    want = ref_gossip._packed_apply(jnp.asarray(r), a_lo, a_hi)
    assert np.array_equal(gossip.packed_apply(t(r), g_lo, g_hi).numpy(), np.asarray(want))
    want = ref_gossip._packed_diag_zero(jnp.asarray(r), owners, n)
    got = gossip.packed_diag_zero_(t(r).clone(), torch.arange(n))
    assert np.array_equal(got.numpy(), np.asarray(want))
    want = ref_gossip._packed_writes_shift(jnp.asarray(r), jnp.asarray(bump), owners)
    assert np.array_equal(gossip.packed_writes_shift(t(r), t(bump)).numpy(), np.asarray(want))


# -- the pairs kernels' packed and shrunk-FD modes ----------------------------------


def _matching(seed, n=N):
    gm, c, p = prng.grouped_matching(prng.key(seed), n)
    return gm.numpy().astype(np.int32), c.numpy().astype(np.int32), p.numpy()


def _packed_case(seed, n=N):
    rng = np.random.default_rng(seed)
    gm, c, p = _matching(seed, n)
    alive = rng.random(n) < 0.85
    return dict(
        w=rng.integers(0, 256, (n, n // 2)).astype(np.uint8), gm=gm, c=c,
        valid=alive & alive[p], alive=alive, owner_alive=rng.random(n) < 0.9,
        bump=rng.integers(0, 4, n).astype(np.int32),
        mv=rng.integers(8, 16, n).astype(np.int32),
    )


@pytest.mark.parametrize(
    "diag, check, totals",
    [(True, False, False), (False, False, False), (False, True, False),
     (True, True, True), (False, False, True)],
    ids=["first", "middle", "last", "only_two_pass", "middle_two_pass"],
)
def test_plain_packed_pull_equals_interpret_kernel(diag, check, totals):
    """The packed sub-exchange (write-bump refresh and diagonal zero on
    the first, the nibble check on the last, the totals input of the
    two-pass form) against the reference's interpreted packed kernel;
    the totals also against its interpreted packed totals pass."""
    case = _packed_case(seed=3 + 2 * diag + check + 4 * totals)
    j = {k: jnp.asarray(v) for k, v in case.items()}
    t = {k: torch.from_numpy(np.array(v)) for k, v in case.items()}
    rkw, pkw = {}, {}
    if diag:
        rkw["mv"], pkw["mv"] = j["bump"], t["bump"]
    if check:
        rkw["check"] = (j["mv"], j["alive"], j["owner_alive"])
        pkw["check"] = (t["mv"], t["alive"], t["owner_alive"])
    if totals:
        want_tot = fused_pull_pairs_totals(
            j["w"], j["gm"], j["c"], j["valid"], interpret=True, mv=rkw.get("mv"))
        got_tot = pairs_totals.pairs_totals(t["w"], t["gm"], t["c"], t["valid"], mv=pkw.get("mv"))
        assert np.array_equal(got_tot.numpy(), np.asarray(want_tot))
        rkw["totals"], pkw["totals"] = want_tot, got_tot
    out = fused_pull_pairs(
        j["w"], None, j["gm"], j["c"], j["valid"], jnp.asarray(SALT, jnp.int32),
        jnp.asarray(RUN_SALT, jnp.uint32), 40, interpret=True, **rkw,
    )
    w = t["w"]
    flag = pairs_pull.pairs_pull(w, None, t["gm"], t["c"], t["valid"], SALT, RUN_SALT, 40, **pkw)
    if check:
        out, want_flag = out
        assert int(flag[0]) == int(want_flag)
    assert np.array_equal(w.numpy(), np.asarray(out))


def test_packed_check_passes_when_caught_up():
    case = _packed_case(seed=9)
    case["w"] = np.zeros_like(case["w"])
    t = {k: torch.from_numpy(np.array(v)) for k, v in case.items()}
    flag = pairs_pull.pairs_pull(
        t["w"], None, t["gm"], t["c"], t["valid"], SALT, RUN_SALT, 40,
        check=(t["mv"], t["alive"], t["owner_alive"]),
    )
    assert int(flag[0]) == 1


@pytest.mark.parametrize(
    "rung, hb0",
    [(("int8", "int8", "bfloat16"), True), (("int16", "int16", "bfloat16"), False),
     (("int8", "int16", "float32"), True)],
    ids=["deep_hb0", "shrunk", "int8w_int16hb"],
)
def test_plain_shrunk_fd_epilogue_equals_interpret_kernel(rung, hb0):
    """The fused FD epilogue on int8 sample counters and the live bitmap
    (the reference's ``fd_live_bits``), after the w+hb pull, against the
    reference's interpreted kernel: every output, the bitmap byte for
    byte."""
    wdt, hdt, imdt = rung
    rng = np.random.default_rng(len(wdt) + hb0)
    gm, c, p = _matching(5)
    alive = rng.random(N) < 0.85
    case = dict(
        w=rng.integers(0, 50, (N, N)).astype(wdt), hb=rng.integers(0, TICK, (N, N)).astype(hdt),
        gm=gm, c=c, valid=alive & alive[p], alive=alive, owner_alive=rng.random(N) < 0.9,
        mv=rng.integers(40, 90, N).astype(np.int32),
        hbv=rng.integers(TICK - 2, TICK + 1, N).astype(np.int32),
        lc=rng.integers(0, TICK, (N, N)).astype(hdt),
        ic=rng.integers(0, 101, (N, N)).astype(np.int8),  # up to the window
        hb0=rng.integers(0, TICK, (N, N)).astype(hdt),
    )
    im = (rng.random((N, N)) * 6).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in case.items()}
    t = {k: torch.from_numpy(np.array(v)) for k, v in case.items()}
    consts = (10.0, 100, 5.0, 3.3)
    out = fused_pull_pairs(
        j["w"], j["hb"], j["gm"], j["c"], j["valid"], jnp.asarray(SALT, jnp.int32),
        jnp.asarray(RUN_SALT, jnp.uint32), 40, interpret=True, hbv=j["hbv"],
        check=(j["mv"], j["alive"], j["owner_alive"]),
        fd=(jnp.asarray(TICK, jnp.int32), j["lc"], jnp.asarray(im, imdt), j["ic"],
            j["hb0"] if hb0 else None, 7.5),
        fd_params=consts + (True,),
    )
    want, want_flag = out
    port_imdt = torch.bfloat16 if imdt == "bfloat16" else torch.float32
    fd = pairs_pull.FdOperands(
        TICK, t["lc"], torch.from_numpy(im).to(port_imdt), t["ic"],
        torch.zeros((N, N // 8), dtype=torch.uint8), t["hb0"] if hb0 else None,
        FdParams(10.0, 100, 5.0, 5.0 * 3.3, 7.5),
    )
    flag = pairs_pull.pairs_pull(
        t["w"], t["hb"], t["gm"], t["c"], t["valid"], SALT, RUN_SALT, 40, hbv=t["hbv"],
        check=(t["mv"], t["alive"], t["owner_alive"]), fd=fd,
    )
    got = [t["w"], t["hb"], fd.lc, fd.im, fd.ic, fd.live]
    assert int(flag[0]) == int(want_flag)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a, b = a.view(np.uint16), b.view(torch.int16).numpy().view(np.uint16)
        else:
            b = b.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_shrunk_fd_plain_block_equals_reference_xla():
    """The standalone plain FD block with int8 counters stores the bitmap
    the reference's XLA block packs (the route off the pairs path)."""
    from aiocluster_torch.ops import fd as fd_mod

    rng = np.random.default_rng(8)
    n = 64
    hb = rng.integers(0, TICK, (n, n)).astype(np.int8)
    hb0 = rng.integers(0, TICK, (n, n)).astype(np.int8)
    hbv = rng.integers(TICK - 2, TICK + 1, n).astype(np.int32)
    lc = rng.integers(0, TICK, (n, n)).astype(np.int8)
    im = (rng.random((n, n)) * 6).astype(np.float32)
    ic = rng.integers(0, 100, (n, n)).astype(np.int8)
    # The reference's FD math through its shared update, then its XLA
    # block's self diagonal, death wipe and bitmap packing.
    eye = np.eye(n, dtype=bool)
    h0 = np.where(eye, hbv[None, :], hb0).astype(np.int32)
    from aiocluster_tpu.ops.pallas_pull import fd_update as ref_fd_update
    lc2, mean, count, live = ref_fd_update(
        jnp.asarray(TICK, jnp.int32), jnp.asarray(hb, jnp.int32), jnp.asarray(h0),
        jnp.asarray(lc, jnp.int32), jnp.asarray(im), jnp.asarray(ic, jnp.int32),
        max_interval=10.0, window=100, prior_weight=5.0, prior_mean=3.3, phi=7.5,
    )
    live = np.asarray(live) | eye
    t = torch.from_numpy
    lc_t, im_t, ic_t = t(lc.copy()), t(im.copy()), t(ic.copy())
    live_t = torch.zeros((n, n // 8), dtype=torch.uint8)
    fd_mod.fused_fd_plain(TICK, t(hb), t(hb0), t(hbv), lc_t, im_t, ic_t, live_t,
                          FdParams(10.0, 100, 5.0, 5.0 * 3.3, 7.5))
    assert np.array_equal(lc_t.numpy(), np.asarray(lc2).astype(np.int8))
    assert np.array_equal(im_t.numpy(), np.where(live, np.asarray(mean), 0.0).astype(np.float32))
    assert np.array_equal(ic_t.numpy(), np.where(live, np.asarray(count), 0).astype(np.int8))
    assert np.array_equal(live_t.numpy(), np.asarray(jax.device_get(ref_packed.pack_bits(jnp.asarray(live)))))
