"""The CUDA kernels against their plain versions at small sizes, and the
kernel path of the simulator against its plain path. These need an
NVIDIA GPU with nvcc (Hopper, sm_90a): on a machine without one they
skip. On a GPU machine without JAX, skip the suite's conftest (it sets
JAX up): ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from aiocluster_torch import Simulator, SimConfig, full_config, lean_config
from aiocluster_torch.ops import counters, gossip, m8_pull, m8_totals, pairs_pull, pairs_totals, prng
from aiocluster_torch.ops import fd as fd_mod
from aiocluster_torch.ops.fd import FdParams
from aiocluster_torch.sim.packed import pack_bits
from aiocluster_torch.sim.state import STATE_FIELDS

pytestmark = pytest.mark.cuda

NARROW = dict(version_dtype="int16", heartbeat_dtype="int16", fd_dtype="bfloat16")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _operands(n, seed, wdt, hdt, imdt, dev, *, diag, check, fd, hb0):
    rng = np.random.default_rng(seed)
    to = lambda a, dt: torch.from_numpy(np.array(a)).to(dev, dt)  # noqa: E731
    gm, c, p = prng.grouped_matching(prng.key(seed), n)
    alive = rng.random(n) < 0.85
    valid = torch.from_numpy(alive) & torch.from_numpy(alive)[p]
    ops = dict(
        w=to(rng.integers(0, 50, (n, n)), wdt), hb=to(rng.integers(0, 30, (n, n)), hdt),
        gm=gm.to(dev, torch.int32), c=c.to(dev, torch.int32), valid=valid.to(dev),
    )
    kw = {}
    mv = to(rng.integers(40, 90, n), torch.int32)
    hbv = to(rng.integers(28, 31, n), torch.int32)
    if diag:
        kw.update(mv=mv, hbv=hbv)
    if check:
        kw["check"] = (mv, to(alive, torch.bool), to(rng.random(n) < 0.9, torch.bool))
    if fd:
        kw["hbv"] = hbv
        kw["fd"] = pairs_pull.FdOperands(
            31, to(rng.integers(0, 31, (n, n)), hdt), to(rng.random((n, n)) * 6, imdt),
            to(rng.integers(0, 12, (n, n)), torch.int16),
            torch.zeros((n, n), dtype=torch.bool, device=dev),
            to(rng.integers(0, 31, (n, n)), hdt) if hb0 else None,
            FdParams(10.0, 1000, 5.0, 16.5, 7.5),
        )
    return ops, kw


def _clone(ops, kw):
    ops = {k: None if v is None else v.clone() for k, v in ops.items()}
    kw = dict(kw)
    if "fd" in kw:
        f = kw["fd"]
        kw["fd"] = dataclasses.replace(
            f, lc=f.lc.clone(), im=f.im.clone(), ic=f.ic.clone(), live=f.live.clone(),
        )
    return ops, kw


def _run(fn, ops, kw):
    flag = fn(ops["w"], ops["hb"], ops["gm"], ops["c"], ops["valid"], 7, 0x12345678, 40, **kw)
    outs = [ops["w"]] + ([] if ops["hb"] is None else [ops["hb"]])
    if "fd" in kw:
        f = kw["fd"]
        outs += [f.lc, f.im, f.ic, f.live]
    return outs + ([flag] if flag is not None else [])


@pytest.mark.parametrize(
    "mode", [
        dict(diag=False, check=False, fd=False, hb0=False),
        dict(diag=True, check=False, fd=False, hb0=False),
        dict(diag=False, check=True, fd=True, hb0=True),
        dict(diag=True, check=True, fd=True, hb0=False),
    ],
)
@pytest.mark.parametrize(
    "rung", [(torch.int16, torch.int16, torch.bfloat16), (torch.int32, torch.int32, torch.float32)]
)
def test_pairs_kernel_equals_plain(dev, mode, rung):
    ops, kw = _operands(256, 3, *rung, dev, **mode)
    before = counters.kernel_launches("pairs_pull")
    got = _run(pairs_pull.pairs_pull, *_clone(ops, kw))
    assert counters.kernel_launches("pairs_pull") == before + 1
    want = _run(pairs_pull.pairs_pull_plain, ops, kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wdt", [torch.int16, torch.int32])
@pytest.mark.parametrize("diag", [False, True])
def test_pairs_totals_kernel_equals_plain(dev, wdt, diag):
    ops, kw = _operands(256, 5, wdt, wdt, torch.float32, dev, diag=diag, check=False,
                        fd=False, hb0=False)
    mv = kw.get("mv")
    before = counters.kernel_launches("pairs_totals")
    got = pairs_totals.pairs_totals(ops["w"], ops["gm"], ops["c"], ops["valid"], mv=mv)
    assert counters.kernel_launches("pairs_totals") == before + 1
    want = pairs_totals.pairs_totals_plain(ops["w"], ops["gm"], ops["c"], ops["valid"], mv=mv)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "mode", [
        dict(diag=False, check=False, fd=False, hb0=False),
        dict(diag=True, check=False, fd=False, hb0=False),
        dict(diag=False, check=True, fd=True, hb0=True),
        dict(diag=True, check=True, fd=False, hb0=False, lean=True),
    ],
)
def test_pairs_kernel_totals_mode_equals_plain_and_staged(dev, mode):
    """The totals mode (pass B) against its plain version and against the
    staged kernel on the same operands."""
    mode = dict(mode)
    lean = mode.pop("lean", False)
    ops, kw = _operands(256, 6, torch.int16, torch.int16, torch.bfloat16, dev, **mode)
    if lean:
        ops["hb"] = None
        kw.pop("hbv", None)
    kw["totals"] = pairs_totals.pairs_totals(
        ops["w"], ops["gm"], ops["c"], ops["valid"], mv=kw.get("mv"))
    before = counters.launches[pairs_pull.counter_key(
        mode["diag"], mode["check"], mode["fd"], totals=True)]
    got = _run(pairs_pull.pairs_pull, *_clone(ops, kw))
    assert counters.launches[pairs_pull.counter_key(
        mode["diag"], mode["check"], mode["fd"], totals=True)] == before + 1
    want = _run(pairs_pull.pairs_pull_plain, *_clone(ops, kw))
    staged_kw = dict(kw)
    del staged_kw["totals"]
    staged = _run(pairs_pull.pairs_pull, ops, staged_kw)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, staged, strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_fd_kernel_equals_plain(dev):
    n = 256
    rng = np.random.default_rng(4)
    to = lambda a, dt: torch.from_numpy(np.array(a)).to(dev, dt)  # noqa: E731

    def fresh():
        r = np.random.default_rng(5)
        return [to(r.integers(0, 31, (n, n)), torch.int16), to(r.random((n, n)) * 6, torch.bfloat16),
                to(r.integers(0, 12, (n, n)), torch.int16), torch.zeros((n, n), dtype=torch.bool, device=dev)]

    hb = to(rng.integers(0, 31, (n, n)), torch.int16)
    hb0 = to(rng.integers(0, 31, (n, n)), torch.int16)
    hbv = to(rng.integers(28, 31, n), torch.int32)
    params = FdParams(10.0, 1000, 5.0, 25.0, 8.0)
    a, b = fresh(), fresh()
    fd_mod.fused_fd(31, hb, hb0, hbv, *a, params)
    fd_mod.fused_fd_plain(31, hb, hb0, hbv, *b, params)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_simulator_kernel_path_equals_plain_path(dev):
    cfg = SimConfig(n_nodes=512, keys_per_node=4, fanout=3, budget=64, **NARROW)
    counters.reset()
    kern = Simulator(cfg, seed=2, device=dev)
    kern.run(5)
    assert counters.kernel_launches("pairs_pull") == 15 and not counters.plain_calls
    plain = Simulator(dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=False), seed=2, device=dev)
    plain.run(5)
    seam = Simulator(dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=True), seed=2, device=dev)
    seam.run(5)
    torch.cuda.synchronize()
    for f in STATE_FIELDS:
        assert torch.equal(getattr(kern.state, f), getattr(plain.state, f)), f
        assert torch.equal(getattr(seam.state, f), getattr(plain.state, f)), f
    assert counters.launches["fd"] == 5
    cpu = Simulator(cfg, seed=2, device="cpu")
    assert cpu.run_until_converged(100) == Simulator(cfg, seed=2, device=dev).run_until_converged(100)


def test_simulator_two_pass_path_equals_plain_path(dev, monkeypatch):
    """Rows that no block may stage (SMEM_LIMIT patched) run both passes
    on the card: 2 launches per sub-exchange, the plain path's states."""
    monkeypatch.setattr(pairs_pull, "SMEM_LIMIT", pairs_pull.STATIC_SMEM)
    for cfg in (
        SimConfig(n_nodes=512, keys_per_node=4, fanout=3, budget=64, **NARROW),
        SimConfig(n_nodes=512, fanout=3, budget=300, version_dtype="int16",
                  track_failure_detector=False, track_heartbeats=False),
    ):
        assert gossip.pull_phase_engaged(cfg, dev) == "pairs_two_pass"
        counters.reset()
        kern = Simulator(cfg, seed=3, device=dev)
        kern.run(5)
        assert counters.kernel_launches("pairs_pull") == 15
        assert counters.kernel_launches("pairs_totals") == 15
        assert not counters.plain_calls
        plain = Simulator(dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=False),
                          seed=3, device=dev)
        plain.run(5)
        torch.cuda.synchronize()
        for f in STATE_FIELDS:
            assert torch.equal(getattr(kern.state, f), getattr(plain.state, f)), f
        cpu = Simulator(cfg, seed=3, device="cpu")
        assert cpu.run_until_converged(100) == Simulator(cfg, seed=3, device=dev).run_until_converged(100)


@pytest.mark.parametrize("totals", [False, True], ids=["staged", "totals"])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("lean", [False, True], ids=["hb", "lean"])
@pytest.mark.parametrize("wdt", [torch.int16, torch.int32])
def test_m8_kernels_equal_plain(dev, wdt, lean, diag, totals):
    """The m8 pull (and, with totals, the m8 totals pass) against their
    plain versions, and against the staged pairs kernel on a copy of the
    same operands; then two column blocks of 128 owners pulled with the
    whole width's totals, side by side, against the whole width."""
    n = 256
    ops, kw = _operands(n, 9, wdt, wdt, torch.float32, dev, diag=diag, check=False,
                        fd=False, hb0=False)
    hb = None if lean else ops["hb"]
    mv = kw.get("mv")
    hbv = kw.get("hbv") if not lean else None
    args = (ops["gm"], ops["c"], ops["valid"], 7, 0x12345678, 40)
    tot = None
    if totals:
        before = counters.kernel_launches("m8_totals")
        tot = m8_totals.m8_totals(ops["w"], ops["gm"], ops["c"], ops["valid"], mv=mv)
        assert counters.kernel_launches("m8_totals") == before + 1
        assert torch.equal(tot, m8_totals.m8_totals_plain(
            ops["w"], ops["gm"], ops["c"], ops["valid"], mv=mv))
    before = counters.kernel_launches("m8_pull")
    got = m8_pull.m8_pull(ops["w"], hb, *args, mv=mv, hbv=hbv, totals=tot)
    assert counters.kernel_launches("m8_pull") == before + 1
    want = m8_pull.m8_pull_plain(ops["w"], hb, *args, mv=mv, hbv=hbv, totals=tot)
    got, want = ((x,) if lean else x for x in (got, want))
    staged = _clone(ops, {})[0]
    pairs_pull.pairs_pull(staged["w"], None if lean else staged["hb"], *args, mv=mv, hbv=hbv)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, (staged["w"], staged["hb"]), strict=False):
        assert torch.equal(a, b) and torch.equal(a, c)
    if totals:
        parts = []
        for col0 in (0, 128):
            cols = slice(col0, col0 + 128)
            bw = ops["w"][:, cols].contiguous()
            bhb = None if lean else ops["hb"][:, cols].contiguous()
            bmv = None if mv is None else mv[cols].contiguous()
            bhbv = None if hbv is None else hbv[cols].contiguous()
            part = m8_totals.m8_totals(bw, ops["gm"], ops["c"], ops["valid"], mv=bmv,
                                       owner_offset=col0)
            out = m8_pull.m8_pull(bw, bhb, *args, mv=bmv, hbv=bhbv, owner_offset=col0,
                                  totals=tot)
            parts.append((part, (out,) if lean else out))
        assert torch.equal(parts[0][0] + parts[1][0], tot)
        for k, whole in enumerate(got):
            assert torch.equal(torch.cat([o[k] for _, o in parts], dim=1), whole)


def _totals_operands(n, seed, wdt, dev, *, self_match, asymmetric):
    """Operands of one m8 totals pass: a grouped matching (with groups 0
    and 1 matched to themselves when ``self_match``, their old partners
    to each other), valid per pair (alive & alive[p]) or, ``asymmetric``,
    with a tenth of the rows flipped."""
    rng = np.random.default_rng(seed)
    gm, c, _ = prng.grouped_matching(prng.key(seed), n)
    gm, c = gm.clone(), c.clone()
    if self_match:
        a, b = int(gm[0]), int(gm[1])
        if a != 1:
            gm[a], gm[b] = b, a
            c[min(a, b)], c[max(a, b)] = 3, 5
        gm[0], gm[1] = 0, 1
        c[0], c[1] = 0, 4
    p = prng.rows_of_groups(gm.long(), c.long())
    assert torch.equal(p[p], torch.arange(n))
    alive = torch.from_numpy(rng.random(n) < 0.85)
    valid = alive & alive[p]
    if asymmetric:
        valid ^= torch.from_numpy(rng.random(n) < 0.1)
        assert (valid != valid[p]).any()
    w = torch.from_numpy(rng.integers(0, 50, (n, n))).to(dev, wdt)
    mv = torch.from_numpy(rng.integers(40, 90, n)).to(dev, torch.int32)
    return w, gm.to(dev, torch.int32), c.to(dev, torch.int32), valid.to(dev), mv


@pytest.mark.parametrize("self_match", [False, True], ids=["matched", "self-matched"])
@pytest.mark.parametrize("valid", ["pair", "asymmetric"])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("wdt", [torch.int16, torch.int32])
def test_m8_totals_kernel_equals_plain(dev, wdt, diag, valid, self_match):
    """The m8 totals kernel (one CTA per leader row, each direction masked
    by its own row's valid) against its plain version and against the
    pairs totals kernel (col0 = 0), and two column blocks whose totals sum
    to the whole width's. n = 2,304: a row is 288 loads of 8, more than
    the 256 threads of a CTA."""
    n = 2304
    w, gm, c, ok, mv = _totals_operands(
        n, 11 + diag, wdt, dev, self_match=self_match, asymmetric=valid == "asymmetric")
    mv = mv if diag else None
    before = counters.launches[m8_totals.counter_key(diag)]
    got = m8_totals.m8_totals(w, gm, c, ok, mv=mv)
    assert counters.launches[m8_totals.counter_key(diag)] == before + 1
    want = m8_totals.m8_totals_plain(w, gm, c, ok, mv=mv)
    pairs = pairs_totals.pairs_totals(w, gm, c, ok, mv=mv)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, pairs)
    half = n // 2
    summed = torch.zeros_like(got)
    for col0 in (0, half):
        cols = slice(col0, col0 + half)
        summed += m8_totals.m8_totals(w[:, cols].contiguous(), gm, c, ok,
                                      mv=None if mv is None else mv[cols].contiguous(),
                                      owner_offset=col0)
    torch.cuda.synchronize()
    assert torch.equal(summed, got)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("arith", ["i16", "i16_f32"])
def test_m8_int16_variants_equal_the_kernel(dev, arith, k):
    """The int16 variants on clusters of k CTAs against the int32 kernel
    and the plain version, on the experiment's ranges with a tenth of the
    rows invalid (some apart from their partner) and a self-matched
    group."""
    n = CLUSTER_N
    w, gm, c, valid, _ = _totals_operands(n, 2, torch.int16, dev, self_match=True,
                                          asymmetric=True)
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.integers(0, 2000, (n, n))).to(dev, torch.int16)
    hb = torch.from_numpy(rng.integers(0, 500, (n, n))).to(dev, torch.int16)
    args = (gm, c, valid, 3, 0xDEAD, 2618)
    want = m8_pull.m8_pull(w, hb, *args, cluster=k)
    plain = m8_pull.m8_pull_plain(w, hb, *args)
    key = m8_pull.counter_key(False, arith=arith, cluster=k > 1)
    before = counters.launches[key]
    got = m8_pull.m8_pull(w, hb, *args, arith=arith, cluster=k)
    assert counters.launches[key] == before + 1
    torch.cuda.synchronize()
    for a, b, p in zip(got, want, plain, strict=True):
        assert torch.equal(a, b) and torch.equal(a, p)


def test_simulator_m8_paths_equal_plain_path(dev, monkeypatch):
    """The pinned m8 forms on the card: 1 (staged by one CTA or a
    cluster) or 2 (two-pass) launches per sub-exchange, the FD phase
    through the standalone kernel, the plain path's states."""
    cfg = SimConfig(n_nodes=512, keys_per_node=4, fanout=3, budget=64, pallas_variant="m8",
                    **NARROW)
    plain = Simulator(dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=False),
                      seed=3, device=dev)
    plain.run(5)
    for form, limit in (("m8", None), ("m8_cluster", pairs_pull.STATIC_SMEM + 300),
                        ("m8_two_pass", pairs_pull.STATIC_SMEM)):
        if limit is not None:
            monkeypatch.setattr(pairs_pull, "SMEM_LIMIT", limit)
        assert gossip.pull_phase_engaged(cfg, dev) == form
        counters.reset()
        kern = Simulator(cfg, seed=3, device=dev)
        kern.run(5)
        torch.cuda.synchronize()
        assert counters.kernel_launches("m8_pull") == 15 and counters.launches["fd"] == 5
        assert counters.kernel_launches("m8_totals") == (15 if form == "m8_two_pass" else 0)
        assert all(("cluster" in key) == (form == "m8_cluster")
                   for key in counters.launches if key.startswith("m8_pull"))
        assert not counters.plain_calls
        for f in STATE_FIELDS:
            assert torch.equal(getattr(kern.state, f), getattr(plain.state, f)), f


def test_draws_on_the_device_equal_the_host(dev):
    key = prng.key(7)
    cfg = SimConfig(n_nodes=1024, fanout=3)
    on_dev = prng.chunk_draws(key.to(dev), 3, 4, cfg)
    on_cpu = prng.chunk_draws(key, 3, 4, cfg)
    for a, b in zip((on_dev.gm, on_dev.c, on_dev.p), (on_cpu.gm, on_cpu.c, on_cpu.p), strict=True):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


# -- the draws kernel (csrc/draws.cu) against the plain draws on CPU keys -----

DRAWS_CASES = [  # (lanes, rounds, first_tick, seed): each value twice per width
    (None, 1, 1, 0), (None, 8, 2**31 + 5, 2**32 - 1),
    (8, 1, 2**31 + 5, 0), (8, 8, 1, 2**32 - 1),
]


def _draws_keys(lanes, seed):
    if lanes is None:
        return prng.key(seed)
    return prng.keys([seed ^ s for s in range(lanes)])


def _assert_kernel_draws(key, first_tick, rounds, cfg, dev):
    counters.reset()
    got = prng.chunk_draws(key.to(dev), first_tick, rounds, cfg)
    assert counters.launches["draws[grouped]"] == 1 and not counters.plain_calls
    want = prng.chunk_draws(key, first_tick, rounds, cfg)
    for name in ("gm", "c", "p"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.device.type == "cuda" and a.dtype == torch.int32, name
        assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("n", [1024, 10_240, 100_352, 262_144])
@pytest.mark.parametrize("lanes, rounds, first_tick, seed", DRAWS_CASES)
def test_draws_kernel_equals_plain(dev, n, lanes, rounds, first_tick, seed):
    """One launch draws a chunk's grouped matchings bit for bit as the
    plain ops: one and two sort rounds (1,280 and 12,544 groups), the
    sort in one shared-memory tile and in two (32,768 groups, past the
    H100's tile of 16,384 slots), a key and 8 lanes, ticks past 2**31,
    seeds at both ends."""
    cfg = SimConfig(n_nodes=n, fanout=3)
    _assert_kernel_draws(_draws_keys(lanes, seed), first_tick, rounds, cfg, dev)


def _sort_key_ties(run_key, tick, fanout, n):
    """Per sub-exchange of round ``tick``, the sort rounds of its group
    permutation whose 32-bit sort keys collide."""
    _, peer = prng._round_keys(run_key, tick, 1)
    subs = prng._sub_keys(peer, fanout, run_key.shape[:-1])[0]
    g, out = n // 8, []
    for f in range(fanout):
        keys, hit = prng.split(subs[f])[0], []
        for r in range(prng.permutation_rounds(g)):
            keys, sub = prng.split(keys).unbind(-2)
            if torch.unique(prng.bits(sub, (g,))).numel() < g:
                hit.append(r)
        out.append(hit)
    return out


# Seed 13 at 262,144 nodes, tick 1: sub-exchange 2's sort keys collide in
# both rounds; seed 14: sub-exchange 0's in round 0, 1's in round 1.
TIE_N, TIE_SEEDS = 262_144, (13, 14)


def test_draws_tie_case_has_ties():
    """The premise of ``test_draws_kernel_sort_ties``, on the CPU."""
    assert _sort_key_ties(prng.key(13), 1, 3, TIE_N) == [[], [], [0, 1]]
    assert _sort_key_ties(prng.key(14), 1, 3, TIE_N) == [[0], [1], []]


def test_draws_kernel_sort_ties(dev):
    """Colliding sort keys keep their positions' order in the kernel's
    sort, as the stable sort does (``test_permutation_multi_round_sort_ties``
    holds the plain sort against JAX's)."""
    cfg = SimConfig(n_nodes=TIE_N, fanout=3)
    _assert_kernel_draws(prng.key(TIE_SEEDS[0]), 1, 1, cfg, dev)
    _assert_kernel_draws(prng.keys(TIE_SEEDS), 1, 1, cfg, dev)


def test_draws_kernel_tiled_sort(dev):
    """Past one tile the sort runs tile by tile through a global scratch:
    at 1,048,576 nodes (131,072 groups, 8 tiles of the H100's 16,384
    slots, three merges past a tile) the kernel still draws the plain
    ops' bits in one launch."""
    _assert_kernel_draws(prng.key(2**32 - 1), 3, 1, SimConfig(n_nodes=1_048_576, fanout=2), dev)


def test_draws_kernel_with_churn(dev):
    """With churn the flips stay plain beside the kernel's matchings: one
    launch and one plain chunk, both bit for bit the plain draws."""
    key, cfg = prng.key(5), SimConfig(n_nodes=1024, fanout=2, death_rate=0.01,
                                      revival_rate=0.02)
    counters.reset()
    got = prng.chunk_draws(key.to(dev), 4, 3, cfg)
    want = prng.chunk_draws(key, 4, 3, cfg)
    assert counters.launches["draws[grouped]"] == 1 and counters.plain_calls["draws"] == 1
    assert not counters.fallbacks
    for name in ("gm", "c", "p", "dies", "revives"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


def test_simulator_chunk_launches_one_draws_kernel(dev):
    """A Simulator's chunk of 8 rounds on the card draws its matchings in
    exactly one launch, and no chunk draws plain."""
    counters.reset()
    sim = Simulator(SimConfig(n_nodes=1024, fanout=3), seed=2, device=dev, chunk=8)
    sim.run(8)
    torch.cuda.synchronize()
    assert counters.launches["draws[grouped]"] == 1
    assert counters.plain_calls["draws"] == 0


# -- the memory ladder's rungs (int8, packed u4r, shrunk FD bookkeeping) ------

LADDER_N = 10_240  # the headline width
LADDER_MODES = {
    "first": dict(diag=True, check=False, fd=False, hb0=False),
    "middle": dict(diag=False, check=False, fd=False, hb0=False),
    "last": dict(diag=False, check=True, fd=True, hb0=True),
    "only": dict(diag=True, check=True, fd=True, hb0=False),
}


def _ladder_operands(n, seed, dev, *, wdt, hdt=None, imdt=torch.bfloat16, icdt=torch.int16,
                     bits=False, diag, check, fd, hb0):
    """Operands of one sub-exchange drawn on the card from ``seed``
    (``wdt`` "u4" is the packed rung; ``hdt`` None is the lean profile),
    with the FD bookkeeping at the given rung. Returns (ops, kw)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(lo, hi, shape, dt=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(dt)

    packed = wdt == "u4"
    gm, c, p = prng.grouped_matching(prng.key(seed), n)
    alive = torch.rand(n, generator=gen, device=dev) < 0.85
    ops = dict(
        w=draw(0, 256, (n, n // 2), torch.uint8) if packed else draw(0, 40, (n, n), wdt),
        hb=None if hdt is None else draw(0, 30, (n, n), hdt),
        gm=gm.to(dev, torch.int32), c=c.to(dev, torch.int32),
        valid=alive & alive[p.to(dev)],
    )
    kw = {}
    mv = draw(0, 4, (n,)) if packed else draw(30, 60, (n,))
    if diag:
        kw["mv"] = mv
        if hdt is not None:
            kw["hbv"] = draw(28, 31, (n,))
    if check:
        kw["check"] = (mv, alive, torch.rand(n, generator=gen, device=dev) < 0.9)
    if fd:
        kw["hbv"] = draw(28, 31, (n,))
        live = torch.rand((n, n), generator=gen, device=dev) < 0.5
        kw["fd"] = pairs_pull.FdOperands(
            31, draw(0, 31, (n, n), hdt),
            (torch.rand((n, n), generator=gen, device=dev) * 6).to(imdt),
            draw(0, 12, (n, n), icdt), pack_bits(live) if bits else live,
            draw(0, 31, (n, n), hdt) if hb0 else None, FdParams(10.0, 100, 5.0, 16.5, 7.5),
        )
    return ops, kw


def _with_totals(fn, ops, kw):
    kw = dict(kw, totals=fn(ops["w"], ops["gm"], ops["c"], ops["valid"], mv=kw.get("mv")))
    return ops, kw


LADDER_FD_RUNGS = {
    "deep": dict(wdt=torch.int8, hdt=torch.int8, icdt=torch.int8, bits=True),
    "shrunk": dict(wdt=torch.int16, hdt=torch.int16, icdt=torch.int8, bits=True),
    "i8w_i16hb": dict(wdt=torch.int8, hdt=torch.int16, imdt=torch.float32),
}


@pytest.mark.parametrize("form", ["staged", "two_pass"])
@pytest.mark.parametrize("mode", list(LADDER_MODES))
@pytest.mark.parametrize("rung", list(LADDER_FD_RUNGS))
def test_pairs_kernel_ladder_rungs_equal_plain(dev, rung, mode, form):
    """The int8 instances and the FD epilogue's int8 counters and live
    bitmap, staged and in the totals mode, at the headline width."""
    ops, kw = _ladder_operands(LADDER_N, 11, dev, **LADDER_FD_RUNGS[rung], **LADDER_MODES[mode])
    kern, plain = _clone(ops, kw), _clone(ops, kw)
    if form == "two_pass":
        kern = _with_totals(pairs_totals.pairs_totals, *kern)
        plain = _with_totals(pairs_totals.pairs_totals_plain, *plain)
    got = _run(pairs_pull.pairs_pull, *kern)
    want = _run(pairs_pull.pairs_pull_plain, *plain)
    torch.cuda.synchronize()
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["staged", "two_pass"])
@pytest.mark.parametrize("mode", ["first", "middle", "last"])
@pytest.mark.parametrize("wdt", [torch.int8, "u4"], ids=["int8", "u4r"])
def test_pairs_kernel_lean_ladder_equals_plain(dev, wdt, mode, form):
    """Lean int8 and the packed u4r codec (refresh = write bump + diagonal
    zero, the nibble check), staged and in the totals mode; the packed
    staged pull also equals the packed two-pass pull."""
    m = dict(LADDER_MODES[mode], fd=False, hb0=False)
    ops, kw = _ladder_operands(LADDER_N, 12, dev, wdt=wdt, **m)
    kern, plain = _clone(ops, kw), _clone(ops, kw)
    if form == "two_pass":
        kern = _with_totals(pairs_totals.pairs_totals, *kern)
        plain = _with_totals(pairs_totals.pairs_totals_plain, *plain)
    got = _run(pairs_pull.pairs_pull, *kern)
    want = _run(pairs_pull.pairs_pull_plain, *plain)
    other = _clone(ops, kw)
    if form == "staged":
        other = _with_totals(pairs_totals.pairs_totals, *other)
    else:
        other = (other[0], {k: v for k, v in other[1].items() if k != "totals"})
    third = _run(pairs_pull.pairs_pull, *other)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, third, strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("wdt", [torch.int8, "u4"], ids=["int8", "u4r"])
def test_pairs_totals_ladder_equals_plain(dev, wdt, diag):
    ops, kw = _ladder_operands(LADDER_N, 13, dev, wdt=wdt, diag=diag, check=False, fd=False,
                               hb0=False)
    args = (ops["w"], ops["gm"], ops["c"], ops["valid"])
    got = pairs_totals.pairs_totals(*args, mv=kw.get("mv"))
    want = pairs_totals.pairs_totals_plain(*args, mv=kw.get("mv"))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("totals", [False, True], ids=["staged", "totals"])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("hdt", [None, torch.int8], ids=["lean", "hb_int8"])
def test_m8_kernels_int8_equal_plain(dev, hdt, diag, totals):
    ops, kw = _ladder_operands(LADDER_N, 14, dev, wdt=torch.int8, hdt=hdt, diag=diag,
                               check=False, fd=False, hb0=False)
    args = (ops["w"], ops["hb"], ops["gm"], ops["c"], ops["valid"], 9, 77, 2618)
    tot = None
    if totals:
        targs = (ops["w"], ops["gm"], ops["c"], ops["valid"])
        tot = m8_totals.m8_totals(*targs, mv=kw.get("mv"))
        assert torch.equal(tot, m8_totals.m8_totals_plain(*targs, mv=kw.get("mv")))
    got = m8_pull.m8_pull(*args, mv=kw.get("mv"), hbv=kw.get("hbv"), totals=tot)
    want = m8_pull.m8_pull_plain(*args, mv=kw.get("mv"), hbv=kw.get("hbv"), totals=tot)
    torch.cuda.synchronize()
    for a, b in zip([got] if hdt is None else got, [want] if hdt is None else want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("imdt", [torch.bfloat16, torch.float32])
def test_fd_kernel_int8_heartbeats_equal_plain(dev, imdt):
    ops, kw = _ladder_operands(LADDER_N, 15, dev, wdt=torch.int8, hdt=torch.int8, imdt=imdt,
                               diag=False, check=False, fd=True, hb0=True)
    f = kw["fd"]

    def fresh():
        return [ops["hb"], f.hb0, kw["hbv"], f.lc.clone(), f.im.clone(), f.ic.clone(),
                f.live.clone()]

    a, b = fresh(), fresh()
    fd_mod.fused_fd(31, *a, f.params)
    fd_mod.fused_fd_plain(31, *b, f.params)
    torch.cuda.synchronize()
    for x, y in zip(a[3:], b[3:], strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("two_pass", [False, True], ids=["staged", "two_pass"])
@pytest.mark.parametrize("rung", ["lean_int8", "lean_u4r", "shrunk", "deep"])
def test_simulator_ladder_kernel_path_equals_plain_path(dev, rung, two_pass, monkeypatch):
    """Each rung's kernel path equals its plain path on the card after 6
    rounds, every sub-exchange through the kernels and nothing plain."""
    if two_pass:
        monkeypatch.setattr(pairs_pull, "SMEM_LIMIT", pairs_pull.STATIC_SMEM)
    if rung.startswith("lean"):
        cfg = lean_config(512, rung[5:], budget=64, keys_per_node=8)
    else:
        cfg = full_config(512, rung, budget=64, keys_per_node=8)
    counters.reset()
    kern = Simulator(cfg, seed=4, device=dev)
    kern.run(6)
    assert counters.kernel_launches("pairs_pull") == 18
    assert counters.kernel_launches("pairs_totals") == (18 if two_pass else 0)
    assert not counters.plain_calls and not counters.fallbacks
    plain = Simulator(dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=False), seed=4,
                      device=dev)
    plain.run(6)
    torch.cuda.synchronize()
    for f in STATE_FIELDS:
        assert torch.equal(getattr(kern.state, f), getattr(plain.state, f)), f
    assert Simulator(cfg, seed=4, device=dev).run_until_converged(100) == Simulator(
        cfg, seed=4, device="cpu").run_until_converged(100)


# -- the lane lift of a sweep ------------------------------------------------------

LANES = 3


def _lane_operands(n, seed, dev, **kw):
    """``_ladder_operands`` of LANES lanes stacked on a leading axis (lane
    1's alive-pair mask all 0: a voided sub-exchange), their salt_mix and
    per-lane phi."""
    lanes = [_ladder_operands(n, seed + s, dev, **kw) for s in range(LANES)]
    ops = {k: None if lanes[0][0][k] is None else torch.stack([o[k] for o, _ in lanes])
           for k in lanes[0][0]}
    ops["valid"][1] = False
    kw0 = lanes[0][1]
    lkw = {}
    for k in ("mv", "hbv"):
        if k in kw0:
            lkw[k] = torch.stack([k_[k] for _, k_ in lanes])
    if "check" in kw0:
        lkw["check"] = tuple(torch.stack([k_["check"][i] for _, k_ in lanes]) for i in range(3))
    if "fd" in kw0:
        f = [k_["fd"] for _, k_ in lanes]
        lkw["fd"] = dataclasses.replace(
            f[0], lc=torch.stack([x.lc for x in f]), im=torch.stack([x.im for x in f]),
            ic=torch.stack([x.ic for x in f]), live=torch.stack([x.live for x in f]),
            hb0=None if f[0].hb0 is None else torch.stack([x.hb0 for x in f]),
            phi=torch.tensor([7.0, 8.25, 9.5], device=dev),
        )
    salt = prng.salt_mix(torch.tensor([7, 2**31 + 5, 123], device=dev),
                         torch.tensor([0x12345678, 0, 0xFFFFFFFF], device=dev))
    return ops, lkw, salt


def _run_lanes(fn, ops, kw, salt):
    flag = fn(ops["w"], ops["hb"], ops["gm"], ops["c"], ops["valid"], salt, 40, **kw)
    outs = [ops["w"]] + ([] if ops["hb"] is None else [ops["hb"]])
    if "fd" in kw:
        f = kw["fd"]
        outs += [f.lc, f.im, f.ic, f.live]
    return outs + ([flag] if flag is not None else [])


LANE_CASES = {
    "first": dict(wdt=torch.int16, hdt=torch.int16, diag=True, check=False, fd=False, hb0=False),
    "middle": dict(wdt=torch.int16, hdt=torch.int16, diag=False, check=False, fd=False,
                   hb0=False),
    "check_fd": dict(wdt=torch.int16, hdt=torch.int16, diag=False, check=True, fd=True,
                     hb0=True),
    "shrunk_only": dict(wdt=torch.int16, hdt=torch.int16, icdt=torch.int8, bits=True,
                        diag=True, check=True, fd=True, hb0=False),
    "int8_lean": dict(wdt=torch.int8, diag=True, check=True, fd=False, hb0=False),
    "u4r": dict(wdt="u4", diag=True, check=True, fd=False, hb0=False),
}


@pytest.mark.parametrize("form", ["staged", "two_pass"])
@pytest.mark.parametrize("case", list(LANE_CASES))
def test_pairs_lanes_kernel_equals_plain(dev, case, form):
    """One lane launch of S = 3 lanes against the plain lane version, and
    each lane against the single-lane kernel on that lane's operands."""
    ops, kw, salt = _lane_operands(256, 21, dev, **LANE_CASES[case])
    kern, plain = _clone(ops, kw), _clone(ops, kw)
    single = _clone(ops, kw)
    if form == "two_pass":
        kern = _with_totals(pairs_totals.pairs_totals_lanes, *kern)
        plain = _with_totals(pairs_totals.pairs_totals_lanes_plain, *plain)
        torch.cuda.synchronize()
        assert torch.equal(kern[1]["totals"], plain[1]["totals"])
    counters.reset()
    got = _run_lanes(pairs_pull.pairs_pull_lanes, *kern, salt)
    assert counters.kernel_launches("pairs_pull") == 1
    assert all(k.startswith("pairs_pull[lanes") for k in counters.launches)
    want = _run_lanes(pairs_pull.pairs_pull_lanes_plain, *plain, salt)
    torch.cuda.synchronize()
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    s_ops, s_kw = single
    for s in range(LANES):
        kw_s = {k: v[s] for k, v in s_kw.items() if k in ("mv", "hbv")}
        if "check" in s_kw:
            kw_s["check"] = tuple(x[s] for x in s_kw["check"])
        if "fd" in s_kw:
            kw_s["fd"] = s_kw["fd"].lane(s)
        ops_s = {k: None if v is None else v[s] for k, v in s_ops.items()}
        if form == "two_pass":
            kw_s["totals"] = pairs_totals.pairs_totals(
                ops_s["w"], ops_s["gm"], ops_s["c"], ops_s["valid"], mv=kw_s.get("mv"))
        flag = pairs_pull.pairs_pull(
            ops_s["w"], ops_s["hb"], ops_s["gm"], ops_s["c"], ops_s["valid"],
            int(salt[s]) & prng.M32, 0, 40, **kw_s,
        )
        torch.cuda.synchronize()
        assert torch.equal(ops_s["w"], got[0][s])
        if flag is not None:
            assert int(flag[0]) == int(got[-1][s])


@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("wdt", [torch.int16, torch.int8, "u4"], ids=["int16", "int8", "u4r"])
def test_pairs_totals_lanes_kernel_equals_plain(dev, wdt, diag):
    ops, kw, _ = _lane_operands(256, 31, dev, wdt=wdt, diag=diag, check=False, fd=False,
                                hb0=False)
    args = (ops["w"], ops["gm"], ops["c"], ops["valid"])
    got = pairs_totals.pairs_totals_lanes(*args, mv=kw.get("mv"))
    want = pairs_totals.pairs_totals_lanes_plain(*args, mv=kw.get("mv"))
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not got[1].any()


@pytest.mark.parametrize("two_pass", [False, True], ids=["staged", "two_pass"])
def test_sweep_kernel_path_equals_sequential_runs(dev, two_pass, monkeypatch):
    """A sweep on the card (fanout, phi and write lanes, a fanout-0 lane):
    one lane launch a sub-exchange (two in two-pass), no plain call, and
    each lane equals its sequential run on the card."""
    from aiocluster_torch import SweepSimulator
    from aiocluster_torch.sim.state import lane

    if two_pass:
        monkeypatch.setattr(pairs_pull, "SMEM_LIMIT", pairs_pull.STATIC_SMEM)
    cfg = SimConfig(n_nodes=512, keys_per_node=4, fanout=3, budget=64, **NARROW)
    values = dict(fanout=[0, 2, 3], phi_threshold=[7.0, 8.0, 9.5], writes_per_round=[1, 0, 2])
    counters.reset()
    sweep = SweepSimulator(cfg, [1, 2, 3], device=dev, **values)
    sweep.run(6)
    torch.cuda.synchronize()
    assert counters.kernel_launches("pairs_pull") == 18 and not counters.plain_calls
    assert counters.kernel_launches("pairs_totals") == (18 if two_pass else 0)
    assert counters.launches["draws[grouped]"] == 1  # the one chunk of 6 rounds
    assert all("[lanes+" in k for k in counters.launches if not k.startswith("draws["))
    for s in range(3):
        seq = Simulator(dataclasses.replace(cfg, **{k: v[s] for k, v in values.items()}),
                        seed=s + 1, device=dev)
        seq.run(6)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(lane(sweep.states, s), f), getattr(seq.state, f)), (s, f)


# -- column blocks of the owners (the owner-sharded round) ------------------------

BLOCK_N, BLOCK_COLS = 512, 256
BLOCK_RUNGS = {
    "int16": dict(wdt=torch.int16, hdt=torch.int16),
    "lean_int16": dict(wdt=torch.int16),
    "lean_int8": dict(wdt=torch.int8),
    "lean_u4r": dict(wdt="u4"),
    "shrunk": dict(wdt=torch.int16, hdt=torch.int16, icdt=torch.int8, bits=True),
}


def _column_block(ops, kw, k):
    """Block k (owners k * BLOCK_COLS ..) of whole-width operands, each
    matrix's columns copied out, and the whole width's totals."""
    packed = ops["w"].dtype == torch.uint8
    cols = slice(k * BLOCK_COLS, (k + 1) * BLOCK_COLS)

    def cut(t, owners_a_column=1):
        step = BLOCK_COLS // owners_a_column
        return t[:, k * step : (k + 1) * step].contiguous()

    bops = dict(ops, w=cut(ops["w"], 2 if packed else 1),
                hb=None if ops["hb"] is None else cut(ops["hb"]))
    bkw = dict(kw, owner_offset=k * BLOCK_COLS)
    for name in ("mv", "hbv"):
        if name in kw:
            bkw[name] = kw[name][cols]
    if "check" in kw:
        need, alive, alive_owner = kw["check"]
        bkw["check"] = (need[cols], alive, alive_owner[cols])
    if "fd" in kw:
        f = kw["fd"]
        bkw["fd"] = dataclasses.replace(
            f, lc=cut(f.lc), im=cut(f.im), ic=cut(f.ic),
            live=cut(f.live, 8 if f.live.dtype == torch.uint8 else 1),
            hb0=None if f.hb0 is None else cut(f.hb0),
        )
    return bops, bkw


def _outs(ops, kw):
    """The matrices a pull writes, in ``_run``'s order."""
    outs = [ops["w"]] + ([] if ops["hb"] is None else [ops["hb"]])
    if "fd" in kw:
        f = kw["fd"]
        outs += [f.lc, f.im, f.ic, f.live]
    return outs


BLOCK_CASES = [(r, m) for r in BLOCK_RUNGS if r != "shrunk" for m in ("first", "middle", "last")]
BLOCK_CASES.append(("shrunk", "last"))


@pytest.mark.parametrize("rung, mode", BLOCK_CASES, ids=[f"{r}-{m}" for r, m in BLOCK_CASES])
def test_pairs_kernels_column_blocks_equal_plain(dev, rung, mode):
    """Each column block (owner_offset 0 and 256 of 512): the totals
    kernel's share equals its plain version and the shares sum to the
    whole width's; the pull fed the whole width's totals equals its
    plain version and, side by side, the whole-width kernel."""
    m = dict(LADDER_MODES[mode])
    if "hdt" not in BLOCK_RUNGS[rung]:
        m.update(fd=False, hb0=False)  # the lean profile
    ops, kw = _ladder_operands(BLOCK_N, 21, dev, **BLOCK_RUNGS[rung], **m)
    whole = _with_totals(pairs_totals.pairs_totals, *_clone(ops, kw))
    tot = whole[1]["totals"]
    _run(pairs_pull.pairs_pull, *whole)
    summed = torch.zeros_like(tot)
    for k in range(BLOCK_N // BLOCK_COLS):
        bops, bkw = _column_block(*_clone(ops, kw), k)
        args = (bops["w"], bops["gm"], bops["c"], bops["valid"])
        share = pairs_totals.pairs_totals(*args, mv=bkw.get("mv"), owner_offset=k * BLOCK_COLS)
        share_plain = pairs_totals.pairs_totals_plain(*args, mv=bkw.get("mv"),
                                                      owner_offset=k * BLOCK_COLS)
        assert torch.equal(share, share_plain)
        summed += share
        kern, plain = _clone(bops, dict(bkw, totals=tot)), _clone(bops, dict(bkw, totals=tot))
        got = _run(pairs_pull.pairs_pull, *kern)
        want = _run(pairs_pull.pairs_pull_plain, *plain)
        torch.cuda.synchronize()
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)
        for a, b in zip(_outs(*kern), _outs(*_column_block(*whole, k)), strict=True):
            assert torch.equal(a, b)
    assert torch.equal(summed, tot)


def test_fd_kernel_column_blocks_equal_plain(dev):
    """The standalone FD kernel at owner_offset 0 and 256 of 512: each
    block equals its plain version and the whole width's columns."""
    ops, kw = _ladder_operands(BLOCK_N, 23, dev, wdt=torch.int16, hdt=torch.int16,
                               diag=False, check=False, fd=True, hb0=True)
    f = kw["fd"]
    base = [ops["hb"], f.hb0, kw["hbv"], f.lc, f.im, f.ic.to(torch.int16), f.live]
    whole = [t.clone() for t in base]
    fd_mod.fused_fd(31, *whole, f.params)
    for k in range(BLOCK_N // BLOCK_COLS):
        cols = slice(k * BLOCK_COLS, (k + 1) * BLOCK_COLS)
        a = [(t[cols] if t.dim() == 1 else t[:, cols]).contiguous() for t in base]
        b = [t.clone() for t in a]
        fd_mod.fused_fd(31, *a, f.params, owner_offset=k * BLOCK_COLS)
        fd_mod.fused_fd_plain(31, *b, f.params, owner_offset=k * BLOCK_COLS)
        torch.cuda.synchronize()
        for x, y, z in zip(a[3:], b[3:], whole[3:], strict=True):
            assert torch.equal(x, y) and torch.equal(x, z[:, cols])


@pytest.mark.parametrize("profile, variant", [("full", "auto"), ("full", "m8"),
                                              ("lean_u4r", "auto")])
def test_two_block_mesh_round_equals_unsharded(dev, profile, variant):
    """A 2-block mesh on the card (the two-pass kernels at each block's
    offset; m8: the m8 column blocks and the FD kernel at each offset)
    equals the unsharded kernel path after 6 rounds and converges at its
    round."""
    from aiocluster_torch.parallel import make_mesh

    if profile == "full":
        cfg = full_config(BLOCK_N, budget=64, keys_per_node=8, pallas_variant=variant)
    else:  # the packed rung has no m8 kernel (the reference's XLA route)
        cfg = lean_config(BLOCK_N, "u4r", budget=64)
    mesh = make_mesh([dev] * 2)
    counters.reset()
    sim = Simulator(cfg, seed=5, mesh=mesh)
    sim.run(6)
    kernel = "m8_pull" if variant == "m8" else "pairs_pull"
    assert counters.kernel_launches(kernel) == 2 * 3 * 6
    assert not counters.plain_calls and not counters.fallbacks
    one = Simulator(cfg, seed=5, device=dev)
    one.run(6)
    torch.cuda.synchronize()
    for f in STATE_FIELDS:
        assert torch.equal(getattr(sim.state, f), getattr(one.state, f)), f
    assert Simulator(cfg, seed=5, mesh=mesh).run_until_converged(100) == Simulator(
        cfg, seed=5, device=dev).run_until_converged(100)


LANE_BLOCK_CASES = [("int16", "first"), ("int16", "middle"), ("int16", "check_fd"),
                    ("int8_lean", "last"), ("u4r", "last"), ("u4r", "first")]


def _lane_block(ops, kw, k):
    """Block k (owners k * BLOCK_COLS ..) of whole-width lane operands:
    ``_column_block`` with the lane axis leading."""
    packed = ops["w"].dtype == torch.uint8
    cols = slice(k * BLOCK_COLS, (k + 1) * BLOCK_COLS)

    def cut(t, owners_a_column=1):
        step = BLOCK_COLS // owners_a_column
        return t[..., k * step : (k + 1) * step].contiguous()

    bops = dict(ops, w=cut(ops["w"], 2 if packed else 1),
                hb=None if ops["hb"] is None else cut(ops["hb"]))
    bkw = dict(kw, owner_offset=k * BLOCK_COLS)
    for name in ("mv", "hbv"):
        if name in kw:
            bkw[name] = kw[name][:, cols].contiguous()
    if "check" in kw:
        need, alive, alive_owner = kw["check"]
        bkw["check"] = (need[:, cols].contiguous(), alive, alive_owner[:, cols].contiguous())
    if "fd" in kw:
        f = kw["fd"]
        bkw["fd"] = dataclasses.replace(
            f, lc=cut(f.lc), im=cut(f.im), ic=cut(f.ic),
            live=cut(f.live, 8 if f.live.dtype == torch.uint8 else 1),
            hb0=None if f.hb0 is None else cut(f.hb0),
        )
    return bops, bkw


@pytest.mark.parametrize("rung, mode", LANE_BLOCK_CASES,
                         ids=[f"{r}-{m}" for r, m in LANE_BLOCK_CASES])
def test_pairs_lanes_column_blocks_equal_plain(dev, rung, mode):
    """The lane launches at an owner offset (S = 3 lanes, blocks of 256 of
    512, lane 1 voided): each block's lane totals equal their plain
    version and sum to the whole width's; each block's lane pull fed the
    sums equals its plain version and the whole-width lane launch on its
    columns, the flags too."""
    base = dict(LANE_CASES[rung if rung != "int16" else mode])
    base.update(LADDER_MODES["last" if mode == "check_fd" else mode])
    if rung != "int16":
        base.update(fd=False, hb0=False)
    if mode == "check_fd":
        base.update(fd=True, hb0=True)
    ops, kw, salt = _lane_operands(BLOCK_N, 41, dev, **base)
    whole = _with_totals(pairs_totals.pairs_totals_lanes, *_clone(ops, kw))
    tot = whole[1]["totals"]
    whole_out = _run_lanes(pairs_pull.pairs_pull_lanes, *whole, salt)
    summed = torch.zeros_like(tot)
    flags = []
    for k in range(BLOCK_N // BLOCK_COLS):
        bops, bkw = _lane_block(*_clone(ops, kw), k)
        args = (bops["w"], bops["gm"], bops["c"], bops["valid"])
        share = pairs_totals.pairs_totals_lanes(*args, mv=bkw.get("mv"),
                                                owner_offset=k * BLOCK_COLS)
        share_plain = pairs_totals.pairs_totals_lanes_plain(*args, mv=bkw.get("mv"),
                                                            owner_offset=k * BLOCK_COLS)
        assert torch.equal(share, share_plain)
        summed += share
        kern, plain = _clone(bops, dict(bkw, totals=tot)), _clone(bops, dict(bkw, totals=tot))
        got = _run_lanes(pairs_pull.pairs_pull_lanes, *kern, salt)
        want = _run_lanes(pairs_pull.pairs_pull_lanes_plain, *plain, salt)
        torch.cuda.synchronize()
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)
        for a, b in zip(_outs(*kern), _outs(*_lane_block(*whole, k)), strict=True):
            assert torch.equal(a, b)
        if "check" in bkw:
            flags.append(got[-1])
    assert torch.equal(summed, tot)
    if flags:
        assert torch.equal(torch.minimum(*flags), whole_out[-1])


def test_mesh_sweep_and_a_world_of_one_on_the_card(dev):
    """A sweep on a 2-block mesh of the card (a lane totals and a lane pull
    launch a block a sub-exchange) equals the unsharded sweep; a world of
    one rank over NCCL holding 2 blocks equals the single-process mesh."""
    import subprocess
    import sys

    from aiocluster_torch import SweepSimulator
    from aiocluster_torch.parallel import make_mesh

    cfg = SimConfig(n_nodes=BLOCK_N, keys_per_node=4, fanout=3, budget=64, **NARROW)
    values = dict(phi_threshold=[7.0, 8.0, 9.5], writes_per_round=[1, 0, 2])
    counters.reset()
    sharded = SweepSimulator(cfg, [1, 2, 3], mesh=make_mesh([dev] * 2), **values)
    sharded.run(6)
    torch.cuda.synchronize()
    assert counters.kernel_launches("pairs_pull") == 2 * 18 and not counters.plain_calls
    assert counters.kernel_launches("pairs_totals") == 2 * 18
    flat = SweepSimulator(cfg, [1, 2, 3], device=dev, **values)
    flat.run(6)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(sharded.states, f), getattr(flat.states, f)), f
    code = (
        "import socket, sys, torch; sys.path.insert(0, '.')\n"
        "from aiocluster_torch import SimConfig, Simulator\n"
        "from aiocluster_torch.parallel import multihost\n"
        "s = socket.socket(); s.bind(('127.0.0.1', 0)); port = s.getsockname()[1]; s.close()\n"
        "multihost.initialize(f'127.0.0.1:{port}', 1, 0)\n"
        f"cfg = SimConfig(n_nodes={BLOCK_N}, keys_per_node=4, fanout=3, budget=64, "
        "version_dtype='int16', heartbeat_dtype='int16', fd_dtype='bfloat16')\n"
        "sim = Simulator(cfg, seed=5, mesh=multihost.global_mesh(['cuda:0'] * 2))\n"
        "print(sim.run_until_converged(100), int(sim.state.w.to(torch.int64).sum()))\n"
    )
    root = __import__("pathlib").Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=root).stdout.split()
    one = Simulator(cfg, seed=5, mesh=make_mesh([dev] * 2))
    assert int(out[0]) == one.run_until_converged(100)
    assert int(out[1]) == int(one.state.w.to(torch.int64).sum())


def test_mesh_over_distinct_cards_equals_one_card(dev):
    """With two or more cards, a mesh over distinct devices (the
    collectives copy each block's partials to the first card and back)
    equals the one-card mesh."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from aiocluster_torch.parallel import make_mesh

    cfg = full_config(BLOCK_N, budget=64, keys_per_node=8)
    a = Simulator(cfg, seed=6, mesh=make_mesh(["cuda:0", "cuda:1"]))
    b = Simulator(cfg, seed=6, mesh=make_mesh(["cuda:0"] * 2))
    assert a.blocks[1].w.device == torch.device("cuda:1")
    a.run(5)
    b.run(5)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


# -- the cluster frame: a row pair staged by a cluster of CTAs -----------------

# 2,192 owners: 274 int16 chunks a row (more than the 256 threads of a
# CTA at k = 1) and 137 packed ones, which no cluster size divides evenly.
CLUSTER_N = 2192
CLUSTER_CASES = {
    "first": dict(wdt=torch.int16, hdt=torch.int16, diag=True, check=False, fd=False, hb0=False),
    "middle": dict(wdt=torch.int16, hdt=torch.int16, diag=False, check=False, fd=False,
                   hb0=False),
    "check": dict(wdt=torch.int16, diag=False, check=True, fd=False, hb0=False),
    "fd_hb0": dict(wdt=torch.int16, hdt=torch.int16, diag=False, check=True, fd=True,
                   hb0=True),
    "int8": dict(wdt=torch.int8, hdt=torch.int8, diag=True, check=True, fd=True, hb0=False),
    "int16_lean": dict(wdt=torch.int16, diag=True, check=True, fd=False, hb0=False),
    "int32": dict(wdt=torch.int32, hdt=torch.int32, imdt=torch.float32, diag=True, check=True,
                  fd=True, hb0=True),
    "packed": dict(wdt="u4", diag=True, check=True, fd=False, hb0=False),
    "shrunk": dict(wdt=torch.int16, hdt=torch.int16, icdt=torch.int8, bits=True, diag=False,
                   check=True, fd=True, hb0=True),
}


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(CLUSTER_CASES))
def test_pairs_cluster_form_equals_plain(dev, case, k):
    """The staged pull on a cluster of k CTAs (forced) against its plain
    version, counted under its cluster key; with the check, a converged
    pair (need 0) keeps the flag at 1 across every CTA of the clusters."""
    m = dict(CLUSTER_CASES[case])
    ops, kw = _ladder_operands(CLUSTER_N, 40 + k, dev, **m)
    packed = m["wdt"] == "u4"
    key = pairs_pull.counter_key(m["diag"], m["check"], m["fd"], packed=packed,
                                 cluster=k > 1)
    before = counters.launches[key]
    got = _run(lambda *a, **o: pairs_pull.pairs_pull(*a, cluster=k, **o), *_clone(ops, kw))
    assert counters.launches[key] == before + 1
    want = _run(pairs_pull.pairs_pull_plain, *_clone(ops, kw))
    torch.cuda.synchronize()
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    if m["check"]:
        need, alive, alive_owner = kw.pop("check")
        kw = {k: v for k, v in kw.items() if k not in ("mv", "fd")}
        kw["check"] = (torch.zeros_like(need), alive, alive_owner)
        if packed:  # a packed row passes where every residual is 0
            ops["w"].zero_()
        flag = _run(lambda *a, **o: pairs_pull.pairs_pull(*a, cluster=k, **o), ops, kw)[-1]
        assert int(flag[0]) == 1


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("case", ["check_fd", "int8_lean", "u4r"])
def test_pairs_lanes_cluster_form_equals_plain(dev, case, k):
    """The lane launch (S = 3, lane 1 voided) on clusters of k CTAs
    against the plain lane version."""
    ops, kw, salt = _lane_operands(CLUSTER_N, 51, dev, **LANE_CASES[case])
    counters.reset()
    got = _run_lanes(lambda *a, **o: pairs_pull.pairs_pull_lanes(*a, cluster=k, **o),
                     *_clone(ops, kw), salt)
    assert counters.kernel_launches("pairs_pull") == 1
    assert all(key.startswith("pairs_pull[lanes+cluster") for key in counters.launches)
    want = _run_lanes(pairs_pull.pairs_pull_lanes_plain, *_clone(ops, kw), salt)
    torch.cuda.synchronize()
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rung", ["full", "lean_u4r", "sweep"])
def test_simulator_cluster_path_equals_plain_path(dev, rung, monkeypatch):
    """A block limit small enough that one CTA cannot stage a pair at 512
    owners sends the round through the cluster form (one launch a
    sub-exchange, no totals pass), equal to the plain path after 6
    rounds."""
    from aiocluster_torch import SweepSimulator
    from aiocluster_torch.sim.state import lane

    monkeypatch.setattr(pairs_pull, "SMEM_LIMIT", pairs_pull.STATIC_SMEM + 300)
    if rung == "lean_u4r":
        cfg = lean_config(512, "u4r", budget=64, keys_per_node=8)
    else:
        cfg = full_config(512, budget=64, keys_per_node=8)
    assert gossip.pull_phase_engaged(cfg, dev) == "pairs_cluster"
    counters.reset()
    if rung == "sweep":
        sim = SweepSimulator(cfg, [1, 2], device=dev, phi_threshold=[7.0, 9.0])
        sim.run(6)
        states = [lane(sim.states, s) for s in range(2)]
    else:
        sim = Simulator(cfg, seed=4, device=dev)
        sim.run(6)
        states = [sim.state]
    assert counters.kernel_launches("pairs_pull") == 18
    assert counters.launches["draws[grouped]"] == 1  # the one chunk of 6 rounds
    assert all("cluster" in key for key in counters.launches if not key.startswith("draws["))
    assert not counters.plain_calls and not counters.fallbacks
    for s, state in enumerate(states):
        plain_cfg = dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=False)
        if rung == "sweep":
            plain_cfg = dataclasses.replace(plain_cfg, phi_threshold=[7.0, 9.0][s])
        plain = Simulator(plain_cfg, seed=s + 1 if rung == "sweep" else 4, device=dev)
        plain.run(6)
        torch.cuda.synchronize()
        for f in STATE_FIELDS:
            assert torch.equal(getattr(state, f), getattr(plain.state, f)), (s, f)


# -- the m8 pull in the pair frame, and the 1-byte totals ----------------------

M8_CLUSTER_CASES = {
    # name: (w dtype, hb dtype or None, diag)
    "i16 hb diag": (torch.int16, torch.int16, True),
    "i16 hb": (torch.int16, torch.int16, False),
    "i16 lean diag": (torch.int16, None, True),
    "i32 hb diag": (torch.int32, torch.int32, True),
    "i32 lean": (torch.int32, None, False),
    "i8 hb diag": (torch.int8, torch.int8, True),
    "i8 lean": (torch.int8, None, False),
}


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(M8_CLUSTER_CASES))
def test_m8_cluster_form_equals_plain(dev, case, k):
    """The staged m8 pull on a cluster of k CTAs (forced) against its
    plain version and the pairs pull on a copy of the same operands, with
    a self-matched group and valid flipped on a tenth of the rows (so some
    rows are valid apart from their partner, and some pairs have no valid
    row): every output row written, the inputs untouched, counted under
    its cluster key. 2,192 owners: no cluster size divides a row's chunks
    evenly."""
    wdt, hdt, diag = M8_CLUSTER_CASES[case]
    n = CLUSTER_N
    w, gm, c, valid, mv = _totals_operands(n, 60 + k, wdt, dev, self_match=True,
                                           asymmetric=True)
    rng = np.random.default_rng(61 + k)
    hb = None if hdt is None else torch.from_numpy(rng.integers(0, 30, (n, n))).to(dev, hdt)
    kw = {}
    if diag:
        kw["mv"] = mv if wdt != torch.int8 else mv.clamp(max=100)
        if hb is not None:
            kw["hbv"] = torch.from_numpy(rng.integers(28, 31, n)).to(dev, torch.int32)
    args = (gm, c, valid, 5, 0x2468ACE, 40)
    w0, hb0 = w.clone(), None if hb is None else hb.clone()
    key = m8_pull.counter_key(diag, cluster=k > 1)
    before = counters.launches[key]
    got = m8_pull.m8_pull(w, hb, *args, cluster=k, **kw)
    assert counters.launches[key] == before + 1
    want = m8_pull.m8_pull_plain(w, hb, *args, **kw)
    pw, phb = w.clone(), None if hb is None else hb.clone()
    pairs_pull.pairs_pull(pw, phb, *args, **kw)
    torch.cuda.synchronize()
    got, want = ((x,) if hb is None else x for x in (got, want))
    for a, b, pp in zip(got, want, (pw, phb), strict=False):
        assert torch.equal(a, b) and torch.equal(a, pp)
    assert torch.equal(w, w0) and (hb is None or torch.equal(hb, hb0))


@pytest.mark.parametrize("wdt", [torch.int8, torch.int16])
def test_m8_totals_form_column_blocks_equal_plain(dev, wdt):
    """The totals-fed m8 pull on two column blocks (owner offsets 0 and
    1,024 of 2,192; self-matched rows, asymmetric valid) against the plain
    version at the same offsets and, side by side, the whole width; any
    cluster but 1 is refused with totals."""
    n = CLUSTER_N
    w, gm, c, valid, mv = _totals_operands(n, 71, wdt, dev, self_match=True, asymmetric=True)
    mv = mv.clamp(max=100)
    hb = torch.from_numpy(np.random.default_rng(72).integers(0, 30, (n, n))).to(dev, wdt)
    hbv = torch.full((n,), 29, dtype=torch.int32, device=dev)
    args = (gm, c, valid, 5, 0x2468ACE, 40)
    tot = m8_totals.m8_totals(w, gm, c, valid, mv=mv)
    whole = m8_pull.m8_pull(w, hb, *args, mv=mv, hbv=hbv, totals=tot)
    with pytest.raises(ValueError, match="no cluster"):
        m8_pull.m8_pull(w, hb, *args, mv=mv, hbv=hbv, totals=tot, cluster=2)
    outs = []
    for col0, width in ((0, 1024), (1024, n - 1024)):
        cols = slice(col0, col0 + width)
        block = (w[:, cols].contiguous(), hb[:, cols].contiguous())
        bkw = dict(mv=mv[cols].contiguous(), hbv=hbv[cols].contiguous(), owner_offset=col0,
                   totals=tot)
        got = m8_pull.m8_pull(*block, *args, **bkw)
        want = m8_pull.m8_pull_plain(*block, *args, **bkw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
        outs.append(got)
    for k, x in enumerate(whole):
        assert torch.equal(torch.cat([o[k] for o in outs], dim=1), x)


# Row bytes 0 and 8 mod 16: int8 at 2,192 and 2,184 owners, packed at
# 2,176 and 2,192 (1,088 and 1,096 bytes); the last ends a row on a half
# step and its rows are not 16-byte aligned.
NARROW_TOTALS_N = {"int8": (2192, 2184), "u4r": (2176, 2192)}


@pytest.mark.parametrize("half", [False, True], ids=["whole_steps", "half_step"])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("rung", ["int8", "u4r"])
def test_pairs_totals_narrow_modes_equal_plain(dev, rung, diag, half):
    """The 1-byte totals modes (16 bytes a row a step, SIMD bytes) against
    their plain versions with a self-matched group and asymmetric valid:
    whole width (the m8 totals too on int8), two column blocks summing to
    it, and 3 lanes (the middle one voided) against the plain lanes."""
    n = NARROW_TOTALS_N[rung][half]
    packed = rung == "u4r"
    w, gm, c, valid, _ = _totals_operands(n, 81 + half, torch.int8, dev, self_match=True,
                                          asymmetric=True)
    rng = np.random.default_rng(82 + half)
    if packed:
        w = torch.from_numpy(rng.integers(0, 256, (n, n // 2), dtype=np.uint8)).to(dev)
        mv = torch.from_numpy(rng.integers(0, 20, n)).to(dev, torch.int32)  # write bumps
    else:
        w = torch.from_numpy(rng.integers(0, 128, (n, n), dtype=np.int8)).to(dev)
        mv = torch.from_numpy(rng.integers(0, 128, n)).to(dev, torch.int32)
    mv = mv if diag else None
    key = pairs_totals.counter_key(diag, packed)
    before = counters.launches[key]
    got = pairs_totals.pairs_totals(w, gm, c, valid, mv=mv)
    assert counters.launches[key] == before + 1
    want = pairs_totals.pairs_totals_plain(w, gm, c, valid, mv=mv)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool((got > 0).any())
    if not packed:
        assert torch.equal(m8_totals.m8_totals(w, gm, c, valid, mv=mv), want)
    split = 1024
    summed = torch.zeros_like(got)
    for col0, width in ((0, split), (split, n - split)):
        cols = slice(col0 // 2, (col0 + width) // 2) if packed else slice(col0, col0 + width)
        block = w[:, cols].contiguous()
        bmv = None if mv is None else mv[col0:col0 + width].contiguous()
        part = pairs_totals.pairs_totals(block, gm, c, valid, mv=bmv, owner_offset=col0)
        assert torch.equal(part, pairs_totals.pairs_totals_plain(block, gm, c, valid, mv=bmv,
                                                                owner_offset=col0))
        summed += part
    torch.cuda.synchronize()
    assert torch.equal(summed, got)
    lanes = 3
    lw = torch.stack([w, torch.roll(w, 1, dims=1), torch.roll(w, 2, dims=0)])
    lgm, lc = gm.expand(lanes, -1).contiguous(), c.expand(lanes, -1).contiguous()
    lvalid = torch.stack([valid, torch.zeros_like(valid), valid.roll(3)])
    lmv = None if mv is None else torch.stack([mv, mv.roll(1), mv.roll(2)])
    lgot = pairs_totals.pairs_totals_lanes(lw, lgm, lc, lvalid, mv=lmv)
    lwant = pairs_totals.pairs_totals_lanes_plain(lw, lgm, lc, lvalid, mv=lmv)
    torch.cuda.synchronize()
    assert torch.equal(lgot, lwant) and not bool(lgot[1].any())


# -- the round's remaining semantics on the card (churn, the other pairings,
# greedy, the lifecycle): the kernels on post-churn masks, the standalone FD
# kernel beside the plain pulls, and the plain routes' ops against the CPU.


def test_pairs_kernel_under_churn_equals_plain(dev):
    """Churn (alive changing between rounds) through the pairs kernels with
    the fused FD and the check equals the plain round on the card every
    round, and nothing falls back."""
    cfg = SimConfig(n_nodes=1024, keys_per_node=8, budget=48, writes_per_round=1,
                    death_rate=0.05, revival_rate=0.2, **NARROW)
    counters.reset()
    kern = Simulator(cfg, seed=3, device=dev, chunk=4)
    plain = Simulator(dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=False), seed=3,
                      device=dev, chunk=4)
    alive = []
    for _ in range(8):
        kern.run(1)
        plain.run(1)
        torch.cuda.synchronize()
        for f in STATE_FIELDS:
            assert torch.equal(getattr(kern.state, f), getattr(plain.state, f)), f
        alive.append(kern.state.alive.clone())
    assert counters.kernel_launches("pairs_pull") == 8 * 3
    assert not counters.fallbacks and not counters.refusals
    assert any(not torch.equal(a, b) for a, b in zip(alive, alive[1:]))


def test_fd_kernel_on_a_choice_round_off_the_lane_width(dev):
    """A choice round at n = 1,000 (n % 128 != 0): the plain pulls with
    the standalone FD kernel (fd.cu takes any multiple of 8 owners) equal
    the all-plain round, one FD launch a round, the reference's reason
    counted."""
    cfg = SimConfig(n_nodes=1000, keys_per_node=8, budget=48, pairing="choice",
                    death_rate=0.05, revival_rate=0.2)
    counters.reset()
    kern = Simulator(cfg, seed=4, device=dev)
    plain = Simulator(dataclasses.replace(cfg, use_pallas_fd=False), seed=4, device=dev)
    kern.run(6)
    plain.run(6)
    torch.cuda.synchronize()
    for f in STATE_FIELDS:
        assert torch.equal(getattr(kern.state, f), getattr(plain.state, f)), f
    assert counters.launches["fd"] == 6
    assert counters.fallbacks == {"pairing": 12}


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_scatter_max_in_each_matrix_dtype(dev, dtype):
    """The responder's scatter-max on the card equals the CPU's in every
    watermark and heartbeat dtype, rows hit many times included."""
    rng = np.random.default_rng(5)
    top = torch.iinfo(dtype).max
    dst = torch.from_numpy(rng.integers(0, top, (512, 256))).to(dtype)
    rows = torch.from_numpy(rng.integers(0, 64, 2048))
    src = torch.from_numpy(rng.integers(0, top, (2048, 256))).to(dtype)
    want = gossip.scatter_max_rows_(dst.clone(), rows, src)
    got = gossip.scatter_max_rows_(dst.to(dev), rows.to(dev), src.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and not torch.equal(want, dst)


def test_plain_routes_on_the_card_equal_the_cpu(dev):
    """The draws (uniform, categorical, the adjacency slot), the float32
    log of the view draw and whole rounds of every new plain route (the
    view draw under churn and the lifecycle, greedy, permutation, the
    unrestricted matching, a scale-free topology) give the same bits on
    the card as on the CPU."""
    from aiocluster_torch.models import scale_free

    key = prng.key(7)
    alive = torch.from_numpy(np.random.default_rng(7).random(700) < 0.6)
    assert torch.equal(prng.categorical(key.to(dev), alive.to(dev), 3).cpu(),
                       prng.categorical(key, alive, 3))
    u = torch.linspace(1e-12, 1 - 2.0**-24, 1 << 20)
    assert torch.equal(gossip.xla_log(u.to(dev)).cpu(), gossip.xla_log(u))
    base = dict(n_nodes=320, keys_per_node=6, fanout=3, budget=16, writes_per_round=1)
    topo = scale_free(320, 3, seed=1)
    for kw, top in (
        (dict(pairing="choice", peer_mode="view", death_rate=0.1, revival_rate=0.1,
              dead_grace_ticks=4), None),
        (dict(pairing="choice", budget_policy="greedy", death_rate=0.1, revival_rate=0.2),
         None),
        (dict(pairing="permutation", **NARROW), None),
        (dict(**NARROW), None),
        (dict(pairing="choice"), topo),
    ):
        cfg = SimConfig(**base, **kw)
        on_dev = Simulator(cfg, seed=2, device=dev, topology=top)
        on_cpu = Simulator(cfg, seed=2, device="cpu", topology=top)
        on_dev.run(8)
        on_cpu.run(8)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(on_dev.state, f).cpu(), getattr(on_cpu.state, f)), (kw, f)


# -- fault plans and heterogeneity on the card: cadence classes in the
# kernels' pair validity, and a faulted round's plain pulls beside fd.cu.


@pytest.mark.parametrize("variant", ["pairs", "m8"])
def test_cadence_kernels_equal_plain(dev, variant):
    """Cadence classes fold into the pair validity of the pairs (fused FD
    and check) and m8 kernels: every round equals the plain round on the
    card, three pull launches a round, no plain pull and no fallback."""
    from aiocluster_torch.models import Heterogeneity

    het = Heterogeneity(gossip_every=(1, 3, 4), class_frac=(0.25, 0.5, 0.25))
    cfg = SimConfig(n_nodes=1024, keys_per_node=8, budget=48, writes_per_round=1,
                    heterogeneity=het, pallas_variant=variant, **NARROW)
    counters.reset()
    kern = Simulator(cfg, seed=5, device=dev, chunk=4)
    plain = Simulator(dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=False), seed=5,
                      device=dev, chunk=4)
    for _ in range(8):
        kern.run(1)
        plain.run(1)
        torch.cuda.synchronize()
        for f in STATE_FIELDS:
            assert torch.equal(getattr(kern.state, f), getattr(plain.state, f)), f
    assert counters.kernel_launches(f"{variant}_pull") == 8 * 3
    # Every plain pull is the plain run's: 3 a round.
    assert not counters.fallbacks and counters.plain_calls["pull"] == 8 * 3
    assert "m8_pull" not in counters.plain_calls


def test_faulted_rounds_on_the_card_equal_the_cpu(dev):
    """A plan with a partition, flaky links, an amnesiac crash window and
    the byzantine storm: the plain pulls and fd.cu (one launch a round) on
    the card equal the CPU's rounds field for field, counted under the
    reference's reason "fault_plan"; the quarantined choice draw and zone
    bias give the CPU's peers."""
    from aiocluster_torch.faults import (
        FaultPlan, LinkFault, NodeCrash, NodeSet, Partition, byzantine_storm,
    )
    from aiocluster_torch.models import Heterogeneity

    plan = FaultPlan(
        links=(LinkFault(drop=0.2),), partitions=(Partition(n_groups=3, end=3.0),),
        crashes=(NodeCrash(nodes=NodeSet(frac=(0.0, 0.3)), at=1.0, down_for=2.0),),
        byzantine=byzantine_storm(0.25).byzantine,
    )
    cfg = SimConfig(n_nodes=512, keys_per_node=8, budget=32, writes_per_round=1,
                    fault_plan=plan, **NARROW)
    counters.reset()
    on_dev = Simulator(cfg, seed=6, device=dev)
    on_cpu = Simulator(cfg, seed=6, device="cpu")
    on_dev.run(6)
    on_cpu.run(6)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(on_dev.state, f).cpu(), getattr(on_cpu.state, f)), f
    assert counters.launches["fd"] == 6 and counters.fallbacks["fault_plan"] == 6
    q = SimConfig(n_nodes=512, pairing="choice", quarantine=True, quarantine_open_after=0,
                  heterogeneity=Heterogeneity(zones=4, zone_bias=0.5),
                  fault_plan=FaultPlan(links=(LinkFault(dst=NodeSet(frac=(0.0, 0.1)), drop=1.0),)))
    alive = torch.ones(512, dtype=torch.bool)
    got = prng.chunk_draws(prng.key(8).to(dev), 1, 3, q, alive=alive.to(dev)).peers
    assert torch.equal(got.cpu(), prng.chunk_draws(prng.key(8), 1, 3, q, alive=alive).peers)


def test_checkpoint_telemetry_and_simcluster_on_the_card(dev, tmp_path):
    """A run on the card saved at tick 5 resumes on the card and on the
    CPU to equal states; its telemetry series (stride 2) closes at the
    final tick with the last sample equal to ``metrics()``; a SimCluster
    on the card runs a write/kill/revive script equal to the CPU's."""
    from aiocluster_torch import MetricsRegistry, SimCluster

    cfg = SimConfig(n_nodes=256, keys_per_node=8, budget=32, **NARROW)
    counters.reset()
    sim = Simulator(cfg, seed=4, device=dev, metrics=MetricsRegistry(), metrics_stride=2,
                    chunk=2)
    sim.run(5)
    sim.save(tmp_path / "c.npz")
    assert counters.kernel_launches("pairs_pull") == 5 * 3
    on_dev = Simulator.resume(tmp_path / "c.npz", device=dev)
    on_cpu = Simulator.resume(tmp_path / "c.npz", device="cpu")
    for s in (sim, on_dev, on_cpu):
        s.run(3)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(on_dev.state, f), getattr(sim.state, f)), f
        assert torch.equal(getattr(on_dev.state, f).cpu(), getattr(on_cpu.state, f)), f
    series = sim.flush_metrics()
    assert [s["tick"] for s in series] == [2, 4, 7, 8]  # chunk boundaries crossing a stride
    assert {k: float(v) for k, v in sim.metrics().items()}.items() <= series[-1].items()

    def script(sc):
        sc.run_until_converged(200)
        sc.set("node-3", "a", "1")
        sc.delete("node-3", "key-0000")
        sc.kill("node-7")
        sc.step(4)
        sc.revive("node-7")
        sc.step(2)
        return sc.tick, sc.replica_view("node-9", "node-3"), sc.live_view("node-9"), sc.compact()

    card, cpu = SimCluster(cfg, seed=2, device=dev), SimCluster(cfg, seed=2, device="cpu")
    assert script(card) == script(cpu)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(card.sim.state, f).cpu(), getattr(cpu.sim.state, f)), f


def test_twin_replay_and_autotune_on_the_card_equal_the_cpu(dev, tmp_path):
    """The twin on the card: a 1,024-node replay (through the pairs
    kernels) and an autotune (the lane launches) equal the CPU runs."""
    from aiocluster_torch import twin
    from aiocluster_torch.core import Config, NodeId
    from tools.twin_trace import write_twin_trace

    path = write_twin_trace(tmp_path / "t.jsonl", n_nodes=1024, rounds=40, seed=4)
    trace = twin.load_runtime_trace(path)
    counters.reset()
    card = twin.replay(trace, seed=1, device=dev)
    assert counters.kernel_launches("pairs_pull") > 0 and not counters.plain_calls
    cpu = twin.replay(trace, seed=1, device="cpu")
    assert card.to_dict() == cpu.to_dict()
    strip = lambda series: [{k: v for k, v in s.items() if k != "step_seconds"} for s in series]  # noqa: E731
    assert strip(card.sim_series) == strip(cpu.sim_series)
    cal = twin.fit_calibration(cpu)
    base = Config(node_id=NodeId(name="op", generation_id=1))
    cfg = twin.lift_sim_config(trace, n_nodes=512)
    grid = dict(fanout=[2, 3], phi_threshold=[8.0, 4.0])
    counters.reset()
    on_card = twin.autotune(twin.SLO(3600.0, 0.5), cal, base, cfg, device=dev, **grid)
    assert counters.kernel_launches("pairs_pull") > 0 and not counters.plain_calls
    on_cpu = twin.autotune(twin.SLO(3600.0, 0.5), cal, base, cfg, device="cpu", **grid)
    assert on_card.to_dict() == on_cpu.to_dict()


def test_host_simulator_equals_a_card_run(dev):
    """The native host simulator against the card's kernel path, round by
    round (w by value), and a card state handed to the host and back."""
    from aiocluster_torch.sim import hostsim

    cfg = full_config(512, budget=24)
    card = Simulator(cfg, seed=3, chunk=1, device=dev)
    host = hostsim.HostSimulator(cfg, seed=3)
    for r in range(1, 9):
        card.run(1)
        host.run(1)
        got = host.state()
        for f in STATE_FIELDS:
            assert torch.equal(getattr(got, f), getattr(card.state, f).cpu()), (r, f)
    back = Simulator(cfg, seed=3, chunk=1, device=dev, state=host.state(dev))
    back.run(2)
    card.run(2)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(back.state, f), getattr(card.state, f)), f
