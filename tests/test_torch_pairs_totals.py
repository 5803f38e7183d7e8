"""The two-pass pair-fused pull: the deficit-totals pass and the pull's
totals mode (the CPU sides of the CUDA kernels' wrappers) equal the
reference's Pallas kernels run in interpret mode; the two-pass form
equals the staged one; the simulator on the two-pass path follows the
reference round by round; ``lean_config`` is the reference's; and the
convergence reductions over blocks of rows give the reference's values.
Tolerance 0 throughout, except where float sums are taken in another
order (stated where it applies)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from aiocluster_tpu.ops.gossip import all_converged_flag as ref_flag
from aiocluster_tpu.ops.gossip import convergence_metrics as ref_metrics
from aiocluster_tpu.ops.gossip import sim_step as ref_step
from aiocluster_tpu.ops.pallas_pull import fused_pull_pairs_totals
from aiocluster_tpu.sim import SimConfig as RefConfig
from aiocluster_tpu.sim import Simulator as RefSimulator
from aiocluster_tpu.sim.memory import lean_config as ref_lean_config
from aiocluster_tpu.sim.state import init_state as ref_init
from aiocluster_torch import Simulator, SimConfig, lean_config
from aiocluster_torch.ops import counters, gossip, pairs_pull, pairs_totals, prng
from aiocluster_torch.ops.fd import FdParams
from aiocluster_torch.sim.state import init_state
from test_torch_pairs_pull import MODES, _case, _np, _port, _reference
from test_torch_sim import NARROW, _assert_states_equal

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# -- pass A: the deficit totals ---------------------------------------------------


@pytest.mark.parametrize(
    "wdt, diag, self_match",
    [
        ("int16", True, False),
        ("int16", False, False),
        ("int32", True, False),
        ("int32", False, True),
        ("int16", True, True),
    ],
)
def test_plain_totals_equals_interpret_kernel(wdt, diag, self_match):
    case = _case(128, seed=11 + diag + 2 * self_match, wdt=wdt, hdt="int16",
                 imdt="bfloat16", self_match=self_match)
    want = fused_pull_pairs_totals(
        jnp.asarray(case["w"]), jnp.asarray(case["gm"]), jnp.asarray(case["c"]),
        jnp.asarray(case["valid"]), interpret=True,
        mv=jnp.asarray(case["mv"]) if diag else None,
    )
    before = counters.plain_calls["totals"]
    got = pairs_totals.pairs_totals(
        _t(case["w"]), _t(case["gm"]), _t(case["c"]), _t(case["valid"]),
        mv=_t(case["mv"]) if diag else None,
    )
    assert counters.plain_calls["totals"] == before + 1  # CPU: the plain version
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    if self_match:  # rows matched to themselves lack nothing
        p = prng.rows_of_groups(_t(case["gm"]).long(), _t(case["c"]).long())
        assert (got[p == torch.arange(128)] == 0).all()


# -- pass B: the pull fed the totals ---------------------------------------------

TOTALS_MODES = dict(MODES, lean=dict(diag=True, check=True, fd=False, hb0=False))


@pytest.mark.parametrize("mode", sorted(TOTALS_MODES))
def test_plain_pull_with_totals_equals_interpret_kernel(mode):
    """Arbitrary totals (some zero, most binding at budget 40): each row's
    scale must come from its own total, both directions of a pair."""
    m = TOTALS_MODES[mode]
    lean = mode == "lean"
    wdt, hdt, imdt = ("int32", "int32", "float32") if mode == "diag" else (
        "int16", "int16", "bfloat16")
    case = _case(128, seed=20 + len(mode), wdt=wdt, hdt=hdt, imdt=imdt)
    rng = np.random.default_rng(len(mode))
    totals = rng.integers(0, 3000, 128).astype(np.float32)
    totals[::7] = 0.0
    want, want_flag = _reference(case, budget=40, totals=totals, lean=lean, **m)
    got, got_flag = _port(case, budget=40, totals=totals, lean=lean, **m)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        assert np.array_equal(a, _np(b))
    if m["check"]:
        assert int(want_flag) == int(got_flag[0])


@pytest.mark.parametrize("fed_totals", [False, True], ids=["staged", "two_pass"])
@pytest.mark.parametrize("mode", sorted(TOTALS_MODES))
def test_plain_versions_in_row_blocks(mode, fed_totals, monkeypatch):
    """Three row pairs per block (an uneven last block, self-matched
    groups among them): the plain totals and the plain pull, as each
    block is written back in place, still equal the reference's
    interpreted kernels."""
    monkeypatch.setattr(gossip, "ROW_BLOCK_ELEMS", 2 * 128 * 3)
    m = TOTALS_MODES[mode]
    lean = mode == "lean"
    case = _case(128, seed=40 + len(mode), wdt="int16", hdt="int16", imdt="bfloat16",
                 self_match=True)
    totals = None
    if fed_totals:
        mv = case["mv"] if m["diag"] else None
        want_t = fused_pull_pairs_totals(
            jnp.asarray(case["w"]), jnp.asarray(case["gm"]), jnp.asarray(case["c"]),
            jnp.asarray(case["valid"]), interpret=True,
            mv=None if mv is None else jnp.asarray(mv),
        )
        got_t = pairs_totals.pairs_totals(
            _t(case["w"]), _t(case["gm"]), _t(case["c"]), _t(case["valid"]),
            mv=None if mv is None else _t(mv),
        )
        totals = np.asarray(want_t)
        assert np.array_equal(got_t.numpy(), totals)
    want, want_flag = _reference(case, budget=40, totals=totals, lean=lean, **m)
    got, got_flag = _port(case, budget=40, totals=totals, lean=lean, **m)
    for a, b in zip(want, got, strict=True):
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        assert np.array_equal(a, _np(b))
    if m["check"]:
        assert int(want_flag) == int(got_flag[0])


def _operands(case, lean):
    t = {k: _t(v) for k, v in case.items() if k != "imdt"}
    return t, (None if lean else t["hb"])


@pytest.mark.parametrize("mode", sorted(TOTALS_MODES))
def test_two_pass_equals_staged(mode):
    """Pass A's totals fed to pass B give the staged pull's bits: the same
    function in two launches."""
    m = TOTALS_MODES[mode]
    lean = mode == "lean"
    case = _case(256, seed=30 + len(mode), wdt="int16", hdt="int16", imdt="bfloat16")
    outs = []
    for two_pass in (False, True):
        t, hb = _operands(case, lean)
        kw = {}
        if m["diag"]:
            kw["mv"] = t["mv"]
            if not lean:
                kw["hbv"] = t["hbv"]
        if m["check"]:
            kw["check"] = (t["mv"], t["alive"], t["owner_alive"])
        fd = None
        if m["fd"]:
            kw["hbv"] = t["hbv"]
            fd = pairs_pull.FdOperands(
                31, t["lc"], t["im"].to(torch.bfloat16), t["ic"],
                torch.zeros((256, 256), dtype=torch.bool), t["hb0"] if m["hb0"] else None,
                FdParams(10.0, 1000, 5.0, 16.5, 7.5),
            )
        if two_pass:
            kw["totals"] = pairs_totals.pairs_totals_plain(
                t["w"], t["gm"], t["c"], t["valid"], mv=kw.get("mv"))
        flag = pairs_pull.pairs_pull_plain(
            t["w"], hb, t["gm"], t["c"], t["valid"], 5, 0x51ED, 48, fd=fd, **kw)
        out = [t["w"]] + ([] if lean else [hb])
        if fd is not None:
            out += [fd.lc, fd.im, fd.ic, fd.live]
        outs.append(out + ([flag] if flag is not None else []))
    for a, b in zip(*outs, strict=True):
        assert torch.equal(a, b)


# -- the slice as a whole -------------------------------------------------------


def _ref_cfg(cfg: SimConfig) -> RefConfig:
    return RefConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize(
    "profile",
    [
        SimConfig(n_nodes=256, keys_per_node=4, fanout=3, budget=64, use_pallas=True, **NARROW),
        lean_config(512, budget=300, use_pallas=True),
    ],
    ids=["headline_shaped", "lean"],
)
def test_two_pass_simulator_equals_reference(profile, monkeypatch):
    """No block may stage a row pair (as at N > 57,984 on the card), so
    every sub-exchange runs both passes; the trajectory is the
    reference's kernel path (interpreted), state for state and round for
    round, and ``run_until_converged`` returns its first converged round."""
    monkeypatch.setattr(pairs_pull, "SMEM_LIMIT", pairs_pull.STATIC_SMEM)
    assert gossip.pull_phase_engaged(profile, "cpu") == "pairs_two_pass"
    ref = RefSimulator(_ref_cfg(profile), seed=4, chunk=1)
    counters.reset()
    port = Simulator(profile, seed=4, chunk=1, device="cpu")
    want_round = None
    for r in range(1, 61):
        ref.run(1)
        port.run(1)
        _assert_states_equal(ref.state, port.state, f"round {r}")
        if bool(ref.metrics()["all_converged"]):
            want_round = r
            break
    assert want_round is not None
    f = profile.fanout
    assert counters.plain_calls == {
        "totals": f * want_round, "pull": f * want_round, "draws": want_round,  # chunk 1
    }
    assert not counters.launches and not counters.refusals
    again = Simulator(profile, seed=4, chunk=4, device="cpu")
    assert again.run_until_converged(200) == want_round


# -- lean_config --------------------------------------------------------------------


@pytest.mark.parametrize(
    "n, rung, over",
    [
        (100_352, "int16", dict(budget=2618)),
        (65_536, "int16", dict(budget=2618)),
        (1_024, "int32", {}),
        (2_048, "int16", dict(fanout=2, keys_per_node=8)),
    ],
)
def test_lean_config_matches_reference(n, rung, over):
    assert dataclasses.asdict(lean_config(n, rung, **over)) == dataclasses.asdict(
        ref_lean_config(n, rung, **over)
    )


def test_lean_config_packed_rungs_run():
    """The packed lean rungs (once refused) equal the reference's configs
    and run two rounds on the CPU."""
    for rung in ("int8", "u4r"):
        cfg = lean_config(1_024, rung)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_lean_config(1_024, rung))
        sim = Simulator(cfg, seed=0, device="cpu")
        sim.run(2)
        assert sim.tick == 2 and 0.0 < float(sim.metrics()["mean_fraction"]) <= 1.0


# -- init_state and the convergence reductions over row blocks -----------------


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_nodes=256, keys_per_node=6, fanout=2, budget=64, **NARROW),
        dict(n_nodes=256, keys_per_node=6, fanout=3, budget=30,
             track_failure_detector=False, track_heartbeats=False, version_dtype="int16"),
    ],
    ids=["fd", "lean"],
)
def test_blocked_reductions_match_reference(kw, monkeypatch):
    """Seven rows per block (an uneven last block): init_state, the
    all-converged flag and every metric equal the reference's after each
    round up to convergence."""
    monkeypatch.setattr(gossip, "ROW_BLOCK_ELEMS", 7 * 256)
    rcfg, pcfg = RefConfig(**kw), SimConfig(**kw)
    rs, ps = ref_init(rcfg), init_state(pcfg, device="cpu")
    _assert_states_equal(rs, ps, "init")
    key, pkey = random.key(3), prng.key(3)
    for r in range(40):
        want = {k: np.asarray(v) for k, v in ref_metrics(rs).items()}
        got = {k: v.numpy() for k, v in gossip.convergence_metrics(ps).items()}
        assert set(got) == set(want)
        for k in ("converged_owners", "all_converged", "alive_count", "kv_known"):
            assert np.array_equal(got[k], want[k]), (r, k)
        if "fd_false_positives" in want:
            assert np.array_equal(got["fd_false_positives"], want["fd_false_positives"])
        # Float sums: the port sums the fractions in float64 and rounds
        # once; the reference sums in float32 (rtol as in
        # test_torch_sim.py::test_metrics_match_reference).
        for k in ("min_fraction", "mean_fraction", "fd_false_positive_fraction"):
            if k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        assert bool(gossip.all_converged_flag(ps)) == bool(ref_flag(rs))
        if bool(want["all_converged"]):
            break
        rs, ps = ref_step(rs, key, rcfg), gossip.sim_step(ps, pkey, pcfg)
    assert bool(gossip.all_converged_flag(ps))


def test_flag_with_a_need_beyond_the_watermark_dtype():
    """An owner's max_version beyond int16 is out of every row's reach:
    the comparison in w's own dtype must not wrap it into reach."""
    cfg = SimConfig(n_nodes=128, track_failure_detector=False, track_heartbeats=False,
                    version_dtype="int16")
    s = init_state(cfg, device="cpu")
    s = s.replace(w=torch.full_like(s.w, 2**15 - 1))
    assert bool(gossip.all_converged_flag(s))
    mv = s.max_version.clone()
    mv[5] = 2**15 + 3  # wraps to 3 in int16
    s = s.replace(max_version=mv)
    assert not bool(gossip.all_converged_flag(s))
    assert int(gossip.convergence_metrics(s)["converged_owners"]) == 127
    alive = s.alive.clone()
    alive[5] = False  # a dead owner is excused
    assert bool(gossip.all_converged_flag(s.replace(alive=alive)))


# -- the kernel's word arithmetic on 1-byte rows, mirrored ------------------------


@pytest.mark.parametrize("col0", [0, 64])
def test_packed_swar_refresh_equals_refresh_packed_rows(col0):
    """The kernel's packed refresh on words of nibble lanes (saturating
    adds with a carry mask, then the row's own owner zeroed in its one
    step) equals ``refreshed_packed_rows`` nibble for nibble, on random
    bytes and bumps (every nibble 0..15, so the clamp bites) and on rows
    whose own owner lies in the block at each nibble position of a word,
    in another step, or outside the block."""
    rng = np.random.default_rng(5 + col0)
    n_bytes = 48  # three 16-byte steps, 96 owners from col0
    r = _t(rng.integers(0, 256, (40, n_bytes), dtype=np.uint8))
    bump_bytes = _t(rng.integers(0, 256, n_bytes, dtype=np.uint8))
    lo, hi = gossip.nibbles(bump_bytes)
    bump = torch.stack((lo, hi), dim=-1).flatten()  # per owner, 0..15
    # The own owner at every nibble of the first word, in later steps,
    # before the block and past it.
    rows = torch.tensor(
        [col0 + t for t in range(16)] + [col0 + 33, col0 + 63, col0 + 64, col0 + 95]
        + [col0 - 1, col0 + 96, col0 + 200] + list(rng.integers(0, 400, 17)),
        dtype=torch.int64,
    )
    rows = rows.clamp(min=0)
    got = pairs_totals.packed_refresh_swar(r, bump_bytes, rows, col0)
    # refreshed_packed_rows' steps, with the rows' own ids for the diagonal.
    want = gossip.packed_diag_zero_(gossip.packed_writes_shift(r, bump), rows, col0)
    assert torch.equal(got, want)
    assert torch.equal(pairs_totals.packed_refresh_swar(r, None, rows, col0), r)


@pytest.mark.parametrize("rung", ["int8", "u4r"])
@pytest.mark.parametrize("diag", [False, True])
def test_narrow_pair_sums_equal_plain_totals(rung, diag):
    """The kernel's deficit sums of 1-byte rows, (A + D) / 2 and (A - D) /
    2 over words of bytes, equal both directions' plain deficit totals,
    masked by each row's own valid (asymmetric too): int8 over the whole
    signed range, the packed rung refreshed by its write bumps."""
    rng = np.random.default_rng(17 + diag)
    r, n_bytes = 24, 64
    vi = _t(rng.random(r) < 0.7)
    vp = _t(rng.random(r) < 0.7)
    if rung == "int8":
        x = _t(rng.integers(-128, 128, (r, n_bytes), dtype=np.int8))
        y = _t(rng.integers(-128, 128, (r, n_bytes), dtype=np.int8))
        ti, tp = pairs_totals.narrow_pair_sums(x, y, vi, vp)
        xs, ys = x.to(torch.int64), y.to(torch.int64)
        want_i = torch.where(vi, (ys - xs).clamp(min=0).sum(dim=1), 0)
        want_p = torch.where(vp, (xs - ys).clamp(min=0).sum(dim=1), 0)
    else:
        x = _t(rng.integers(0, 256, (r, n_bytes), dtype=np.uint8))
        y = _t(rng.integers(0, 256, (r, n_bytes), dtype=np.uint8))
        rows_i = torch.arange(0, 2 * r, 2)
        rows_p = rows_i + 1
        bump_bytes = _t(rng.integers(0, 64, n_bytes, dtype=np.uint8)) if diag else None
        bump = None
        if diag:
            lo, hi = gossip.nibbles(bump_bytes)
            bump = torch.stack((lo, hi), dim=-1).flatten()
        ti, tp = pairs_totals.narrow_pair_sums(x, y, vi, vp, bump=bump_bytes, rows_i=rows_i,
                                               rows_p=rows_p)
        both = torch.cat([x, y])
        if diag:  # the rows' own owners are rows_i / rows_p
            both = gossip.packed_diag_zero_(gossip.packed_writes_shift(both, bump),
                                            torch.cat([rows_i, rows_p]))
        xr, yr = both[:r], both[r:]
        want_i = gossip.packed_totals(xr, yr, vi).to(torch.int64)
        want_p = gossip.packed_totals(yr, xr, vp).to(torch.int64)
    assert torch.equal(ti, want_i) and torch.equal(tp, want_p)
    assert bool((ti > 0).any()) and bool((tp > 0).any())
