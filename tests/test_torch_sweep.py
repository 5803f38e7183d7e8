"""The port's multi-scenario sweep equals the reference's: a
``SweepSimulator`` with per-lane seeds, fanouts, phi thresholds and write
rates, field by field and lane by lane against the reference's
``SweepSimulator`` on JAX CPU and against the port's own sequential
``Simulator`` runs, on both of its routes (the plain round lane by lane,
and the lane wrappers' plain versions as the card's lane launches see
them, staged and two-pass); its converged rounds, metrics and result
table; its lane keys, draws and salts; its refusals and validation.
Tolerance 0, except the metrics' float sums taken in another order."""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
from jax import random

from aiocluster_tpu.ops.gossip import staleness_tensor as ref_staleness
from aiocluster_tpu.sim import SimConfig as RefConfig
from aiocluster_tpu.sim.state import SimState as RefState
from aiocluster_tpu.sim.sweep import SweepSimulator as RefSweep
from aiocluster_torch import MetricsRegistry, Simulator, SimConfig, SweepSimulator, lean_config
from aiocluster_torch.ops import counters, gossip, pairs_pull, prng
from aiocluster_torch.parallel import make_mesh
from aiocluster_torch.sim.carry import state_from_numpy, state_to_numpy
from aiocluster_torch.sim.state import STATE_FIELDS, init_lanes, lane
from test_torch_sim import NARROW, _assert_states_equal

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)

SEEDS = [3, 4, 5]
LANES = dict(fanout=[1, 2, 3], phi_threshold=[7.0, 8.0, 9.5], writes_per_round=[0, 1, 2])
ROUNDS = 6
CFG = SimConfig(n_nodes=128, keys_per_node=4, fanout=3, budget=64, **NARROW)
INT_METRICS = ("converged_owners", "all_converged", "alive_count", "fd_false_positives",
               "version_spread", "staleness_p50", "staleness_p99", "staleness_p100")
FLOAT_METRICS = ("min_fraction", "mean_fraction", "kv_known", "fd_false_positive_fraction")


def _ref_cfg(cfg: SimConfig) -> RefConfig:
    return RefConfig(**dict(dataclasses.asdict(cfg), use_pallas=False, use_pallas_fd=False))


def _lane_state(states, s):
    """Lane s of the reference's lane-batched state, as numpy arrays."""
    return types.SimpleNamespace(**{f: np.asarray(getattr(states, f))[s] for f in STATE_FIELDS})


@functools.lru_cache(maxsize=None)
def _reference(n: int):
    """The reference sweep after ``ROUNDS`` rounds (states, metrics,
    result rows), then run on to convergence (rounds, rows)."""
    ref = RefSweep(_ref_cfg(dataclasses.replace(CFG, n_nodes=n)), SEEDS, chunk=4, **LANES)
    ref.run(ROUNDS)
    states = jax.tree_util.tree_map(np.asarray, ref.states)
    metrics = ref.metrics()
    rows = ref.result().rows()
    rounds = ref.run_until_converged(200)
    return states, metrics, rows, rounds, ref.result().rows()


def _assert_rows_equal(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert set(a) == set(b)
        for k in a:
            if k in ("mean_fraction", "min_fraction", "fd_false_positive_fraction"):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize(
    "n, route",
    [(128, "plain"), (128, "lanes"), (256, "lanes_two_pass")],
)
def test_sweep_equals_reference_lane_by_lane(n, route, monkeypatch):
    """Every state field of every lane after 6 rounds, the metrics, the
    result table, and the converged rounds equal the reference sweep's.
    ``plain``: each lane runs the plain round; ``lanes``: the lane
    wrappers' plain versions (use_pallas=True on CPU tensors), staged or
    forced two-pass (no row may stage)."""
    cfg = dataclasses.replace(CFG, n_nodes=n, use_pallas=route != "plain")
    if route == "lanes_two_pass":
        monkeypatch.setattr(pairs_pull, "SMEM_LIMIT", pairs_pull.STATIC_SMEM)
    want_states, want_metrics, want_rows, want_rounds, want_final = _reference(n)
    counters.reset()
    sweep = SweepSimulator(cfg, SEEDS, chunk=4, device="cpu", **LANES)
    sweep.run(ROUNDS)
    for s in range(len(SEEDS)):
        _assert_states_equal(_lane_state(want_states, s), lane(sweep.states, s), f"lane {s}")
    chunks = -(-ROUNDS // 4)  # each drawn by the plain ops, for every lane
    if route == "plain":
        # Each lane's own fanout of plain sub-exchanges, one FD phase each.
        assert counters.plain_calls == {"pull": ROUNDS * 6, "fd": ROUNDS * 3, "draws": chunks}
    else:
        # One lane call a sub-exchange for all lanes (two in two-pass).
        want = {"pull": ROUNDS * 3, "draws": chunks}
        if route == "lanes_two_pass":
            want["totals"] = ROUNDS * 3
        assert counters.plain_calls == want
    assert not counters.launches and not counters.fallbacks and not counters.refusals
    got = sweep.metrics()
    assert set(got) == set(want_metrics)
    for k in INT_METRICS:
        assert np.array_equal(got[k], want_metrics[k]), k
    for k in FLOAT_METRICS:
        np.testing.assert_allclose(got[k], want_metrics[k], rtol=1e-5, err_msg=k)
    _assert_rows_equal(want_rows, sweep.result().rows())
    assert sweep.run_until_converged(200) == want_rounds
    assert want_rounds[0] is not None  # the lanes that write never converge
    _assert_rows_equal(want_final, sweep.result().rows())


@pytest.mark.parametrize("route", ["plain", "lanes", "lanes_fd_plain"])
def test_sweep_equals_sequential_runs(route):
    """Lane s equals ``Simulator(replace(cfg, <lane values>), seed)``,
    field for field after 6 rounds, and converges at the same round.
    ``lanes_fd_plain``: the lane pulls with the FD phase pinned plain
    (use_pallas_fd=False), lane by lane with each lane's phi."""
    cfg = dataclasses.replace(CFG, n_nodes=256, use_pallas=route != "plain",
                              use_pallas_fd=False if route == "lanes_fd_plain" else "auto")
    sweep = SweepSimulator(cfg, SEEDS, chunk=3, device="cpu", **LANES)
    sweep.run(ROUNDS)
    seqs = []
    for s, seed in enumerate(SEEDS):
        values = {k: v[s] for k, v in LANES.items()}
        seq = Simulator(dataclasses.replace(cfg, **values), seed=seed, chunk=5, device="cpu")
        seq.run(ROUNDS)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(lane(sweep.states, s), f), getattr(seq.state, f)), (s, f)
        seqs.append(seq)
    got = sweep.run_until_converged(200)
    assert got == [seq.run_until_converged(200) for seq in seqs]


def test_sweep_step_alone_equals_a_sweep_round():
    """``sweep_step`` called a round at a time, on one round's draws and
    salt table and the sweep's run salts and fanout masks, equals a round
    of ``SweepSimulator``, which draws and salts a chunk at a time."""
    cfg = dataclasses.replace(CFG, use_pallas=True)
    sweep = SweepSimulator(cfg, SEEDS, device="cpu", **LANES)
    states = init_lanes(cfg, len(SEEDS), device="cpu")
    keys = prng.keys(SEEDS)
    for tick in range(3):
        sweep.run(1)
        draws = prng.chunk_draws(keys, tick + 1, 1, cfg, alive=states.alive).round(0)
        salts = gossip.lane_salt_table(tick + 1, 1, cfg.fanout, sweep._lane_fanout,
                                       sweep._device_run_salts)[0]
        states, conv = gossip.sweep_step(
            states, keys, cfg, sweep._sweep, tick=tick, draws=draws, salts=salts,
            run_salts=sweep._run_salts, active=sweep._active, return_converged=True,
        )
        assert conv.shape == (len(SEEDS),) and conv.dtype == torch.bool
        for f in STATE_FIELDS:
            assert torch.equal(getattr(states, f), getattr(sweep.states, f)), (tick, f)


def test_fanout_zero_lane_equals_its_sequential_run():
    """A fanout-0 lane beside fanout-2 lanes: its sub-exchanges are all
    voided, its diagonal refresh and FD still run, and it equals a
    sequential fanout-0 run (which takes the "fanout" fallback when the
    kernels are wanted)."""
    cfg = dataclasses.replace(CFG, fanout=2, use_pallas=True)
    counters.reset()
    sweep = SweepSimulator(cfg, [7, 7, 8], fanout=[0, 2, 0], writes_per_round=[1, 0, 2],
                           device="cpu")
    sweep.run(5)
    assert counters.plain_calls == {"pull": 10, "draws": 1}
    for s, (f, wpr, seed) in enumerate(((0, 1, 7), (2, 0, 7), (0, 2, 8))):
        seq = Simulator(dataclasses.replace(cfg, fanout=f, writes_per_round=wpr), seed=seed,
                        device="cpu")
        seq.run(5)
        for fld in STATE_FIELDS:
            assert torch.equal(getattr(lane(sweep.states, s), fld), getattr(seq.state, fld))
    assert counters.fallbacks == {"fanout": 10}


@pytest.mark.parametrize(
    "cfg",
    [
        lean_config(256, budget=300, use_pallas=True),
        lean_config(256, "u4r", budget=300, use_pallas=True),
    ],
    ids=["lean_int16", "lean_u4r"],
)
def test_lean_sweep_equals_sequential_runs(cfg):
    """The lean profile (no hb, no FD) and the packed u4r rung through the
    lane wrappers: each lane equals its sequential run, and the sweep
    converges where they do."""
    wpr = [0, 1] if cfg.version_dtype != "u4r" else None
    sweep = SweepSimulator(cfg, [1, 2], writes_per_round=wpr, device="cpu")
    seqs = [Simulator(dataclasses.replace(cfg, writes_per_round=(wpr or [0, 0])[s]), seed=seed,
                      device="cpu") for s, seed in enumerate([1, 2])]
    sweep.run(4)
    for s, seq in enumerate(seqs):
        seq.run(4)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(lane(sweep.states, s), f), getattr(seq.state, f)), (s, f)
    if wpr is None:
        assert sweep.run_until_converged(200) == [seq.run_until_converged(200) for seq in seqs]


def test_pinned_m8_sweep_runs_plain_and_counts():
    """A sweep pinned to m8 (no lane lift in the reference): its pull runs
    plain with the fallback "sweep_needs_pairs", its FD plain, both
    counted; the lanes still equal their sequential runs."""
    cfg = dataclasses.replace(CFG, use_pallas=True, pallas_variant="m8")
    phases = gossip.resolve_phases(cfg, "cpu", sweep=True)
    assert phases == gossip.Phases("plain", "sweep_needs_pairs", "plain", None)
    counters.reset()
    sweep = SweepSimulator(cfg, [0, 1], phi_threshold=[7.0, 9.0], device="cpu")
    sweep.run(3)
    assert counters.fallbacks == {"sweep_needs_pairs": 3}
    assert counters.plain_calls == {"pull": 18, "fd": 6, "draws": 1}
    for s, (seed, phi) in enumerate(((0, 7.0), (1, 9.0))):
        seq = Simulator(dataclasses.replace(CFG, phi_threshold=phi), seed=seed, device="cpu")
        seq.run(3)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(lane(sweep.states, s), f), getattr(seq.state, f))


def test_sweep_dispatch_resolution():
    cuda = torch.device("cuda")
    head = SimConfig(n_nodes=10_240, keys_per_node=16, fanout=3, budget=2618, **NARROW)
    assert gossip.resolve_phases(head, cuda, sweep=True) == gossip.Phases(
        "pairs", None, "fused", None)
    assert gossip.resolve_phases(lean_config(100_352, budget=2618), cuda, sweep=True) == (
        gossip.Phases("pairs_cluster", None, "off", None))
    m8 = dataclasses.replace(head, pallas_variant="m8")
    assert gossip.resolve_phases(m8, cuda, sweep=True) == gossip.Phases(
        "plain", "sweep_needs_pairs", "plain", None)
    shrunk_m8 = dataclasses.replace(m8, icount_dtype="int8", live_bits=True, window_ticks=100)
    assert gossip.resolve_phases(shrunk_m8, cuda, sweep=True) == gossip.Phases(
        "plain", "sweep_needs_pairs", "plain", "fd_packed_bookkeeping")
    assert gossip.resolve_phases(dataclasses.replace(head, fanout=0), cuda, sweep=True) == (
        gossip.Phases("plain", "fanout", "plain", None))
    # The reference's own gates, sweep=True: the same names.
    from aiocluster_tpu.ops import gossip as ref_gossip
    ref_m8 = RefConfig(**dict(dataclasses.asdict(m8), use_pallas=True))
    assert ref_gossip.pallas_fallback_reason(ref_m8, sweep=True) == "sweep_needs_pairs"
    assert ref_gossip.fd_phase_engaged(ref_m8, sweep=True) == "xla"


def test_lane_keys_draws_and_salts():
    """Lane keys equal the reference's ``vmap(random.key)`` and each lane's
    ``prng.key``; one batched draw of every lane equals each lane's own
    draws; the salt table is the reference's schedule."""
    seeds = [0, 1, 2**32 - 1, 123_456]
    want = np.asarray(random.key_data(jax.vmap(random.key)(np.asarray(seeds, np.uint32))))
    got = prng.keys(seeds)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    for s, seed in enumerate(seeds):
        assert torch.equal(got[s], prng.key(seed))
    with pytest.raises(ValueError, match="2\\*\\*32"):
        prng.keys([2**32])
    draw_cfg = SimConfig(n_nodes=256, fanout=2)
    batched = prng.chunk_draws(got, 5, 3, draw_cfg)
    for s, seed in enumerate(seeds):
        single = prng.chunk_draws(prng.key(seed), 5, 3, draw_cfg)
        for a, b in zip((batched.gm, batched.c, batched.p), (single.gm, single.c, single.p)):
            assert a.shape[:3] == (3, 2, len(seeds))
            assert torch.equal(a[:, :, s], b)
    run = prng.run_salts(got)
    assert run.tolist() == [prng.run_salt(prng.key(s)) for s in seeds]
    f_lane = torch.tensor([0, 1, 2, 2])
    table = gossip.lane_salt_table(5, 3, 2, f_lane, run)
    for r in range(3):
        for c in range(2):
            for s in range(len(seeds)):
                salt = (5 + r) * 2 * int(f_lane[s]) + 2 * c
                want_mix = (salt ^ int(run[s])) & prng.M32
                assert int(table[r, c, s]) & prng.M32 == want_mix


def test_staleness_metrics_equal_reference_over_row_blocks(monkeypatch):
    """The staleness tensor and its percentiles over blocks of 7 rows, on
    a state with dead nodes and lag, packed and unpacked."""
    monkeypatch.setattr(gossip, "ROW_BLOCK_ELEMS", 7 * 256)
    for cfg in (dataclasses.replace(CFG, n_nodes=256), lean_config(256, "u4r", budget=40)):
        sim = Simulator(cfg, seed=2, device="cpu")
        sim.run(3)
        alive = sim.state.alive.clone()
        alive[::9] = False
        state = sim.state.replace(alive=alive)
        ref = RefState(**{f: jax.numpy.asarray(a) for f, a in state_to_numpy(state).items()})
        want = np.asarray(ref_staleness(ref))
        got = gossip.staleness_tensor(state)
        assert np.array_equal(got.numpy(), want)
        pct = gossip.staleness_percentiles(state)
        ordered = np.sort(want)
        for label, q in gossip.STALENESS_PCTS:
            assert int(pct[f"staleness_p{label}"]) == ordered[min(255, int(q * 255 + 0.5))]
        assert int(gossip.version_spread(state)) == want.max()


def test_provided_states_and_horizon():
    """A provided lane-batched state is checked (lanes, rung, shapes) and
    continues the trajectory; the horizon guard charges the
    fastest-writing lane."""
    cfg = dataclasses.replace(CFG, n_nodes=128)
    a = SweepSimulator(cfg, [1, 2], device="cpu")
    a.run(4)
    states = a.states
    b = SweepSimulator(cfg, [1, 2], states=init_lanes(cfg, 2, device="cpu"), device="cpu")
    b.run(4)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a.states, f), getattr(b.states, f))
    c = SweepSimulator(cfg, [1, 2], states=states, device="cpu")
    assert c.tick == 4
    with pytest.raises(ValueError, match="carry 2 lanes, expected 3"):
        SweepSimulator(cfg, [1, 2, 3], states=states, device="cpu")
    with pytest.raises(ValueError, match="config expects"):
        SweepSimulator(dataclasses.replace(cfg, version_dtype="int32"), [1, 2], states=states,
                       device="cpu")
    wcfg = SimConfig(n_nodes=128, version_dtype="int16", keys_per_node=30_000, **{
        k: v for k, v in NARROW.items() if k != "version_dtype"})
    slow = SweepSimulator(wcfg, [0, 1], writes_per_round=[0, 0], device="cpu")
    slow._check_horizon(8)
    fast = SweepSimulator(wcfg, [0, 1], writes_per_round=[0, 400], device="cpu")
    with pytest.raises(ValueError, match="version_dtype='int16'"):
        fast.run(8)


def test_refusals_and_validation(tmp_path):
    """mesh= (A15b, once refused; tests/test_torch_sweep_mesh.py holds it
    against the reference) places its blocks itself, so device= beside
    it is refused as Simulator refuses it, and nothing is refused by
    roadmap ID; metrics= and save/resume, once refused, work
    (tests/test_torch_obs.py and tests/test_torch_checkpoint.py hold them
    against the reference); the reference's validation errors, word for
    word."""
    cfg = dataclasses.replace(CFG, n_nodes=128)
    counters.reset()
    with pytest.raises(ValueError, match="list its devices, not device="):
        SweepSimulator(cfg, [0], mesh=make_mesh(["cpu"] * 2), device="cpu")
    reg = MetricsRegistry()
    sweep = SweepSimulator(cfg, [0], metrics=reg, device="cpu")
    sweep.run(2)
    sweep.save(tmp_path / "s.npz")
    again = SweepSimulator.resume(tmp_path / "s.npz", metrics=reg, device="cpu")
    assert again.tick == 2 and again.result().rows() == sweep.result().rows()
    assert reg.snapshot()["aiocluster_sim_sweep_lanes{engine=torch}"] == 1
    assert sum(counters.refusals.values()) == 0
    rcfg = _ref_cfg(cfg)
    cases = [
        (dict(seeds=[]), {}),
        (dict(seeds=[2**32]), {}),
        (dict(seeds=[0, 1]), dict(fanout=[1])),
        (dict(seeds=[0, 1]), dict(fanout=[1, 4])),
        (dict(seeds=[0, 1]), dict(fanout=[-1, 1])),
        (dict(seeds=[0, 1]), dict(writes_per_round=[0, -1])),
        (dict(seeds=[0, 1]), dict(fault_seeds=[1, 2])),
        (dict(seeds=[0, 1]), dict(byz_frac=[0.1, 0.2])),
        (dict(seeds=[0, 1]), dict(byz_frac=[0.1, 2.0])),
    ]
    for args, kw in cases:
        with pytest.raises(ValueError) as want:
            RefSweep(rcfg, args["seeds"], **kw)
        with pytest.raises(ValueError) as got:
            SweepSimulator(cfg, args["seeds"], device="cpu", **kw)
        assert str(got.value) == str(want.value), (args, kw)
    lean = lean_config(128)
    with pytest.raises(ValueError, match="requires the failure detector") as got:
        SweepSimulator(lean, [0], phi_threshold=[8.0], device="cpu")
    with pytest.raises(ValueError) as want:
        RefSweep(_ref_cfg(lean), [0], phi_threshold=[8.0])
    assert str(got.value) == str(want.value)
    # Churn (A6, once refused here) sweeps; a fanout sweep under choice
    # keeps the reference's error.
    churn = SweepSimulator(dataclasses.replace(cfg, death_rate=0.1), [0, 1], device="cpu")
    churn.run(2)
    assert churn.tick == 2 and not bool(churn.states.alive.all())
    choice = dataclasses.replace(cfg, pairing="choice")
    with pytest.raises(ValueError) as got:
        SweepSimulator(choice, [0, 1], fanout=[1, 2], device="cpu")
    with pytest.raises(ValueError) as want:
        RefSweep(_ref_cfg(choice), [0, 1], fanout=[1, 2])
    assert str(got.value) == str(want.value)


def test_result_table():
    """``SweepResult``: rows, summary, evaluate and best_lane (ties to the
    lower lane)."""
    cfg = dataclasses.replace(CFG, n_nodes=128)
    sweep = SweepSimulator(cfg, [0, 1, 2], phi_threshold=[7.0, 8.0, 9.0], device="cpu")
    rounds = sweep.run_until_converged(200)
    res = sweep.result()
    assert [r["rounds_to_convergence"] for r in res.rows()] == rounds
    assert [r["phi_threshold"] for r in res.rows()] == [7.0, 8.0, 9.0]
    assert res.summary() == {
        "lanes": 3, "lanes_converged": 3, "rounds_to_convergence_min": min(rounds),
        "rounds_to_convergence_max": max(rounds), "swept": ["phi_threshold"],
    }
    assert res.best_lane(lambda row: row["rounds_to_convergence"]) == (
        int(np.argmin(rounds)), float(min(rounds)))
    assert res.best_lane(lambda row: None) is None
    assert res.best_lane(lambda row: 1.0) == (0, 1.0)
    assert res.evaluate(lambda row: row["lane"]) == [0, 1, 2]


def test_carried_lane_continues_as_a_sequential_run():
    """A lane's state carried out of the sweep (the reference's layout)
    continues in a sequential port run exactly as the sweep's lane does."""
    cfg = dataclasses.replace(CFG, n_nodes=128)
    sweep = SweepSimulator(cfg, [4, 9], writes_per_round=[1, 0], device="cpu")
    sweep.run(3)
    arrays = state_to_numpy(lane(sweep.states, 1))
    seq = Simulator(cfg, seed=9, device="cpu", state=state_from_numpy(arrays, cfg, "cpu"))
    sweep.run(3)
    seq.run(3)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(lane(sweep.states, 1), f), getattr(seq.state, f))
