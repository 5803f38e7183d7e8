"""The plain reference against the port on the CPU, round by round, on
small copies of both configurations under each traffic mix; its hash and
its byte count against the port's."""

import dataclasses

import pytest
import torch

from aiocluster_torch import MetricsRegistry, SimConfig, Simulator, SweepSimulator
from aiocluster_torch.sim.bytes import per_round_bytes
from gossipbench import harness
from gossipbench.reference import bytes as ref_bytes
from gossipbench.reference import sim as R

# Small copies: a width the grouped matching takes (256) and one it does
# not (200); budgets small enough that every round is budget-bound.
SMALL = {
    "northstar100k": [{"n_nodes": 256, "budget": 60}, {"n_nodes": 200, "budget": 45}],
    "headline10k": [{"n_nodes": 256, "budget": 60}, {"n_nodes": 200, "budget": 45}],
}
SEEDS = (0, 4_000_000_007)


def cfg_of(config: str, small: dict) -> dict:
    cell = {"northstar100k": "northstar.converge", "headline10k": "headline.converge"}[config]
    return harness.load_cell(cell, overrides=small).fields


def assert_same(program_state, ref_state, where):
    for name in R.MATRICES:
        a, b = getattr(program_state, name), getattr(ref_state, name)
        assert a.shape == b.shape and torch.equal(a, b), (where, name)


@pytest.mark.parametrize("config", sorted(SMALL))
@pytest.mark.parametrize("small", [0, 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_converge_round_by_round(config, small, seed):
    fields = cfg_of(config, SMALL[config][small])
    sim = Simulator(SimConfig(**fields), seed=seed, chunk=8, device="cpu")
    run = R.Run(R.Config.from_fields(fields), seed, "cpu")
    assert_same(sim.state, run.state, 0)
    first = None
    for t in range(1, 80):
        sim.run(1)
        run.step()
        assert_same(sim.state, run.state, t)
        if first is None and R.converged(run.state):
            first = t
            break
    assert first is not None and first > 4
    chunked = Simulator(SimConfig(**fields), seed=seed, chunk=8, device="cpu")
    assert chunked.run_until_converged(max_rounds=600) == first


@pytest.mark.parametrize("seed", SEEDS)
def test_sampled_series_equals_reference(seed):
    fields = cfg_of("headline10k", SMALL["headline10k"][0])
    sim = Simulator(SimConfig(**fields), seed=seed, chunk=1, metrics=MetricsRegistry(),
                    metrics_stride=1, device="cpu")
    first = sim.run_until_converged(max_rounds=600)
    series = sim.flush_metrics()
    run = R.Run(R.Config.from_fields(fields), seed, "cpu")
    want = []
    while run.state.tick < first:
        run.step()
        want.append({"tick": run.state.tick, **R.metrics_sample(run.state)})
    assert harness.diff_series(series, want) == 0
    assert [s["tick"] for s in series] == list(range(1, first + 1))


@pytest.mark.parametrize("seed", SEEDS)
def test_phi_sweep_lanes_round_by_round(seed):
    fields = cfg_of("headline10k", SMALL["headline10k"][0])
    phis = [7.0 + 0.25 * i for i in range(8)]
    seeds = [harness.derive_seed(seed, 0, s) for s in range(8)]
    sweep = SweepSimulator(SimConfig(**fields), seeds, phi_threshold=phis, chunk=8, device="cpu")
    runs = [R.Run(R.Config.from_fields({**fields, "phi_threshold": p}), s, "cpu")
            for p, s in zip(phis, seeds)]
    for t in range(1, 30):
        sweep.run(1)
        for s, run in enumerate(runs):
            run.step()
            assert_same(harness.lane_of(sweep.states, s, R.COMPARED), run.state, (t, s))


def test_dither_int32_equals_int64_words():
    g = torch.Generator().manual_seed(7)
    for _ in range(8):
        i = torch.randint(0, 2**17, (64, 1), generator=g, dtype=torch.int64)
        j = torch.randint(0, 2**17, (1, 257), generator=g, dtype=torch.int64)
        s = int(torch.randint(0, 2**32, (1,), generator=g, dtype=torch.int64))
        assert torch.equal(R.dither(i, j, s), R.dither_words(i, j, s))


@pytest.mark.parametrize("config,ms", [("northstar100k", 36.07), ("headline10k", 1.221)])
def test_fused_bytes_equal_the_port_model(config, ms):
    fields = cfg_of(config, {})
    got = ref_bytes.fused_round_bytes(fields)
    cfg = SimConfig(**fields)
    fd = "fused" if cfg.track_failure_detector else "off"
    assert got == per_round_bytes(cfg, variant="pairs", fd_phase=fd)
    assert round(ref_bytes.fused_round_ms(fields), 3 if ms < 10 else 2) == ms


def test_reference_refuses_what_it_does_not_model():
    base = cfg_of("headline10k", SMALL["headline10k"][0])
    for change in ({"death_rate": 0.1}, {"pairing": "permutation"}, {"quarantine": True}):
        with pytest.raises(NotImplementedError):
            R.Config.from_fields({**base, **change})
    assert dataclasses.is_dataclass(R.Config.from_fields(base))
