"""Sweeps over a mesh: ``SweepSimulator(mesh=make_mesh(["cpu"] * k))``
holds its lanes as column blocks of the owners and equals, lane by lane,
the reference's sharded sweep (its 2-device CPU mesh, XLA) and the
port's unsharded sweep, on the lane launches' plain versions
(``use_pallas=True``: the lanes at each block's owner offset, the lane
totals reduced over the blocks) and on the plain lane route; a sweep
saved on a mesh resumes on a mesh and unsharded. N = 256, 2 to 4
blocks, 3 lanes. State fields and integer metrics bit for bit; the
float metrics as the unsharded sweep's test holds them (rtol 1e-5)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from aiocluster_tpu.parallel.mesh import make_mesh as ref_make_mesh
from aiocluster_tpu.sim import SimConfig as RefConfig
from aiocluster_tpu.sim.sweep import SweepSimulator as RefSweep
from aiocluster_torch import SimConfig, SweepSimulator
from aiocluster_torch.ops import counters
from aiocluster_torch.parallel import (
    init_sweep_blocks,
    make_mesh,
    shard_sweep_state,
    sharded_sweep_chunk_fn,
    sharded_sweep_metrics_fn,
    sweep_state_partition_spec,
)
from aiocluster_torch.sim.state import STATE_FIELDS, init_lanes, lane
from test_torch_sim import NARROW, _assert_states_equal

torch.set_num_threads(1)

N, SEEDS, ROUNDS, HORIZON = 256, [3, 4, 5], 5, 40
CFG = SimConfig(n_nodes=N, keys_per_node=4, fanout=3, budget=64, **NARROW)
LANES = dict(fanout=[1, 2, 3], phi_threshold=[7.0, 8.0, 9.5], writes_per_round=[0, 1, 0])
INT_METRICS = ("converged_owners", "all_converged", "alive_count", "fd_false_positives",
               "version_spread")
FLOAT_METRICS = ("min_fraction", "mean_fraction", "kv_known", "fd_false_positive_fraction")


def _ref_cfg(cfg: SimConfig) -> RefConfig:
    return RefConfig(**dict(dataclasses.asdict(cfg), use_pallas=False, use_pallas_fd=False))


@functools.lru_cache(maxsize=None)
def _reference(blocks: int):
    """The reference's sharded sweep run until each lane converged or
    ``HORIZON`` rounds passed: the converged rounds, its lane states and
    its sharded metrics then."""
    mesh = ref_make_mesh(jax.devices()[:blocks])
    ref = RefSweep(_ref_cfg(CFG), SEEDS, chunk=4, mesh=mesh, **LANES)
    rounds = ref.run_until_converged(HORIZON)
    return jax.tree_util.tree_map(np.asarray, ref.states), ref.metrics(), rounds


def _ref_lane(states, s):
    import types

    return types.SimpleNamespace(**{f: np.asarray(getattr(states, f))[s] for f in STATE_FIELDS})


@pytest.mark.parametrize("route", ["lanes", "plain"])
def test_mesh_sweep_equals_reference_sharded_sweep(route):
    """The converged rounds, every lane's state at the end (lane 1, which
    writes, never converges: 40 rounds) and the sharded metrics equal the
    reference's sharded sweep on 2 devices; ``lanes`` runs one lane
    launch a block for all lanes (two in the blocks' two-pass form),
    ``plain`` each lane's plain round."""
    cfg = dataclasses.replace(CFG, use_pallas=route == "lanes")
    want_states, want_metrics, want_rounds = _reference(2)
    counters.reset()
    sweep = SweepSimulator(cfg, SEEDS, chunk=4, mesh=make_mesh(["cpu"] * 2), **LANES)
    assert sweep.run_until_converged(HORIZON) == want_rounds
    assert want_rounds[0] is not None and want_rounds[1] is None
    if route == "lanes":
        # A totals and a pull lane call a block for each sub-exchange.
        calls = HORIZON * 3 * 2
        assert counters.plain_calls == {"pull": calls, "totals": calls, "draws": HORIZON // 4}
    assert not counters.launches and not counters.refusals
    whole = sweep.states
    for s in range(len(SEEDS)):
        _assert_states_equal(_ref_lane(want_states, s), lane(whole, s), f"lane {s}")
    got = sweep.metrics()
    assert set(got) == set(want_metrics)
    for k in INT_METRICS:
        assert np.array_equal(got[k], want_metrics[k]), k
    for k in FLOAT_METRICS:
        np.testing.assert_allclose(got[k], want_metrics[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize(
    "blocks, case",
    [(2, "phi_ladder_lean"), (2, "u4r"), (4, "faults_plain"), (2, "fd_plain")],
)
def test_mesh_sweep_equals_unsharded_sweep(blocks, case):
    """Each lane of a sweep on ``blocks`` column blocks equals the same
    lane of the unsharded sweep, field for field, every round of a
    chunk, and converges at its round: the lean int16 and packed u4r
    rungs on the lane launches, a fault-seed sweep on the plain lane
    route (4 blocks of 64), and the lane launches with the FD phase
    pinned plain (use_pallas_fd=False, lane by lane and block by block)."""
    kw = {}
    if case == "phi_ladder_lean":
        cfg = SimConfig(n_nodes=N, keys_per_node=4, fanout=3, budget=64, use_pallas=True,
                        version_dtype="int16", track_failure_detector=False,
                        track_heartbeats=False)
        kw = dict(writes_per_round=[0, 1, 2])
    elif case == "u4r":
        cfg = SimConfig(n_nodes=N, keys_per_node=15, fanout=3, budget=64, use_pallas=True,
                        version_dtype="u4r", track_failure_detector=False,
                        track_heartbeats=False)
        kw = dict(fanout=[0, 2, 3])
    elif case == "faults_plain":
        from aiocluster_torch.faults import flaky_links

        cfg = dataclasses.replace(CFG, fault_plan=flaky_links(0.3))
        kw = dict(fault_seeds=[1, 2, 3])
    else:
        cfg = dataclasses.replace(CFG, use_pallas=True, use_pallas_fd=False)
        kw = LANES
    sharded = SweepSimulator(cfg, SEEDS, chunk=3, mesh=make_mesh(["cpu"] * blocks), **kw)
    flat = SweepSimulator(cfg, SEEDS, chunk=3, device="cpu", **kw)
    sharded.run(ROUNDS)
    flat.run(ROUNDS)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(sharded.states, f), getattr(flat.states, f)), f
    assert sharded.run_until_converged(60) == flat.run_until_converged(60)


def test_mesh_sweep_saves_block_by_block_and_resumes_anywhere(tmp_path):
    """A sweep saved on 2 blocks writes the unsharded sweep's file (the
    same arrays) and resumes on 2 blocks and unsharded, each then equal
    to the uninterrupted sweep."""
    cfg = dataclasses.replace(CFG, use_pallas=True)
    sharded = SweepSimulator(cfg, SEEDS, chunk=4, mesh=make_mesh(["cpu"] * 2), **LANES)
    flat = SweepSimulator(cfg, SEEDS, chunk=4, device="cpu", **LANES)
    sharded.run(3)
    flat.run(3)
    sharded.save(tmp_path / "mesh.npz")
    flat.save(tmp_path / "flat.npz")
    a, b = np.load(tmp_path / "mesh.npz"), np.load(tmp_path / "flat.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        assert np.array_equal(a[name], b[name]), name
    on_mesh = SweepSimulator.resume(tmp_path / "mesh.npz", mesh=make_mesh(["cpu"] * 2))
    unsharded = SweepSimulator.resume(tmp_path / "mesh.npz", device="cpu")
    for sim in (on_mesh, unsharded, flat):
        sim.run(4)
    for f in STATE_FIELDS:
        want = getattr(flat.states, f)
        assert torch.equal(getattr(on_mesh.states, f), want), f
        assert torch.equal(getattr(unsharded.states, f), want), f
    assert on_mesh.tick == 7 and len(on_mesh.blocks) == 2


def test_sweep_mesh_functions_keep_the_reference_contracts():
    """``sweep_state_partition_spec`` prepends the lane axis; the blocks
    made by ``init_sweep_blocks`` equal ``shard_sweep_state`` of
    ``init_lanes``; the tracked ``sharded_sweep_chunk_fn`` carries each
    lane's first-converged tick, and ``sharded_sweep_metrics_fn`` gives
    the reference's sharded bundle per lane (no staleness percentiles)."""
    spec = sweep_state_partition_spec()
    assert spec["w"] == (None, None, "owners") and spec["tick"] == ()
    mesh = make_mesh(["cpu"] * 2)
    cfg = dataclasses.replace(CFG, use_pallas=True, fanout=2)
    made = init_sweep_blocks(cfg, mesh, 2)
    split = shard_sweep_state(init_lanes(cfg, 2, device="cpu"), mesh)
    for x, y in zip(made, split):
        assert all(torch.equal(getattr(x, f), getattr(y, f)) for f in STATE_FIELDS)
    sweep = SweepSimulator(cfg, [0, 1], mesh=mesh, chunk=64)
    rounds = sweep.run_until_converged(64)
    assert all(r is not None for r in rounds)
    metrics = sharded_sweep_metrics_fn(mesh)(sweep.blocks)
    assert "staleness_p50" not in metrics and metrics["all_converged"].all()
    assert callable(sharded_sweep_chunk_fn(cfg, mesh, tracked=True))
