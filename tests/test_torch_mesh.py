"""The owner-sharded simulator in one process: a round over the column
blocks of ``make_mesh(["cpu"] * 8)`` (N = 1,024, blocks of 128) equals
the reference's unsharded XLA ``sim_step`` state for state, on the full
and lean profiles and every rung the blocks carry, through the pairs and
the m8 dispatch (``use_pallas=True``: the kernel wrappers' plain
versions on CPU tensors), and the reference's own 8-device sharded step;
``Simulator(mesh=)`` converges at the unsharded run's round and its
metrics equal the reference's sharded metrics; the partition rules, the
mesh widths and the still-unported routes refuse by name."""

import dataclasses

import numpy as np
import pytest
import torch

from jax import random

from aiocluster_tpu.ops.gossip import sim_step as ref_step
from aiocluster_tpu.parallel.mesh import make_mesh as ref_make_mesh
from aiocluster_tpu.parallel.mesh import shard_state as ref_shard_state
from aiocluster_tpu.parallel.mesh import sharded_metrics_fn, sharded_step_fn
from aiocluster_tpu.sim import SimConfig as RefConfig
from aiocluster_tpu.sim import Simulator as RefSimulator
from aiocluster_tpu.sim.state import init_state as ref_init
from aiocluster_torch import SimConfig, Simulator, SweepSimulator
from aiocluster_torch.models import ring
from aiocluster_torch.ops import counters, gossip
from aiocluster_torch.parallel import (
    PARTITION_RULES,
    gather_state,
    init_blocks,
    make_mesh,
    match_partition_rules,
    shard_state,
    sharded_chunk_fn,
    sharded_metrics_fn as port_metrics_fn,
    sharded_tracked_chunk_fn,
    state_partition_spec,
)
from aiocluster_torch.sim.carry import state_to_numpy
from aiocluster_torch.sim.state import STATE_FIELDS, init_state

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)

N, BLOCKS = 1024, 8
NARROW = dict(version_dtype="int16", heartbeat_dtype="int16", fd_dtype="bfloat16")
PROFILES = {
    "full": dict(keys_per_node=8, fanout=2, budget=48, **NARROW),
    "lean": dict(keys_per_node=8, fanout=3, budget=64, version_dtype="int16",
                 track_failure_detector=False, track_heartbeats=False),
    "lean_int8": dict(keys_per_node=8, fanout=3, budget=64, version_dtype="int8",
                      track_failure_detector=False, track_heartbeats=False),
    "lean_u4r": dict(keys_per_node=15, fanout=3, budget=64, version_dtype="u4r",
                     track_failure_detector=False, track_heartbeats=False),
    "shrunk": dict(keys_per_node=8, fanout=2, budget=48, icount_dtype="int8",
                   live_bits=True, window_ticks=100, writes_per_round=1, **NARROW),
}


def _mesh():
    return make_mesh(["cpu"] * BLOCKS)


def _assert_states_equal(ref, port, where):
    got = state_to_numpy(port)
    for f in STATE_FIELDS:
        a, b = np.asarray(getattr(ref, f)), got[f]
        if a.dtype.name == "bfloat16":
            a, b = a.view(np.uint16), b.view(np.uint16)
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{where}: {f}"


CASES = [
    ("full", "auto"), ("full", "m8"), ("lean", "auto"), ("lean", "m8"),
    ("lean_int8", "auto"), ("lean_u4r", "auto"), ("shrunk", "auto"),
]


@pytest.mark.parametrize("profile, variant", CASES, ids=[f"{p}-{v}" for p, v in CASES])
def test_sharded_round_equals_reference(profile, variant):
    """Four rounds over 8 column blocks equal the reference's unsharded
    XLA rounds on every state field (gathered), round by round, and the
    flag of each round equals the reference's."""
    kw = dict(n_nodes=N, **PROFILES[profile])
    cfg = SimConfig(**kw, use_pallas=True, pallas_variant=variant)
    rcfg = RefConfig(**kw, use_pallas=False, use_pallas_fd=False)
    mesh = _mesh()
    offsets = mesh.offsets(cfg)
    pull = gossip.resolve_phases(cfg, "cpu", n_local=N // BLOCKS).pull
    assert pull == ("m8_two_pass" if variant == "m8" else "pairs_two_pass")
    blocks = init_blocks(cfg, mesh)
    rs = ref_init(rcfg)
    key, pkey = random.key(7), gossip.prng.key(7)
    counters.reset()
    for r in range(4):
        rs, rflag = ref_step(rs, key, rcfg, return_converged=True)
        blocks, flag = gossip.step_blocks(blocks, pkey, cfg, offsets=offsets,
                                          return_converged=True)
        _assert_states_equal(rs, gather_state(blocks), f"round {r + 1}")
        assert bool(flag) == bool(rflag)
    # Every block's pull and totals passes ran (the wrappers' plain versions).
    per_round = BLOCKS * cfg.fanout
    if variant == "m8":
        assert counters.plain_calls["m8_pull"] == counters.plain_calls["m8_totals"] == 4 * per_round
    else:
        assert counters.plain_calls["pull"] == counters.plain_calls["totals"] == 4 * per_round
    assert not counters.fallbacks and not counters.refusals


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel_forms"])
def test_sharded_round_equals_reference_sharded_step(use_pallas):
    """Three rounds over the port's 8 blocks equal the reference's own
    sharded step on its 8-device CPU mesh (its XLA sharded round: the
    psum'd deficit totals), field for field."""
    kw = dict(n_nodes=N, **PROFILES["full"])
    cfg = SimConfig(**kw, use_pallas=use_pallas)
    rcfg = RefConfig(**kw)
    mesh = _mesh()
    step = sharded_step_fn(rcfg, ref_make_mesh())
    rs = ref_shard_state(ref_init(rcfg), ref_make_mesh())
    blocks = init_blocks(cfg, mesh)
    key, pkey = random.key(3), gossip.prng.key(3)
    for r in range(3):
        rs = step(rs, key)
        blocks = gossip.step_blocks(blocks, pkey, cfg, offsets=mesh.offsets(cfg))
        _assert_states_equal(rs, gather_state(blocks), f"round {r + 1}")


@pytest.mark.parametrize("seed", [0, 4])
def test_simulator_mesh_converges_like_unsharded(seed):
    """``Simulator(mesh=)`` converges at the round of the reference's
    unsharded run and of the port's, and its metrics at convergence are
    the converged bundle."""
    kw = dict(n_nodes=N, keys_per_node=4, fanout=2, budget=128, **NARROW)
    want = RefSimulator(RefConfig(**kw), seed=seed, chunk=4).run_until_converged(200)
    sim = Simulator(SimConfig(**kw, use_pallas=True), seed=seed, chunk=4, mesh=_mesh())
    assert sim.device == torch.device("cpu") and len(sim.blocks) == BLOCKS
    got = sim.run_until_converged(200)
    assert got is not None and got == want
    assert got == Simulator(SimConfig(**kw), seed=seed, chunk=4, device="cpu").run_until_converged(200)
    m = sim.metrics()
    assert bool(m["all_converged"]) and float(m["min_fraction"]) == 1.0
    assert int(m["version_spread"]) == 0 and int(m["staleness_p100"]) == 0


def test_simulator_mesh_metrics_equal_reference_sharded_metrics():
    """Mid-run, ``Simulator(mesh=).metrics()`` equals the reference's
    ``sharded_metrics_fn`` on its 8-device mesh at the same state: the
    counts, the flag, the version spread and the staleness percentiles
    exactly; the fraction and key-version sums to float32 rounding (the
    reference sums each shard in float32 then psums, the port sums in
    float64 and int64 and rounds once)."""
    kw = dict(n_nodes=N, keys_per_node=6, fanout=2, budget=20, writes_per_round=1, **NARROW)
    rcfg = RefConfig(**kw)
    ref = RefSimulator(rcfg, seed=2, chunk=3, mesh=ref_make_mesh())
    ref.run(3)
    want = {k: np.asarray(v) for k, v in sharded_metrics_fn(ref_make_mesh())(ref.state).items()}
    sim = Simulator(SimConfig(**kw, use_pallas=True), seed=2, chunk=3, mesh=_mesh())
    sim.run(3)
    _assert_states_equal(ref.state, sim.state, "round 3")
    got = sim.metrics()
    assert set(got) == set(want)
    exact = ("converged_owners", "all_converged", "alive_count", "fd_false_positives",
             "version_spread", "staleness_p50", "staleness_p99", "staleness_p100")
    for k in exact:
        assert np.array_equal(got[k], want[k]), k
    for k in set(want) - set(exact):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert not bool(got["all_converged"]) and int(got["version_spread"]) > 0


def test_chunk_functions_equal_the_simulator():
    """The reference-shaped chunk, tracked-chunk and metrics functions
    run the Simulator's rounds: 3 + 2 rounds of them equal 5 of
    ``Simulator(mesh=)``, the tracked chunk's first converged tick is 0
    before convergence, and the metrics are the Simulator's."""
    cfg = SimConfig(n_nodes=N, **PROFILES["full"], use_pallas=True)
    mesh = _mesh()
    key = gossip.prng.key(9)
    blocks = sharded_chunk_fn(cfg, mesh)(init_blocks(cfg, mesh), key, 3, 0)
    blocks, first = sharded_tracked_chunk_fn(cfg, mesh)(blocks, key, 2, 3)
    sim = Simulator(cfg, seed=9, mesh=mesh)
    sim.run(5)
    assert int(first) == 0 and int(blocks[0].tick) == sim.tick == 5
    whole = gather_state(blocks)
    assert all(torch.equal(getattr(whole, f), getattr(sim.state, f)) for f in STATE_FIELDS)
    got = {k: v.numpy() for k, v in port_metrics_fn(mesh)(blocks).items()}
    want = sim.metrics()
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)


def test_one_block_mesh_runs_the_unsharded_forms():
    """A mesh of one block is the unsharded round (the staged forms), as
    in the reference; a state passed in is sharded into the blocks."""
    cfg = SimConfig(n_nodes=256, keys_per_node=4, fanout=2, budget=32, use_pallas=True, **NARROW)
    assert gossip.resolve_phases(cfg, "cpu", n_local=256).pull == "pairs"
    a = Simulator(cfg, seed=1, mesh=make_mesh(["cpu"]))
    b = Simulator(cfg, seed=1, device="cpu")
    a.run(3)
    b.run(3)
    assert all(torch.equal(getattr(a.state, f), getattr(b.state, f)) for f in STATE_FIELDS)
    c = Simulator(cfg, seed=1, mesh=make_mesh(["cpu"] * 2), state=b.state)
    assert c.tick == 3 and [blk.w.shape for blk in c.blocks] == [(256, 128)] * 2
    c.run(2)
    b.run(2)
    assert all(torch.equal(getattr(c.state, f), getattr(b.state, f)) for f in STATE_FIELDS)


@pytest.mark.parametrize("profile", ["full", "lean_u4r", "shrunk"])
def test_blocks_shard_and_gather_the_state(profile):
    """``init_blocks`` makes the blocks of ``init_state`` without the
    whole state, ``shard_state`` splits a state into them (the packed w
    and live bitmap along their stored columns) and ``gather_state``
    puts them back."""
    cfg = SimConfig(n_nodes=512, **PROFILES[profile])
    mesh = make_mesh(["cpu"] * 4)
    whole = init_state(cfg, device="cpu")
    made, split = init_blocks(cfg, mesh), shard_state(whole, mesh)
    for a, b in zip(made, split):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in STATE_FIELDS)
    back = gather_state(made)
    assert all(torch.equal(getattr(back, f), getattr(whole, f)) for f in STATE_FIELDS)
    assert made[1].w.shape[1] == (64 if cfg.version_dtype == "u4r" else 128)


def test_partition_rules_classify_every_field_and_refuse_new_ones():
    specs = state_partition_spec()
    assert set(specs) == set(STATE_FIELDS)
    assert specs["w"] == (None, "owners") and specs["alive"] == ()
    with pytest.raises(ValueError, match="'staleness'.*PARTITION_RULES"):
        match_partition_rules(PARTITION_RULES, ["w", "staleness"])


def test_mesh_widths_are_refused_by_name():
    """A mesh that does not split the owners into whole blocks, or whose
    blocks leave the kernels' lane-aligned domain while the kernels are
    wanted, is refused naming the width; the plain round takes any
    whole block."""
    cfg = SimConfig(n_nodes=1024, keys_per_node=4, **NARROW)
    with pytest.raises(ValueError, match="n_nodes=1024"):
        Simulator(cfg, mesh=make_mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="n_local=64"):
        Simulator(dataclasses.replace(cfg, use_pallas=True), mesh=make_mesh(["cpu"] * 16))
    plain = Simulator(cfg, seed=1, mesh=make_mesh(["cpu"] * 16))
    plain.run(2)
    ref = Simulator(cfg, seed=1, device="cpu")
    ref.run(2)
    assert all(torch.equal(getattr(plain.state, f), getattr(ref.state, f)) for f in STATE_FIELDS)
    with pytest.raises(ValueError, match="device="):
        Simulator(cfg, mesh=make_mesh(["cpu"] * 2), device="cpu")


def test_unported_mesh_routes_refuse_by_roadmap_id():
    """No mesh route is refused by roadmap ID any more: a topology over a
    mesh (A7, once refused here) runs, equal to the unsharded run, and so
    does a sweep over a mesh (A15b, once refused here), lane for lane
    (tests/test_torch_sweep_mesh.py holds it against the reference)."""
    counters.reset()
    cfg = SimConfig(n_nodes=128, **NARROW)
    meshed = Simulator(cfg, seed=2, mesh=make_mesh(["cpu"] * 2), topology=ring(128, 2))
    whole = Simulator(cfg, seed=2, device="cpu", topology=ring(128, 2))
    meshed.run(3)
    whole.run(3)
    assert all(torch.equal(getattr(meshed.state, f), getattr(whole.state, f)) for f in STATE_FIELDS)
    lanes = SweepSimulator(cfg, [0, 1], mesh=make_mesh(["cpu"] * 2))
    flat = SweepSimulator(cfg, [0, 1], device="cpu")
    lanes.run(3)
    flat.run(3)
    assert all(
        torch.equal(getattr(lanes.states, f), getattr(flat.states, f)) for f in STATE_FIELDS
    )
    assert sum(counters.refusals.values()) == 0


def test_topology_mesh_takes_blocks_off_the_kernels_domain():
    """A topology round's pull is plain ("topology") whatever the config
    asks, so a mesh whose blocks are off the kernels' lane-aligned domain
    runs it where the kernels are wanted, equal to the unsharded run;
    the same blocks without the topology stay refused."""
    cfg = SimConfig(n_nodes=256, keys_per_node=4, use_pallas=True, **NARROW)
    with pytest.raises(ValueError, match="n_local=64"):
        Simulator(cfg, mesh=make_mesh(["cpu"] * 4))
    counters.reset()
    meshed = Simulator(cfg, seed=3, mesh=make_mesh(["cpu"] * 4), topology=ring(256, 2))
    whole = Simulator(cfg, seed=3, device="cpu", topology=ring(256, 2))
    meshed.run(3)
    assert counters.fallbacks["topology"] == 3
    whole.run(3)
    assert all(torch.equal(getattr(meshed.state, f), getattr(whole.state, f)) for f in STATE_FIELDS)


def test_reduce_blocks_in_block_order():
    """The collectives reduce in block order and hand each block the
    result; float32 partials summed in order 0 .. P-1."""
    parts = [torch.tensor([1.0, 2.0 ** 24]), torch.tensor([2.0 ** -30, 1.0]),
             torch.tensor([3.0, -(2.0 ** 24)])]
    out = gossip.reduce_blocks(parts, "sum")
    want = (parts[0] + parts[1]) + parts[2]
    assert len(out) == 3 and all(torch.equal(o, want) for o in out)
    assert torch.equal(gossip.reduce_blocks(parts, "min")[1], torch.tensor([2.0 ** -30, -(2.0 ** 24)]))
    assert torch.equal(gossip.reduce_blocks(parts, "max")[2], torch.tensor([3.0, 2.0 ** 24]))
