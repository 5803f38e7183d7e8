"""Checkpoints interoperate with the reference: a file the reference
writes resumes in the port and one the port writes resumes in the
reference, for every rung of the memory ladder, churn, a fault plan and
a topology, and both continue on field-equal trajectories; the same for
sweep files; the metadata JSON of both packages is equal; the port
refuses every file the reference refuses, with the reference's words.
Tolerance 0 (the reference's XLA path on the CPU against the port's
plain path)."""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import jax
from aiocluster_tpu.models import topology as ref_topology
from aiocluster_tpu.sim import Simulator as RefSimulator
from aiocluster_tpu.sim import SweepSimulator as RefSweep
from aiocluster_tpu.sim import checkpoint as ref_ckpt
from aiocluster_torch import Simulator, SimConfig, SweepSimulator, full_config, lean_config
from aiocluster_torch.faults import flaky_links, split_brain
from aiocluster_torch.models import Heterogeneity, topology
from aiocluster_torch.parallel import make_mesh
from aiocluster_torch.sim import checkpoint
from aiocluster_torch.sim.state import STATE_FIELDS, lane
from test_torch_sim import NARROW, _assert_states_equal

torch.set_num_threads(1)

PLAIN = dict(use_pallas=False, use_pallas_fd=False)
BASE = dict(n_nodes=128, keys_per_node=4, fanout=3, budget=64, **PLAIN)
SAVE_TICK, MORE = 5, 4

# name: (port config, topology spec (constructor name, args) or None)
RUNGS = {
    "headline": (SimConfig(**BASE, **NARROW), None),
    "lean_int8": (lean_config(128, "int8", budget=64, keys_per_node=4, **PLAIN), None),
    "u4r": (lean_config(128, "u4r", budget=64, keys_per_node=8, **PLAIN), None),
    "full_deep": (full_config(128, "deep", budget=64, keys_per_node=4, **PLAIN), None),
    "churn": (SimConfig(**BASE, **NARROW, death_rate=0.05, revival_rate=0.2,
                        writes_per_round=1), None),
    "fault_plan": (SimConfig(**BASE, fault_plan=split_brain(2, start=0.0, heal=6.0)), None),
    "topology": (SimConfig(**dict(BASE, n_nodes=64)), ("ring", (64, 1))),
}


def ref_config(cfg: SimConfig):
    """The reference's config for a port config, through the checkpoint
    metadata's JSON form (the interop path itself)."""
    return ref_ckpt._config_from_meta(json.loads(json.dumps(dataclasses.asdict(cfg))))


def _topologies(spec):
    if spec is None:
        return None, None
    name, args = spec
    return getattr(topology, name)(*args), getattr(ref_topology, name)(*args)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
@pytest.mark.parametrize("rung", list(RUNGS))
def test_checkpoint_resumes_across_packages(rung, direction, tmp_path):
    cfg, spec = RUNGS[rung]
    topo, ref_topo = _topologies(spec)
    path = tmp_path / "run.npz"
    if direction == "reference_to_port":
        ref = RefSimulator(ref_config(cfg), seed=7, topology=ref_topo)
        ref.run(SAVE_TICK)
        ref.save(path)
        port = Simulator.resume(path, topology=topo, device="cpu")
    else:
        port = Simulator(cfg, seed=7, topology=topo, device="cpu")
        port.run(SAVE_TICK)
        port.save(path)
        ref = RefSimulator.resume(path, topology=ref_topo)
        port = Simulator.resume(path, topology=topo, device="cpu")
    assert port.cfg == cfg and port.seed == 7 and port.tick == SAVE_TICK
    _assert_states_equal(ref.state, port.state, "at the resume")
    ref.run(MORE)
    port.run(MORE)
    _assert_states_equal(ref.state, port.state, f"{MORE} rounds after the resume")


def test_resume_restores_the_horizon_guard_and_continues_on_a_mesh(tmp_path):
    """A resumed run's guard charges writes only from the saved tick; the
    same file continues on column blocks equal to the unsharded resume,
    and a mesh run saves block by block the state an unsharded run saves."""
    cfg = SimConfig(**dict(BASE, n_nodes=256), version_dtype="int16", writes_per_round=1)
    sim = Simulator(cfg, seed=2, device="cpu")
    sim.run(6)
    path = tmp_path / "a.npz"
    sim.save(path)
    whole = Simulator.resume(path, device="cpu")
    assert (whole._host_tick, whole._version_base_tick) == (6, 6)
    assert whole._known_max_version == int(sim.state.max_version.max())
    mesh = Simulator.resume(path, mesh=make_mesh(["cpu"] * 4))
    whole.run(3)
    mesh.run(3)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(whole.state, f), getattr(mesh.state, f)), f
    mesh_path, whole_path = tmp_path / "m.npz", tmp_path / "w.npz"
    mesh.save(mesh_path)
    whole.save(whole_path)
    with np.load(mesh_path) as a, np.load(whole_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="list its devices"):
        Simulator.resume(path, mesh=make_mesh(["cpu"] * 4), device="cpu")


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_sweep_checkpoint_resumes_across_packages(direction, tmp_path):
    cfg = SimConfig(**BASE, **NARROW)
    lanes = dict(fanout=[1, 2, 3], phi_threshold=[7.0, 8.0, 9.5], writes_per_round=[0, 1, 2])
    seeds = [3, 4, 5]
    path = tmp_path / "sweep.npz"
    if direction == "reference_to_port":
        ref = RefSweep(ref_config(cfg), seeds, chunk=4, **lanes)
        ref.run(SAVE_TICK)
        ref.save(path)
        port = SweepSimulator.resume(path, chunk=4, device="cpu")
    else:
        port = SweepSimulator(cfg, seeds, chunk=4, device="cpu", **lanes)
        port.run(SAVE_TICK)
        port.save(path)
        ref = RefSweep.resume(path, chunk=4)
        port = SweepSimulator.resume(path, chunk=4, device="cpu")
    assert port.params == ref.params and port.seeds == seeds
    assert (port.tick, port._version_base_tick) == (SAVE_TICK, SAVE_TICK)
    rounds = ref.run_until_converged(200)
    assert port.run_until_converged(200) == rounds
    for s in range(3):
        want = jax.tree_util.tree_map(lambda x, s=s: np.asarray(x)[s], ref.states)
        _assert_states_equal(want, lane(port.states, s), f"lane {s}")


def test_sweep_resume_keeps_the_convergence_accumulator(tmp_path):
    cfg = SimConfig(**BASE, **NARROW)
    sweep = SweepSimulator(cfg, [0, 1], phi_threshold=[7.0, 9.0], device="cpu")
    rounds = sweep.run_until_converged(200)
    sweep.save(tmp_path / "s.npz")
    again = SweepSimulator.resume(tmp_path / "s.npz", device="cpu")
    assert again.run_until_converged(200) == rounds and again.tick == sweep.tick


@pytest.mark.parametrize(
    "cfg",
    [
        SimConfig(n_nodes=128),
        SimConfig(**BASE, **NARROW, fault_plan=flaky_links(0.2)),
        full_config(128, "shrunk", dead_grace_ticks=40),
        SimConfig(**BASE, heterogeneity=Heterogeneity(class_frac=(0.5, 0.5),
                                                      gossip_every=(1, 4))),
    ],
    ids=["default", "fault_plan", "shrunk_lifecycle", "heterogeneity"],
)
def test_meta_json_equals_the_reference(cfg, tmp_path):
    """The port's file carries the reference's metadata byte for byte."""
    Simulator(cfg, seed=1, device="cpu").save(tmp_path / "p.npz")
    if cfg.heterogeneity is None:
        RefSimulator(ref_config(cfg), seed=1).save(tmp_path / "r.npz")
    else:  # the reference cannot rebuild this config from its JSON
        from aiocluster_tpu.models.topology import Heterogeneity as RefHet
        from aiocluster_tpu.sim import SimConfig as RefConfig

        h = dataclasses.asdict(cfg.heterogeneity)
        rcfg = RefConfig(**dict(dataclasses.asdict(dataclasses.replace(cfg, heterogeneity=None)),
                                heterogeneity=RefHet(**h)))
        RefSimulator(rcfg, seed=1).save(tmp_path / "r.npz")
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "r.npz") as r:
        assert bytes(p["__meta__"]) == bytes(r["__meta__"])


def test_bfloat16_bytes_equal_the_reference(tmp_path):
    """The FD means, stored as bfloat16 bytes, are the reference's bytes
    (little-endian 16-bit words, a trailing itemsize axis)."""
    cfg = SimConfig(**BASE, **NARROW)
    ref = RefSimulator(ref_config(cfg), seed=4)
    ref.run(6)
    ref.save(tmp_path / "r.npz")
    port = Simulator.resume(tmp_path / "r.npz", device="cpu")
    port.save(tmp_path / "p.npz")
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "r.npz") as r:
        assert p["imean"].dtype == np.uint8 and p["imean"].shape == (128, 128, 2)
        for k in r.files:
            assert np.array_equal(p[k], r[k]), k


def _refusal(load, path):
    with pytest.raises(ValueError) as err:
        load(path)
    return str(err.value)


def test_refusals_match_the_reference(tmp_path):
    """Wrong kind of file, tampered dtypes and a missing topology are
    refused with the reference's words."""
    cfg = SimConfig(**BASE, **NARROW)
    single, sweep = tmp_path / "single.npz", tmp_path / "sweep.npz"
    Simulator(cfg, device="cpu").save(single)
    SweepSimulator(cfg, [0, 1], device="cpu").save(sweep)
    assert _refusal(lambda p: checkpoint.load_state(p, device="cpu"), sweep) == _refusal(
        ref_ckpt.load_state, sweep)
    assert _refusal(lambda p: checkpoint.load_sweep(p, device="cpu"), single) == _refusal(
        ref_ckpt.load_sweep, single)
    # A file whose dtypes claim another rung.
    with np.load(single) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    meta["dtypes"]["w"] = "uint8"
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    tampered = tmp_path / "tampered.npz"
    np.savez_compressed(tampered, **arrays)
    got = _refusal(lambda p: checkpoint.load_state(p, device="cpu"), tampered)
    assert got == _refusal(ref_ckpt.load_state, tampered)
    assert "stored 'uint8' != rung-expected 'int16'" in got
    # A topology run resumed without its topology.
    ring_path = tmp_path / "ring.npz"
    Simulator(SimConfig(**dict(BASE, n_nodes=64)), topology=topology.ring(64, 1),
              device="cpu").save(ring_path)
    got = _refusal(lambda p: Simulator.resume(p, device="cpu"), ring_path)
    assert got == _refusal(RefSimulator.resume, ring_path)


def test_heterogeneity_is_refused_on_load_as_the_reference_refuses_it(tmp_path):
    """A limitation shared with the reference: the metadata keeps the
    heterogeneity classes as a dict, which neither package's SimConfig
    takes back."""
    cfg = SimConfig(n_nodes=128, heterogeneity=Heterogeneity(class_frac=(0.5, 0.5),
                                                             gossip_every=(1, 4)))
    path = tmp_path / "het.npz"
    Simulator(cfg, device="cpu").save(path)
    got = _refusal(lambda p: Simulator.resume(p, device="cpu"), path)
    assert got == _refusal(RefSimulator.resume, path)
    assert got == "heterogeneity must be a models.topology.Heterogeneity"


def test_unknown_config_key_warns_and_missing_key_defaults(tmp_path):
    cfg = SimConfig(**BASE, **NARROW)
    path = tmp_path / "x.npz"
    Simulator(cfg, device="cpu").save(path)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    meta["config"]["from_the_future"] = 1
    del meta["config"]["window_ticks"]
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **arrays)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, got, _ = checkpoint.load_state(path, device="cpu")
    assert any("unknown keys ['from_the_future']" in str(w.message) for w in caught)
    assert got == cfg and got.window_ticks == SimConfig(n_nodes=2).window_ticks
    assert int(state.tick) == 0
