"""``SimCluster`` equals the reference's: one script of writes
(set, idempotent set, delete, set_with_ttl), steps, kills, revivals and
compactions on both packages, with ``get``, ``replica_view``,
``live_view``, ``alive_nodes``, the compaction counts and the state
equal after every step; the same on a mesh's column blocks; the u4r
refusal; the write flush, kill and revival leave a state handed out
earlier untouched. Tolerance 0.

The reference's write flush adds a numpy array that it zeroes right
after dispatch, and JAX's CPU backend reads it only when the add runs,
so writes flushed behind queued rounds can be lost (ROADMAP.md C6). The
reference here flushes a copy (``tools.torch_reference_digests.
copying_simcluster``), its intended semantics, which the port keeps."""

import dataclasses

import numpy as np
import pytest
import torch

from aiocluster_torch import SimCluster, SimConfig, lean_config
from aiocluster_torch.parallel import make_mesh
from aiocluster_torch.sim.state import STATE_FIELDS
from test_torch_checkpoint import ref_config
from test_torch_sim import NARROW, _assert_states_equal
from tools.torch_reference_digests import copying_simcluster

torch.set_num_threads(1)

RefSimCluster = copying_simcluster()

PLAIN = dict(use_pallas=False, use_pallas_fd=False)
CONFIGS = {
    "headline_64": SimConfig(n_nodes=64, keys_per_node=4, fanout=3, budget=64, **NARROW,
                             **PLAIN),
    "lifecycle_128": SimConfig(n_nodes=128, keys_per_node=4, fanout=2, budget=32,
                               dead_grace_ticks=6, **PLAIN),
}
OWNERS = (0, 5, 17, 40)
OBSERVERS = (1, 3, 9, 40, 63)
KILLED = (3, 9)


def _observe(sc) -> dict:
    """Everything the public surface shows, for the observers and owners
    of the script."""
    names = [f"node-{i}" for i in range(sc.cfg.n_nodes)]
    out = {
        "tick": sc.tick,
        "alive": sc.alive_nodes(),
        "get": {(o, k): sc.get(names[o], k) for o in OWNERS
                for k in ("key-0000", "key-0001", "a", "b", "ttl")},
        "views": {(i, j): sc.replica_view(names[i], names[j])
                  for i in OBSERVERS for j in OWNERS + KILLED},
    }
    if sc.cfg.track_failure_detector:
        out["live"] = {i: sc.live_view(names[i]) for i in OBSERVERS}
    return out


def _script(sc) -> list:
    seen = []

    def snap(**extra):
        seen.append(dict(_observe(sc), **extra))

    names = [f"node-{i}" for i in range(sc.cfg.n_nodes)]
    snap(converged=sc.run_until_converged(200))
    for k, o in enumerate(OWNERS):
        sc.set(names[o], "a", f"v{k}")
        sc.set(names[o], "a", f"v{k}")  # idempotent
        sc.set(names[o], "b", "x")
        sc.delete(names[o], "key-0001")
        sc.delete(names[o], "missing")  # no-op
        sc.set_with_ttl(names[o], "ttl", "t")
        sc.set_with_ttl(names[o], "ttl", "t")  # idempotent
    sc.step(1)
    snap()
    sc.step(2)
    snap(folded=sc.compact())
    for i in KILLED:
        sc.kill(names[i])
    sc.set(names[OWNERS[1]], "a", "after-kill")
    sc.set(names[KILLED[0]], "dead-write", "z")  # a dead owner's write waits
    sc.step(40)  # past the failure detectors' bound
    snap(folded=sc.compact())
    sc.revive(names[KILLED[0]])
    sc.step(4)
    snap()
    sc.revive(names[KILLED[1]])
    snap(converged=sc.run_until_converged(400), folded=sc.compact())
    return seen


@pytest.mark.parametrize("mesh", [None, 4], ids=["one_block", "mesh"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_script_equals_the_reference(name, mesh):
    cfg = CONFIGS[name]
    ref = RefSimCluster(ref_config(cfg), seed=11)
    port = SimCluster(cfg, seed=11, device=None if mesh else "cpu",
                      mesh=make_mesh(["cpu"] * mesh) if mesh else None)
    want, got = _script(ref), _script(port)
    assert len(want) == len(got)
    for step, (a, b) in enumerate(zip(want, got)):
        assert a == b, f"step {step}"
    _assert_states_equal(ref.sim.state, port.sim.state, "end of the script")
    killed = [f"node-{k}" for k in KILLED]
    assert not set(killed) & set(got[3]["live"][OBSERVERS[0]])  # the FD saw them die
    assert np.array_equal(ref.sim.metrics()["converged_owners"], port.metrics()["converged_owners"])


def test_writes_kills_and_revivals_replace_the_state_out_of_place():
    cfg = CONFIGS["headline_64"]
    sc = SimCluster(cfg, seed=1, device="cpu")
    held = sc.sim.state
    before = {f: getattr(held, f).clone() for f in STATE_FIELDS}
    sc.set("node-2", "k", "v")
    sc._flush_writes()
    sc.kill("node-4")
    sc.revive("node-4")
    sc.kill("node-5")
    for f in STATE_FIELDS:
        assert torch.equal(getattr(held, f), before[f]), f
    now = sc.sim.state
    assert int(now.max_version[2]) == cfg.keys_per_node + 1
    assert bool(now.alive[4]) and not bool(now.alive[5])
    assert sc.sim._known_max_version == cfg.keys_per_node + 1


def test_refusals_equal_the_reference():
    u4r = lean_config(128, "u4r", keys_per_node=8, **PLAIN)
    with pytest.raises(ValueError) as want:
        RefSimCluster(ref_config(u4r))
    with pytest.raises(ValueError) as got:
        SimCluster(u4r, device="cpu")
    assert str(got.value) == str(want.value)
    lean = lean_config(128, keys_per_node=4, **PLAIN)
    with pytest.raises(ValueError, match="failure detector disabled"):
        SimCluster(lean, device="cpu").live_view("node-0")
    with pytest.raises(ValueError, match="names length"):
        SimCluster(lean, names=["a"], device="cpu")


def test_explicit_names_and_initial_values_equal_the_reference():
    """BASELINE config 1's shape: three named nodes with one key each."""
    cfg = SimConfig(n_nodes=3, keys_per_node=1, fanout=1, budget=8, **PLAIN)
    names = ["alpha", "beta", "gamma"]
    kv = {n: {"key": f"{n}-value"} for n in names}
    ref = RefSimCluster(ref_config(cfg), names=names, initial_key_values=kv, seed=0)
    port = SimCluster(cfg, names=names, initial_key_values=kv, seed=0, device="cpu")
    assert port.run_until_converged(50) == ref.run_until_converged(50)
    for i in names:
        for j in names:
            assert port.replica_view(i, j) == ref.replica_view(i, j) == kv[j]
    assert port.live_view("beta") == ref.live_view("beta") == names
    port.set("gamma", "key", "new")
    ref.set("gamma", "key", "new")
    port.step(3)
    ref.step(3)
    assert [port.replica_view(n, "gamma") for n in names] == [
        ref.replica_view(n, "gamma") for n in names]
    _assert_states_equal(ref.sim.state, port.sim.state, "three nodes")
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(cfg)


def test_writes_flushed_behind_queued_rounds_are_kept():
    """Writes issued right after an unsynced ``step`` reach max_version
    (the reference's race, C6, loses them on its CPU backend)."""
    cfg = SimConfig(n_nodes=1024, keys_per_node=4, fanout=3, budget=64, **NARROW, **PLAIN)
    ref = RefSimCluster(ref_config(cfg), seed=3)
    port = SimCluster(cfg, seed=3, device="cpu")
    for sc in (ref, port):
        sc.step(2)
        for i in OWNERS:
            sc.set(f"node-{i}", "a", "1")
        sc.step(2)
        for i in OWNERS:
            sc.delete(f"node-{i}", "a")
        sc.step(2)
    assert port.sim.state.max_version[list(OWNERS)].tolist() == [cfg.keys_per_node + 2] * 4
    _assert_states_equal(ref.sim.state, port.sim.state, "after the flushes")
