"""The port's native host simulator (aiocluster_torch/sim/hostsim.py) walks
the port ``Simulator``'s trajectory on its domain, round by round and
field by field (w compared by value: the host keeps it as int8): lean
budget-bound and saturating, the choice pairing, the full profile with
float32 and bfloat16 means, int8 watermarks, an 8-block CPU mesh, and the
converged rounds. It equals the reference's ``HostSimulator`` on the same
configs; on crafted failure-detector state where the liveness bound's
fused and unfused multiply-adds fall on either side of its left-hand
side (ROADMAP C3), its FD pass equals ``ops/fd.fd_update`` (the
reference's host pass and its simulator disagree there: ROADMAP C7). Its
support domain answers as the reference's, each package resumes the
other's checkpoint, a card run's state hands over and back, and a failed
g++ build raises with the compiler's message."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from aiocluster_tpu.faults import FaultPlan as RefFaultPlan
from aiocluster_tpu.faults import LinkFault as RefLinkFault
from aiocluster_tpu.faults import NodeSet as RefNodeSet
from aiocluster_tpu.models.topology import Heterogeneity as RefHeterogeneity
from aiocluster_tpu.obs.registry import MetricsRegistry as RefRegistry
from aiocluster_tpu.sim import SimConfig as RefConfig
from aiocluster_tpu.sim import Simulator as RefSimulator
from aiocluster_tpu.sim import hostsim as ref_hostsim
from aiocluster_tpu.sim.state import SimState as RefState
from aiocluster_torch import SimConfig, Simulator, full_config, lean_config
from aiocluster_torch.faults import FaultPlan, LinkFault, NodeSet
from aiocluster_torch.models import Heterogeneity
from aiocluster_torch.obs import MetricsRegistry
from aiocluster_torch.ops import fd as fd_mod
from aiocluster_torch.parallel import make_mesh
from aiocluster_torch.sim import hostsim
from aiocluster_torch.sim.carry import state_to_numpy
from aiocluster_torch.sim.state import STATE_FIELDS
from aiocluster_torch.utils import cbuild
from test_torch_checkpoint import ref_config

torch.set_num_threads(1)

N = 256
NARROW = dict(version_dtype="int16", heartbeat_dtype="int16")

# name: (config, seed, rounds compared one by one)
CASES = {
    "lean_budget_bound": (lean_config(N, budget=24), 1, 12),
    "lean_saturating": (lean_config(N, budget=4096), 2, 8),
    "lean_int8": (lean_config(N, "int8", budget=24), 3, 10),
    "choice_lean": (lean_config(N, budget=24, pairing="choice"), 11, 10),
    "full_float32": (full_config(N, budget=24, fd_dtype="float32"), 7, 10),
    "full_bfloat16": (full_config(N, budget=24), 7, 10),
}


def _assert_host_equals(host, state, where):
    """Every field of the host run (as a SimState) equals ``state``."""
    got = host.state()
    for f in STATE_FIELDS:
        a, b = getattr(got, f), getattr(state, f).cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, (where, f)
        assert torch.equal(a, b), (where, f)


def _ref_host_arrays(host) -> dict[str, np.ndarray]:
    """The reference host run's matrices, bfloat16 as its bits."""
    out = {"w": host.w}
    for name in ("hb", "heartbeat", "last_change", "imean", "icount", "live_view"):
        if hasattr(host, name):
            arr = getattr(host, name)
            out[name] = arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr
    return out


def _port_host_arrays(host) -> dict[str, np.ndarray]:
    out = {"w": host.w}
    for name in ("hb", "heartbeat", "last_change", "imean", "icount", "live_view"):
        if hasattr(host, name):
            out[name] = getattr(host, name)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_host_equals_simulator_round_by_round(name):
    cfg, seed, rounds = CASES[name]
    host = hostsim.HostSimulator(cfg, seed=seed)
    sim = Simulator(cfg, seed=seed, chunk=1, device="cpu")
    for r in range(1, rounds + 1):
        host.run(1)
        sim.run(1)
        _assert_host_equals(host, sim.state, f"{name} round {r}")


@pytest.mark.parametrize("name", ["lean_budget_bound", "choice_lean", "full_bfloat16"])
def test_converged_round_equals_simulator(name):
    cfg, seed, _ = CASES[name]
    cfg = dataclasses.replace(cfg, budget=64)
    want = Simulator(cfg, seed=seed, chunk=4, device="cpu").run_until_converged(max_rounds=512)
    host = hostsim.HostSimulator(cfg, seed=seed)
    assert want is not None and host.run_until_converged(max_rounds=512) == want


def test_host_equals_eight_block_mesh_round_by_round():
    cfg = lean_config(N, budget=64)
    sim = Simulator(cfg, seed=4, chunk=1, mesh=make_mesh(["cpu"] * 8))
    host = hostsim.HostSimulator(cfg, seed=4)
    for r in range(1, 9):
        sim.run(1)
        host.run(1)
        _assert_host_equals(host, sim.state, f"mesh round {r}")


@pytest.mark.parametrize("name", list(CASES))
def test_host_equals_the_reference_host(name):
    cfg, seed, rounds = CASES[name]
    ref = ref_hostsim.HostSimulator(ref_config(cfg), seed=seed)
    port = hostsim.HostSimulator(cfg, seed=seed)
    for r in range(1, rounds + 1):
        ref.run(1)
        port.run(1)
        want, got = _ref_host_arrays(ref), _port_host_arrays(port)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} round {r} {k}")
    assert port.tick == ref.tick


def test_telemetry_equals_the_reference_host(tmp_path):
    cfg = lean_config(N, budget=64)
    ref = ref_hostsim.HostSimulator(ref_config(cfg), seed=1, metrics=RefRegistry(),
                                    metrics_stride=3)
    port = hostsim.HostSimulator(cfg, seed=1, metrics=MetricsRegistry(), metrics_stride=3)
    assert port.run_until_converged(200) == ref.run_until_converged(200)
    want, got = ref.flush_metrics(), port.flush_metrics()
    wall = ("step_seconds",)
    assert [{k: v for k, v in s.items() if k not in wall} for s in got] == [
        {k: v for k, v in s.items() if k not in wall} for s in want]
    assert got[-1]["tick"] == port.tick


# -- C3: the FD bound's multiply-add, rounded once -----------------------------

# (icount, elapsed, imean): the FD bound's left-hand side elapsed * (count
# + 5) lies above 8 * fma(imean, count, 25) and at 8 * (imean * count +
# 25) with the product and the sum rounded apart (phi 8, prior weight 5,
# prior mean 5). The first is ROADMAP C3's 360.0 against 359.99997.
C3_CASES = (
    (5, 36, 3.999999523162842),
    (10, 24, 1.999999761581421),
    (13, 20, 1.5384613275527954),
    (25, 12, 0.7999998927116394),
    (3, 27, 0.6666663289070129),
    (3, 44, 6.333332538604736),
)


def _bounds(count, elapsed, mean):
    f32 = np.float32
    lhs = f32(f32(elapsed) * f32(count + 5))
    unfused = f32(8) * f32(f32(f32(mean) * f32(count)) + f32(25))
    fused = f32(8) * f32(np.float64(f32(mean)) * count + 25.0)
    return lhs, unfused, fused


@pytest.mark.parametrize("case", C3_CASES, ids=[f"lhs{(c[0] + 5) * c[1]}_count{c[0]}" for c in C3_CASES])
def test_fd_pass_equals_fd_update_on_crafted_state(case):
    """One FD pass of the host library on crafted state (no heartbeat
    rose, so the crafted mean and count stand): the live view, means and
    counts equal ``fd.fd_update``'s, and the crafted pair is dead, as the
    simulator rounds the bound."""
    count, elapsed, mean = case
    lhs, unfused, fused = _bounds(count, elapsed, mean)
    assert fused < lhs <= unfused  # the two roundings split the bound
    n, tick = 16, 50
    cfg = full_config(n, budget=24, fd_dtype="float32")
    rng = np.random.default_rng(count)
    hb = rng.integers(1, 40, (n, n)).astype(np.int16)
    hb0 = hb.copy()
    hb0[rng.random((n, n)) < 0.3] -= 1  # some heartbeats rose this round
    lc = rng.integers(1, tick, (n, n)).astype(np.int16)
    icount = rng.integers(0, 30, (n, n)).astype(np.int16)
    imean = rng.uniform(0.5, 9.0, (n, n)).astype(np.float32)
    i, j = 3, 11  # the crafted pair: nothing rose there
    hb0[i, j] = hb[i, j]
    lc[i, j], icount[i, j], imean[i, j] = tick - elapsed, count, mean
    live = np.zeros((n, n), dtype=bool)
    args = [hb.copy(), hb0.copy(), lc.copy(), imean.copy(), icount.copy(), live.copy()]
    lib = hostsim.load()
    lib.acg_hostsim_fd(
        args[0].ctypes.data, args[1].ctypes.data, args[2].ctypes.data, args[3].ctypes.data, 0,
        args[4].ctypes.data, args[5].ctypes.data, n, tick, cfg.max_interval_ticks,
        cfg.window_ticks, float(np.float32(cfg.prior_weight)),
        float(np.float32(cfg.prior_weight * cfg.prior_mean_ticks)),
        float(np.float32(cfg.phi_threshold)))
    t = lambda a: torch.from_numpy(a).to(torch.int32)
    lc2, im2, ic2, live2 = fd_mod.fd_update(
        tick, t(hb), t(hb0), t(lc), torch.from_numpy(imean), t(icount),
        fd_mod.FdParams.from_config(cfg))
    live2 = live2 | torch.eye(n, dtype=torch.bool)
    np.testing.assert_array_equal(args[5], live2.numpy())
    np.testing.assert_array_equal(args[2], lc2.numpy().astype(np.int16))
    np.testing.assert_array_equal(args[3], torch.where(live2, im2, 0.0).numpy())
    np.testing.assert_array_equal(args[4], torch.where(live2, ic2, 0).numpy().astype(np.int16))
    assert not args[5][i, j]


def _crafted_state(tick: int = 44):
    """A real full-profile run at ``tick`` (float32 means), with the C3
    cases planted on pairs whose heartbeat knowledge no peer can raise."""
    cfg = SimConfig(n_nodes=128, keys_per_node=4, fanout=3, budget=64, fd_dtype="float32",
                    **NARROW)
    sim = Simulator(cfg, seed=3, chunk=8, device="cpu")
    sim.run(tick)
    arrays = state_to_numpy(sim.state)
    pairs = [(2 + 9 * k, 70 + 5 * k) for k in range(len(C3_CASES))]
    for (i, j), (count, elapsed, mean) in zip(pairs, C3_CASES):
        arrays["hb_known"][i, j] = 30_000
        arrays["last_change"][i, j] = tick + 1 - elapsed
        arrays["icount"][i, j] = count
        arrays["imean"][i, j] = mean
        arrays["live_view"][i, j] = True
    return cfg, arrays, pairs


def test_crafted_c3_state_round_equals_simulator_and_c7():
    """One round from the crafted state: the port's host run equals the
    port's Simulator on every field, each crafted pair dead. The
    reference's host pass rounds the bound's multiply-add apart and keeps
    every crafted pair live, where the reference's jit-compiled simulator
    (XLA:CPU contracts it) finds them dead: ROADMAP C7."""
    from aiocluster_torch.sim.carry import state_from_numpy

    cfg, arrays, pairs = _crafted_state()
    sim = Simulator(cfg, seed=3, chunk=1, device="cpu", state=state_from_numpy(arrays, cfg, "cpu"))
    host = hostsim.HostSimulator.from_state(cfg, sim.state, seed=3)
    sim.run(1)
    host.run(1)
    _assert_host_equals(host, sim.state, "crafted round")
    assert not any(host.live_view[i, j] for i, j in pairs)

    import jax.numpy as jnp

    rcfg = ref_config(cfg)
    ref_sim = RefSimulator(rcfg, seed=3, chunk=1,
                           state=RefState(**{f: jnp.asarray(arrays[f]) for f in STATE_FIELDS}))
    ref_host = ref_hostsim.HostSimulator(
        rcfg, seed=3, state_w=arrays["w"], tick=int(arrays["tick"]),
        state_extra={"hb": arrays["hb_known"], "heartbeat": arrays["heartbeat"],
                     "last_change": arrays["last_change"], "imean": arrays["imean"],
                     "icount": arrays["icount"], "live_view": arrays["live_view"]})
    ref_sim.run(1)
    ref_host.run(1)
    ref_live = np.asarray(ref_sim.state.live_view)
    np.testing.assert_array_equal(ref_live, host.live_view)  # the port equals the reference's simulator
    split = ref_live != ref_host.live_view
    assert sorted(zip(*np.nonzero(split))) == sorted(pairs)
    assert all(ref_host.live_view[i, j] for i, j in pairs)


# -- the support domain, checkpoints, hand-over, the build ---------------------


def _domain_cases(SimConfig, FaultPlan, LinkFault, NodeSet, Heterogeneity):
    """The support-domain matrix, built from either package's types: the
    in-domain bases, one violation per row, and every pair of violations
    combined (name -> config, or the ValueError its construction
    raises)."""
    lean = dict(n_nodes=128, keys_per_node=8, budget=24, version_dtype="int16",
                track_failure_detector=False, track_heartbeats=False)
    full = dict(n_nodes=128, keys_per_node=8, budget=24, version_dtype="int16",
                heartbeat_dtype="int16", fd_dtype="bfloat16", window_ticks=100)
    violations = {
        "heartbeat_dtype": (full, dict(heartbeat_dtype="int8")),
        "icount_dtype": (full, dict(icount_dtype="int8")),
        "live_bits": (full, dict(live_bits=True)),
        "dead_grace": (full, dict(dead_grace_ticks=8)),
        "pairing": (lean, dict(pairing="permutation")),
        "pairing_choice_full": (full, dict(pairing="choice")),
        "budget_policy": (lean, dict(budget_policy="greedy")),
        "shape_mod_128": (lean, dict(n_nodes=100)),
        "version_dtype": (lean, dict(version_dtype="u4r")),
        "version_int32": (lean, dict(version_dtype="int32")),
        "keys_fit_int8": (lean, dict(keys_per_node=200)),
        "deficit_total_f32_exact": (lean, dict(n_nodes=2**18, keys_per_node=127)),
        "churn_free": (lean, dict(death_rate=0.1)),
        "writes_free": (lean, dict(writes_per_round=1)),
        "fault_plan_inert": (lean, dict(fault_plan=FaultPlan(seed=1, links=(
            LinkFault(src=NodeSet(frac=(0.0, 0.5)), dst=NodeSet(frac=(0.5, 1.0)), drop=1.0),)))),
        "heterogeneity_inert": (lean, dict(heterogeneity=Heterogeneity(
            gossip_every=(1, 2), class_frac=(0.5, 0.5)))),
        "wan_classes": (lean, dict(heterogeneity=Heterogeneity(zones=2, wan_loss=0.1))),
        "quarantine": (lean, dict(quarantine=True, pairing="choice")),
    }
    cases = {"lean": dict(lean), "full": dict(full), "lean_int8": dict(lean, version_dtype="int8"),
             "choice": dict(lean, pairing="choice"), "full_float32": dict(full, fd_dtype="float32")}
    names = sorted(violations)
    for a in names:
        base, over = violations[a]
        cases[a] = {**base, **over}
        for b in names[names.index(a) + 1:]:
            base_b, over_b = violations[b]
            both = full if full in (base, base_b) else lean
            cases[f"{a}+{b}"] = {**both, **over, **over_b}
    out = {}
    for name, kw in cases.items():
        try:
            out[name] = SimConfig(**kw)
        except ValueError as exc:
            out[name] = ValueError(str(exc))
    return out


def test_unsupported_features_equal_the_reference_over_the_domain_matrix():
    port = _domain_cases(SimConfig, FaultPlan, LinkFault, NodeSet, Heterogeneity)
    ref = _domain_cases(RefConfig, RefFaultPlan, RefLinkFault, RefNodeSet, RefHeterogeneity)
    assert sorted(port) == sorted(ref)
    assert [r.feature for r in hostsim.SUPPORT_DOMAIN] == [
        r.feature for r in ref_hostsim.SUPPORT_DOMAIN]
    assert [r.allowed for r in hostsim.SUPPORT_DOMAIN] == [
        r.allowed for r in ref_hostsim.SUPPORT_DOMAIN]
    assert [r.note for r in hostsim.SUPPORT_DOMAIN] == [r.note for r in ref_hostsim.SUPPORT_DOMAIN]
    built = 0
    for name in port:
        p, r = port[name], ref[name]
        if isinstance(r, ValueError):
            assert isinstance(p, ValueError) and str(p) == str(r), name
            continue
        built += 1
        assert hostsim.unsupported_features(p) == ref_hostsim.unsupported_features(r), name
        assert hostsim.supported(p) == ref_hostsim.supported(r), name
    assert built > 100
    for name in ("lean", "full", "lean_int8", "choice", "full_float32"):
        assert hostsim.supported(port[name]), name
    with pytest.raises(ValueError, match="shape_mod_128"):
        hostsim.HostSimulator(port["shape_mod_128"])


@pytest.mark.parametrize("name", ["lean_budget_bound", "full_bfloat16"])
def test_checkpoints_resume_in_either_package(name, tmp_path):
    cfg, seed, _ = CASES[name]
    rcfg = ref_config(cfg)
    port = hostsim.HostSimulator(cfg, seed=seed)
    ref = ref_hostsim.HostSimulator(rcfg, seed=seed)
    port.run(5)
    ref.run(5)
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "ref"))
    assert json.loads((tmp_path / "port.json").read_text())["extras"] == json.loads(
        (tmp_path / "ref.json").read_text())["extras"]
    from_ref = hostsim.HostSimulator.resume(str(tmp_path / "ref"), cfg)
    from_port = ref_hostsim.HostSimulator.resume(str(tmp_path / "port"), rcfg)
    assert from_ref.tick == from_port.tick == 5
    for sim in (port, ref, from_ref, from_port):
        sim.run(4)
    runs = [_port_host_arrays(port), _port_host_arrays(from_ref), _ref_host_arrays(ref),
            _ref_host_arrays(from_port)]
    for got in runs[1:]:
        assert sorted(got) == sorted(runs[0])
        for k in got:
            np.testing.assert_array_equal(got[k], runs[0][k], err_msg=k)
    lean = hostsim.HostSimulator(lean_config(N, budget=64), seed=1)
    lean.save(str(tmp_path / "lean"))
    with pytest.raises(ValueError, match="profile"):
        hostsim.HostSimulator.resume(str(tmp_path / "lean"), full_config(N, budget=64))


def test_card_state_hands_over_to_the_host_and_back():
    """A Simulator's state continues on the host and comes back: the
    three-leg run equals one Simulator run of all the rounds."""
    cfg = full_config(N, budget=24)
    straight = Simulator(cfg, seed=5, chunk=4, device="cpu")
    straight.run(15)
    first = Simulator(cfg, seed=5, chunk=4, device="cpu")
    first.run(5)
    host = hostsim.HostSimulator.from_state(cfg, first.state, seed=5)
    assert host.tick == 5
    host.run(5)
    last = Simulator(cfg, seed=5, chunk=4, device="cpu", state=host.state("cpu"))
    last.run(5)
    _assert_host_equals(hostsim.HostSimulator.from_state(cfg, last.state, seed=5),
                        straight.state, "after the hand-back")
    lean = lean_config(N, budget=24)
    sim = Simulator(lean, seed=2, chunk=4, device="cpu")
    sim.run(3)
    host = hostsim.HostSimulator.from_state(lean, sim.state, seed=2)
    host.run(3)
    sim.run(3)
    _assert_host_equals(host, sim.state, "lean hand-over")


def test_build_failure_raises_with_the_compiler_message(monkeypatch, tmp_path):
    monkeypatch.setattr(cbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(hostsim, "_LIB", None)
    monkeypatch.setattr(hostsim, "FLAGS", ("-O3", "-fno-such-flag-exists"))
    with pytest.raises(cbuild.NativeBuildError, match="no-such-flag-exists"):
        hostsim.load()
    with pytest.raises(cbuild.NativeBuildError, match="no-such-flag-exists"):
        hostsim.HostSimulator(lean_config(N))
    assert not hostsim.available()
    assert not list(tmp_path.glob("*.so"))
