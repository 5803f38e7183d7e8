"""Reference digests for the PyTorch port's chip check (chip_smoke.py,
phases 14 to 16).

Runs the reference simulator (``aiocluster_tpu``, its XLA path on JAX's
CPU backend) on the configurations phase 14 drives at full width and
prints, as JSON, the sha256 of every state field after each of the
first ticks (the first 16 hex digits, field by field) and, where asked,
the converged round. chip_smoke.py holds the port's run on the card
against these constants, so they are recomputed with this script
whenever a configuration there changes:

    JAX_PLATFORMS=cpu python -m tools.torch_reference_digests CASE [CASE ...]

CASE is one of the names in ``CASES`` (each a few minutes on 8 CPU cores
and a few GB of host memory at 10,240 nodes; ``config4`` and the cases
marked so run on to their converged round), or one of ``SCRIPTS``:
``resume_headline`` (the headline saved at tick 8 and resumed from the
file), ``simcluster_headline`` (``SimCluster``'s write script,
``SIMCLUSTER_SCRIPT``) and ``twin_1024`` (the twin loop of
``tools.twin_trace.TWIN_LOOP`` on its seeded trace: the sha256 of the
replay's rows, the calibration record and the recommendation, about a
minute).
"""

from __future__ import annotations

import hashlib
import json
import sys

import numpy as np

FIELDS = ("tick", "max_version", "heartbeat", "alive", "w", "hb_known", "last_change",
          "imean", "icount", "live_view", "dead_since")


def field_digest(arr) -> str:
    """The first 16 hex digits of the sha256 of a field's bytes (C order;
    bfloat16 as its raw 16-bit words)."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def state_digests(state) -> dict[str, str]:
    return {f: field_digest(getattr(state, f)) for f in FIELDS}


def _headline(**over):
    from aiocluster_tpu.sim import SimConfig

    return SimConfig(n_nodes=10_240, keys_per_node=16, fanout=3, budget=2618,
                     version_dtype="int16", heartbeat_dtype="int16", fd_dtype="bfloat16",
                     **over)


def _config3(n):
    # BASELINE config 3 (benchmarks/run_all.py::config3).
    from aiocluster_tpu.sim import SimConfig

    return SimConfig(n_nodes=n, keys_per_node=16, fanout=3, budget=2618, death_rate=0.05,
                     revival_rate=0.2, writes_per_round=1, peer_mode="view", pairing="choice",
                     dead_grace_ticks=40)


def _lean(**over):
    # The lean profile at the headline's width and budget (fault_bench's
    # sim arm; lean_config(10_240, budget=2618)).
    from aiocluster_tpu.sim import SimConfig

    return SimConfig(n_nodes=10_240, keys_per_node=16, fanout=3, budget=2618,
                     track_failure_detector=False, track_heartbeats=False,
                     version_dtype="int16", **over)


def _faulted(name):
    # Phase 15's fault plans and heterogeneity classes.
    from aiocluster_tpu.faults import (
        FaultPlan, LinkFault, NodeSet, byzantine_storm, flaky_links, rolling_restart,
        split_brain,
    )
    from aiocluster_tpu.models.topology import Heterogeneity

    if name == "fault_bench_split":  # benchmarks/fault_bench.py's sim arm
        return _lean(fault_plan=split_brain(3, start=0.0, heal=48.0))
    if name == "flaky_headline":
        return _headline(fault_plan=flaky_links(0.2))
    if name == "cadence_headline":
        return _headline(heterogeneity=Heterogeneity(gossip_every=(1, 4), class_frac=(0.5, 0.5)))
    if name == "amnesia_headline":
        return _headline(fault_plan=rolling_restart(4, recovery="amnesia"))
    if name == "storm_headline":
        return _headline(fault_plan=byzantine_storm(0.25), dead_grace_ticks=40)
    if name == "quarantine_choice":
        return _lean(pairing="choice", quarantine=True, fault_plan=FaultPlan(
            links=(LinkFault(dst=NodeSet(frac=(0.0, 0.1)), drop=1.0),)))
    if name == "zone_choice":
        return _lean(pairing="choice", heterogeneity=Heterogeneity(
            zones=4, wan_loss=0.1, wan_delay=1.5, zone_bias=0.5))
    raise KeyError(name)


def _config4():
    # BASELINE config 4 (benchmarks/run_all.py::config4).
    from aiocluster_tpu.sim import SimConfig

    return SimConfig(n_nodes=10_000, keys_per_node=16, fanout=3, budget=2618, pairing="choice")


# name: (config builder, seed, ticks digested, topology builder, to convergence)
CASES = {
    "churn_headline": (lambda: _headline(death_rate=0.05, revival_rate=0.2, writes_per_round=1),
                       0, (1, 2, 3), None, False),
    "config3_1000": (lambda: _config3(1000), 0, (1, 2, 3, 200), None, False),
    "config3_10240": (lambda: _config3(10_240), 0, (1, 2, 3), None, False),
    "permutation_headline": (lambda: _headline(pairing="permutation"), 0, (1, 2, 3), None, False),
    "greedy_headline": (lambda: _headline(budget_policy="greedy"), 0, (1, 2, 3), None, False),
    "config4": (_config4, 0, (1, 2, 3), "scale_free", True),
    "fault_bench_split": (lambda: _faulted("fault_bench_split"), 0, (1, 2, 3), None, True),
    "flaky_headline": (lambda: _faulted("flaky_headline"), 0, (1, 2, 3), None, True),
    "cadence_headline": (lambda: _faulted("cadence_headline"), 0, (1, 2, 3), None, True),
    "amnesia_headline": (lambda: _faulted("amnesia_headline"), 0, (1, 2, 3, 4), None, False),
    "storm_headline": (lambda: _faulted("storm_headline"), 0, (1, 2, 3), None, False),
    "quarantine_choice": (lambda: _faulted("quarantine_choice"), 0, (1, 2, 3), None, False),
    "zone_choice": (lambda: _faulted("zone_choice"), 0, (1, 2, 3), None, False),
}


def run_case(name: str) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from aiocluster_tpu.models.topology import scale_free
    from aiocluster_tpu.sim import Simulator

    build, seed, ticks, topo, converge = CASES[name]
    cfg = build()
    topology = scale_free(cfg.n_nodes, attach=3, seed=0) if topo == "scale_free" else None
    sim = Simulator(cfg, seed=seed, topology=topology, chunk=1)
    out = {"ticks": {}}
    for t in ticks:
        sim.run(t - sim.tick)
        out["ticks"][t] = state_digests(sim.state)
    if converge:
        out["converged_round"] = sim.run_until_converged(max_rounds=4 * cfg.n_nodes)
    return out


RESUME_SAVE_TICK = 8


def run_resume_headline() -> dict:
    """The headline run to tick 8, saved, resumed from the file in a new
    simulator and digested at ticks 9-11, then run on to convergence."""
    import tempfile
    from pathlib import Path

    import jax

    jax.config.update("jax_platforms", "cpu")
    from aiocluster_tpu.sim import Simulator

    sim = Simulator(_headline(), seed=0, chunk=8)
    sim.run(RESUME_SAVE_TICK)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "headline.npz"
        sim.save(path)
        del sim
        resumed = Simulator.resume(path, chunk=1)
    out = {"ticks": {}}
    for t in (9, 10, 11):
        resumed.run(t - resumed.tick)
        out["ticks"][t] = state_digests(resumed.state)
    resumed.chunk = 8
    out["converged_round"] = resumed.run_until_converged(max_rounds=400)
    return out


# SimCluster's script at the headline width: 16 owners evenly spaced,
# each write phase followed by rounds; the names are the default
# "node-<i>". chip_smoke.py runs the same script on the port.
SIMCLUSTER_OWNERS = tuple(k * 640 for k in range(16))
SIMCLUSTER_KILLED = (7, 2_001, 5_003, 10_239)
SIMCLUSTER_KILL_ROUNDS = 32


def simcluster_script(sc, digest) -> dict:
    """Drive ``sc`` (a SimCluster of either package at the headline
    config) through the script; ``digest(tick)`` records the state's
    digests at the ticks the chip check holds. Returns the converged
    rounds."""
    names = [f"node-{i}" for i in SIMCLUSTER_OWNERS]
    out = {"converged_round": sc.run_until_converged(max_rounds=400)}
    for k, o in enumerate(names):
        sc.set(o, f"key-{k:04d}", f"new-{k}")
        sc.set(o, "extra", f"x{k}")
    sc.step(2)
    for o in names:
        sc.delete(o, "key-0001")
    sc.step(2)
    digest(sc.tick)
    for k, o in enumerate(names):
        sc.set_with_ttl(o, "ttl", f"t{k}")
    out["script_converged_round"] = sc.run_until_converged(max_rounds=400)
    for i in SIMCLUSTER_KILLED:
        sc.kill(f"node-{i}")
    sc.step(SIMCLUSTER_KILL_ROUNDS)
    digest(sc.tick)
    return out


def copying_simcluster():
    """The reference's SimCluster with its write flush adding a copy of the
    pending counts. The reference adds the numpy array it zeroes right
    after dispatch; JAX's CPU backend reads that buffer when the add
    runs, behind any rounds still queued, so writes flushed after an
    unsynced ``step`` are lost (ROADMAP.md C6). The copy gives the
    reference's intended semantics, which the port implements."""
    from aiocluster_tpu.sim.simcluster import SimCluster

    class CopyingSimCluster(SimCluster):
        def _flush_writes(self) -> None:
            if self._pending_writes.any():
                state = self.sim.state
                self.sim.state = state.replace(
                    max_version=state.max_version + self._pending_writes.copy())
                self.sim.note_max_version_increase(int(self._pending_writes.max()))
                self._pending_writes[:] = 0

    return CopyingSimCluster


def run_simcluster_headline() -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sc = copying_simcluster()(_headline(), seed=0)
    out = {"ticks": {}}
    out.update(simcluster_script(sc, lambda t: out["ticks"].__setitem__(
        t, state_digests(sc.sim.state))))
    return out


def run_twin_1024() -> dict:
    """The twin loop (tools/twin_trace.py ``TWIN_LOOP``) through the
    reference's twin, on the seeded trace chip_smoke.py writes."""
    import tempfile
    from pathlib import Path

    import jax

    jax.config.update("jax_platforms", "cpu")
    from aiocluster_tpu import twin
    from aiocluster_tpu.core.config import Config
    from aiocluster_tpu.core.identity import NodeId
    from tools.twin_trace import TWIN_LOOP, run_twin_loop, twin_digests, write_twin_trace

    with tempfile.TemporaryDirectory() as tmp:
        path = write_twin_trace(Path(tmp) / "twin_1024.jsonl", n_nodes=TWIN_LOOP["n_nodes"],
                                rounds=TWIN_LOOP["rounds"], seed=TWIN_LOOP["seed"])
        report, cal, rec = run_twin_loop(twin, Config, NodeId, path)
    return {"digests": twin_digests(report.to_dict(), cal.to_dict(), rec.to_dict()),
            "converged_round": report.sim_converged_round, "lane": rec.lane}


SCRIPTS = {"resume_headline": run_resume_headline, "simcluster_headline": run_simcluster_headline,
           "twin_1024": run_twin_1024}


def main(argv: list[str]) -> None:
    names = argv or list(CASES) + list(SCRIPTS)
    for name in names:
        out = SCRIPTS[name]() if name in SCRIPTS else run_case(name)
        print(json.dumps({name: out}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
