"""Reference digests for the PyTorch port's chip check (chip_smoke.py,
phases 14 and 15).

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
marked so run on to their converged round).
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


def main(argv: list[str]) -> None:
    names = argv or list(CASES)
    for name in names:
        print(json.dumps({name: run_case(name)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
