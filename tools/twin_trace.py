"""A seeded, twin-grade runtime trace, written without a runtime.

The twin (``aiocluster_tpu.twin`` and its port ``aiocluster_torch.twin``)
reads the JSONL trace a recorded fleet leaves (docs/twin.md): a
``trace_header`` carrying the trace schema, one ``twin_node`` record per
member and one ``twin_round`` record per initiated round. This module
writes such a trace from a seed, for fleets of any size, so the port's
chip check (``chip_smoke.py``), the reference digests
(``tools/torch_reference_digests.py``) and the tests feed both packages
the same file without starting an asyncio fleet:

    from tools.twin_trace import write_twin_trace
    write_twin_trace("fleet.jsonl", n_nodes=1024, rounds=40, seed=0)

Each node ticks at ``gossip_interval_s`` scaled by its own speed (within
5%) from a random phase, with a little jitter on every timestamp; its
key-versions applied a round follow a logistic catch-up on the
``(n_nodes - 1) * n_own_keys`` versions it has to learn. Standard
library only: ``random.Random(seed)`` draws every number, so the bytes
depend on the arguments alone. ``twin_digests`` hashes a twin loop's
results for the chip check's reference constants.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import random
import statistics
from pathlib import Path

TRACE_SCHEMA = "aiocluster-trace/1"  # obs/trace.py's schema tag
T0 = 1_700_000_000.0  # the header's timestamp; rounds start after it


def _line(record: dict) -> str:
    return json.dumps(record, separators=(",", ":")) + "\n"


def _caught_up(r: float, rounds: int) -> float:
    """The fraction of its versions a node knows after ``r`` rounds."""
    mid, scale = 0.3 * rounds, max(0.06 * rounds, 0.5)
    return 1.0 / (1.0 + math.exp(-(r - mid) / scale))


def write_twin_trace(
    path,
    *,
    n_nodes: int,
    rounds: int = 40,
    seed: int = 0,
    gossip_count: int = 3,
    n_own_keys: int = 16,
    phi_threshold: float = 8.0,
    max_payload_size: int = 65_507,
    gossip_interval_s: float = 1.0,
) -> Path:
    """Write a twin-grade trace of ``n_nodes`` members, ``rounds`` rounds
    each, to ``path`` (replaced if it exists); returns the path."""
    if n_nodes < 1 or rounds < 1:
        raise ValueError("need at least one node and one round")
    rng = random.Random(seed)
    path = Path(path)
    names = [f"node-{i:05d}" for i in range(n_nodes)]
    total = (n_nodes - 1) * n_own_keys
    grown = [_caught_up(r, rounds) for r in range(rounds + 1)]
    base = grown[0]
    rows = []
    for i, name in enumerate(names):
        speed = rng.uniform(0.95, 1.05)
        phase = rng.uniform(0.0, gossip_interval_s)
        for r in range(rounds):
            ts = T0 + phase + r * gossip_interval_s * speed + rng.uniform(-0.01, 0.01)
            share = (grown[r + 1] - grown[r]) / (1.0 - base)
            applied = int(round(total * share * rng.uniform(0.8, 1.2)))
            rows.append((round(ts, 6), i, {
                "event": "twin_round", "ts": round(ts, 6), "node": name, "round": r,
                "duration_s": round(rng.uniform(0.002, 0.006), 6),
                "targets": min(gossip_count, n_nodes - 1),
                "live": int((n_nodes - 1) * (grown[r + 1] - base) / (1.0 - base)),
                "dead": 0,
                "kv_sent": applied + rng.randint(0, 3),
                "kv_applied": applied,
                "heartbeat": r + 1,
                "phi_max": round(rng.uniform(0.0, 2.0), 4),
            }))
    rows.sort(key=lambda row: (row[0], row[1]))
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(_line({"event": "trace_header", "ts": T0, "kind": "trace_header",
                        "schema": TRACE_SCHEMA}))
        for i, name in enumerate(names):
            fh.write(_line({
                "event": "twin_node", "ts": T0, "node": name,
                "generation": 1_700_000_000_000_000_000 + i,
                "gossip_interval_s": gossip_interval_s, "gossip_count": gossip_count,
                "phi_threshold": phi_threshold, "max_payload_size": max_payload_size,
                "n_own_keys": n_own_keys,
            }))
        fh.writelines(_line(rec) for _, _, rec in rows)
    return path


def stretch_trace(src, dst, factor: float) -> Path:
    """Copy the trace at ``src`` to ``dst`` with every timestamp's offset
    from the header's multiplied by ``factor`` (a fleet ``factor`` times
    slower per round; work times unchanged); returns ``dst``."""
    dst = Path(dst)
    with open(src, encoding="utf-8") as fin, open(dst, "w", encoding="utf-8") as fout:
        t0 = None
        for line in fin:
            rec = json.loads(line)
            if t0 is None:
                t0 = rec["ts"]
            rec["ts"] = _stretched(t0, rec["ts"], factor)
            fout.write(_line(rec))
    return dst


def _stretched(t0: float, ts: float, factor: float) -> float:
    return round(t0 + (ts - t0) * factor, 6)


def stretch_loaded_trace(trace, factor: float):
    """``stretch_trace`` of a trace already loaded (either package's
    ``RuntimeTrace``, with its header), without the file: the copy equals
    what loading the stretched file gives, apart from ``path``."""
    t0 = trace.header["ts"]
    at = lambda rec: dict(rec, ts=_stretched(t0, rec["ts"], factor))  # noqa: E731
    node_rounds = {k: [at(r) for r in recs] for k, recs in trace.node_rounds.items()}
    by_round: dict[int, list[float]] = {}
    for recs in node_rounds.values():
        for rec in recs:
            by_round.setdefault(int(rec["round"]), []).append(rec["ts"])
    return dataclasses.replace(
        trace, header=at(trace.header), nodes={k: at(r) for k, r in trace.nodes.items()},
        node_rounds=node_rounds, transitions=[at(r) for r in trace.transitions],
        rounds=[dataclasses.replace(row, ts=statistics.fmean(by_round[row.round]))
                for row in trace.rounds])


def twin_digests(report: dict, calibration: dict, recommendation: dict,
                 source: str = "twin_trace.jsonl") -> dict[str, str]:
    """The sha256 of a twin loop's results, as the chip check holds them:
    the replay's aligned rows (``ReplayReport.to_dict()["rounds"]`` with
    the report's converged round), the calibration record's dict and the
    recommendation's dict, each as canonical JSON with the trace path
    (``source``, ``trace_path``) replaced by ``source``, so runs that
    wrote the same trace under different paths compare."""
    def fixed(d):
        if isinstance(d, dict):
            return {k: (source if k in ("source", "trace_path") else fixed(v))
                    for k, v in d.items()}
        if isinstance(d, list):
            return [fixed(v) for v in d]
        return d

    def digest(obj) -> str:
        blob = json.dumps(fixed(obj), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    return {
        "replay": digest({"rounds": report["rounds"],
                          "sim_converged_round": report["sim_converged_round"],
                          "sim_config": report["sim_config"]}),
        "calibration": digest(calibration),
        "recommendation": digest(recommendation),
    }


# The twin loop the chip check holds against the reference's digests
# (``REF_DIGESTS["twin_1024"]`` in chip_smoke.py): a 1,024-node trace,
# replayed, fitted, and autotuned over fanout x phi.
TWIN_LOOP = dict(n_nodes=1024, rounds=40, seed=0, deadline_s=600.0, fd_budget=0.5,
                 fanout=[1, 2, 3, 4], phi_threshold=[8.0, 4.0])


def run_twin_loop(twin, config_cls, node_cls, trace_path, **device):
    """``TWIN_LOOP`` through either package's twin (``twin`` the module,
    ``config_cls`` / ``node_cls`` its runtime ``Config`` / ``NodeId``;
    ``device`` the port's keyword, absent for the reference) on the
    trace at ``trace_path``. Returns (replay report, calibration record,
    recommendation)."""
    trace = twin.load_runtime_trace(trace_path)
    report = twin.replay(trace, seed=TWIN_LOOP["seed"], **device)
    calibration = twin.fit_calibration(report)
    base = config_cls(node_id=node_cls(name="operator", generation_id=1,
                                       gossip_advertise_addr=("127.0.0.1", 0)))
    recommendation = twin.autotune(
        twin.SLO(TWIN_LOOP["deadline_s"], TWIN_LOOP["fd_budget"]), calibration, base,
        twin.lift_sim_config(trace), fanout=TWIN_LOOP["fanout"],
        phi_threshold=TWIN_LOOP["phi_threshold"], seed=TWIN_LOOP["seed"], **device)
    return report, calibration, recommendation
