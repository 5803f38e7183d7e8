"""Command-line entry point: ``python -m aiocluster_torch {sim,twin}`` (the
port of the reference's ``python -m aiocluster_tpu sim`` and ``twin``).

``sim`` runs a convergence study and prints one JSON line of results
(rounds to convergence, the tick, the metrics), with the reference's
flags, defaults, messages, record and exit codes. It runs on the CUDA
card; ``--cpu`` runs it on the CPU instead (there every kernel wrapper
takes its plain version). With no card and no ``--cpu`` it raises: it
never goes on on the CPU. ``--shards k`` holds the state as k column
blocks of the owners (``parallel.make_mesh``): on the first k visible
cards, or under ``--cpu`` on ``["cpu"] * k``, the port's CPU mesh.
``--host-native`` runs the native host simulator (sim/hostsim.py) on the
CPU instead, on its support domain.

``twin`` replays a recorded runtime trace into the simulator, fits and
optionally writes a calibration record, and with ``--deadline`` and
candidate lists autotunes against an SLO; ``--check-drift`` verdicts a
fresh trace against a stored record (docs/twin.md). It runs on the card
unless ``--cpu`` is given, and raises without one. ``node`` and
``fleet`` belong to the reference's asyncio runtime, which the port
does not carry.
"""

from __future__ import annotations

import argparse
import json
import sys

from .core.config import DEFAULT_MAX_PAYLOAD_SIZE


def _sim_config(args: argparse.Namespace):
    """Build the SimConfig from CLI flags. ValueErrors raised here are
    user errors (bad --mtu/--nodes/--grace combinations) and surface as
    clean parser errors; anything raised later in the run is a real bug
    and keeps its traceback."""
    from .sim import SimConfig
    from .sim.bytes import budget_from_mtu

    if args.lean and args.keys >= 2**15:
        # The lean profile's int16 watermarks cap initial versions.
        raise ValueError(
            f"--lean stores int16 watermarks: --keys {args.keys} >= 32768 "
            "overflows (drop --lean or lower --keys)"
        )
    narrow = args.lean or args.host_native
    return SimConfig(
        n_nodes=args.nodes,
        keys_per_node=args.keys,
        fanout=args.fanout,
        budget=budget_from_mtu(args.mtu if args.mtu is not None else DEFAULT_MAX_PAYLOAD_SIZE),
        death_rate=args.churn,
        revival_rate=4 * args.churn,
        track_failure_detector=not args.lean,
        track_heartbeats=not args.lean,
        # The profile sim.config.lean_config prescribes: int16 watermarks
        # are what buy the memory headroom at scale.
        version_dtype="int16" if narrow else "int32",
        heartbeat_dtype="int16" if narrow else "int32",
        fd_dtype="bfloat16" if narrow else "float32",
        dead_grace_ticks=args.grace if args.churn and not args.lean else None,
    )


def _make_telemetry(args: argparse.Namespace):
    """(registry, trace, server, obs_kwargs) from the CLI flags. Telemetry
    is opt-in: without --metrics-port/--trace-file the simulator gets no
    registry and its loop carries no sampling."""
    from .obs import MetricsHTTPServer, TraceWriter, default_registry

    trace = TraceWriter(args.trace_file) if args.trace_file else None
    server = None
    registry = None
    if args.metrics_port is not None:
        registry = default_registry()
        server = MetricsHTTPServer(registry, port=args.metrics_port)
        try:
            port = server.start_in_thread()
        except BaseException:
            if trace is not None:
                trace.close()
            raise
        print(f"[sim] /metrics on 127.0.0.1:{port}", file=sys.stderr, flush=True)
    kwargs = {}
    if registry is not None or trace is not None:
        kwargs = {
            # metrics=None with a trace writer: the sampler records into
            # a private registry.
            "metrics": registry,
            "metrics_stride": args.metrics_stride,
            "trace_writer": trace,
        }
    return registry, trace, server, kwargs


def _device(args: argparse.Namespace) -> str:
    """The CUDA card, or the CPU with ``--cpu``; without a card and
    without ``--cpu`` the command raises (it never goes on on the CPU)."""
    import torch

    if args.cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError(f"{args.command}: no CUDA device (pass --cpu to run on the CPU)")
    return "cuda"


def host_native_record(host, converged: int | None) -> dict:
    """The record ``sim --host-native`` prints for a host run that
    ``converged`` at that round (or None), without its telemetry count."""
    import numpy as np

    # Reductions only, never an (N, N) float temporary: on this domain
    # w <= keys_per_node always (no writes), so the device path's clip is
    # a no-op and min/mean commute with the divide.
    cfg = host.cfg
    k = cfg.keys_per_node
    col_min = host.w.min(axis=0)
    metrics = {
        "converged_owners": int((col_min >= k).sum()),
        "all_converged": bool((col_min >= k).all()),
        "min_fraction": float(host.w.min()) / k,
        "mean_fraction": float(host.w.mean(dtype=np.float64)) / k,
        "alive_count": cfg.n_nodes,
    }
    return {
        "nodes": cfg.n_nodes,
        "shards": 1,
        "engine": "host-native",
        "rounds_to_convergence": converged,
        "tick": host.tick,
        "metrics": metrics,
    }


def _run_host_native(args: argparse.Namespace, cfg) -> int:
    """The native host simulator (sim/hostsim.py): the Simulator's
    trajectory on its domain, on the CPU."""
    from .sim import hostsim
    from .utils.cbuild import NativeBuildError

    if args.shards:
        print("--host-native runs unsharded (single host)", file=sys.stderr)
        return 2
    if not hostsim.supported(cfg):
        print(
            "--host-native needs the matching domain (lean or full "
            "profile): no --churn, --nodes a multiple of 128, "
            "--keys <= 127 and --keys * --nodes < 2^24 "
            "(sim.hostsim.supported)",
            file=sys.stderr,
        )
        return 2
    if cfg.track_heartbeats and args.max_rounds > 32_766:
        # The full profile's int16 heartbeat matrices cap the horizon;
        # clamp up front rather than fail mid-run.
        print(
            "--host-native full profile: clamping --max-rounds to "
            "32766 (int16 heartbeat horizon)",
            file=sys.stderr,
        )
        args.max_rounds = 32_766
    try:
        hostsim.load()
    except NativeBuildError as exc:
        print(f"native hostsim build failed: {exc}", file=sys.stderr)
        return 2
    _registry, trace, server, obs_kwargs = _make_telemetry(args)
    try:
        host = hostsim.HostSimulator(cfg, seed=args.seed, **obs_kwargs)
        converged = host.run_until_converged(max_rounds=args.max_rounds)
        telemetry_samples = host.flush_metrics()
    finally:
        if server is not None:
            server.stop_thread()
        if trace is not None:
            trace.close()
    record = host_native_record(host, converged)
    if telemetry_samples:
        record["telemetry_samples"] = len(telemetry_samples)
    print(json.dumps(record), flush=True)
    return 0 if converged is not None else 1


def _run_sim(args: argparse.Namespace, cfg) -> int:
    if args.host_native:
        return _run_host_native(args, cfg)
    import torch

    from .parallel.mesh import make_mesh
    from .sim import Simulator

    device = _device(args)
    mesh = None
    if args.shards:
        devices = (["cpu"] * args.shards if args.cpu
                   else [f"cuda:{i}" for i in range(torch.cuda.device_count())])
        if args.shards < 0:
            print(f"--shards {args.shards} must be positive", file=sys.stderr)
            return 2
        if args.shards > len(devices):
            print(f"--shards {args.shards} > {len(devices)} visible device(s)", file=sys.stderr)
            return 2
        if args.nodes % args.shards:
            print(f"--nodes {args.nodes} must divide evenly into --shards {args.shards}",
                  file=sys.stderr)
            return 2
        mesh = make_mesh(devices[: args.shards])
    _registry, trace, server, obs_kwargs = _make_telemetry(args)
    try:
        sim = Simulator(cfg, seed=args.seed, mesh=mesh,
                        device=None if mesh is not None else device, chunk=8, **obs_kwargs)
        converged = sim.run_until_converged(max_rounds=args.max_rounds)
        telemetry_samples = sim.flush_metrics()
    finally:
        if server is not None:
            server.stop_thread()
        if trace is not None:
            trace.close()
    m = {k: v.tolist() for k, v in sim.metrics().items()}
    record = {
        "nodes": args.nodes,
        "shards": args.shards or 1,
        "rounds_to_convergence": converged,
        "tick": sim.tick,
        "metrics": m,
    }
    if telemetry_samples:
        record["telemetry_samples"] = len(telemetry_samples)
    print(json.dumps(record), flush=True)
    return 0 if converged is not None else 1


def _run_twin(args: argparse.Namespace) -> int:
    """Replay, calibrate (and autotune) from the CLI (docs/twin.md): the
    one-command form of the twin loop. Prints a JSON summary; exits 1
    when the held-out validation misses its stated tolerance, no
    candidate lane meets the SLO or the drift check finds drift."""
    from . import twin

    def csv_list(text, cast):
        return None if text is None else [cast(x) for x in text.split(",")]

    # Flag combinations are checked before any work: candidate lists or
    # an FD budget without a deadline would be dropped silently, and a
    # deadline without candidates has no grid to sweep.
    tuning_flags = [
        name for name, val in (
            ("--fanout", args.fanout),
            ("--phi", args.phi),
            ("--writes", args.writes),
            ("--fd-budget", args.fd_budget),
        ) if val is not None
    ]
    if args.deadline is None and tuning_flags:
        print(
            f"twin: {', '.join(tuning_flags)} require --deadline "
            "(the SLO the candidates are tuned against)",
            file=sys.stderr, flush=True,
        )
        return 2
    if args.deadline is not None and not (
        args.fanout or args.phi or args.writes
    ):
        print(
            "twin: --deadline needs at least one candidate list "
            "(--fanout/--phi/--writes) spanning two or more lanes",
            file=sys.stderr, flush=True,
        )
        return 2
    device = _device(args)

    if args.check_drift is not None:
        # Drift-monitor mode: verdict a FRESH trace against a STORED
        # calibration; exits 1 on drift so a scheduled check alerts.
        cal = twin.load_calibration(args.check_drift)
        verdict = twin.check_drift(
            cal,
            args.trace,
            window=args.drift_window,
            tolerance=args.tolerance,
            seed=args.seed,
            device=device,
        )
        print(
            json.dumps(
                {
                    "trace": args.trace,
                    "calibration": args.check_drift,
                    "drift": verdict.to_dict(),
                }
            ),
            flush=True,
        )
        return 0 if verdict.ok else 1

    trace = twin.load_runtime_trace(args.trace)
    report = twin.replay(trace, seed=args.seed, device=device)
    cal = twin.fit_calibration(
        report,
        tolerance=0.35 if args.tolerance is None else args.tolerance,
    )
    if args.calibration_out:
        twin.save_calibration(args.calibration_out, cal)
    out = {
        "trace": trace.path,
        "n_nodes": trace.n_nodes,
        "trace_rounds": len(trace.rounds),
        "skipped_lines": trace.skipped,
        "sim_converged_round": report.sim_converged_round,
        "calibration": cal.to_dict(),
    }
    ok = cal.holdout_ok
    if args.deadline is not None:
        from .core.config import Config
        from .core.identity import NodeId

        slo = twin.SLO(
            convergence_deadline_s=args.deadline,
            fd_false_positive_budget=args.fd_budget,
        )
        # The CLI has no deployment Config to tune against; recommend
        # over a placeholder identity: the tunables are what matter.
        base = Config(
            node_id=NodeId(
                name="operator", gossip_advertise_addr=("127.0.0.1", 0)
            )
        )
        try:
            rec = twin.autotune(
                slo,
                cal,
                base,
                twin.lift_sim_config(trace),
                fanout=csv_list(args.fanout, int),
                phi_threshold=csv_list(args.phi, float),
                writes_per_round=csv_list(args.writes, int),
                seed=args.seed,
                device=device,
            )
            out["recommendation"] = rec.to_dict()
        except twin.AutotuneInfeasible as exc:
            out["autotune_infeasible"] = str(exc)
            out["lanes"] = exc.lanes
            ok = False
        except ValueError as exc:
            # e.g. a single-value candidate list (one lane is not a
            # sweep): still reported through the JSON record.
            out["autotune_error"] = str(exc)
            ok = False
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m aiocluster_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    sim = sub.add_parser("sim", help="run a tensor-sim convergence study")
    sim.add_argument("--nodes", type=int, default=1024)
    sim.add_argument("--keys", type=int, default=16)
    sim.add_argument("--fanout", type=int, default=3)
    sim.add_argument("--mtu", type=int, default=None,
                     help="per-exchange budget as a wire MTU in bytes "
                     "(default: the reference's 65,507)")
    sim.add_argument("--churn", type=float, default=0.0,
                     help="per-round death probability (revival = 4x)")
    sim.add_argument("--grace", type=int, default=40,
                     help="dead-node grace in rounds (with --churn)")
    sim.add_argument("--lean", action="store_true",
                     help="convergence-only profile (no FD matrices)")
    sim.add_argument("--seed", type=int, default=0)
    sim.add_argument("--max-rounds", type=int, default=10_000)
    sim.add_argument("--cpu", action="store_true",
                     help="run on the CPU (the default is the CUDA card; "
                     "without one the run raises)")
    sim.add_argument("--shards", type=int, default=0,
                     help="column-shard the owner axis into this many blocks: "
                     "on the first k visible cards, or with --cpu on "
                     "k CPU blocks (0 = one device, no mesh)")
    sim.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                     help="serve Prometheus text on 127.0.0.1:PORT"
                     "/metrics from a daemon thread (0 = ephemeral port)")
    sim.add_argument("--trace-file", default=None, metavar="PATH",
                     help="append sampled sim_round JSONL events to PATH")
    sim.add_argument("--metrics-stride", type=int, default=64,
                     help="rounds between metric samples (device metrics "
                     "are buffered un-synced and flushed at the end; "
                     "default 64)")
    sim.add_argument("--host-native", action="store_true",
                     help="run the native host simulator on the CPU (the "
                     "Simulator's trajectory on the matching domain: lean, "
                     "or the full FD profile at int16/bf16 dtypes; no "
                     "churn/shards)")

    twin = sub.add_parser(
        "twin",
        help="replay a recorded runtime trace, fit a calibration, "
        "optionally autotune against an SLO (docs/twin.md)",
    )
    twin.add_argument("--trace", required=True, metavar="PATH",
                      help="twin-grade JSONL trace (Cluster.trace_rounds)")
    twin.add_argument("--calibration-out", default=None, metavar="PATH",
                      help="write the fitted CalibrationRecord JSON here")
    twin.add_argument("--seed", type=int, default=0)
    twin.add_argument("--tolerance", type=float, default=None,
                      help="held-out validation tolerance recorded in "
                      "(and gated by) the calibration (default 0.35)")
    twin.add_argument("--deadline", type=float, default=None,
                      metavar="SECONDS",
                      help="SLO convergence deadline; with candidate "
                      "lists below, runs the autotuner")
    twin.add_argument("--fd-budget", type=float, default=None,
                      help="SLO failure-detector false-positive budget")
    twin.add_argument("--fanout", default=None,
                      help="comma-separated fanout candidates")
    twin.add_argument("--phi", default=None,
                      help="comma-separated phi-threshold candidates")
    twin.add_argument("--writes", default=None,
                      help="comma-separated writes-per-round candidates")
    twin.add_argument("--check-drift", default=None, metavar="CALIBRATION",
                      help="drift-monitor mode: verdict --trace against "
                      "this stored CalibrationRecord (twin/drift.py); "
                      "exits 1 on drift")
    twin.add_argument("--drift-window", type=int, default=None,
                      metavar="ROUNDS",
                      help="rolling window for --check-drift (default: "
                      "the stored record's fit window)")
    twin.add_argument("--cpu", action="store_true",
                      help="run on the CPU (the default is the CUDA card; "
                      "without one the run raises)")

    args = parser.parse_args(argv)
    if args.command == "twin":
        return _run_twin(args)
    try:
        cfg = _sim_config(args)
    except ValueError as exc:  # bad --mtu/--nodes/--grace combinations
        parser.error(str(exc))
    return _run_sim(args, cfg)


if __name__ == "__main__":
    sys.exit(main())
