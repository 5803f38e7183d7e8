"""Command-line entry point: ``python -m aiocluster_torch sim ...`` (the
port of the reference's ``python -m aiocluster_tpu sim``).

``sim`` runs a convergence study and prints one JSON line of results
(rounds to convergence, the tick, the metrics), with the reference's
flags, defaults, messages, record and exit codes. It runs on the CUDA
card; ``--cpu`` runs it on the CPU instead (there every kernel wrapper
takes its plain version). With no card and no ``--cpu`` it raises: it
never goes on on the CPU. ``--shards k`` holds the state as k column
blocks of the owners (``parallel.make_mesh``): on the first k visible
cards, or under ``--cpu`` on ``["cpu"] * k``, the port's CPU mesh.

Not ported: ``--host-native`` (the native host simulator, ROADMAP.md
A19) and the ``twin`` subcommand (ROADMAP.md A17b) exit 2 naming their
items; ``node`` and ``fleet`` belong to the reference's asyncio runtime.
"""

from __future__ import annotations

import argparse
import json
import sys

# The reference's max_payload_size (its core.DEFAULT_MAX_PAYLOAD_SIZE):
# the wire MTU the default budget is converted from.
DEFAULT_MAX_PAYLOAD_SIZE = 65_507


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


def _run_sim(args: argparse.Namespace, cfg) -> int:
    if args.host_native:
        print("--host-native: the native host simulator is not ported yet "
              "(ROADMAP.md A19)", file=sys.stderr)
        return 2
    import torch

    from .parallel.mesh import make_mesh
    from .sim import Simulator

    if args.cpu:
        device = "cpu"
    elif not torch.cuda.is_available():
        raise RuntimeError("sim: no CUDA device (pass --cpu to run on the CPU)")
    else:
        device = "cuda"
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
                     help="the native host simulator: not ported yet "
                     "(ROADMAP.md A19), exits 2")

    sub.add_parser("twin", help="the digital twin: not ported yet (ROADMAP.md A17b), "
                   "exits 2")

    args, extra = parser.parse_known_args(argv)
    if args.command == "twin":
        print("twin: the digital twin (replay, calibrate, drift, autotune) is not "
              "ported yet (ROADMAP.md A17b)", file=sys.stderr)
        return 2
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    try:
        cfg = _sim_config(args)
    except ValueError as exc:  # bad --mtu/--nodes/--grace combinations
        parser.error(str(exc))
    return _run_sim(args, cfg)


if __name__ == "__main__":
    sys.exit(main())
