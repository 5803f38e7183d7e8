"""End-to-end smoke test of aiocluster_torch on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``aiocluster_torch/ops/csrc`` (nvcc, sm_90a, into
``build/aiocluster_torch/``), holds each kernel bit-equal to its plain
PyTorch version at the headline width, drives the simulator's main path
(the reference bench's headline config, N = 10,240, seed 0) to
convergence through the kernels, runs the use_pallas=False /
use_pallas_fd=True seam through the standalone FD kernel, times the
kernels with CUDA events and the round rate on the host clock, and takes
one ``torch.profiler`` trace of a chunk of rounds (written to
``build/chip_smoke_trace.json``) for the device's busy share and the
split of a round's host and device time. Every phase prints one line;
any failure raises. The last three lines are the card, the kernel table
(JSON) and the device record (JSON). It exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from aiocluster_torch import Simulator, headline_config
from aiocluster_torch.ops import _build, counters, pairs_pull, prng
from aiocluster_torch.ops import fd as fd_mod
from aiocluster_torch.ops.fd import FdParams
from aiocluster_torch.sim.state import STATE_FIELDS

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
N = 10_240
CONVERGED_ROUND = 24  # the reference's headline trajectory at seed 0
TRACE_PATH = Path(__file__).resolve().parent / "build" / "chip_smoke_trace.json"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Integer/float operations per element, counted from the kernel source:
# per row direction the deficit (3), the hash and dither (13), the
# advance (7) and the heartbeat absorb (3); per FD element ~22.
OPS_PULL, OPS_FD = 2 * 26, 22


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    """Fail the run (a raise, so ``python -O`` cannot skip it)."""
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- random operands ------------------------------------------------------------


def pull_case(n, wdt, hdt, imdt, seed, *, diag, check, fd, hb0, dev):
    """Random sub-exchange operands (numpy seed) in the ranges a run sees.
    Returns a factory of fresh copies, so kernel and plain start equal."""
    rng = np.random.default_rng(seed)
    tick = 40
    w = rng.integers(0, 17, (n, n), dtype=np.int32)
    hb = rng.integers(0, tick, (n, n), dtype=np.int32)
    lc = rng.integers(0, tick, (n, n), dtype=np.int32)
    im = (rng.random((n, n), dtype=np.float32) * 6).astype(np.float32)
    ic = rng.integers(0, 12, (n, n), dtype=np.int32)
    h0 = rng.integers(0, tick, (n, n), dtype=np.int32)
    alive = rng.random(n) < 0.9
    mv = rng.integers(16, 20, n)
    hbv = rng.integers(tick - 2, tick + 1, n)
    gm, c, p = prng.grouped_matching(prng.key(seed), n)
    valid = torch.from_numpy(alive) & torch.from_numpy(alive)[p]
    to = lambda a, dt: torch.from_numpy(a).to(dev, dt, copy=True)  # noqa: E731
    shared = dict(
        gm=gm.to(dev, torch.int32), c=c.to(dev, torch.int32),
        valid=valid.to(dev), salt=2 * seed + 1, run_salt=0x9E3779B9,
        budget=2618,
    )
    kw = {}
    if diag:
        kw["mv"] = to(mv, torch.int32)
        kw["hbv"] = to(hbv, torch.int32)
    if check:
        kw["check"] = (to(mv, torch.int32), to(alive, torch.bool), to(alive, torch.bool))
    if fd:
        kw["hbv"] = to(hbv, torch.int32)

    def fresh():
        ops = dict(shared, w=to(w, wdt), hb=to(hb, hdt), **kw)
        if fd:
            ops["fd"] = pairs_pull.FdOperands(
                tick, to(lc, hdt), to(im, imdt), to(ic, torch.int16),
                torch.zeros((n, n), dtype=torch.bool, device=dev),
                to(h0, hdt) if hb0 else None, FdParams.from_config(headline_config(n)),
            )
        return ops

    return fresh


def call_pull(fn, ops):
    return fn(
        ops["w"], ops["hb"], ops["gm"], ops["c"], ops["valid"], ops["salt"],
        ops["run_salt"], ops["budget"], mv=ops.get("mv"), hbv=ops.get("hbv"),
        check=ops.get("check"), fd=ops.get("fd"),
    )


def outputs(ops, flag):
    outs = [ops["w"], ops["hb"]]
    f = ops.get("fd")
    if f is not None:
        outs += [f.lc, f.im, f.ic, f.live]
    if flag is not None:
        outs.append(flag)
    return outs


def max_abs_err(xs, ys) -> float:
    """Largest absolute difference over paired outputs; raises unless
    every pair is also equal element for element."""
    err = 0.0
    for x, y in zip(xs, ys, strict=True):
        check(x.dtype == y.dtype and x.shape == y.shape, "output dtype/shape differs")
        err = max(err, float((x.to(torch.float64) - y.to(torch.float64)).abs().max()))
        check(torch.equal(x, y), f"{x.dtype} output differs (max_abs_err {err})")
    return err


def pull_bytes(n, wsize, hsize, *, diag, check, fd, hb0, imsize=2):
    mat = n * n
    b = 2 * mat * wsize + 2 * mat * hsize + n * (4 + 4 + 1)
    if diag:
        b += 2 * n * 4
    if check:
        b += n * (4 + 1)
    if fd:
        b += 2 * mat * (hsize + imsize + 2) + mat * 1 + n * 4
        if hb0:
            b += mat * hsize
    return b


def trace_breakdown(path: Path, window: str, labels: tuple[str, ...]) -> dict:
    """Read a chrome trace of ``torch.profiler``: within the host range
    ``window``, the device's busy time (the union of kernel, copy and set
    intervals), the host time inside each range of ``labels``, and the
    device time of the work launched from each label (by the launches'
    correlation ids), also split into the port's two kernels and the
    rest. Times in ms; ``device_events`` 0 means the trace saw no device."""
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    win = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == window)
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = sorted(
        (e for e in events if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] <= w1),
        key=lambda e: e["ts"],
    )
    busy, end = 0.0, w0
    for e in dev:
        a, b = max(e["ts"], end), min(e["ts"] + e["dur"], w1)
        if b > a:
            busy += b - a
        end = max(end, e["ts"] + e["dur"])
    spans = {lab: [] for lab in labels}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in spans and w0 <= e["ts"] <= w1:
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    owner = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            for lab, ranges in spans.items():
                if any(a <= e["ts"] <= b for a, b in ranges):
                    owner[corr] = lab
    dev_by = collections.Counter()
    for e in dev:
        lab = owner.get(e.get("args", {}).get("correlation"), "unlabelled")
        dev_by[lab] += e["dur"]
        name = e["name"]
        kind = "pairs_kernel" if "pairs_kernel" in name else "fd_kernel" if "fd_kernel" in name else "other"
        dev_by["kind:" + kind] += e["dur"]
    return {
        "window_ms": (w1 - w0) / 1e3, "device_busy_ms": busy / 1e3,
        "device_events": len(dev),
        "host_ms": {lab: sum(b - a for a, b in r) / 1e3 for lab, r in spans.items()},
        "device_ms": {k: v / 1e3 for k, v in dev_by.items()},
    }


# -- phases ---------------------------------------------------------------------


def check_pull_kernel(dev):
    """Phase 3: the pairs kernel against its plain version, every mode on
    the main path, at N=10,240 on the int16/int16/bf16 rung and at 2,048
    on int32/int32/f32."""
    modes = {
        "first": dict(diag=True, check=False, fd=False, hb0=False),
        "middle": dict(diag=False, check=False, fd=False, hb0=False),
        "last": dict(diag=False, check=True, fd=True, hb0=True),
        "only": dict(diag=True, check=True, fd=True, hb0=False),
    }
    worst = 0.0
    rungs = (
        (N, torch.int16, torch.int16, torch.bfloat16),
        (2048, torch.int32, torch.int32, torch.float32),
    )
    for n, wdt, hdt, imdt in rungs:
        for i, (name, m) in enumerate(modes.items()):
            fresh = pull_case(n, wdt, hdt, imdt, 10 + i, dev=dev, **m)
            a, b = fresh(), fresh()
            fa = call_pull(pairs_pull.pairs_pull, a)
            fb = call_pull(pairs_pull.pairs_pull_plain, b)
            torch.cuda.synchronize()
            err = max_abs_err(outputs(a, fa), outputs(b, fb))
            flag = "" if fa is None else f" flag={int(fa[0])}"
            live = "" if "fd" not in a else f" live={int(a['fd'].live.sum())}"
            log("pairs", f"n={n} {wdt} {hdt} {imdt} mode={name}: max_abs_err={err}{flag}{live}")
            check(err == 0.0, f"pairs kernel disagrees in mode {name}")
            worst = max(worst, err)
    # The check must also pass a converged pair: need below every w.
    fresh = pull_case(N, torch.int16, torch.int16, torch.bfloat16, 3, dev=dev,
                      diag=False, check=True, fd=False, hb0=False)
    a = fresh()
    a["check"] = (torch.zeros_like(a["check"][0]),) + a["check"][1:]
    check(int(call_pull(pairs_pull.pairs_pull, a)[0]) == 1, "check flag of a converged pair is 0")
    return worst


def check_fd_kernel(dev):
    """Phase 4: the standalone FD kernel against its plain version."""
    rng = np.random.default_rng(7)
    tick = 40
    to = lambda a, dt: torch.from_numpy(a).to(dev, dt, copy=True)  # noqa: E731
    hb = rng.integers(0, tick, (N, N), dtype=np.int32)
    h0 = rng.integers(0, tick, (N, N), dtype=np.int32)
    hbv = rng.integers(tick - 2, tick + 1, N)
    lc = rng.integers(0, tick, (N, N), dtype=np.int32)
    im = (rng.random((N, N), dtype=np.float32) * 6).astype(np.float32)
    ic = rng.integers(0, 12, (N, N), dtype=np.int32)
    params = FdParams.from_config(headline_config())

    def fresh():
        return [to(hb, torch.int16), to(h0, torch.int16), to(hbv, torch.int32),
                to(lc, torch.int16), to(im, torch.bfloat16), to(ic, torch.int16),
                torch.zeros((N, N), dtype=torch.bool, device=dev)]

    a, b = fresh(), fresh()
    fd_mod.fused_fd(tick, *a, params)
    fd_mod.fused_fd_plain(tick, *b, params)
    torch.cuda.synchronize()
    err = max_abs_err(a[3:], b[3:])
    log("fd", f"n={N} int16/bf16: max_abs_err={err} live={int(a[6].sum())}")
    check(err == 0.0, "fd kernel disagrees with its plain version")
    return err, fresh, params


def states_equal(s1, s2) -> bool:
    return all(
        torch.equal(getattr(s1, f), getattr(s2, f)) for f in STATE_FIELDS
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    t_all = time.perf_counter()
    card_line = card()
    log("device", f"{card_line}; torch {torch.__version__} cuda {torch.version.cuda}")

    _build.build_all()
    log("build", f"{_build.build_seconds:.1f} s (nvcc per source, in parallel)")
    static_smem = pairs_pull.compiled_static_smem()
    log("build", f"pairs_kernel static shared memory {static_smem} bytes "
        f"(the wrapper's width check assumes {pairs_pull.STATIC_SMEM})")
    check(static_smem == pairs_pull.STATIC_SMEM,
          "pairs_pull.STATIC_SMEM disagrees with the compiled kernel")
    for name, report in _build.ptxas_report.items():
        regs = [int(t.split()[0]) for t in report.split("Used ")[1:]]
        spills = sum(
            int(t.split()[0]) for t in report.split(", ")
            if t.split()[1:3] == ["bytes", "spill"]
        )
        if regs:
            log("build", f"{name}: {len(regs)} kernels, registers <= {max(regs)}, "
                f"spilled bytes {spills}")

    pull_err = check_pull_kernel(dev)
    fd_err, fd_fresh, fd_params = check_fd_kernel(dev)

    cfg = headline_config()
    plain_cfg = dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=False)
    seam_cfg = dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=True)

    # Phase 5: the main path.
    counters.reset()
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=0, device=dev)
    converged = sim.run_until_converged(max_rounds=200)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    main_launches = dict(counters.launches)
    main_plain = dict(counters.plain_calls)
    rounds_run = sim.tick
    log("main", f"run_until_converged -> {converged} after {rounds_run} rounds "
        f"({main_s:.2f} s incl. setup); launches {main_launches}; "
        f"plain calls {main_plain}")
    check(converged == CONVERGED_ROUND, f"converged at {converged}, expected {CONVERGED_ROUND}")
    check(counters.pull_launches() == 3 * rounds_run and not main_plain,
          "the main path did not run every sub-exchange through the kernel")
    m = sim.metrics()
    check(bool(m["all_converged"]) and float(m["min_fraction"]) == 1.0,
          "metrics disagree with the converged flag")
    check(int(m["fd_false_positives"]) >= 0 and np.isfinite(float(m["mean_fraction"])),
          "metrics are not finite")
    del sim

    counters.reset()
    kern = Simulator(cfg, seed=0, device=dev)
    kern.run(4)
    check(counters.pull_launches() == 12 and not counters.plain_calls,
          "4 kernel-path rounds did not launch 12 pulls")
    plain = Simulator(plain_cfg, seed=0, device=dev)
    plain.run(4)
    torch.cuda.synchronize()
    check(states_equal(kern.state, plain.state), "kernel path != plain path")
    log("main", "4 rounds: kernel path == plain path on every state tensor; "
        "12 pull launches, 0 plain pulls in the kernel run")
    del plain

    # Phase 6: the A/B seam (plain pull, standalone FD kernel).
    counters.reset()
    seam = Simulator(seam_cfg, seed=0, device=dev)
    seam.run(4)
    torch.cuda.synchronize()
    seam_fd_launches = counters.launches["fd"]
    log("seam", f"use_pallas=False use_pallas_fd=True, 4 rounds: fd launches "
        f"{seam_fd_launches}, plain calls {dict(counters.plain_calls)}")
    check(seam_fd_launches == 4 and counters.pull_launches() == 0,
          "the seam path did not run its FD phase through the standalone kernel")
    check(states_equal(seam.state, kern.state), "seam path != kernel path")
    del seam, kern

    # The simulator draws its matchings on the device: the same bits as
    # on the host, at the headline width.
    key0 = prng.key(0)
    on_dev = prng.round_draws(key0.to(dev), 1, 16, N, cfg.fanout)
    on_cpu = prng.round_draws(key0, 1, 16, N, cfg.fanout)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(on_dev, on_cpu)),
          "device draws differ from host draws")
    log("draws", f"16 rounds x {cfg.fanout} matchings at N={N}: device == host")

    # Phase 7: times. The round rate on the host clock, then one profiled
    # chunk for where a round's time goes.
    rate_sim = Simulator(cfg, seed=0, device=dev, chunk=16)
    rate_sim.run(8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rate_sim.run(48)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) / 48 * 1e3
    rounds_per_s = 1e3 / round_ms
    log("time", f"kernel path: {rounds_per_s:.2f} rounds/s at N={N} "
        f"({round_ms:.3f} ms/round; {card_line})")
    prof_rounds = 16
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        with torch.profiler.record_function("chip_smoke.window"):
            rate_sim.run(prof_rounds)
            torch.cuda.synchronize()
    TRACE_PATH.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE_PATH))
    del rate_sim
    tb = trace_breakdown(TRACE_PATH, "chip_smoke.window",
                         ("aiocluster_torch.draws", "aiocluster_torch.sim_step"))
    per = {k: v / prof_rounds for k, v in tb["device_ms"].items()}
    host = {k: v / prof_rounds for k, v in tb["host_ms"].items()}
    prof_round_ms = tb["window_ms"] / prof_rounds
    busy_share = tb["device_busy_ms"] / tb["window_ms"]
    if tb["device_events"]:
        log("trace", f"{prof_rounds} profiled rounds: {prof_round_ms:.3f} ms/round "
            f"under the profiler; device busy {busy_share:.1%} "
            f"({tb['device_busy_ms'] / prof_rounds:.3f} ms/round); host per round: "
            f"draws {host['aiocluster_torch.draws']:.3f} ms, sim_step "
            f"{host['aiocluster_torch.sim_step']:.3f} ms; device per round: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(per.items())))
    else:
        log("trace", "the profiler recorded no device activity: busy share "
            "not measured")
    n_ranges = 10_000
    t0 = time.perf_counter()
    for _ in range(n_ranges):
        with torch.profiler.record_function("chip_smoke.empty"):
            pass
    range_us = (time.perf_counter() - t0) / n_ranges * 1e6
    log("trace", f"one profiler range costs {range_us:.2f} us on the host with "
        "the profiler off (the simulator opens 1 + 1/chunk per round)")

    kernels = []
    modes = {
        "first": dict(diag=True, check=False, fd=False, hb0=False),
        "middle": dict(diag=False, check=False, fd=False, hb0=False),
        "last": dict(diag=False, check=True, fd=True, hb0=True),
    }
    mode_keys = {"first": "pairs_pull[diag]", "middle": "pairs_pull[pull]",
                 "last": "pairs_pull[check+fd]"}
    for i, (name, m) in enumerate(modes.items()):
        fresh = pull_case(N, torch.int16, torch.int16, torch.bfloat16, 20 + i, dev=dev, **m)
        ops = fresh()
        ms = cuda_ms(lambda: call_pull(pairs_pull.pairs_pull, ops), 20)
        ops = fresh()
        plain_ms = cuda_ms(lambda: call_pull(pairs_pull.pairs_pull_plain, ops), 3, 1)
        del ops
        b_ms, b_by = bound(
            pull_bytes(N, 2, 2, **m),
            (OPS_PULL + (OPS_FD * 2 if m["fd"] else 0)) * N * N / 2,
        )
        kernels.append(dict(
            name=f"pairs_pull[{name}]", route="cuda",
            source="aiocluster_torch/ops/csrc/pairs_pull.cu",
            replaces="aiocluster_tpu/ops/pallas_pull.py:490",
            launches=main_launches.get(mode_keys[name], 0), max_abs_err=pull_err,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, path="main",
        ))
        log("time", f"pairs_pull[{name}]: {ms:.4f} ms (bound {b_ms:.4f} ms by "
            f"{b_by}; plain {plain_ms:.3f} ms)")
    args = fd_fresh()
    ms = cuda_ms(lambda: fd_mod.fused_fd(40, *args, fd_params), 20)
    args = fd_fresh()
    plain_ms = cuda_ms(lambda: fd_mod.fused_fd_plain(40, *args, fd_params), 3, 1)
    del args
    mat = N * N
    b_ms, b_by = bound(mat * (5 * 2 + 3 * 2 + 1) + N * 4, OPS_FD * mat)
    kernels.append(dict(
        name="fd", route="cuda", source="aiocluster_torch/ops/csrc/fd.cu",
        replaces="aiocluster_tpu/ops/pallas_fd.py:51",
        launches=seam_fd_launches, max_abs_err=fd_err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        path="seam",
    ))
    log("time", f"fd: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; plain {plain_ms:.3f} ms)")
    log("done", f"{time.perf_counter() - t_all:.1f} s in all; converged at "
        f"round {converged}; {rounds_per_s:.2f} rounds/s")

    print(card_line)
    print(json.dumps({
        "kernels": kernels, "rounds_per_s": rounds_per_s,
        "converged_round": converged, "round_ms": round_ms,
        "trace": {
            "rounds": prof_rounds, "round_ms": prof_round_ms,
            "device_events": tb["device_events"],
            "device_busy_share": busy_share if tb["device_events"] else None,
            "host_ms_per_round": host, "device_ms_per_round": per,
            "range_cost_us": range_us,
        },
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
