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
split of a round's host and device time.

Then the two-pass path: the deficit-totals kernel and the pull's totals
mode are held bit-equal to their plain versions and to the staged pull
at N = 10,240, and the staged pulls are timed beside the two-pass form
of the same sub-exchanges. At the north star's width,
``lean_config(100_352, budget=2618)`` (int16 watermarks, 20.1 GB
resident), each two-pass mode is held bit-equal to its plain version on
the north star's state 100 rounds in; then the north star runs to
convergence at seed 1 through the kernels: it must converge at round
209, the round the reference's 8-device mesh run certified. Its passes
are timed at that width and one trace of a few rounds is taken
(``build/chip_smoke_trace_north_star.json``).

Every phase prints one line; any failure raises. The last three lines
are the card, the kernel table (JSON) and the device record (JSON). It
exits non-zero without a CUDA device.
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

from aiocluster_torch import Simulator, headline_config, lean_config
from aiocluster_torch.ops import _build, counters, pairs_pull, pairs_totals, prng
from aiocluster_torch.ops import fd as fd_mod
from aiocluster_torch.ops.fd import FdParams
from aiocluster_torch.sim.state import STATE_FIELDS

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
N = 10_240
CONVERGED_ROUND = 24  # the reference's headline trajectory at seed 0
# The north star: lean_config(100_352, budget=2618) at seed 1 converges at
# round 209 (benchmarks/records/r4_northstar_100k_convergence.json).
NORTH_STAR_N, NORTH_STAR_SEED, NORTH_STAR_ROUND = 100_352, 1, 209
FULL_WIDTH_ROUNDS = 100  # the north star's rounds before its parity check
TRACE_PATH = Path(__file__).resolve().parent / "build" / "chip_smoke_trace.json"
NORTH_STAR_TRACE = TRACE_PATH.with_name("chip_smoke_trace_north_star.json")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Integer/float operations per element, counted from the kernel source:
# per row direction the deficit (3), the hash and dither (13), the
# advance (7) and the heartbeat absorb (3); per FD element ~22. The
# totals pass: per column of a pair 2 compares, 2 subtracts, 2 adds.
OPS_PULL, OPS_FD, OPS_TOTALS = 2 * 26, 22, 6
OPS_PULL_LEAN = OPS_PULL - 2 * 3


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


def pull_case(n, wdt, hdt, imdt, seed, *, diag, check, fd, hb0, dev, lean=False):
    """Random sub-exchange operands (numpy seed) in the ranges a run sees
    (``lean``: no heartbeat matrix). Returns a factory of fresh copies, so
    kernel and plain start equal."""
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
        if not lean:
            kw["hbv"] = to(hbv, torch.int32)
    if check:
        kw["check"] = (to(mv, torch.int32), to(alive, torch.bool), to(alive, torch.bool))
    if fd:
        kw["hbv"] = to(hbv, torch.int32)

    def fresh():
        ops = dict(shared, w=to(w, wdt), hb=None if lean else to(hb, hdt), **kw)
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
        check=ops.get("check"), fd=ops.get("fd"), totals=ops.get("totals"),
    )


def outputs(ops, flag):
    outs = [ops["w"]] + ([] if ops["hb"] is None else [ops["hb"]])
    f = ops.get("fd")
    if f is not None:
        outs += [f.lc, f.im, f.ic, f.live]
    if flag is not None:
        outs.append(flag)
    return outs


def max_abs_err(xs, ys) -> float:
    """Largest absolute difference over paired outputs, taken over blocks
    of about 2^26 elements (a widened copy of a whole matrix of the north
    star would not fit beside it); raises unless every pair is also
    equal element for element."""
    err = 0.0
    for x, y in zip(xs, ys, strict=True):
        check(x.dtype == y.dtype and x.shape == y.shape, "output dtype/shape differs")
        step = max(1, (1 << 26) // max(1, x[0].numel()))
        for r0 in range(0, x.shape[0], step):
            a, b = x[r0 : r0 + step], y[r0 : r0 + step]
            err = max(err, float((a.to(torch.float64) - b.to(torch.float64)).abs().max()))
            check(torch.equal(a, b), f"{x.dtype} output differs (max_abs_err {err})")
    return err


def pull_bytes(n, wsize, hsize, *, diag, check, fd, hb0, imsize=2, totals=False):
    """Bytes one pull must move: w (and hb; ``hsize`` 0 in the lean
    profile) read and written once, the FD matrices, the vectors."""
    mat = n * n
    b = 2 * mat * wsize + 2 * mat * hsize + n * (4 + 4 + 1)
    if totals:
        b += n * 4
    if diag:
        b += 2 * n * 4
    if check:
        b += n * (4 + 1)
    if fd:
        b += 2 * mat * (hsize + imsize + 2) + mat * 1 + n * 4
        if hb0:
            b += mat * hsize
    return b


def totals_bytes(n, wsize, *, diag):
    """Bytes the totals pass must move: w read once, totals written,
    the matching, valid and (diag) mv read."""
    return n * n * wsize + n * (4 + 4 + 1) + (n * 4 if diag else 0)


def trace_breakdown(path: Path, window: str, labels: tuple[str, ...]) -> dict:
    """Read a chrome trace of ``torch.profiler``: within the host range
    ``window``, the device's busy time (the union of kernel, copy and set
    intervals), the host time inside each range of ``labels``, and the
    device time of the work launched from each label (by the launches'
    correlation ids), also split into the port's kernels and the rest,
    and when the first of the port's kernels starts (``first_kernel_ms``,
    from the window's start) with the device's busy time from then on.
    Times in ms; ``device_events`` 0 means the trace saw no device."""
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    win = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == window)
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = sorted(
        (e for e in events if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] <= w1),
        key=lambda e: e["ts"],
    )
    kinds = ("pairs_kernel", "pairs_totals_kernel", "fd_kernel")
    first = next((e["ts"] for e in dev if any(k in e["name"] for k in kinds)), w1)
    busy = busy_after = 0.0
    end = w0
    for e in dev:
        a, b = max(e["ts"], end), min(e["ts"] + e["dur"], w1)
        if b > a:
            busy += b - a
            busy_after += max(0.0, b - max(a, first))
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
        kind = next((k for k in kinds if k in name), "other")
        dev_by["kind:" + kind] += e["dur"]
    return {
        "window_ms": (w1 - w0) / 1e3, "device_busy_ms": busy / 1e3,
        "device_events": len(dev), "first_kernel_ms": (first - w0) / 1e3,
        "busy_share_after_first_kernel": busy_after / max(w1 - first, 1e-9),
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


# The pull's totals modes: those of the north star's rounds (lean: no
# heartbeat matrix; the last sub-exchange carries the check), then those
# of a full-profile config beyond the staged width (with hb and the FD).
TWO_PASS_MODES = {
    "lean first": dict(diag=True, check=False, fd=False, hb0=False, lean=True),
    "lean middle": dict(diag=False, check=False, fd=False, hb0=False, lean=True),
    "lean last": dict(diag=False, check=True, fd=False, hb0=False, lean=True),
    "first": dict(diag=True, check=False, fd=False, hb0=False),
    "middle": dict(diag=False, check=False, fd=False, hb0=False),
    "last": dict(diag=False, check=True, fd=True, hb0=True),
}


def two_pass_key(m) -> str:
    return pairs_pull.counter_key(m["diag"], m["check"], m["fd"], totals=True)


def check_two_pass_kernels(dev):
    """Phase 3b: the totals kernel against its plain version (with and
    without the diagonal refresh), and the pull's totals mode against its
    plain version and against the staged kernel on the same operands, at
    N = 10,240 on the int16/int16/bf16 rung. Returns the max_abs_err of
    each launch key."""
    errs: dict[str, float] = collections.defaultdict(float)
    for diag in (True, False):
        ops = pull_case(N, torch.int16, torch.int16, torch.bfloat16, 40 + diag, dev=dev,
                        diag=diag, check=False, fd=False, hb0=False, lean=True)()
        args = (ops["w"], ops["gm"], ops["c"], ops["valid"])
        got = pairs_totals.pairs_totals(*args, mv=ops.get("mv"))
        want = pairs_totals.pairs_totals_plain(*args, mv=ops.get("mv"))
        torch.cuda.synchronize()
        key = pairs_totals.counter_key(diag)
        errs[key] = max(errs[key], max_abs_err([got], [want]))
        log("two_pass", f"n={N} int16 {key}: max_abs_err={errs[key]} "
            f"sum={float(got.double().sum()):.0f}")
        check(errs[key] == 0.0, f"{key} disagrees with its plain version")
    for i, (name, m) in enumerate(TWO_PASS_MODES.items()):
        m = dict(m)
        lean = m.pop("lean", False)
        fresh = pull_case(N, torch.int16, torch.int16, torch.bfloat16, 50 + i, dev=dev,
                          lean=lean, **m)
        kern, plain, staged = fresh(), fresh(), fresh()
        tot = pairs_totals.pairs_totals(
            kern["w"], kern["gm"], kern["c"], kern["valid"], mv=kern.get("mv"))
        kern["totals"], plain["totals"] = tot, tot.clone()
        fk = call_pull(pairs_pull.pairs_pull, kern)
        fp = call_pull(pairs_pull.pairs_pull_plain, plain)
        fs = call_pull(pairs_pull.pairs_pull, staged)
        torch.cuda.synchronize()
        err = max(max_abs_err(outputs(kern, fk), outputs(plain, fp)),
                  max_abs_err(outputs(kern, fk), outputs(staged, fs)))
        key = two_pass_key(m)
        errs[key] = max(errs[key], err)
        flag = "" if fk is None else f" flag={int(fk[0])}"
        log("two_pass", f"n={N} int16 {key} ({name}): max_abs_err={err} against "
            f"the plain version and the staged kernel{flag}")
        check(err == 0.0, f"{key} ({name}) disagrees")
    return errs


def check_two_pass_full_width(dev, errs):
    """Phase 8a: the two-pass kernels against their plain versions at the
    north star's width (N^2 > 2^31 elements, 100,352 CTAs a launch), on
    the north star's state ``FULL_WIDTH_ROUNDS`` rounds in. One round's
    three sub-exchanges run chained as ``sim_step`` chains them (the
    first refreshes the diagonal, the last carries the check), the
    kernels on a copy of w and the plain versions (over blocks of row
    pairs) on the state itself; then a fourth, whose check every row
    passes (need 0), so the flag must stay 1 across every CTA. A seeded
    tenth of the nodes is dead and a seeded half of the owners wrote a
    key, so the masks and the refresh change values. Raises each launch
    key's max_abs_err in ``errs``."""
    cfg = lean_config(NORTH_STAR_N, budget=2618)
    n = cfg.n_nodes
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=NORTH_STAR_SEED, device=dev)
    sim.run(FULL_WIDTH_ROUNDS)
    w_plain = sim.state.w
    w_kern = w_plain.clone()
    gen = torch.Generator(device=dev).manual_seed(8)
    alive = torch.rand(n, generator=gen, device=dev) < 0.9
    wrote = torch.rand(n, generator=gen, device=dev) < 0.5
    mv = sim.state.max_version + wrote.to(torch.int32)
    tick = FULL_WIDTH_ROUNDS + 1
    run_key = prng.key(NORTH_STAR_SEED)
    gm_all, c_all, p_all = (
        t[0] for t in prng.round_draws(run_key.to(dev), tick, 1, n, 4)
    )
    steps = (
        ("first", dict(mv=mv)),
        ("middle", {}),
        ("last", dict(check=(mv, alive, alive))),
        ("need 0", dict(check=(torch.zeros_like(mv), alive, alive))),
    )
    for s, (name, kw) in enumerate(steps):
        gm, c, p = gm_all[s], c_all[s], p_all[s]
        valid = alive & alive[p]
        diag = "mv" in kw
        tk = pairs_totals.pairs_totals(w_kern, gm, c, valid, mv=kw.get("mv"))
        tp = pairs_totals.pairs_totals_plain(w_plain, gm, c, valid, mv=kw.get("mv"))
        t_key = pairs_totals.counter_key(diag)
        t_err = max_abs_err([tk], [tp])
        errs[t_key] = max(errs[t_key], t_err)
        salt = tick * 2 * 4 + 2 * s
        args = (gm, c, valid, salt, prng.run_salt(run_key), cfg.budget)
        fk = pairs_pull.pairs_pull(w_kern, None, *args, totals=tk, **kw)
        fp = pairs_pull.pairs_pull_plain(w_plain, None, *args, totals=tp, **kw)
        torch.cuda.synchronize()
        p_key = pairs_pull.counter_key(diag, "check" in kw, False, totals=True)
        p_err = max_abs_err([w_kern] + ([] if fk is None else [fk]),
                            [w_plain] + ([] if fp is None else [fp]))
        errs[p_key] = max(errs[p_key], p_err)
        flag = "" if fk is None else f" flag={int(fk[0])}"
        log("two_pass", f"n={n} int16 sub-exchange {s} ({name}): {t_key} max_abs_err="
            f"{t_err} (totals sum {float(tk.double().sum()):.0f}, max "
            f"{float(tk.max()):.0f}); {p_key} max_abs_err={p_err}{flag}")
        if name == "need 0":
            check(int(fk[0]) == 1, "the check flag of a passing sub-exchange is 0")
    del sim, w_plain, w_kern
    torch.cuda.empty_cache()
    log("two_pass", f"n={n}: every two-pass mode equals its plain version on the "
        f"north star's state {FULL_WIDTH_ROUNDS} rounds in "
        f"({time.perf_counter() - t0:.1f} s with the rounds)")


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


def north_star(dev, card_line):
    """Phase 8: the two-pass path at full width. Runs the north star to
    convergence (must be round 209, every sub-exchange through both
    kernels), times 16 more rounds on the host clock, traces 4, then
    times each pass at this width with CUDA events on the converged
    state. Returns the record for the JSON line and the per-key times."""
    cfg = lean_config(NORTH_STAR_N, budget=2618)
    n = cfg.n_nodes
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=NORTH_STAR_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    converged = sim.run_until_converged(max_rounds=400)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(counters.launches)
    plain, refusals = dict(counters.plain_calls), dict(counters.refusals)
    rounds = sim.tick
    log("north_star", f"lean_config({n}, budget=2618) seed {NORTH_STAR_SEED}: "
        f"run_until_converged -> {converged} after {rounds} rounds in {run_s:.2f} s "
        f"(init {init_s:.2f} s); launches {launches}; plain calls {plain}; "
        f"refusals {refusals}")
    check(converged == NORTH_STAR_ROUND,
          f"north star converged at {converged}, expected {NORTH_STAR_ROUND}")
    check(counters.kernel_launches("pairs_totals") == 3 * rounds
          and counters.kernel_launches("pairs_pull") == 3 * rounds
          and launches.get("pairs_pull[totals+check]") == rounds
          and not plain and not refusals,
          "the north star did not run every sub-exchange through both kernels")
    m = sim.metrics()
    check(bool(m["all_converged"]) and float(m["min_fraction"]) == 1.0
          and np.isfinite(float(m["mean_fraction"])) and int(m["alive_count"]) == n,
          "north-star metrics disagree with the converged flag")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    win = 16
    sim.run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(win)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) / win * 1e3
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        with torch.profiler.record_function("chip_smoke.north_star"):
            sim.run(4)
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(NORTH_STAR_TRACE))
    tb = trace_breakdown(NORTH_STAR_TRACE, "chip_smoke.north_star",
                         ("aiocluster_torch.draws", "aiocluster_torch.sim_step"))
    dev_per_round = {k: v / 4 for k, v in tb["device_ms"].items()}
    busy = tb["device_busy_ms"] / tb["window_ms"] if tb["device_events"] else None

    # Each pass at this width, on the converged state (updated in place).
    w, alive, mv = sim.state.w, sim.state.alive, sim.state.max_version
    gm, c, _ = prng.grouped_matching(prng.key(9), n)
    gm, c = gm.to(dev, torch.int32), c.to(dev, torch.int32)
    tot = pairs_totals.pairs_totals(w, gm, c, alive, mv=mv)
    times = {}
    for diag in (True, False):
        key = pairs_totals.counter_key(diag)
        times[key] = (
            cuda_ms(lambda: pairs_totals.pairs_totals(w, gm, c, alive, mv=mv if diag else None), 10),
            bound(totals_bytes(n, 2, diag=diag), OPS_TOTALS * n * n / 2),
        )
    for name in ("lean first", "lean middle", "lean last"):
        mm = TWO_PASS_MODES[name]
        kw = {"mv": mv} if mm["diag"] else {}
        if mm["check"]:
            kw["check"] = (mv, alive, alive)
        times[two_pass_key(mm)] = (
            cuda_ms(lambda: pairs_pull.pairs_pull(
                w, None, gm, c, alive, 1, 0x9E3779B9, cfg.budget, totals=tot, **kw), 10),
            bound(pull_bytes(n, 2, 0, diag=mm["diag"], check=mm["check"], fd=False,
                             hb0=False, totals=True), OPS_PULL_LEAN * n * n / 2),
        )
    torch.cuda.synchronize()
    del sim, w, tot
    torch.cuda.empty_cache()
    # A tracked round: one totals pass with the refresh, two without, and
    # one pull in each mode.
    per_round = {k: (2 if k == "pairs_totals[sum]" else 1) for k in times}
    per_round_ms = sum(per_round[k] * ms for k, (ms, _) in times.items())
    per_round_bound = sum(per_round[k] * b[0] for k, (_, b) in times.items())
    log("north_star", f"{1e3 / round_ms:.3f} rounds/s ({round_ms:.3f} ms/round over {win} "
        f"untracked rounds); tracked run {rounds / run_s:.3f} rounds/s; kernels "
        f"{per_round_ms:.3f} ms/round by CUDA events against a {per_round_bound:.3f} ms "
        f"bound ({per_round_bound / per_round_ms:.1%}); peak memory {peak_gb:.2f} GB; "
        f"{card_line}")
    if tb["device_events"]:
        log("north_star", f"trace of 4 rounds: {tb['window_ms'] / 4:.3f} ms/round under the "
            f"profiler, device busy {busy:.1%} of the window and "
            f"{tb['busy_share_after_first_kernel']:.1%} after the first pass starts at "
            f"{tb['first_kernel_ms']:.3f} ms (the chunk's draws come first, "
            f"{tb['device_events']} device events in all); device per round: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(dev_per_round.items())))
    for key, (ms, (b_ms, b_by)) in times.items():
        log("north_star", f"{key} at n={n}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by})")
    record = {
        "n": n, "seed": NORTH_STAR_SEED, "converged_round": converged,
        "rounds_run": rounds, "run_s": run_s, "init_s": init_s,
        "round_ms": round_ms, "rounds_per_s": 1e3 / round_ms,
        "kernel_ms_per_round": per_round_ms, "bound_ms_per_round": per_round_bound,
        "peak_memory_gb": peak_gb, "device_busy_share": busy,
        "first_kernel_ms": tb["first_kernel_ms"],
        "busy_share_after_first_kernel": tb["busy_share_after_first_kernel"],
        "device_ms_per_round": dev_per_round,
    }
    return record, launches, times


def two_pass_kernel_entries(dev, errs, ns_launches, ns_times):
    """The kernel-line entries of the two-pass modes on the north star's
    path: times at N = 10,240 beside the plain versions' and the bounds,
    the times at the north star's width (``ns_times``), and the launches
    of its run (each must be > 0)."""
    entries = []

    def two_pass_entry(key, kernel, line, ms, plain_ms, b):
        check(ns_launches.get(key, 0) > 0, f"{key} was not launched on the north star's path")
        log("time", f"{key}: {ms:.4f} ms at n={N} (bound {b[0]:.4f} ms by {b[1]}; plain "
            f"{plain_ms:.3f} ms); {ns_times[key][0]:.4f} ms at n={NORTH_STAR_N} (bound "
            f"{ns_times[key][1][0]:.4f} ms)")
        return dict(
            name=key, route="cuda", source=f"aiocluster_torch/ops/csrc/{kernel}.cu",
            replaces=f"aiocluster_tpu/ops/pallas_pull.py:{line}",
            launches=ns_launches[key], max_abs_err=errs[key], ms=ms,
            plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None,
            path="north_star", n=N, n_main=NORTH_STAR_N, ms_main=ns_times[key][0],
            bound_ms_main=ns_times[key][1][0], parity_n=[N, NORTH_STAR_N],
        )

    for diag in (True, False):
        ops = pull_case(N, torch.int16, torch.int16, torch.bfloat16, 60 + diag, dev=dev,
                        diag=diag, check=False, fd=False, hb0=False, lean=True)()
        args = (ops["w"], ops["gm"], ops["c"], ops["valid"])
        mv = ops.get("mv")
        ms = cuda_ms(lambda: pairs_totals.pairs_totals(*args, mv=mv), 20)
        plain_ms = cuda_ms(lambda: pairs_totals.pairs_totals_plain(*args, mv=mv), 3, 1)
        entries.append(two_pass_entry(
            pairs_totals.counter_key(diag), "pairs_totals", 899, ms, plain_ms,
            bound(totals_bytes(N, 2, diag=diag), OPS_TOTALS * N * N / 2),
        ))
    for i, name in enumerate(("lean first", "lean middle", "lean last")):
        m = dict(TWO_PASS_MODES[name])
        m.pop("lean")
        fresh = pull_case(N, torch.int16, torch.int16, torch.bfloat16, 70 + i, dev=dev,
                          lean=True, **m)

        def with_totals():
            ops = fresh()
            ops["totals"] = pairs_totals.pairs_totals(
                ops["w"], ops["gm"], ops["c"], ops["valid"], mv=ops.get("mv"))
            return ops

        ops = with_totals()
        ms = cuda_ms(lambda: call_pull(pairs_pull.pairs_pull, ops), 20)
        ops = with_totals()
        plain_ms = cuda_ms(lambda: call_pull(pairs_pull.pairs_pull_plain, ops), 3, 1)
        del ops
        entries.append(two_pass_entry(
            two_pass_key(m), "pairs_pull", 490, ms, plain_ms,
            bound(pull_bytes(N, 2, 0, totals=True, **m), OPS_PULL_LEAN * N * N / 2),
        ))
    return entries


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
        stacks = sum(
            1 for line in report.splitlines()
            if "bytes stack frame" in line and not line.strip().startswith("0 ")
        )
        if regs:
            log("build", f"{name}: {len(regs)} kernels, registers <= {max(regs)}, "
                f"spilled bytes {spills}, kernels with a stack frame {stacks}")

    pull_err = check_pull_kernel(dev)
    two_pass_errs = check_two_pass_kernels(dev)
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
    check(counters.kernel_launches("pairs_pull") == 3 * rounds_run and not main_plain,
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
    check(counters.kernel_launches("pairs_pull") == 12 and not counters.plain_calls,
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
    check(seam_fd_launches == 4 and counters.kernel_launches("pairs_pull") == 0,
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
        # The same sub-exchange as the two-pass form would run it: is the
        # staged form worth keeping where it fits?
        ops = fresh()

        def two_pass():
            ops["totals"] = pairs_totals.pairs_totals(
                ops["w"], ops["gm"], ops["c"], ops["valid"], mv=ops.get("mv"))
            call_pull(pairs_pull.pairs_pull, ops)

        two_pass_ms = cuda_ms(two_pass, 20)
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
            library_ms=None, path="main", two_pass_ms=two_pass_ms,
        ))
        log("time", f"pairs_pull[{name}]: {ms:.4f} ms (bound {b_ms:.4f} ms by "
            f"{b_by}; plain {plain_ms:.3f} ms); the two-pass form of the same "
            f"sub-exchange (totals + pull) {two_pass_ms:.4f} ms, "
            f"{two_pass_ms / ms:.3f}x the staged")
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

    # Phase 8: the two-pass path, the north star: its kernels against
    # their plain versions at its width, its run, then its kernels' times
    # at N = 10,240 (beside their plain versions) and at its own width.
    check_two_pass_full_width(dev, two_pass_errs)
    ns, ns_launches, ns_times = north_star(dev, card_line)

    kernels += two_pass_kernel_entries(dev, two_pass_errs, ns_launches, ns_times)
    log("done", f"{time.perf_counter() - t_all:.1f} s in all; converged at "
        f"round {converged}; {rounds_per_s:.2f} rounds/s; the north star converged "
        f"at round {ns['converged_round']}, {ns['rounds_per_s']:.3f} rounds/s")

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
        "north_star": ns,
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
