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
resident), each two-pass mode and one chained round of its own form
(each row pair staged by a cluster of CTAs) are held bit-equal to their
plain versions on the north star's state 100 rounds in; then the north
star runs to convergence at seed 1 through the kernels: it must
converge at round 209, the round the reference's 8-device mesh run
certified, one launch a sub-exchange. Its sub-exchanges are timed at
that width in both forms, one trace of a few rounds is taken
(``build/chip_smoke_trace_north_star.json``) and the run is repeated in
the two-pass form. Every full-width run below likewise holds and times
the form the dispatch does not take beside its own (``other_form``);
``RUN_FORMS`` is the dispatch rule's expected form of each run.

Then the single-pass m8 path (``pallas_variant="m8"``): the m8 pull and
the m8 totals pass are held bit-equal to their plain versions (and to
the staged pairs kernel and the pairs totals, the same functions) at
N = 10,240 in every mode, int16 and int32 (the totals also where a row
is valid and its partner is not); the headline config pinned to
m8 runs to convergence (round 24, one pull launch a sub-exchange and the
standalone FD kernel once a round) and equals the pairs path after 4
rounds; the north star pinned to m8 runs 100 rounds, its two-pass m8
modes are held against their plain versions at that width, the
reference's 8-shard computation is done block by block on the card (8
column blocks of 12,544 owners: their totals sum to the whole width's
and their outputs side by side are the whole width's), and the run goes
on to convergence (round 209). Last, the reference's int16 experiment
(benchmarks/records/_i16_kernel_experiment.py) on Hopper: the m8 pull's
int16 variants bit-exact against the int32 kernel and timed as the
experiment times them.

Then the memory ladder's rungs (phase 10): every new kernel mode (int8
matrices, the packed u4r codec, the FD epilogue on int8 sample counters
and the live bitmap, the int8 m8 and FD kernels) held bit-equal to its
plain version at N = 10,240, staged and two-pass, and the staged modes
again at their paths' widths on an early state (int8 pairs and m8 at
100,352; deep and shrunk with the fused FD at 49,152). Full-width runs:
the lean int8 north star (round 209, staged pairs, also timed in the
two-pass form; pinned to m8, 209); the lean u4r north star beside the
port's int16 keys-15 run (the same converged round, residuals equal to
clip(max_version - w, 0, 15) at rounds 1, 2 and the converged round);
the widest u4r, ``lean_config(262_144, "u4r")`` (34.4 GB, the packed
two-pass form: 8 untracked rounds, one sub-exchange against the plain
versions); the full deep and shrunk rungs at N = 49,152 (round 103, the
fused FD on the shrunk bookkeeping); the deep rung at the headline width
field for field against the int16/window-100 profile (both 24); and
short runs at N = 10,240 of every other route the rungs take (the int8
m8 and FD kernels, fanout 1, the two-pass forms). Each mode is timed
beside its bound at N = 10,240 and at its run's width.

Then sweeps (phase 11), ``SweepSimulator`` through the lane launches of
the pairs kernels (one launch a sub-exchange for all S lanes): every lane
mode held bit-equal to its plain version at N = 10,240 with S = 3 (and
each lane to the single-lane kernel on its operands); the reference's
sweep_bench scenario at the headline width (8 lanes, seeds 0-7, phi
7.0 + 0.25 i) to convergence, every lane equal to its sequential run
(lane 0 at 24), timed against 8 sequential runs and traced
(``build/chip_smoke_trace_sweep.json``); a fanout and write-rate sweep
(a fanout-0 lane beside it, its sequential run through the plain pull
and the standalone FD kernel); the north star as a 2-lane sweep (seeds
1 and 2, the two-pass lane launches, lane 0 at 209, lane 1 equal to its
sequential run); short sweeps through every other lane mode; the
counters of a sweep pinned to m8 and of a fanout-0 round. Last (phase
12), ``full_config(65_536)`` past the staged width: the two-pass form
with the fused FD, one chained round held against the plain versions on
a sample of row pairs (a second copy of the state does not fit).

Then the owner-sharded round (phase 13), the reference's 8-shard mesh on
this one card (``make_mesh(["cuda:0"] * 8)``): every column-block mode
of the pairs pull, the pairs totals and the FD kernel held bit-equal to
its plain version at N = 10,240 over 8 blocks of 1,280 owners, the
blocks' totals summed equal to the whole width's and their pulls side by
side equal to the whole-width kernel's; the headline on 8 blocks to
convergence (round 24, field-equal to the unsharded run; its round timed
and traced, ``build/chip_smoke_trace_mesh.json``; pinned to m8, 24 with
the FD kernel at each block's offset); the north star on 8
blocks of 12,544 (its w digests at ticks 1 and 2 equal to the reference's
certified mesh run, which phase 8 also checks unsharded; its w equal to
the unsharded run's at tick 20; round 209), timed with each block pass
beside its bound; 4 rounds each of the int8, u4r and shrunk rungs on 8
blocks, field-equal to their unsharded runs.

Every phase prints one line; any failure raises. The last three lines
are the card, the kernel table (JSON) and the device record (JSON). It
exits non-zero without a CUDA device.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from aiocluster_torch import (
    Simulator, SweepSimulator, full_config, headline_config, lean_config,
)
from aiocluster_torch.ops import (
    _build, counters, gossip, m8_pull, m8_totals, pairs_pull, pairs_totals, prng,
)
from aiocluster_torch.ops import fd as fd_mod
from aiocluster_torch.ops.fd import FdParams
from aiocluster_torch.parallel import make_mesh
from aiocluster_torch.sim.packed import is_packed_w, pack_bits, unpack_bits, unpack_u4
from aiocluster_torch.sim.state import STATE_FIELDS, lane

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
N = 10_240
CONVERGED_ROUND = 24  # the reference's headline trajectory at seed 0
# The north star: lean_config(100_352, budget=2618) at seed 1 converges at
# round 209 (benchmarks/records/r4_northstar_100k_convergence.json).
NORTH_STAR_N, NORTH_STAR_SEED, NORTH_STAR_ROUND = 100_352, 1, 209
FULL_WIDTH_ROUNDS = 100  # the north star's rounds before its parity check
# The form of each run's sub-exchanges and the CTAs that stage a row
# pair, by the dispatch rule (pairs_pull.pull_form through
# gossip.kernel_pull_form), held before each run: a change of the rule
# shows here first.
RUN_FORMS = {
    "north_star": ("pairs_cluster", 4),
    "north_star_pair": ("pairs_cluster", 4),
    "north_star_int8": ("pairs_two_pass", 1),
    "north_star_int8_other": ("pairs_cluster", 2),
    "north_star_u4r": ("pairs_two_pass", 1),
    "north_star_u4r_other": ("pairs", 1),
    "widest_u4r": ("pairs_two_pass", 1),
    "widest_u4r_other": ("pairs_cluster", 4),
    "full_past_staged": ("pairs_cluster", 4),
    "full_deep": ("pairs_two_pass", 1),
    "full_shrunk": ("pairs_cluster", 2),
    "lean_int8_staged": ("pairs", 1),
    "lean_u4r_staged": ("pairs", 1),
    "deep_staged": ("pairs", 1),
    "shrunk_staged": ("pairs", 1),
}
COLUMN_BLOCKS = 8  # the reference's certified north-star mesh: 8 shards
TRACE_PATH = Path(__file__).resolve().parent / "build" / "chip_smoke_trace.json"
NORTH_STAR_TRACE = TRACE_PATH.with_name("chip_smoke_trace_north_star.json")
SWEEP_TRACE = TRACE_PATH.with_name("chip_smoke_trace_sweep.json")
MESH_TRACE = TRACE_PATH.with_name("chip_smoke_trace_mesh.json")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Integer/float operations per element, counted from the kernel source:
# per row direction the deficit (3), the hash and dither (13), the
# advance (7) and the heartbeat absorb (3); per FD element ~22. The
# totals pass: per column of a pair 2 compares, 2 subtracts, 2 adds. The
# pairs pull takes one advance per column pair (the receiving direction
# and its deficit, 3; one hash and dither, 13; one advance, 7; each
# row's absorb, 3); the m8 pull, a row a CTA, one per row direction.
OPS_PULL, OPS_FD, OPS_TOTALS = 2 * 26, 22, 6
OPS_PULL_LEAN = OPS_PULL - 2 * 3
OPS_PAIR = 3 + 13 + 7 + 2 * 3
OPS_PAIR_LEAN = OPS_PAIR - 2 * 3


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


@contextlib.contextmanager
def two_pass_forced():
    """No row pair staged: the block's shared-memory limit set to the
    kernel's static shared memory, so every sub-exchange takes the
    two-pass form (the totals pass, then the pull fed them), as past what
    a cluster of 8 stages. For timing the old form beside the new."""
    saved = pairs_pull.SMEM_LIMIT
    pairs_pull.SMEM_LIMIT = pairs_pull.STATIC_SMEM
    try:
        yield
    finally:
        pairs_pull.SMEM_LIMIT = saved


@contextlib.contextmanager
def other_form(cfg):
    """The form the dispatch rule does not take for ``cfg``: the two-pass
    form where it stages (``two_pass_forced``), else the staged form (the
    narrow rows' limit lifted, so the smallest cluster that lets two CTAs
    share an SM stages them). Yields that form and its cluster size. For
    timing the two forms side by side."""
    if gossip.kernel_pull_form(cfg)[0] != "pairs_two_pass":
        with two_pass_forced():
            yield gossip.kernel_pull_form(cfg)
        return
    saved = pairs_pull.NARROW_STAGED_BYTES
    pairs_pull.NARROW_STAGED_BYTES = 1 << 40
    try:
        yield gossip.kernel_pull_form(cfg)
    finally:
        pairs_pull.NARROW_STAGED_BYTES = saved


def form_key(form, k, diag=False, check=False, fd=False, packed=False, lanes=False):
    """The launch key of a pull in ``form`` on clusters of ``k``."""
    two_pass = form == "pairs_two_pass"
    return pairs_pull.counter_key(diag, check, fd, two_pass, packed, lanes=lanes,
                                  cluster=not two_pass and k > 1)


def expect_form(cfg, dev, name, n_local=None):
    """The run ``name``'s form and cluster size by the dispatch rule
    (``gossip.kernel_pull_form``), which must be ``RUN_FORMS[name]``."""
    got = gossip.kernel_pull_form(cfg, n_local)
    check(got == RUN_FORMS[name] and gossip.pull_phase_engaged(cfg, dev, n_local) == got[0],
          f"{name}: the dispatch gives {got}, expected {RUN_FORMS[name]}")
    return got


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
        owner_offset=ops.get("owner_offset", 0),
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


def pull_bytes(n, wsize, hsize, *, diag, check, fd, hb0, imsize=2, icsize=2, livesize=1,
               totals=False, n_cols=None):
    """Bytes one pull must move: w (and hb; ``hsize`` 0 in the lean
    profile) read and written once, the FD matrices (sample counters
    ``icsize`` bytes, the live view ``livesize``: 1/8 as the bitmap),
    the vectors; over ``n_cols`` owner columns (a column block) or all
    ``n``."""
    n_cols = n if n_cols is None else n_cols
    mat = n * n_cols
    b = 2 * mat * wsize + 2 * mat * hsize + n * (4 + 4 + 1)
    if totals:
        b += n * 4
    if diag:
        b += 2 * n_cols * 4
    if check:
        b += n_cols * 4 + n
    if fd:
        b += 2 * mat * (hsize + imsize + icsize) + mat * livesize + n_cols * 4
        if hb0:
            b += mat * hsize
    return b


def totals_bytes(n, wsize, *, diag, n_cols=None):
    """Bytes the totals pass must move: w read once, totals written,
    the matching, valid and (diag) mv read; over ``n_cols`` owner
    columns or all ``n``."""
    n_cols = n if n_cols is None else n_cols
    return n * n_cols * wsize + n * (4 + 4 + 1) + (n_cols * 4 if diag else 0)


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
    del w_plain, w_kern
    torch.cuda.empty_cache()
    log("two_pass", f"n={n}: every two-pass mode equals its plain version on the "
        f"north star's state {FULL_WIDTH_ROUNDS} rounds in "
        f"({time.perf_counter() - t0:.1f} s with the rounds)")
    # The run's own form (the cluster frame), one round chained on the
    # same state.
    found = chained_round_check(dev, sim, "lean16", errs)
    del sim
    torch.cuda.empty_cache()
    log("north_star", f"n={n}, {RUN_FORMS['north_star']}: one chained round on the north "
        f"star's state {FULL_WIDTH_ROUNDS} rounds in: "
        + ", ".join(f"{k} max_abs_err={e}" for k, e in found))
    check(all(e == 0.0 for _, e in found), "the north star's cluster launches disagree")


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


LEAN_MODES = {
    "lean first": dict(diag=True, check=False),
    "lean middle": dict(diag=False, check=False),
    "lean last": dict(diag=False, check=True),
}


def lean_form_times(w, alive, mv, budget, k, rung, wsize):
    """A lean round's sub-exchanges at ``w``'s width by CUDA events, on
    the same state (updated in place; no time depends on the values), in
    the staged form on clusters of ``k`` CTAs and in the two-pass form:
    the totals pass (with and without the refresh) and the pull fed
    them. ``mv`` is the refresh operand (packed: the write bumps). Returns
    name -> (ms, (bound ms, bound by)), names the launch keys and the
    rung; and each form's ms and bound a round (3 sub-exchanges)."""
    n = w.shape[0]
    packed = rung == "u4r"
    gm, c, _ = prng.grouped_matching(prng.key(9), n)
    gm, c = gm.to(w.device, torch.int32), c.to(w.device, torch.int32)
    tot = pairs_totals.pairs_totals(w, gm, c, alive, mv=mv)
    ops = OPS_PAIR_LEAN * n * n / 2
    times = {}
    for diag in (True, False):
        key = f"{pairs_totals.counter_key(diag, packed)} {rung}"
        times[key] = (
            cuda_ms(lambda: pairs_totals.pairs_totals(w, gm, c, alive, mv=mv if diag else None),
                    5),
            bound(totals_bytes(n, wsize, diag=diag), OPS_TOTALS * n * n / 2),
        )
    for m in LEAN_MODES.values():
        kw = {"mv": mv} if m["diag"] else {}
        if m["check"]:
            kw["check"] = (torch.zeros_like(alive, dtype=torch.int32), alive, alive)
        for totals in (False, True):
            mode = dict(m, fd=False, hb0=False)
            key = ladder_key(mode, rung, totals=totals, cluster=not totals and k > 1)
            extra = {"totals": tot} if totals else {"cluster": k}
            times[key] = (
                cuda_ms(lambda: pairs_pull.pairs_pull(
                    w, None, gm, c, alive, 1, 0x9E3779B9, budget, **kw, **extra), 5),
                bound(pull_bytes(n, wsize, 0, diag=m["diag"], check=m["check"], fd=False,
                                 hb0=False, totals=totals), ops),
            )
    torch.cuda.synchronize()
    rounds = {}
    for form in ("staged", "two_pass"):
        per = {}
        for key in times:
            if key.startswith("pairs_totals"):
                per[key] = (0 if form == "staged" else 1 if "diag" in key else 2)
            else:
                per[key] = int(("totals" in key) == (form == "two_pass"))
        rounds[form] = (sum(per[kk] * t[0] for kk, t in times.items()),
                        sum(per[kk] * t[1][0] for kk, t in times.items()))
    return times, rounds


def north_star(dev, card_line):
    """Phase 8: the north star at full width in its form (``RUN_FORMS``:
    one launch a sub-exchange, each row pair staged by a cluster of CTAs).
    Runs its first two rounds (w's digests at ticks 1 and 2 must be the
    record's of the reference's 8-device mesh run), then on to
    convergence (must be round 209, one pull launch a sub-exchange and no
    totals pass), times 16 more rounds on the host clock, traces 4, then
    times each sub-exchange at this width in the run's form and in the
    two-pass form on the same state. Last, the same run in the two-pass
    form (forced, from counters at 0; its launches are the two-pass
    entries' path), to 209, its wall time a round beside the run's.
    Returns the record, the run's launches, the times, and the two-pass
    run's (launches, rounds)."""
    cfg = lean_config(NORTH_STAR_N, budget=2618)
    n = cfg.n_nodes
    form, k = expect_form(cfg, dev, "north_star")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=NORTH_STAR_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # The record's w digests at ticks 1 and 2 (the reference's 8-device
    # mesh run), on the unsharded run.
    t0 = time.perf_counter()
    pending = {}
    for tick in sorted(NORTH_STAR_DIGESTS):
        sim.run(tick - sim.tick)
        pending[tick] = w_digest([sim.state])
    copy_s = time.perf_counter() - t0
    counters.reset()
    t0 = time.perf_counter()
    converged = sim.run_until_converged(max_rounds=400)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    digests = {tick: f.result() for tick, f in pending.items()}
    log("north_star", f"w digests at ticks 1, 2: {digests} (host copies fed to sha256 "
        f"{copy_s:.1f} s); the record's: {NORTH_STAR_DIGESTS}")
    check(digests == NORTH_STAR_DIGESTS, "the north star's w digests differ from the record's")
    launches = dict(counters.launches)
    plain, refusals = dict(counters.plain_calls), dict(counters.refusals)
    rounds = sim.tick - len(NORTH_STAR_DIGESTS)  # the tracked rounds
    log("north_star", f"lean_config({n}, budget=2618) seed {NORTH_STAR_SEED}, {form} on "
        f"clusters of {k}: run_until_converged -> {converged} after {rounds} tracked rounds "
        f"in {run_s:.2f} s ({run_s / rounds * 1e3:.3f} ms a round; init {init_s:.2f} s); "
        f"launches {launches}; plain calls {plain}; refusals {refusals}")
    check(converged == NORTH_STAR_ROUND,
          f"north star converged at {converged}, expected {NORTH_STAR_ROUND}")
    check_key = pairs_pull.counter_key(False, True, False, cluster=k > 1)
    check(counters.kernel_launches("pairs_totals") == 0
          and counters.kernel_launches("pairs_pull") == 3 * rounds
          and launches.get(check_key) == rounds and not plain and not refusals,
          "the north star did not run every sub-exchange as one staged pull launch")
    m = sim.metrics()
    check(bool(m["all_converged"]) and float(m["min_fraction"]) == 1.0
          and np.isfinite(float(m["mean_fraction"])) and int(m["alive_count"]) == n,
          "north-star metrics disagree with the converged flag")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    win = 16
    round_ms = round_rate(sim, win)
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        with torch.profiler.record_function("chip_smoke.north_star"):
            sim.run(4)
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(NORTH_STAR_TRACE))
    tb = trace_breakdown(NORTH_STAR_TRACE, "chip_smoke.north_star",
                         ("aiocluster_torch.draws", "aiocluster_torch.sim_step"))
    dev_per_round = {kk: v / 4 for kk, v in tb["device_ms"].items()}
    busy = tb["device_busy_ms"] / tb["window_ms"] if tb["device_events"] else None

    # Each sub-exchange at this width in both forms, on the same state.
    times, form_rounds = lean_form_times(sim.state.w, sim.state.alive, sim.state.max_version,
                                         cfg.budget, k, "lean16", 2)
    del sim
    torch.cuda.empty_cache()
    # The same run in the two-pass form (the old form), from counters at 0.
    timed = {}
    with two_pass_forced():
        check(gossip.pull_phase_engaged(cfg, dev) == "pairs_two_pass", "not forced two-pass")
        sim, conv2, launches2, _, _ = run_to(cfg, dev, NORTH_STAR_SEED, NORTH_STAR_ROUND,
                                             "north_star_two_pass", timed=timed)
    rounds2 = sim.tick
    check(counters.kernel_launches("pairs_totals") == 3 * rounds2
          and counters.kernel_launches("pairs_pull") == 3 * rounds2,
          "the forced north star did not take both passes a sub-exchange")
    del sim
    torch.cuda.empty_cache()
    (k_ms, k_bound), (t_ms, t_bound) = form_rounds["staged"], form_rounds["two_pass"]
    log("north_star", f"{1e3 / round_ms:.3f} rounds/s ({round_ms:.3f} ms/round over {win} "
        f"untracked rounds); whole run {run_s / rounds * 1e3:.3f} ms a round, the two-pass "
        f"form's {timed['round_ms']:.3f}; kernels by CUDA events: {k_ms:.3f} ms a round "
        f"against a {k_bound:.3f} ms bound ({k_bound / k_ms:.1%}), the two-pass form "
        f"{t_ms:.3f} against {t_bound:.3f} ({t_bound / t_ms:.1%}); peak memory "
        f"{peak_gb:.2f} GB; {card_line}")
    if tb["device_events"]:
        log("north_star", f"trace of 4 rounds: {tb['window_ms'] / 4:.3f} ms/round under the "
            f"profiler, device busy {busy:.1%} of the window and "
            f"{tb['busy_share_after_first_kernel']:.1%} after the first pass starts at "
            f"{tb['first_kernel_ms']:.3f} ms (the chunk's draws come first, "
            f"{tb['device_events']} device events in all); device per round: "
            + ", ".join(f"{kk} {v:.3f} ms" for kk, v in sorted(dev_per_round.items())))
    for key, (ms, (b_ms, b_by)) in times.items():
        log("north_star", f"{key} at n={n}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by})")
    record = {
        "n": n, "seed": NORTH_STAR_SEED, "form": form, "cluster": k,
        "converged_round": converged, "rounds_run": rounds, "run_s": run_s, "init_s": init_s,
        "run_round_ms": run_s / rounds * 1e3, "digests": digests, "digest_copy_s": copy_s,
        "round_ms": round_ms, "rounds_per_s": 1e3 / round_ms,
        "kernel_ms_per_round": k_ms, "bound_ms_per_round": k_bound,
        "two_pass": {"run_round_ms": timed["round_ms"], "converged_round": conv2,
                     "kernel_ms_per_round": t_ms, "bound_ms_per_round": t_bound},
        "peak_memory_gb": peak_gb, "device_busy_share": busy,
        "first_kernel_ms": tb["first_kernel_ms"],
        "busy_share_after_first_kernel": tb["busy_share_after_first_kernel"],
        "device_ms_per_round": dev_per_round,
    }
    return record, launches, times, (launches2, rounds2)


def two_pass_kernel_entries(dev, errs, ns_launches, ns_rounds, ns_times):
    """The kernel-line entries of the two-pass modes on the north star's
    two-pass run (``ns_launches``, ``ns_rounds``): times at N = 10,240
    beside the plain versions' and the bounds, the times at the north
    star's width (``ns_times``, the lean16 names), and the launches of
    that run (each must be > 0)."""
    entries = []

    def two_pass_entry(key, kernel, line, ms, plain_ms, b):
        check(ns_launches.get(key, 0) > 0,
              f"{key} was not launched on the north star's two-pass run")
        main = ns_times[f"{key} lean16"]
        log("time", f"{key}: {ms:.4f} ms at n={N} (bound {b[0]:.4f} ms by {b[1]}; plain "
            f"{plain_ms:.3f} ms); {main[0]:.4f} ms at n={NORTH_STAR_N} (bound "
            f"{main[1][0]:.4f} ms)")
        return dict(
            name=key, route="cuda", source=f"aiocluster_torch/ops/csrc/{kernel}.cu",
            replaces=f"aiocluster_tpu/ops/pallas_pull.py:{line}",
            launches=ns_launches[key], launches_per_round=ns_launches[key] / ns_rounds,
            max_abs_err=errs[key], ms=ms,
            plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None,
            path="north_star_two_pass", n=N, n_main=NORTH_STAR_N, ms_main=main[0],
            bound_ms_main=main[1][0], parity_n=[N, NORTH_STAR_N],
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
            bound(pull_bytes(N, 2, 0, totals=True, **m), OPS_PAIR_LEAN * N * N / 2),
        ))
    return entries


# -- the single-pass m8 path ---------------------------------------------------


def m8_bytes(n, n_local, wsize, hsize, *, diag, totals, reads=1):
    """Bytes one m8 pull moves: w (and hb; ``hsize`` 0 when lean) read
    ``reads`` times and written once, and the vectors. ``reads=1`` is
    what the function must move (its bound); ``reads=2`` is this design's
    traffic (each row read as itself and as its partner's peer)."""
    mat = n * n_local
    b = (reads + 1) * mat * (wsize + hsize) + n * (4 + 4 + 1)
    if totals:
        b += n * 4
    if diag:
        b += n_local * 4 * (2 if hsize else 1)
    return b


def m8_totals_bytes(n, n_local, wsize, *, diag):
    """Bytes the m8 totals pass moves: w read once (this design visits
    each pair once, so its traffic is the function's bound), the totals
    written, the matching, valid and (diag) mv read."""
    return n * n_local * wsize + n * (4 + 4 + 1) + (n_local * 4 if diag else 0)


def m8_case(n, wdt, seed, dev, *, diag, lean, asymmetric=False):
    """Random operands of one m8 sub-exchange in the ranges a run sees,
    drawn on the card from ``seed``, with a tenth of the nodes dead
    (``lean``: no heartbeat matrix; ``asymmetric``: a tenth of the rows'
    valid flipped, so that some rows are valid where their partner is
    not). Returns a factory of fresh copies of w and hb, so every version
    starts from the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    w = draw(0, 17, (n, n)).to(wdt)
    hb = None if lean else draw(0, 40, (n, n)).to(wdt)
    alive = torch.rand(n, generator=gen, device=dev) < 0.9
    gm, c, p = prng.grouped_matching(prng.key(seed), n)
    shared = dict(
        gm=gm.to(dev, torch.int32), c=c.to(dev, torch.int32),
        valid=alive & alive[p.to(dev)], salt=2 * seed + 1, run_salt=0x9E3779B9,
        budget=2618,
    )
    if diag:
        shared["mv"] = draw(16, 20, (n,))
        if not lean:
            shared["hbv"] = draw(38, 41, (n,))
    if asymmetric:
        shared["valid"] = shared["valid"] ^ (torch.rand(n, generator=gen, device=dev) < 0.1)
        check(bool((shared["valid"] != shared["valid"][p.to(dev)]).any()),
              "the asymmetric case has no row valid apart from its partner")

    def fresh():
        return dict(shared, w=w.clone(), hb=None if hb is None else hb.clone())

    return fresh


def call_m8(fn, ops, **kw):
    out = fn(
        ops["w"], ops["hb"], ops["gm"], ops["c"], ops["valid"], ops["salt"],
        ops["run_salt"], ops["budget"], mv=ops.get("mv"), hbv=ops.get("hbv"), **kw,
    )
    return [out] if ops["hb"] is None else list(out)


def check_m8_kernels(dev):
    """Phase 9a: the m8 totals pass and the m8 pull against their plain
    versions at N = 10,240, int16 and int32, with a seeded tenth of the
    nodes dead: totals with and without the diagonal refresh, valid per
    pair and per row (asymmetric: the kernel visits each pair once and
    masks each direction by its own row), also against the pairs totals,
    the same function; the pull lean and with hb, refresh on and off,
    totals given and not (also against the staged pairs kernel on a copy
    of the same operands, and with its inputs left untouched). Returns
    the max_abs_err of each launch key."""
    errs: dict[str, float] = collections.defaultdict(float)
    for wdt in (torch.int16, torch.int32):
        for diag, asym in ((d, a) for d in (True, False) for a in (False, True)):
            ops = m8_case(N, wdt, 80 + diag + 2 * asym, dev, diag=diag, lean=True,
                          asymmetric=asym)()
            args = (ops["w"], ops["gm"], ops["c"], ops["valid"])
            got = m8_totals.m8_totals(*args, mv=ops.get("mv"))
            want = m8_totals.m8_totals_plain(*args, mv=ops.get("mv"))
            pairs = pairs_totals.pairs_totals(*args, mv=ops.get("mv"))
            torch.cuda.synchronize()
            key = m8_totals.counter_key(diag)
            err = max(max_abs_err([got], [want]), max_abs_err([got], [pairs]))
            errs[key] = max(errs[key], err)
            log("m8", f"n={N} {wdt} {key}{' asymmetric valid' if asym else ''}: "
                f"max_abs_err={err} against the plain version and the pairs totals "
                f"(sum {float(got.double().sum()):.0f})")
            check(err == 0.0, f"{key} disagrees")
        for i, (lean, diag, given) in enumerate(
            (lean, diag, given) for lean in (False, True) for diag in (True, False)
            for given in (False, True)
        ):
            fresh = m8_case(N, wdt, 90 + i, dev, diag=diag, lean=lean)
            ops = fresh()
            tot = None
            if given:
                tot = m8_totals.m8_totals(ops["w"], ops["gm"], ops["c"], ops["valid"],
                                          mv=ops.get("mv"))
            got = call_m8(m8_pull.m8_pull, ops, totals=tot)
            want = call_m8(m8_pull.m8_pull_plain, ops, totals=tot)
            staged = fresh()
            call_pull(pairs_pull.pairs_pull, staged)
            untouched = fresh()
            torch.cuda.synchronize()
            err = max(max_abs_err(got, want),
                      max_abs_err(got, [staged["w"]] + ([] if lean else [staged["hb"]])))
            check(torch.equal(ops["w"], untouched["w"])
                  and (lean or torch.equal(ops["hb"], untouched["hb"])),
                  "the m8 pull wrote its inputs")
            key = m8_pull.counter_key(diag, given)
            errs[key] = max(errs[key], err)
            log("m8", f"n={N} {wdt} {'lean' if lean else 'hb'} {key}: max_abs_err={err} "
                "against the plain version and the staged pairs kernel")
            check(err == 0.0, f"{key} disagrees")
            del ops, staged, untouched, got, want
    return errs


def headline_m8(dev, card_line):
    """Phase 9b: the headline config pinned to m8 runs to convergence
    through the m8 pull (one launch a sub-exchange, the diagonal refresh
    on the first) and the standalone FD kernel (one launch a round), with
    no plain call: round 24, the pairs path's. Then 4 rounds of it equal
    4 rounds of the pairs path on every state tensor, and the round rate
    is timed as the pairs path's is."""
    cfg = dataclasses.replace(headline_config(), pallas_variant="m8")
    counters.reset()
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=0, device=dev)
    converged = sim.run_until_converged(max_rounds=200)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, plain = dict(counters.launches), dict(counters.plain_calls)
    rounds = sim.tick
    log("headline_m8", f"pallas_variant='m8': run_until_converged -> {converged} after "
        f"{rounds} rounds ({run_s:.2f} s incl. setup); launches {launches}; plain calls "
        f"{plain}")
    check(converged == CONVERGED_ROUND,
          f"headline m8 converged at {converged}, expected {CONVERGED_ROUND}")
    check(counters.kernel_launches("m8_pull") == 3 * rounds
          and launches.get("m8_pull[diag]") == rounds and launches.get("fd") == rounds
          and counters.kernel_launches("pairs_pull") == 0 and not plain,
          "headline m8 did not run 3 m8 pulls and 1 FD kernel a round")
    m = sim.metrics()
    check(bool(m["all_converged"]) and float(m["min_fraction"]) == 1.0
          and np.isfinite(float(m["mean_fraction"])) and int(m["fd_false_positives"]) >= 0,
          "headline m8 metrics disagree with the converged flag")
    del sim
    a = Simulator(cfg, seed=0, device=dev)
    a.run(4)
    b = Simulator(headline_config(), seed=0, device=dev)
    b.run(4)
    torch.cuda.synchronize()
    check(states_equal(a.state, b.state), "4 rounds of the m8 path != the pairs path")
    log("headline_m8", "4 rounds: m8 path == pairs path on every state tensor")
    del a, b
    sim = Simulator(cfg, seed=0, device=dev, chunk=16)
    sim.run(8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(48)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) / 48 * 1e3
    del sim
    log("headline_m8", f"{1e3 / round_ms:.2f} rounds/s at N={N} ({round_ms:.3f} ms/round; "
        f"{card_line})")
    record = {"n": N, "seed": 0, "converged_round": converged, "rounds_run": rounds,
              "round_ms": round_ms, "rounds_per_s": 1e3 / round_ms}
    return record, launches


def m8_subexchange(dev, sim, seed, s):
    """Operands of sub-exchange ``s`` of the round after the simulator's
    tick, with a seeded tenth of the nodes dead and a seeded half of the
    owners having written a key (so the masks and the refresh change
    values): (gm, c, valid, mv, salt, run_salt)."""
    n = sim.cfg.n_nodes
    gen = torch.Generator(device=dev).manual_seed(seed)
    alive = torch.rand(n, generator=gen, device=dev) < 0.9
    wrote = torch.rand(n, generator=gen, device=dev) < 0.5
    mv = sim.state.max_version + wrote.to(torch.int32)
    tick = sim.tick + 1
    run_key = prng.key(sim.seed)
    gm, c, p = (t[0][s] for t in prng.round_draws(run_key.to(dev), tick, 1, n, sim.cfg.fanout))
    salt = tick * 2 * sim.cfg.fanout + 2 * s
    return gm, c, alive & alive[p], mv, salt, prng.run_salt(run_key)


def check_m8_full_width(dev, sim, errs):
    """Phase 9c: the two-pass m8 modes against their plain versions at the
    north star's width, on its state ``FULL_WIDTH_ROUNDS`` rounds in: the
    first sub-exchange's (refresh) and a later one's, each from the
    state's w (the kernels never write it). Raises each launch key's
    max_abs_err in ``errs``."""
    w, budget = sim.state.w, sim.cfg.budget
    t0 = time.perf_counter()
    for s, diag in ((0, True), (1, False)):
        gm, c, valid, mv, salt, run_salt = m8_subexchange(dev, sim, 8, s)
        mv = mv if diag else None
        tk = m8_totals.m8_totals(w, gm, c, valid, mv=mv)
        tp = m8_totals.m8_totals_plain(w, gm, c, valid, mv=mv)
        t_key = m8_totals.counter_key(diag)
        t_err = max_abs_err([tk], [tp])
        errs[t_key] = max(errs[t_key], t_err)
        args = (gm, c, valid, salt, run_salt, budget)
        wk = m8_pull.m8_pull(w, None, *args, mv=mv, totals=tk)
        wp = m8_pull.m8_pull_plain(w, None, *args, mv=mv, totals=tp)
        torch.cuda.synchronize()
        p_key = m8_pull.counter_key(diag, True)
        p_err = max_abs_err([wk], [wp])
        errs[p_key] = max(errs[p_key], p_err)
        log("north_star_m8", f"n={w.shape[0]} sub-exchange {s}: {t_key} max_abs_err={t_err} "
            f"(totals sum {float(tk.double().sum()):.0f}, max {float(tk.max()):.0f}); "
            f"{p_key} max_abs_err={p_err}")
        del wk, wp
    torch.cuda.empty_cache()
    log("north_star_m8", f"every two-pass m8 mode equals its plain version on the north "
        f"star's state {sim.tick} rounds in ({time.perf_counter() - t0:.1f} s)")


def check_column_blocks(dev, sim, errs):
    """Phase 9d: the reference's certified 8-shard computation, block by
    block on one card. The first sub-exchange of the next round (refresh
    on, a tenth of the nodes dead) over the whole width: its totals and
    its pull. Then over 8 column blocks of the owners, each copied out
    (2.5 GB) and run at its owner offset: the blocks' totals, summed in
    float32, must equal the whole width's bit for bit, and each block's
    pull with the whole width's totals must equal the whole width's
    output on its columns."""
    w, budget = sim.state.w, sim.cfg.budget
    n = w.shape[0]
    width = n // COLUMN_BLOCKS
    t0 = time.perf_counter()
    gm, c, valid, mv, salt, run_salt = m8_subexchange(dev, sim, 9, 0)
    args = (gm, c, valid, salt, run_salt, budget)
    tot = m8_totals.m8_totals(w, gm, c, valid, mv=mv)
    whole = m8_pull.m8_pull(w, None, *args, mv=mv, totals=tot)
    summed = torch.zeros_like(tot)
    err = 0.0
    for k in range(COLUMN_BLOCKS):
        cols = slice(k * width, (k + 1) * width)
        block = w[:, cols].contiguous()
        bmv = mv[cols].contiguous()
        summed += m8_totals.m8_totals(block, gm, c, valid, mv=bmv, owner_offset=k * width)
        out = m8_pull.m8_pull(block, None, *args, mv=bmv, owner_offset=k * width, totals=tot)
        torch.cuda.synchronize()
        err = max(err, max_abs_err([out], [whole[:, cols]]))
        del block, out
    torch.cuda.synchronize()
    t_err = max_abs_err([summed], [tot])
    for key in (m8_totals.counter_key(True), m8_pull.counter_key(True, True)):
        errs[key] = max(errs[key], t_err, err)
    log("north_star_m8", f"{COLUMN_BLOCKS} column blocks of {width} owners (owner_offset "
        f"k*{width}): summed totals max_abs_err={t_err} against the whole width's; pulls "
        f"side by side max_abs_err={err} ({time.perf_counter() - t0:.1f} s)")
    del whole
    torch.cuda.empty_cache()


def north_star_m8(dev, card_line, errs):
    """Phase 9c-d: the north star pinned to m8, through the two-pass m8
    form (3 m8 totals and 3 m8 pull launches a round, no plain call). It
    runs ``FULL_WIDTH_ROUNDS`` rounds; the full-width parity and the
    column-block checks read that state (their launches are not the
    run's); then it runs on to convergence, which must be round 209. The
    round rate is timed over 16 more rounds and each pass at this width
    with CUDA events. Returns the record, the run's launches and the
    per-key times."""
    cfg = lean_config(NORTH_STAR_N, budget=2618, pallas_variant="m8")
    n = cfg.n_nodes
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=NORTH_STAR_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim.run(FULL_WIDTH_ROUNDS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = collections.Counter(counters.launches)
    plain = collections.Counter(counters.plain_calls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_m8_full_width(dev, sim, errs)
    check_column_blocks(dev, sim, errs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    converged = sim.run_until_converged(max_rounds=400)
    torch.cuda.synchronize()
    run_s += time.perf_counter() - t0
    launches.update(counters.launches)
    plain.update(counters.plain_calls)
    launches, plain = dict(launches), dict(plain)
    peak_gb = max(peak_gb, torch.cuda.max_memory_allocated() / 1e9)
    rounds = sim.tick
    log("north_star_m8", f"lean_config({n}, budget=2618, pallas_variant='m8') seed "
        f"{NORTH_STAR_SEED}: converged at round {converged} after {rounds} rounds in "
        f"{run_s:.2f} s of rounds (init {init_s:.2f} s); launches {launches}; plain calls "
        f"{plain}; refusals {dict(counters.refusals)}")
    check(converged == NORTH_STAR_ROUND,
          f"north star m8 converged at {converged}, expected {NORTH_STAR_ROUND}")

    def total(kernel):
        return sum(v for k, v in launches.items() if k.startswith(kernel + "["))

    check(total("m8_totals") == 3 * rounds and total("m8_pull") == 3 * rounds
          and launches.get("m8_totals[diag]") == rounds
          and launches.get("m8_pull[totals+diag]") == rounds
          and total("pairs_pull") == 0 and not plain and not counters.refusals,
          "the north star m8 did not run every sub-exchange through both m8 kernels")
    m = sim.metrics()
    check(bool(m["all_converged"]) and float(m["min_fraction"]) == 1.0
          and np.isfinite(float(m["mean_fraction"])) and int(m["alive_count"]) == n,
          "north-star m8 metrics disagree with the converged flag")

    win = 16
    sim.run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(win)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) / win * 1e3
    # A tracked round on this path also takes the plain convergence flag
    # (the reference's m8 path does too): its cost, and a chunk's.
    flag_ms = cuda_ms(lambda: gossip.all_converged_flag(sim.state), 3, 1)
    t0 = time.perf_counter()
    sim.run_until_converged(max_rounds=sim.tick + win)  # converged: metrics only
    torch.cuda.synchronize()
    metrics_ms = (time.perf_counter() - t0) * 1e3
    log("north_star_m8", f"all_converged_flag {flag_ms:.3f} ms (CUDA events; a tracked "
        f"round's flag on this path); the converged check at a run's start "
        f"(convergence_metrics) {metrics_ms:.1f} ms")

    # Each pass at this width, on the converged state (read only).
    w, alive, mv = sim.state.w, sim.state.alive, sim.state.max_version
    gm, c, _ = prng.grouped_matching(prng.key(9), n)
    gm, c = gm.to(dev, torch.int32), c.to(dev, torch.int32)
    tot = m8_totals.m8_totals(w, gm, c, alive, mv=mv)
    times = {}
    for diag in (True, False):
        mvk = mv if diag else None
        t_bound = bound(m8_totals_bytes(n, n, 2, diag=diag), OPS_TOTALS * n * n / 2)
        times[m8_totals.counter_key(diag)] = (  # its traffic is its bound
            cuda_ms(lambda: m8_totals.m8_totals(w, gm, c, alive, mv=mvk), 10),
            t_bound, t_bound,
        )
        times[m8_pull.counter_key(diag, True)] = (
            cuda_ms(lambda: m8_pull.m8_pull(w, None, gm, c, alive, 1, 0x9E3779B9,
                                            cfg.budget, mv=mvk, totals=tot), 10),
            bound(m8_bytes(n, n, 2, 0, diag=diag, totals=True), OPS_PULL_LEAN * n * n / 2),
            bound(m8_bytes(n, n, 2, 0, diag=diag, totals=True, reads=2),
                  OPS_PULL_LEAN * n * n / 2),
        )
    torch.cuda.synchronize()
    del sim, w, tot
    torch.cuda.empty_cache()
    # A round: one totals pass and one pull with the refresh, two of each
    # without.
    per_round = {k: (1 if "diag" in k else 2) for k in times}
    per_round_ms = sum(per_round[k] * t[0] for k, t in times.items())
    per_round_bound = sum(per_round[k] * t[1][0] for k, t in times.items())
    per_round_design = sum(per_round[k] * t[2][0] for k, t in times.items())
    log("north_star_m8", f"{1e3 / round_ms:.3f} rounds/s ({round_ms:.3f} ms/round over {win} "
        f"untracked rounds); run {rounds / run_s:.3f} rounds/s; kernels "
        f"{per_round_ms:.3f} ms/round by CUDA events against the function's "
        f"{per_round_bound:.3f} ms bound ({per_round_bound / per_round_ms:.1%}) and this "
        f"design's {per_round_design:.3f} ms of traffic ({per_round_design / per_round_ms:.1%})"
        f"; peak memory {peak_gb:.2f} GB while running; {card_line}")
    for key, (ms, (b_ms, b_by), (d_ms, _)) in times.items():
        log("north_star_m8", f"{key} at n={n}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
            f"this design's traffic {d_ms:.4f} ms)")
    record = {
        "n": n, "seed": NORTH_STAR_SEED, "converged_round": converged,
        "rounds_run": rounds, "run_s": run_s, "init_s": init_s,
        "round_ms": round_ms, "rounds_per_s": 1e3 / round_ms,
        "kernel_ms_per_round": per_round_ms, "bound_ms_per_round": per_round_bound,
        "design_bound_ms_per_round": per_round_design, "peak_memory_gb": peak_gb,
        "flag_ms": flag_ms, "metrics_ms": metrics_ms,
    }
    return record, launches, times


def i16_experiment(dev):
    """Phase 9e: the reference's int16 experiment on Hopper. Its inputs
    (N = 10,240, w in [0, 2000), hb in [0, 500), everyone alive, budget
    2618; from a numpy seed), the m8 pull's int16 variants against the
    int32 kernel (bit-exact) and its plain version, then each timed as
    the experiment's ``main()`` times them: 64 chained calls, best of 2,
    the variants in turns. Returns {arith: (ms, max_abs_err)}."""
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy(rng.integers(0, 2000, (N, N), dtype=np.int16)).to(dev)
    hb0 = torch.from_numpy(rng.integers(0, 500, (N, N), dtype=np.int16)).to(dev)
    gm, c, _ = prng.grouped_matching(prng.key(0), N)
    args = (gm.to(dev, torch.int32), c.to(dev, torch.int32),
            torch.ones(N, dtype=torch.bool, device=dev), 3, 0xDEAD, 2618)
    ref = m8_pull.m8_pull(w0, hb0, *args)
    plain = m8_pull.m8_pull_plain(w0, hb0, *args)
    torch.cuda.synchronize()
    errs = {"i32": max_abs_err(list(ref), list(plain))}
    for arith in ("i16", "i16_f32"):
        out = m8_pull.m8_pull(w0, hb0, *args, arith=arith)
        torch.cuda.synchronize()
        errs[arith] = max_abs_err(list(out), list(ref))
        log("i16", f"variant {arith}: max_abs_err={errs[arith]} against the int32 kernel")
        check(errs[arith] == 0.0, f"the {arith} variant is not bit-exact")
        del out
    del ref, plain

    def chained(arith):
        w, hb = w0, hb0
        for _ in range(64):
            w, hb = m8_pull.m8_pull(w, hb, *args, arith=arith)

    best = {a: float("inf") for a in errs}
    for a in best:
        chained(a)  # warm-up
    for _ in range(2):
        for a in best:
            best[a] = min(best[a], cuda_ms(lambda a=a: chained(a), 1, 0) / 64)
    log("i16", "64 chained calls, best of 2: " + ", ".join(
        f"{a} {ms:.4f} ms/call ({best['i32'] / ms:.3f}x the int32 kernel)"
        for a, ms in best.items()))
    return {a: (best[a], errs[a]) for a in best}


def m8_kernel_entries(dev, errs, head_launches, head_rounds, ns_launches, ns_rounds,
                      ns_times, experiment):
    """The kernel-line entries of the m8 path: the headline's staged modes
    (with hb) and the north star's two-pass modes (lean), each timed at
    N = 10,240 beside its plain version, its bound (the bytes the
    function must move) and this design's traffic; the north star's modes
    also at its width (``ns_times``); launches and launches a round from
    the runs (each must be > 0). The int16 variants ride the entry of the
    mode they run in."""
    entries = []

    def entry(key, kernel, line, launches, rounds, ms, plain_ms, b, d, **extra):
        check(launches.get(key, 0) > 0, f"{key} was not launched on its path")
        log("time", f"{key}: {ms:.4f} ms at n={N} (bound {b[0]:.4f} ms by {b[1]}; this "
            f"design's traffic {d[0]:.4f} ms; plain {plain_ms:.3f} ms)"
            + ("" if "ms_main" not in extra else
               f"; {extra['ms_main']:.4f} ms at n={NORTH_STAR_N} (bound "
               f"{extra['bound_ms_main']:.4f} ms)"))
        return dict(
            name=key, route="cuda", source=f"aiocluster_torch/ops/csrc/{kernel}.cu",
            replaces=f"aiocluster_tpu/ops/pallas_pull.py:{line}",
            launches=launches[key], launches_per_round=launches[key] / rounds,
            max_abs_err=errs[key], ms=ms, plain_ms=plain_ms, bound_ms=b[0],
            bound_by=b[1], library_ms=None, design_bound_ms=d[0], n=N, **extra,
        )

    for i, diag in enumerate((True, False)):
        ops = m8_case(N, torch.int16, 100 + i, dev, diag=diag, lean=False)()
        ms = cuda_ms(lambda: call_m8(m8_pull.m8_pull, ops), 20)
        plain_ms = cuda_ms(lambda: call_m8(m8_pull.m8_pull_plain, ops), 3, 1)
        del ops
        key = m8_pull.counter_key(diag)
        extra = dict(path="headline_m8")
        if not diag:  # the experiment's mode
            extra["ms_chained"] = experiment["i32"][0]
            extra["variants"] = {
                a: dict(ms_chained=t, max_abs_err=e,
                        replaces="benchmarks/records/_i16_kernel_experiment.py:43")
                for a, (t, e) in experiment.items() if a != "i32"
            }
        entries.append(entry(
            key, "m8_pull", 263, head_launches, head_rounds, ms, plain_ms,
            bound(m8_bytes(N, N, 2, 2, diag=diag, totals=False), OPS_PULL * N * N / 2),
            bound(m8_bytes(N, N, 2, 2, diag=diag, totals=False, reads=2),
                  OPS_PULL * N * N / 2),
            **extra,
        ))
    for i, diag in enumerate((True, False)):
        ops = m8_case(N, torch.int16, 110 + i, dev, diag=diag, lean=True)()
        targs = (ops["w"], ops["gm"], ops["c"], ops["valid"])
        mv = ops.get("mv")
        tot = m8_totals.m8_totals(*targs, mv=mv)
        t_bound = bound(m8_totals_bytes(N, N, 2, diag=diag), OPS_TOTALS * N * N / 2)
        for key, kernel, line, fn, plain_fn, b, d in (
            (m8_totals.counter_key(diag), "m8_totals", 374,
             lambda: m8_totals.m8_totals(*targs, mv=mv),
             lambda: m8_totals.m8_totals_plain(*targs, mv=mv),
             t_bound, t_bound),
            (m8_pull.counter_key(diag, True), "m8_pull", 263,
             lambda: call_m8(m8_pull.m8_pull, ops, totals=tot),
             lambda: call_m8(m8_pull.m8_pull_plain, ops, totals=tot),
             bound(m8_bytes(N, N, 2, 0, diag=diag, totals=True), OPS_PULL_LEAN * N * N / 2),
             bound(m8_bytes(N, N, 2, 0, diag=diag, totals=True, reads=2),
                   OPS_PULL_LEAN * N * N / 2)),
        ):
            ms = cuda_ms(fn, 20)
            plain_ms = cuda_ms(plain_fn, 3, 1)
            ms_main, b_main, d_main = ns_times[key]
            entries.append(entry(
                key, kernel, line, ns_launches, ns_rounds, ms, plain_ms, b, d,
                path="north_star_m8", n_main=NORTH_STAR_N, ms_main=ms_main,
                bound_ms_main=b_main[0], design_bound_ms_main=d_main[0],
                parity_n=[N, NORTH_STAR_N],
            ))
        del ops, tot
    return entries


# -- the memory ladder's rungs (int8, packed u4r, the shrunk FD bookkeeping) ----

# lean_config(100_352, rung="int8", budget=2618) at seed 1 converges where
# the int16 north star does: the rungs share one trajectory.
LADDER_NS_ROUND = NORTH_STAR_ROUND
# full_config(49_152, rung, budget=2618) at seed 1: the reference's
# certified full-profile round at this width
# (benchmarks/records/r5_full_profile_convergence.json, key "49152").
FULL_N, FULL_ROUND = 49_152, 103
FULL_CHECK_ROUNDS = 40  # the full rungs' rounds before their parity check
WIDEST_U4R_N, WIDEST_U4R_ROUNDS = 262_144, 8
# The FD bookkeeping's stored form per rung: (icount dtype, live bitmap).
FD_RUNGS = {
    "deep": dict(wdt=torch.int8, hdt=torch.int8, icdt=torch.int8, bits=True),
    "shrunk": dict(wdt=torch.int16, hdt=torch.int16, icdt=torch.int8, bits=True),
}
LADDER_CHECKS = (
    # (rung, operands, modes): every new mode of the pairs kernel, each
    # staged and in the totals mode.
    ("int8", dict(wdt=torch.int8), ("first", "middle", "last")),
    ("u4r", dict(wdt="u4"), ("first", "middle", "last")),
    ("deep", FD_RUNGS["deep"], ("first", "middle", "last_fd", "only_fd")),
    ("shrunk", FD_RUNGS["shrunk"], ("last_fd", "only_fd")),
)
LADDER_MODES = {
    "first": dict(diag=True, check=False, fd=False, hb0=False),
    "middle": dict(diag=False, check=False, fd=False, hb0=False),
    "last": dict(diag=False, check=True, fd=False, hb0=False),
    "last_fd": dict(diag=False, check=True, fd=True, hb0=True),
    "only_fd": dict(diag=True, check=True, fd=True, hb0=False),
}


def ladder_case(n, seed, dev, *, wdt, hdt=None, imdt=torch.bfloat16, icdt=torch.int16,
                bits=False, diag, check, fd, hb0):
    """Random operands of one sub-exchange on a ladder rung, drawn on the
    card from ``seed`` (``wdt`` "u4" is the packed rung; ``hdt`` None the
    lean profile), a tenth of the nodes dead. Returns a factory of fresh
    copies, for ``call_pull`` and ``outputs``."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(lo, hi, shape, dt=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(dt)

    packed = wdt == "u4"
    gm, c, p = prng.grouped_matching(prng.key(seed), n)
    alive = torch.rand(n, generator=gen, device=dev) < 0.9
    w = draw(0, 256, (n, n // 2), torch.uint8) if packed else draw(0, 17, (n, n), wdt)
    hb = None if hdt is None else draw(0, 40, (n, n), hdt)
    shared = dict(gm=gm.to(dev, torch.int32), c=c.to(dev, torch.int32),
                  valid=alive & alive[p.to(dev)], salt=2 * seed + 1, run_salt=0x9E3779B9,
                  budget=2618)
    mv = draw(0, 3, (n,)) if packed else draw(16, 20, (n,))
    if diag:
        shared["mv"] = mv
        if hdt is not None:
            shared["hbv"] = draw(38, 41, (n,))
    if check:
        shared["check"] = (mv, alive, torch.rand(n, generator=gen, device=dev) < 0.95)
    lc = im = ic = live = h0 = None
    if fd:
        shared["hbv"] = draw(38, 41, (n,))
        lc = draw(0, 40, (n, n), hdt)
        im = (torch.rand((n, n), generator=gen, device=dev) * 6).to(imdt)
        ic = draw(0, 101, (n, n), icdt)  # up to the window: the clamp runs
        live = torch.rand((n, n), generator=gen, device=dev) < 0.5
        live = pack_bits(live) if bits else live
        h0 = draw(0, 40, (n, n), hdt) if hb0 else None
    params = FdParams.from_config(full_config(n, "deep"))

    def fresh():
        ops = dict(shared, w=w.clone(), hb=None if hb is None else hb.clone())
        if fd:
            ops["fd"] = pairs_pull.FdOperands(
                40, lc.clone(), im.clone(), ic.clone(), live.clone(), h0, params)
        return ops

    return fresh


def ladder_key(m, rung, totals=False, cluster=False) -> str:
    """The name of a ladder mode's entry: its launch key and its rung."""
    key = pairs_pull.counter_key(m["diag"], m["check"], m["fd"], totals, rung == "u4r",
                                 cluster=cluster)
    return f"{key} {rung}"


def check_ladder_kernels(dev):
    """Phase 10a: every new mode of the pairs kernels against its plain
    version at N = 10,240: int8 (lean and with hb), the packed u4r codec
    (write-bump refresh, nibble check), the FD epilogue on int8 sample
    counters and the live bitmap (deep: int8 matrices; shrunk: int16),
    each staged and in the totals mode (the two-pass form also against
    the staged kernel); the totals pass on int8 and packed rows; the m8
    kernels on int8 (lean and with int8 hb); the standalone FD kernel on
    int8 heartbeats. Returns each entry's max_abs_err."""
    errs: dict[str, float] = collections.defaultdict(float)
    seed = 200
    for rung, operands, modes in LADDER_CHECKS:
        for name in modes:
            m = LADDER_MODES[name]
            seed += 1
            fresh = ladder_case(N, seed, dev, **operands, **m)
            kern, plain, staged, two_pass = fresh(), fresh(), fresh(), fresh()
            fk = call_pull(pairs_pull.pairs_pull, kern)
            fp = call_pull(pairs_pull.pairs_pull_plain, plain)
            err = max_abs_err(outputs(kern, fk), outputs(plain, fp))
            errs[ladder_key(m, rung)] = max(errs[ladder_key(m, rung)], err)
            args = (two_pass["w"], two_pass["gm"], two_pass["c"], two_pass["valid"])
            two_pass["totals"] = pairs_totals.pairs_totals(*args, mv=two_pass.get("mv"))
            staged["totals"] = pairs_totals.pairs_totals_plain(*args, mv=staged.get("mv"))
            ft = call_pull(pairs_pull.pairs_pull, two_pass)
            fp = call_pull(pairs_pull.pairs_pull_plain, staged)
            torch.cuda.synchronize()
            t_err = max(max_abs_err([two_pass["totals"]], [staged["totals"]]),
                        max_abs_err(outputs(two_pass, ft), outputs(staged, fp)),
                        max_abs_err(outputs(two_pass, ft), outputs(kern, fk)))
            t_key = ladder_key(m, rung, totals=True)
            errs[t_key] = max(errs[t_key], t_err)
            flag = "" if fk is None else f" flag={int(fk[0])}"
            log("ladder", f"n={N} {rung} {name}: {ladder_key(m, rung)} max_abs_err={err}; "
                f"two-pass {t_key} max_abs_err={t_err} (against the plain version and the "
                f"staged kernel){flag}")
            check(err == 0.0 and t_err == 0.0, f"{rung} {name} disagrees")
            del kern, plain, staged, two_pass
    for rung, wdt in (("int8", torch.int8), ("u4r", "u4")):
        for diag in (True, False):
            ops = ladder_case(N, 230 + diag, dev, wdt=wdt, diag=diag, check=False, fd=False,
                              hb0=False)()
            args = (ops["w"], ops["gm"], ops["c"], ops["valid"])
            got = pairs_totals.pairs_totals(*args, mv=ops.get("mv"))
            want = pairs_totals.pairs_totals_plain(*args, mv=ops.get("mv"))
            torch.cuda.synchronize()
            key = f"{pairs_totals.counter_key(diag, rung == 'u4r')} {rung}"
            errs[key] = max(errs[key], max_abs_err([got], [want]))
            log("ladder", f"n={N} {key}: max_abs_err={errs[key]} "
                f"(sum {float(got.double().sum()):.0f})")
            check(errs[key] == 0.0, f"{key} disagrees")
    for hdt, diag, given in ((h, d, g) for h in (None, torch.int8) for d in (True, False)
                             for g in (False, True)):
        ops = ladder_case(N, 240 + diag + 2 * given, dev, wdt=torch.int8, hdt=hdt, diag=diag,
                          check=False, fd=False, hb0=False)()
        tot = None
        if given:
            targs = (ops["w"], ops["gm"], ops["c"], ops["valid"])
            tot = m8_totals.m8_totals(*targs, mv=ops.get("mv"))
            t_want = m8_totals.m8_totals_plain(*targs, mv=ops.get("mv"))
            t_key = f"{m8_totals.counter_key(diag)} int8"
            errs[t_key] = max(errs[t_key], max_abs_err([tot], [t_want]))
        got = call_m8(m8_pull.m8_pull, ops, totals=tot)
        want = call_m8(m8_pull.m8_pull_plain, ops, totals=tot)
        torch.cuda.synchronize()
        key = f"{m8_pull.counter_key(diag, given)} int8{'' if hdt is None else '+hb'}"
        errs[key] = max(errs[key], max_abs_err(got, want))
        log("ladder", f"n={N} {key}: max_abs_err={errs[key]}")
        check(errs[key] == 0.0, f"{key} disagrees")
    ops = ladder_case(N, 250, dev, wdt=torch.int8, hdt=torch.int8, diag=False, check=False,
                      fd=True, hb0=True)()
    f = ops["fd"]

    def fd_fresh():
        return [ops["hb"], f.hb0, ops["hbv"], f.lc.clone(), f.im.clone(),
                f.ic.to(torch.int16, copy=True),
                torch.zeros((N, N), dtype=torch.bool, device=dev)]

    a, b = fd_fresh(), fd_fresh()
    fd_mod.fused_fd(40, *a, f.params)
    fd_mod.fused_fd_plain(40, *b, f.params)
    torch.cuda.synchronize()
    errs["fd int8"] = max_abs_err(a[3:], b[3:])
    log("ladder", f"n={N} fd int8 heartbeats: max_abs_err={errs['fd int8']}")
    check(errs["fd int8"] == 0.0, "the fd kernel disagrees on int8 heartbeats")
    return errs


def chained_round_check(dev, sim, rung, errs, seed=8):
    """One round's sub-exchanges at the simulator's width in its form
    (``gossip.kernel_pull_form``: staged on its clusters, or the two-pass
    form, the totals of both sides held too), chained as ``sim_step``
    chains them (the first refreshes the diagonal, the last carries the
    check and, with the FD, the fused epilogue reading the round-start
    hb), then a fourth whose check every row passes (need 0: the flag
    must stay 1 across every CTA). The kernel runs on copies of every
    matrix it writes, the plain version (over blocks of row pairs) on the
    state itself. A seeded tenth of the nodes is dead and a seeded half
    of the owners wrote a key, so the masks and the refresh change
    values. Raises each mode's max_abs_err in ``errs``; returns the
    round's (key, max_abs_err) pairs."""
    st, cfg, n = sim.state, sim.cfg, sim.cfg.n_nodes
    form, k = gossip.kernel_pull_form(cfg)
    two_pass = form == "pairs_two_pass"
    packed = rung == "u4r"
    gen = torch.Generator(device=dev).manual_seed(seed)
    alive = torch.rand(n, generator=gen, device=dev) < 0.9
    wrote = torch.rand(n, generator=gen, device=dev) < 0.5
    mv = st.max_version + wrote.to(torch.int32)
    heartbeat = st.heartbeat + alive.to(torch.int32)
    tick = sim.tick + 1
    run_key = prng.key(sim.seed)
    gm_all, c_all, p_all = (
        t[0] for t in prng.round_draws(run_key.to(dev), tick, 1, n, cfg.fanout)
    )
    plain = dict(w=st.w, hb=st.hb_known if cfg.track_heartbeats else None)
    kern = {k: None if v is None else v.clone() for k, v in plain.items()}
    fds = None
    if cfg.track_failure_detector:
        params = FdParams.from_config(cfg)
        hb0 = st.hb_known.clone()  # the round-start matrix, diagonal unrefreshed
        fds = (pairs_pull.FdOperands(tick, st.last_change.clone(), st.imean.clone(),
                                     st.icount.clone(), st.live_view.clone(), hb0.clone(),
                                     params),
               pairs_pull.FdOperands(tick, st.last_change, st.imean, st.icount, st.live_view,
                                     hb0, params))
    steps = [("first", 0)] + [("middle", s) for s in range(1, cfg.fanout - 1)]
    steps += [("last_fd" if fds else "last", cfg.fanout - 1), ("need 0", cfg.fanout - 1)]
    found = []
    for name, s in steps:
        mode = LADDER_MODES["last" if name == "need 0" else name]
        valid = alive & alive[p_all[s]]
        kw = {}
        if mode["diag"]:
            kw["mv"] = mv
            if cfg.track_heartbeats:
                kw["hbv"] = heartbeat
        if mode["check"]:
            # need 0 and every owner excused: the flag must stay 1 (a packed row
            # passes only where its owners are caught up or excused).
            kw["check"] = ((torch.zeros_like(mv), alive, torch.zeros_like(alive))
                           if name == "need 0" else (mv, alive, alive))
        if packed and "mv" in kw:
            kw["mv"] = mv - st.max_version  # the packed refresh takes the write bumps
        args = (gm_all[s], c_all[s], valid, tick * 2 * cfg.fanout + 2 * s,
                prng.run_salt(run_key), cfg.budget)
        outs = []
        t_err = None
        if two_pass:
            tk = pairs_totals.pairs_totals(kern["w"], gm_all[s], c_all[s], valid,
                                           mv=kw.get("mv"))
            tp = pairs_totals.pairs_totals_plain(plain["w"], gm_all[s], c_all[s], valid,
                                                 mv=kw.get("mv"))
            t_err = max_abs_err([tk], [tp])
            t_key = f"{pairs_totals.counter_key(mode['diag'], packed)} {rung}"
            errs[t_key] = max(errs[t_key], t_err)
        for ops, fd in ((kern, fds and fds[0]), (plain, fds and fds[1])):
            fn = pairs_pull.pairs_pull if ops is kern else pairs_pull.pairs_pull_plain
            extra = dict(hbv=heartbeat, fd=fd) if mode["fd"] else {}
            if two_pass:
                extra["totals"] = tk if ops is kern else tp
            flag = fn(ops["w"], ops["hb"], *args, **kw, **extra)
            outs.append([ops["w"]] + ([] if ops["hb"] is None else [ops["hb"]])
                        + ([fd.lc, fd.im, fd.ic, fd.live] if mode["fd"] else [])
                        + ([] if flag is None else [flag]))
        torch.cuda.synchronize()
        key = ladder_key(mode, rung, totals=two_pass, cluster=not two_pass and k > 1)
        err = max_abs_err(*outs)
        errs[key] = max(errs[key], err)
        if t_err is not None:
            found.append((f"{t_key} ({name})", t_err))
        found.append((f"{key} ({name})", err))
        if name == "need 0":
            check(int(outs[0][-1][0]) == 1, f"{rung}: the check flag of a passing "
                  "sub-exchange is 0")
    del kern, fds, outs
    torch.cuda.empty_cache()
    return found


def check_ladder_full_width(dev, errs):
    """Phase 10a': the pairs modes at the width of their paths' runs, in
    both forms (the run's and ``other_form``), against the plain versions,
    on an early state (at convergence every deficit is 0, which would
    prove little): the lean int8 north star's state ``FULL_WIDTH_ROUNDS``
    rounds in (rows of 100,352 bytes): the m8 pull in both modes from that
    state, then one round of pairs pulls chained in each form; the full
    deep and shrunk rungs at N = 49,152, ``FULL_CHECK_ROUNDS`` rounds in:
    one round chained in each form, the last with the fused FD epilogue
    on the int8 counters and the live bitmap (last_change, imean, icount
    and the bitmap compared). Raises each mode's max_abs_err in
    ``errs``."""
    t0 = time.perf_counter()
    cfg = lean_config(NORTH_STAR_N, "int8", budget=2618)
    sim = Simulator(cfg, seed=NORTH_STAR_SEED, device=dev)
    sim.run(FULL_WIDTH_ROUNDS)
    found = []
    for s, diag in ((0, True), (1, False)):
        gm, c, valid, mv, salt, run_salt = m8_subexchange(dev, sim, 8, s)
        args = (sim.state.w, None, gm, c, valid, salt, run_salt, cfg.budget)
        wk = m8_pull.m8_pull(*args, mv=mv if diag else None)
        wp = m8_pull.m8_pull_plain(*args, mv=mv if diag else None)
        torch.cuda.synchronize()
        key = f"{m8_pull.counter_key(diag)} int8"
        err = max_abs_err([wk], [wp])
        errs[key] = max(errs[key], err)
        found.append((key, err))
        del wk, wp
    torch.cuda.empty_cache()
    found += chained_round_check(dev, sim, "int8", errs)
    with other_form(cfg):  # the other form's launches at this width too
        found += chained_round_check(dev, sim, "int8", errs, seed=9)
    del sim
    torch.cuda.empty_cache()
    log("ladder_full_width", f"n={NORTH_STAR_N} int8, the north star's state "
        f"{FULL_WIDTH_ROUNDS} rounds in: " + ", ".join(f"{k} max_abs_err={e}" for k, e in found))
    for rung in ("deep", "shrunk"):
        sim = Simulator(full_config(FULL_N, rung, budget=2618), seed=NORTH_STAR_SEED,
                        device=dev)
        sim.run(FULL_CHECK_ROUNDS)
        found = chained_round_check(dev, sim, rung, errs)
        with other_form(sim.cfg):
            found += chained_round_check(dev, sim, rung, errs, seed=9)
        del sim
        torch.cuda.empty_cache()
        log("ladder_full_width", f"n={FULL_N} {rung}, {FULL_CHECK_ROUNDS} rounds in: "
            + ", ".join(f"{k} max_abs_err={e}" for k, e in found))
    log("ladder_full_width", f"every staged ladder mode equals its plain version at its "
        f"path's width ({time.perf_counter() - t0:.1f} s with the rounds)")


def run_to(cfg, dev, seed, want, what, max_rounds=400, chunk=8, mesh=None, timed=None):
    """Run ``cfg`` to convergence through the kernels from counters at 0
    (over ``mesh``'s column blocks when given): it must converge at round
    ``want`` (None: any) with no plain call, fallback or refusal. With
    ``timed`` (a dict), its "round_ms" is set to the run's wall time a
    round, the state's set-up left out. Returns (simulator, round,
    launches, seconds with the set-up, peak GB)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    place = {"device": dev} if mesh is None else {"mesh": mesh}
    sim = Simulator(cfg, seed=seed, chunk=chunk, **place)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    converged = sim.run_until_converged(max_rounds=max_rounds)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if timed is not None:
        timed["round_ms"] = (time.perf_counter() - t1) / max(sim.tick, 1) * 1e3
    launches = dict(counters.launches)
    log(what, f"converged at round {converged} after {sim.tick} rounds in {run_s:.2f} s "
        f"(with init); launches {launches}; plain calls {dict(counters.plain_calls)}; "
        f"fallbacks {dict(counters.fallbacks)}; refusals {dict(counters.refusals)}")
    check(want is None or converged == want, f"{what} converged at {converged}, expected {want}")
    check(converged is not None and not counters.plain_calls and not counters.fallbacks
          and not counters.refusals, f"{what} did not run through the kernels alone")
    m = sim.metrics()
    check(bool(m["all_converged"]) and float(m["min_fraction"]) == 1.0
          and np.isfinite(float(m["mean_fraction"])) and int(m["alive_count"]) == cfg.n_nodes,
          f"{what}: metrics disagree with the converged flag")
    return sim, converged, launches, run_s, torch.cuda.max_memory_allocated() / 1e9


def round_rate(sim, rounds=16, warmup=2):
    """ms a round on the host clock over ``rounds`` untracked rounds
    after ``warmup`` of them."""
    sim.run(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(rounds)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / rounds * 1e3


ZERO_SHARE_EVERY, ZERO_SHARE_ROWS = 20, 4096


def zero_deficit_shares(sim, gen, rows=ZERO_SHARE_ROWS):
    """The share of zero deficits in the state's next sub-exchange, on a
    seeded sample of ``rows`` leader rows and their partners (all alive
    on this run): of the column pairs, of the 8-column chunks a thread
    takes, and of the 256-column spans a warp takes (a chunk or span
    counts where all its deficits are 0, both ways)."""
    n = sim.cfg.n_nodes
    dev = sim.state.w.device
    _, _, p = (t[0][0] for t in prng.round_draws(prng.key(sim.seed).to(dev), sim.tick + 1, 1,
                                                  n, sim.cfg.fanout))
    p = p.long()
    ids = torch.arange(n, device=dev)
    lead = ids[ids < p]
    lead = lead[torch.randperm(lead.numel(), generator=gen, device=dev)[:rows]]
    diff = sim.state.w[lead] != sim.state.w[p[lead]]
    return {span: 1.0 - float(diff.view(diff.shape[0], -1, span).any(-1).float().mean())
            for span in (1, 8, 256)}


def lean_int8_north_star(dev, card_line):
    """Phase 10b: lean_config(100_352, "int8", budget=2618) at seed 1 in
    its form (``RUN_FORMS``): round 209, its launches a sub-exchange; then
    the same run in the other form (``other_form``, from counters at 0),
    stepped 20 rounds at a time with the share of zero deficits counted
    on a sample of row pairs at each step (how much a skip of zero
    deficits could save), to 209; then pinned to m8 (staged m8 pulls and
    the plain flag, as in the reference): round 209 again. Each path's
    pulls are timed at this width on the converged state, the pairs path
    in both forms."""
    cfg = lean_config(NORTH_STAR_N, "int8", budget=2618)
    form, k = expect_form(cfg, dev, "north_star_int8")
    two_pass = form == "pairs_two_pass"
    timed = {}
    sim, conv, launches, run_s, peak = run_to(cfg, dev, NORTH_STAR_SEED, LADDER_NS_ROUND,
                                              "north_star_int8", timed=timed)
    rounds = sim.tick
    check(counters.kernel_launches("pairs_pull") == 3 * rounds
          and counters.kernel_launches("pairs_totals") == (3 * rounds if two_pass else 0)
          and launches.get(form_key(form, k, check=True)) == rounds,
          "the int8 north star did not run its form's launches a sub-exchange")
    round_ms = round_rate(sim)
    w, alive, mv = sim.state.w, sim.state.alive, sim.state.max_version
    k_staged = pairs_pull.cluster_size(NORTH_STAR_N, 1)
    times, form_rounds = lean_form_times(w, alive, mv, cfg.budget, k_staged, "int8", 1)
    times = {key: (NORTH_STAR_N, *t) for key, t in times.items()}
    del sim, w
    torch.cuda.empty_cache()
    # The other form, whole run, with the zero-deficit shares.
    gen = torch.Generator(device=dev).manual_seed(11)
    shares = {}
    with other_form(cfg) as (other, k_other):
        expect_form(cfg, dev, "north_star_int8_other")
        counters.reset()
        sim = Simulator(cfg, seed=NORTH_STAR_SEED, device=dev)
        torch.cuda.synchronize()
        shares[0] = zero_deficit_shares(sim, gen)
        steps_s = 0.0
        while sim.tick + ZERO_SHARE_EVERY <= LADDER_NS_ROUND:
            t1 = time.perf_counter()
            sim.run(ZERO_SHARE_EVERY)
            torch.cuda.synchronize()
            steps_s += time.perf_counter() - t1
            shares[sim.tick] = zero_deficit_shares(sim, gen)
        t1 = time.perf_counter()
        conv2 = sim.run_until_converged(max_rounds=LADDER_NS_ROUND + 20)
        torch.cuda.synchronize()
        steps_s += time.perf_counter() - t1
        other_launches, other_rounds = dict(counters.launches), sim.tick
        check(conv2 == LADDER_NS_ROUND and counters.kernel_launches("pairs_pull") == 3 * sim.tick
              and other_launches.get(form_key(other, k_other, check=True), 0) > 0,
              f"the int8 north star in the other form converged at {conv2} or did not take "
              "its launches")
        other_round_ms = steps_s / sim.tick * 1e3
    del sim
    torch.cuda.empty_cache()
    log("north_star_int8", "zero-deficit shares (column pairs, 8-column chunks, 256-column "
        "spans) by round: " + "; ".join(
            f"{r}: {v[1]:.4f}, {v[8]:.4f}, {v[256]:.4f}" for r, v in shares.items()))
    staged, two = form_rounds["staged"], form_rounds["two_pass"]
    mine, theirs = (two, staged) if two_pass else (staged, two)
    record = dict(n=NORTH_STAR_N, seed=NORTH_STAR_SEED, form=form, cluster=k,
                  converged_round=conv, rounds_run=rounds, run_s=run_s,
                  run_round_ms=timed["round_ms"], round_ms=round_ms,
                  rounds_per_s=1e3 / round_ms, peak_memory_gb=peak,
                  kernel_ms_per_round=mine[0], bound_ms_per_round=mine[1],
                  other=dict(form=other, cluster=k_other, converged_round=conv2,
                             run_round_ms=other_round_ms, kernel_ms_per_round=theirs[0],
                             bound_ms_per_round=theirs[1]),
                  zero_deficit_shares={r: {str(s_): v for s_, v in sh.items()}
                                       for r, sh in shares.items()})
    log("north_star_int8", f"{form}: {1e3 / round_ms:.3f} rounds/s ({round_ms:.3f} ms/round "
        f"over 16 untracked rounds); whole run {timed['round_ms']:.3f} ms a round, in the "
        f"other form ({other} on clusters of {k_other}) {other_round_ms:.3f}; kernels a round "
        f"by CUDA events: staged on clusters of {k_staged} {staged[0]:.3f} ms (bound "
        f"{staged[1]:.3f}), two-pass {two[0]:.3f} (bound {two[1]:.3f}); peak memory "
        f"{peak:.2f} GB; passes at n={NORTH_STAR_N}: "
        + ", ".join(f"{kk} {v[1]:.4f} ms" for kk, v in times.items()) + f"; {card_line}")

    gm, c, _ = prng.grouped_matching(prng.key(9), NORTH_STAR_N)
    gm, c = gm.to(dev, torch.int32), c.to(dev, torch.int32)
    m8_cfg = dataclasses.replace(cfg, pallas_variant="m8")
    check(gossip.pull_phase_engaged(m8_cfg, dev) == "m8", "int8 north star m8 is not staged")
    sim, conv8, launches8, run8_s, peak8 = run_to(m8_cfg, dev, NORTH_STAR_SEED,
                                                  LADDER_NS_ROUND, "north_star_int8_m8")
    check(counters.kernel_launches("m8_pull") == 3 * sim.tick
          and launches8.get("m8_pull[diag]") == sim.tick,
          "the int8 north star m8 did not run 3 m8 pulls a round")
    round8_ms = round_rate(sim)
    w, alive, mv = sim.state.w, sim.state.alive, sim.state.max_version
    for diag in (True, False):
        times[f"{m8_pull.counter_key(diag)} int8"] = (NORTH_STAR_N, cuda_ms(
            lambda: m8_pull.m8_pull(w, None, gm, c, alive, 1, 0x9E3779B9, cfg.budget,
                                    mv=mv if diag else None), 10),
            bound(m8_bytes(NORTH_STAR_N, NORTH_STAR_N, 1, 0, diag=diag, totals=False),
                  OPS_PULL_LEAN * NORTH_STAR_N * NORTH_STAR_N / 2))
    rounds8 = sim.tick
    del sim, w
    torch.cuda.empty_cache()
    record_m8 = dict(n=NORTH_STAR_N, seed=NORTH_STAR_SEED, converged_round=conv8,
                     rounds_run=rounds8, run_s=run8_s, round_ms=round8_ms,
                     rounds_per_s=1e3 / round8_ms, peak_memory_gb=peak8)
    log("north_star_int8_m8", f"{1e3 / round8_ms:.3f} rounds/s ({round8_ms:.3f} ms/round); "
        f"peak memory {peak8:.2f} GB; m8 pulls at n={NORTH_STAR_N}: "
        + ", ".join(f"{k} {v[1]:.4f} ms" for k, v in times.items() if k.startswith("m8"))
        + f"; {card_line}")
    return ((record, launches, rounds), (record_m8, launches8, rounds8), times,
            (other_launches, other_rounds))


def residual_errs(w16, mv, w_u4) -> float:
    """Max abs difference, over blocks of rows, between clip(max_version
    - w, 0, 15) of an int16 state and the residuals of a u4r state."""
    n = w16.shape[0]
    step = max(1, (1 << 26) // n)
    err = 0.0
    for r0 in range(0, n, step):
        want = torch.clamp(mv[None, :] - w16[r0:r0 + step].to(torch.int32), 0, 15)
        got = unpack_u4(w_u4[r0:r0 + step])
        err = max(err, float((want - got).abs().max()))
    return err


def lean_u4r_north_star(dev, card_line):
    """Phase 10c: lean_config(100_352, "u4r", budget=2618) at seed 1 (keys
    15; 5.04 GB, the staged packed pull) and the port's int16 run of
    lean_config(100_352, budget=2618, keys_per_node=15), stepped side by
    side: the u4r residuals equal clip(max_version - w, 0, 15) of the
    int16 run at rounds 1 and 2 and at the converged round, and both
    converge at the same round (the reference's u4r contract). The u4r
    run's pulls are timed at this width in both forms, and the run again
    in the other form (``other_form``, from counters at 0), its wall time
    a round beside the run's."""
    cfg = lean_config(NORTH_STAR_N, "u4r", budget=2618)
    ref_cfg = lean_config(NORTH_STAR_N, budget=2618, keys_per_node=15)
    form, k = expect_form(cfg, dev, "north_star_u4r")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    u4 = Simulator(cfg, seed=NORTH_STAR_SEED, device=dev, chunk=1)
    i16 = Simulator(ref_cfg, seed=NORTH_STAR_SEED, device=dev, chunk=1)
    errs = []
    for r in (1, 2):
        u4.run(1)
        i16.run(1)
        errs.append(residual_errs(i16.state.w, i16.state.max_version, u4.state.w))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    conv_u4 = u4.run_until_converged(max_rounds=400)
    torch.cuda.synchronize()
    u4_run_ms = (time.perf_counter() - t1) / (u4.tick - 2) * 1e3
    u4_launches = {k: v for k, v in counters.launches.items() if "packed" in k}
    u4_rounds = u4.tick
    conv_16 = i16.run_until_converged(max_rounds=400)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check(u4.tick == i16.tick == conv_u4, "the two runs did not stop at the converged round")
    errs.append(residual_errs(i16.state.w, i16.state.max_version, u4.state.w))
    log("north_star_u4r", f"u4r converged at round {conv_u4}, the int16 keys-15 run at "
        f"{conv_16}; residual max_abs_err at rounds 1, 2, {conv_u4}: {errs} ({run_s:.2f} s "
        f"for both); u4r launches {u4_launches}; plain calls {dict(counters.plain_calls)}; "
        f"fallbacks {dict(counters.fallbacks)}")
    check(conv_u4 == conv_16 and conv_u4 is not None, "u4r and int16 keys-15 rounds differ")
    check(max(errs) == 0.0, "the u4r residuals differ from the int16 run's")
    check(not counters.plain_calls and not counters.fallbacks
          and sum(v for kk, v in u4_launches.items() if kk.startswith("pairs_pull"))
          == 3 * u4_rounds and u4_launches.get(form_key(form, k, check=True, packed=True)),
          "the u4r north star did not run 3 packed pulls a round in its form")
    both_peak = torch.cuda.max_memory_allocated() / 1e9
    del i16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    round_ms = round_rate(u4)
    peak = torch.cuda.max_memory_allocated() / 1e9
    w, alive = u4.state.w, u4.state.alive
    k_staged = pairs_pull.cluster_size(NORTH_STAR_N // 2, 1)
    times, form_rounds = lean_form_times(w, alive, torch.ones_like(u4.state.max_version),
                                         cfg.budget, k_staged, "u4r", 0.5)
    times = {key: (NORTH_STAR_N, *t) for key, t in times.items()}
    del u4, w
    torch.cuda.empty_cache()
    timed = {}
    with other_form(cfg) as (other, k_other):
        expect_form(cfg, dev, "north_star_u4r_other")
        sim, _, other_launches, _, _ = run_to(cfg, dev, NORTH_STAR_SEED, conv_u4,
                                              "north_star_u4r_other", chunk=1, timed=timed)
    other_rounds = sim.tick
    del sim
    torch.cuda.empty_cache()
    staged, two = form_rounds["staged"], form_rounds["two_pass"]
    mine, theirs = (two, staged) if form == "pairs_two_pass" else (staged, two)
    record = dict(n=NORTH_STAR_N, seed=NORTH_STAR_SEED, form=form, cluster=k,
                  converged_round=conv_u4,
                  int16_keys15_round=conv_16, residual_max_abs_err=errs,
                  rounds_run=u4_rounds, run_round_ms=u4_run_ms, round_ms=round_ms,
                  rounds_per_s=1e3 / round_ms,
                  kernel_ms_per_round=mine[0], bound_ms_per_round=mine[1],
                  other=dict(form=other, cluster=k_other, run_round_ms=timed["round_ms"],
                             kernel_ms_per_round=theirs[0], bound_ms_per_round=theirs[1]),
                  peak_memory_gb_u4r_alone=peak, peak_memory_gb_with_int16_run=both_peak)
    log("north_star_u4r", f"{form}: {1e3 / round_ms:.3f} rounds/s ({round_ms:.3f} ms/round, "
        f"u4r alone); whole run {u4_run_ms:.3f} ms a round, in the other form ({other} on "
        f"clusters of {k_other}) {timed['round_ms']:.3f}; kernels a round by CUDA events: "
        f"staged on clusters of {k_staged} {staged[0]:.3f} ms (bound {staged[1]:.3f}), "
        f"two-pass {two[0]:.3f} (bound {two[1]:.3f}); peak {peak:.2f} GB alone, "
        f"{both_peak:.2f} GB beside the int16 run; pulls at n={NORTH_STAR_N}: "
        + ", ".join(f"{kk} {v[1]:.4f} ms" for kk, v in times.items()) + f"; {card_line}")
    return record, u4_launches, u4_rounds, times, (other_launches, other_rounds)


def widest_u4r(dev, card_line, errs):
    """Phase 10d: lean_config(262_144, "u4r", budget=2618) at seed 1, 34.4
    GB, in its form (``RUN_FORMS``): ``WIDEST_U4R_ROUNDS`` untracked rounds
    (rounds/s, peak memory), then one round's sub-exchanges held against
    the plain versions on sampled row pairs (``sampled_round_check``),
    then 2 tracked rounds (the packed check). Each
    sub-exchange is timed at this width in both forms, and the round in
    the other form (``other_form``, from counters at 0: one tracked round,
    then 4; its launches are that form's entries' path); the sampled
    round check runs in both forms."""
    cfg = lean_config(WIDEST_U4R_N, "u4r", budget=2618)
    n = cfg.n_nodes
    form, k = expect_form(cfg, dev, "widest_u4r")
    two_pass = form == "pairs_two_pass"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=NORTH_STAR_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim.run(WIDEST_U4R_ROUNDS)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) / WIDEST_U4R_ROUNDS * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = collections.Counter(counters.launches)
    check(counters.kernel_launches("pairs_totals") == (3 * WIDEST_U4R_ROUNDS if two_pass else 0)
          and counters.kernel_launches("pairs_pull") == 3 * WIDEST_U4R_ROUNDS
          and not counters.plain_calls and not counters.fallbacks,
          "the widest u4r run did not take its form's launches a sub-exchange")
    m = sim.metrics()
    frac = float(m["mean_fraction"])
    check(np.isfinite(frac) and 0.0 < frac <= 1.0, "widest u4r metrics are not finite")
    log("widest_u4r", f"lean_config({n}, 'u4r', budget=2618), {form} on clusters of {k}: init "
        f"{init_s:.2f} s, {WIDEST_U4R_ROUNDS} rounds at {round_ms:.3f} ms/round "
        f"({1e3 / round_ms:.3f} rounds/s); peak memory {peak:.2f} GB; mean fraction "
        f"{frac:.6f}; {card_line}")
    t0 = time.perf_counter()
    found = sampled_round_check(dev, sim, errs, "u4r")
    with other_form(cfg):  # the other form's launches at this width too
        found += sampled_round_check(dev, sim, errs, "u4r", seed=9)
    log("widest_u4r", f"one chained round at n={n} in each form, {C2_LEADERS} sampled row "
        "pairs a pull: " + ", ".join(f"{kk} max_abs_err={e}" for kk, e in found)
        + f" ({time.perf_counter() - t0:.1f} s)")
    check(all(e == 0.0 for _, e in found), "the widest u4r round disagrees")
    counters.reset()
    sim.run_until_converged(max_rounds=sim.tick + 2)  # two tracked rounds
    torch.cuda.synchronize()
    launches.update(counters.launches)
    launches = dict(launches)
    check(launches.get(form_key(form, k, check=True, packed=True), 0) == 2,
          "the tracked widest u4r rounds did not carry the packed check")
    k_staged = pairs_pull.cluster_size(n // 2, 1)
    times, form_rounds = lean_form_times(sim.state.w, sim.state.alive,
                                         torch.ones_like(sim.state.max_version), cfg.budget,
                                         k_staged, "u4r", 0.5)
    times = {key: (n, *t) for key, t in times.items()}
    with other_form(cfg) as (other, k_other):
        expect_form(cfg, dev, "widest_u4r_other")
        counters.reset()
        sim.run_until_converged(max_rounds=sim.tick + 1)  # a tracked round: every mode
        other_round_ms = round_rate(sim, 4, 0)
        other_launches = dict(counters.launches)
        check(counters.kernel_launches("pairs_pull") == 3 * 5
              and counters.kernel_launches("pairs_totals")
              == (15 if other == "pairs_two_pass" else 0),
              "the widest u4r rounds in the other form did not take its launches")
    del sim
    torch.cuda.empty_cache()
    staged, two = form_rounds["staged"], form_rounds["two_pass"]
    mine, theirs = (two, staged) if two_pass else (staged, two)
    record = dict(n=n, seed=NORTH_STAR_SEED, form=form, cluster=k, rounds=WIDEST_U4R_ROUNDS,
                  init_s=init_s, round_ms=round_ms, rounds_per_s=1e3 / round_ms,
                  peak_memory_gb=peak, kernel_ms_per_round=mine[0], bound_ms_per_round=mine[1],
                  other=dict(form=other, cluster=k_other, round_ms=other_round_ms,
                             kernel_ms_per_round=theirs[0], bound_ms_per_round=theirs[1]))
    log("widest_u4r", f"rounds {round_ms:.3f} ms (in the other form, {other} on clusters of "
        f"{k_other}, {other_round_ms:.3f} ms over 4 rounds on the later state); kernels a round "
        f"by CUDA events: staged on clusters of {k_staged} {staged[0]:.3f} ms (bound "
        f"{staged[1]:.3f}), two-pass {two[0]:.3f} (bound {two[1]:.3f}); passes at this width: "
        + ", ".join(f"{kk} {v[1]:.4f} ms" for kk, v in times.items()))
    return record, launches, WIDEST_U4R_ROUNDS + 2, times, (other_launches, 5)


def full_pull_times(sim, rung, dev):
    """The full rung's pulls timed at its width on ``sim``'s converged
    state (updated in place), staged (on the rule's cluster for the width)
    and fed the totals (the two-pass form's pull): the first and a middle
    sub-exchange (deep only: the shrunk rung's are int16, the headline's
    instances) and the last, with the FD epilogue and the round-start hb0
    stream."""
    st, cfg, n = sim.state, sim.cfg, sim.cfg.n_nodes
    k = pairs_pull.cluster_size(n, st.w.element_size())
    gm, c, _ = prng.grouped_matching(prng.key(9), n)
    gm, c = gm.to(dev, torch.int32), c.to(dev, torch.int32)
    fd = pairs_pull.FdOperands(sim.tick + 1, st.last_change, st.imean, st.icount,
                               st.live_view, st.hb_known.clone(), FdParams.from_config(cfg))
    times = {}
    for mode in ("first", "middle", "last_fd"):
        mm = LADDER_MODES[mode]
        if rung == "shrunk" and not mm["fd"]:
            continue
        kw = {}
        if mm["diag"]:
            kw.update(mv=st.max_version, hbv=st.heartbeat)
        if mm["check"]:
            kw["check"] = (st.max_version, st.alive, st.alive)
        if mm["fd"]:
            kw.update(hbv=st.heartbeat, fd=fd)
        tot = pairs_totals.pairs_totals(st.w, gm, c, st.alive, mv=kw.get("mv"))
        for totals in (False, True):
            extra = {"totals": tot} if totals else {"cluster": k}
            times[ladder_key(mm, rung, totals, cluster=not totals and k > 1)] = (
                n, cuda_ms(lambda: pairs_pull.pairs_pull(
                    st.w, st.hb_known, gm, c, st.alive, 1, 0x9E3779B9, cfg.budget, **kw,
                    **extra), 10),
                ladder_pull_bound(n, rung, mm, totals))
    return times


def full_ladder(dev, card_line):
    """Phase 10e: full_config(49_152, "deep" and "shrunk", budget=2618) at
    seed 1 in their forms (``RUN_FORMS``), with the fused FD epilogue on int8 sample
    counters and the live bitmap: both converge at round 103, the
    reference's full-profile round at this width (the FD does not feed
    back into w without the lifecycle). Each run's round rate, peak
    memory, and its pulls timed at this width on its converged state."""
    records, all_launches, times = {}, {}, {}
    for rung in ("deep", "shrunk"):
        cfg = full_config(FULL_N, rung, budget=2618)
        what = f"full_{rung}"
        form, k = expect_form(cfg, dev, what)
        check(gossip.fd_phase_engaged(cfg, dev) == "fused", f"full {rung}'s FD is not fused")
        sim, conv, launches, run_s, peak = run_to(cfg, dev, NORTH_STAR_SEED, FULL_ROUND, what)
        rounds = sim.tick
        check(counters.kernel_launches("pairs_pull") == 3 * rounds
              and launches.get(form_key(form, k, check=True, fd=True)) == rounds,
              f"full {rung} did not run 3 pulls a round, the last with the FD")
        # 8 rounds each after one: the deep rung's int8 heartbeats hold
        # ticks below 128.
        round_ms = round_rate(sim, 8, 1)
        with other_form(cfg) as (other, k_other):
            other_round_ms = round_rate(sim, 8, 1)
        fp = int(sim.metrics()["fd_false_positives"])
        rung_times = full_pull_times(sim, rung, dev)
        times.update(rung_times)
        records[rung] = dict(n=FULL_N, seed=NORTH_STAR_SEED, form=form, cluster=k,
                             converged_round=conv,
                             rounds_run=rounds, run_s=run_s, round_ms=round_ms,
                             rounds_per_s=1e3 / round_ms, peak_memory_gb=peak,
                             fd_false_positives=fp,
                             other=dict(form=other, cluster=k_other, round_ms=other_round_ms))
        all_launches[rung] = (launches, rounds)
        log(what, f"{form} on clusters of {k}: {1e3 / round_ms:.3f} rounds/s ({round_ms:.3f} "
            f"ms/round; the other form, {other} on clusters of {k_other}, {other_round_ms:.3f}); "
            "peak memory "
            f"{peak:.2f} GB; FD false positives {fp}; pulls at n={FULL_N}: "
            + ", ".join(f"{k} {v[1]:.4f} ms" for k, v in rung_times.items())
            + f"; {card_line}")
        del sim
        torch.cuda.empty_cache()
    return records, all_launches, times


def headline_deep_parity(dev):
    """Phase 10f: full_config(10_240, "deep", budget=2618) against
    full_config(10_240, "int16", budget=2618, window_ticks=100) at seed
    0: after 24 rounds every field is equal (w, hb and last_change and
    icount widened, imean as stored bf16, live unpacked), and both
    converge at 24."""
    deep = full_config(N, "deep", budget=2618)
    wide = full_config(N, "int16", budget=2618, window_ticks=100)
    a = Simulator(deep, seed=0, device=dev)
    b = Simulator(wide, seed=0, device=dev)
    a.run(CONVERGED_ROUND)
    b.run(CONVERGED_ROUND)
    torch.cuda.synchronize()
    sa, sb = a.state, b.state
    same = {
        f: torch.equal(getattr(sa, f).to(torch.int32), getattr(sb, f).to(torch.int32))
        for f in ("w", "hb_known", "last_change", "icount", "max_version", "heartbeat")
    }
    same["imean"] = torch.equal(sa.imean, sb.imean)
    same["live_view"] = torch.equal(unpack_bits(sa.live_view), sb.live_view)
    log("headline_deep", f"24 rounds of full_config({N}, 'deep') against the int16/window-100 "
        f"profile: fields equal {same}")
    check(all(same.values()), "the deep rung's state differs from the int16 profile's")
    del a, b, sa, sb
    rounds = {}
    for name, cfg in (("deep", deep), ("int16", wide)):
        sim = Simulator(cfg, seed=0, device=dev)
        rounds[name] = sim.run_until_converged(max_rounds=100)
        del sim
    log("headline_deep", f"converged rounds {rounds}")
    check(rounds == {"deep": CONVERGED_ROUND, "int16": CONVERGED_ROUND},
          "the deep and int16 headline-width runs did not both converge at 24")
    return rounds


def int8_side_paths(dev, card_line):
    """Phase 10g: the ladder's kernels off the main runs' paths, at
    N = 10,240. The deep rung with int16 bookkeeping pinned to m8 (staged
    m8 pulls on int8 w and hb, the standalone FD kernel on int8
    heartbeats once a round): round 24. The deep and shrunk rungs at
    fanout 1 (one sub-exchange a round: refresh, check and FD in one
    launch): the int16 profile's round. Then, with no row staged (the
    shared-memory limit set to the static shared memory, as at widths
    beyond 116,096 int8), the two-pass forms: the lean int8 rung through
    the pairs and the m8 totals passes (the staged run's round), and the
    deep and shrunk rungs through the pairs totals pass and the pull's
    totals mode with the fused FD (round 24; fanout 1: as staged).
    Each rung's run staged by one CTA a pair at this width first (lean
    int8 and u4r, deep and shrunk). Returns each run's (launches, rounds)
    by name."""
    runs = {}
    cfg = full_config(N, "deep", budget=2618, icount_dtype="int16", live_bits=False,
                      pallas_variant="m8")
    check(gossip.pull_phase_engaged(cfg, dev) == "m8"
          and gossip.fd_phase_engaged(cfg, dev) == "kernel",
          "the int8 m8 headline does not take the m8 and FD kernels")
    sim, _, launches, _, _ = run_to(cfg, dev, 0, CONVERGED_ROUND, "headline_int8_m8")
    check(launches.get("fd") == sim.tick and counters.kernel_launches("m8_pull") == 3 * sim.tick,
          "the int8 m8 headline did not run 3 m8 pulls and 1 FD kernel a round")
    runs["headline_int8_m8"] = (launches, sim.tick)
    del sim
    # Each rung at this width staged by one CTA a pair: the one-CTA staged
    # modes' path (their full-width runs take other forms).
    for name, c0, want in (
        ("lean_int8_staged", lean_config(N, "int8", budget=2618), None),
        ("lean_u4r_staged", lean_config(N, "u4r", budget=2618), None),
        ("deep_staged", full_config(N, "deep", budget=2618), CONVERGED_ROUND),
        ("shrunk_staged", full_config(N, "shrunk", budget=2618), CONVERGED_ROUND),
    ):
        expect_form(c0, dev, name)
        sim, got, launches, _, _ = run_to(c0, dev, 0, want, name)
        runs[name] = (launches, sim.tick)
        if name == "lean_int8_staged":
            lean, lean_round = c0, got
        del sim
    # Fanout 1: the round's only sub-exchange refreshes, checks and runs
    # the FD, on the int16/window-100 profile's round.
    one = Simulator(full_config(N, "int16", budget=2618, window_ticks=100, fanout=1), seed=0,
                    device=dev)
    one_round = one.run_until_converged(max_rounds=400)
    del one
    for rung in ("deep", "shrunk"):
        c1 = full_config(N, rung, budget=2618, fanout=1)
        sim, _, launches, _, _ = run_to(c1, dev, 0, one_round, f"fanout1_{rung}")
        runs[f"fanout1_{rung}"] = (launches, sim.tick)
        del sim
    with two_pass_forced():
        for name, c2, form, want in (
            ("two_pass_int8", lean, "pairs_two_pass", lean_round),
            ("two_pass_int8_m8", dataclasses.replace(lean, pallas_variant="m8"),
             "m8_two_pass", lean_round),
            ("two_pass_deep", full_config(N, "deep", budget=2618), "pairs_two_pass",
             CONVERGED_ROUND),
            ("two_pass_shrunk", full_config(N, "shrunk", budget=2618), "pairs_two_pass",
             CONVERGED_ROUND),
            ("two_pass_fanout1_deep", full_config(N, "deep", budget=2618, fanout=1),
             "pairs_two_pass", one_round),
            ("two_pass_fanout1_shrunk", full_config(N, "shrunk", budget=2618, fanout=1),
             "pairs_two_pass", one_round),
        ):
            check(gossip.pull_phase_engaged(c2, dev) == form, f"{name}: {form} not engaged")
            sim, _, launches, _, _ = run_to(c2, dev, 0, want, name)
            runs[name] = (launches, sim.tick)
            del sim
    log("int8_side_paths", f"the lean int8 rung at n={N} converges at {lean_round} staged and "
        f"in both two-pass forms; the deep and shrunk rungs at fanout 1 at {one_round}, the "
        f"int16 profile's, staged and two-pass; {card_line}")
    return runs


def ladder_pull_bound(n, rung, m, totals):
    """(bytes, operations) of one ladder pull at width ``n``: w (and hb)
    read and written once, the FD bookkeeping at the rung's sizes."""
    wsize = {"u4r": 0.5, "int8": 1, "deep": 1, "shrunk": 2, "lean16": 2, "full int16": 2}[rung]
    hsize = {"deep": 1, "shrunk": 2, "full int16": 2}.get(rung, 0)
    icsize, livesize = (2, 1) if rung == "full int16" else (1, 1 / 8)
    b = pull_bytes(n, wsize, hsize, diag=m["diag"], check=m["check"], fd=m["fd"],
                   hb0=m["hb0"], icsize=icsize, livesize=livesize, totals=totals)
    ops = (OPS_PAIR if hsize else OPS_PAIR_LEAN) + (2 * OPS_FD if m["fd"] else 0)
    return bound(b, ops * n * n / 2)


def ladder_entries(dev, errs, runs, main_times):
    """The kernel-line entries of the ladder's modes, staged by one CTA a
    pair and two-pass: each timed at N = 10,240 by CUDA events beside its
    plain version and its bound, and (``main_times``, (n, ms)) at its
    path's width, with the launches of its path's run (``runs``: name ->
    (launches, rounds); each must be > 0). The cluster-staged modes are
    ``cluster_entries``'."""
    entries = []

    def entry(name, kernel, line, run, launch_key, ms, plain_ms, b, **extra):
        launches, rounds = runs[run]
        check(launches.get(launch_key, 0) > 0, f"{name} was not launched on {run}")
        main = main_times.get(name)
        msg = f"{name}: {ms:.4f} ms at n={N} (bound {b[0]:.4f} ms by {b[1]}; plain {plain_ms:.3f} ms)"
        if main is not None:
            extra.update(n_main=main[0], ms_main=main[1], bound_ms_main=main[2][0])
            msg += f"; {main[1]:.4f} ms at n={main[0]} (bound {main[2][0]:.4f} ms)"
        log("time", msg + f"; {launches[launch_key]} launches on {run}")
        return dict(
            name=name, route="cuda", source=f"aiocluster_torch/ops/csrc/{kernel}.cu",
            replaces=line, launches=launches[launch_key],
            launches_per_round=launches[launch_key] / rounds, max_abs_err=errs[name],
            ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None,
            path=run, n=N, **extra,
        )

    pull_line = "aiocluster_tpu/ops/pallas_pull.py:490"
    staged_runs = {"int8": "lean_int8_staged", "u4r": "lean_u4r_staged",
                   "deep": "deep_staged", "shrunk": "shrunk_staged"}
    two_pass_runs = {"int8": "two_pass_int8", "u4r": "north_star_u4r",
                     "deep": "two_pass_deep", "shrunk": "two_pass_shrunk"}
    seed = 300
    for rung, operands, modes in LADDER_CHECKS:
        for mode in modes:
            m = LADDER_MODES[mode]
            for totals in (False, True):
                seed += 1
                fresh = ladder_case(N, seed, dev, **operands, **m)

                def prepared(plain=False):
                    ops = fresh()
                    if totals:
                        fn = pairs_totals.pairs_totals_plain if plain else pairs_totals.pairs_totals
                        ops["totals"] = fn(ops["w"], ops["gm"], ops["c"], ops["valid"],
                                           mv=ops.get("mv"))
                    return ops

                ops = prepared()
                ms = cuda_ms(lambda: call_pull(pairs_pull.pairs_pull, ops), 20)
                ops = prepared(plain=True)
                plain_ms = cuda_ms(lambda: call_pull(pairs_pull.pairs_pull_plain, ops), 3, 1)
                del ops
                name = ladder_key(m, rung, totals)
                key = pairs_pull.counter_key(m["diag"], m["check"], m["fd"], totals,
                                             rung == "u4r")
                run = (two_pass_runs if totals else staged_runs)[rung]
                if mode == "only_fd":  # the only sub-exchange of a fanout-1 round
                    run = f"{'two_pass_' if totals else ''}fanout1_{rung}"
                entries.append(entry(name, "pairs_pull", pull_line, run, key, ms, plain_ms,
                                     ladder_pull_bound(N, rung, m, totals)))
    for rung, wdt in (("int8", torch.int8), ("u4r", "u4")):
        for diag in (True, False):
            ops = ladder_case(N, 320 + diag, dev, wdt=wdt, diag=diag, check=False, fd=False,
                              hb0=False)()
            args = (ops["w"], ops["gm"], ops["c"], ops["valid"])
            mv = ops.get("mv")
            ms = cuda_ms(lambda: pairs_totals.pairs_totals(*args, mv=mv), 20)
            plain_ms = cuda_ms(lambda: pairs_totals.pairs_totals_plain(*args, mv=mv), 3, 1)
            key = pairs_totals.counter_key(diag, rung == "u4r")
            entries.append(entry(
                f"{key} {rung}", "pairs_totals", "aiocluster_tpu/ops/pallas_pull.py:899",
                two_pass_runs[rung], key, ms, plain_ms,
                bound(totals_bytes(N, 0.5 if rung == "u4r" else 1, diag=diag),
                      OPS_TOTALS * N * N / 2),
            ))
    m8_line = "aiocluster_tpu/ops/pallas_pull.py:263"
    for hdt, given, diag in ((h, g, d) for h in (None, torch.int8) for g in (False, True)
                             for d in (True, False)):
        if hdt is not None and given:
            continue  # the two-pass m8 form runs the lean profile here
        ops = ladder_case(N, 330 + diag + 2 * given, dev, wdt=torch.int8, hdt=hdt, diag=diag,
                          check=False, fd=False, hb0=False)()
        targs = (ops["w"], ops["gm"], ops["c"], ops["valid"])
        tot = m8_totals.m8_totals(*targs, mv=ops.get("mv")) if given else None
        ms = cuda_ms(lambda: call_m8(m8_pull.m8_pull, ops, totals=tot), 20)
        plain_ms = cuda_ms(lambda: call_m8(m8_pull.m8_pull_plain, ops, totals=tot), 3, 1)
        key = m8_pull.counter_key(diag, given)
        name = f"{key} int8{'' if hdt is None else '+hb'}"
        run = ("two_pass_int8_m8" if given else "north_star_int8_m8") if hdt is None else (
            "headline_int8_m8")
        hsize = 0 if hdt is None else 1
        entries.append(entry(
            name, "m8_pull", m8_line, run, key, ms, plain_ms,
            bound(m8_bytes(N, N, 1, hsize, diag=diag, totals=given),
                  (OPS_PULL if hsize else OPS_PULL_LEAN) * N * N / 2),
            design_bound_ms=bound(m8_bytes(N, N, 1, hsize, diag=diag, totals=given, reads=2),
                                  OPS_PULL_LEAN * N * N / 2)[0],
        ))
        if given:
            tkey = m8_totals.counter_key(diag)
            t_ms = cuda_ms(lambda: m8_totals.m8_totals(*targs, mv=ops.get("mv")), 20)
            t_plain = cuda_ms(lambda: m8_totals.m8_totals_plain(*targs, mv=ops.get("mv")), 3, 1)
            entries.append(entry(
                f"{tkey} int8", "m8_totals", "aiocluster_tpu/ops/pallas_pull.py:374",
                "two_pass_int8_m8", tkey, t_ms, t_plain,
                bound(m8_totals_bytes(N, N, 1, diag=diag), OPS_TOTALS * N * N / 2),
            ))
        del ops, tot
    ops = ladder_case(N, 340, dev, wdt=torch.int8, hdt=torch.int8, diag=False, check=False,
                      fd=True, hb0=True)()
    f = ops["fd"]
    live = torch.zeros((N, N), dtype=torch.bool, device=dev)
    ic16 = f.ic.to(torch.int16)
    args = (ops["hb"], f.hb0, ops["hbv"], f.lc, f.im, ic16, live, f.params)
    ms = cuda_ms(lambda: fd_mod.fused_fd(40, *args), 20)
    plain_ms = cuda_ms(lambda: fd_mod.fused_fd_plain(40, *args), 3, 1)
    mat = N * N
    entries.append(entry(
        "fd int8", "fd", "aiocluster_tpu/ops/pallas_fd.py:51", "headline_int8_m8", "fd", ms,
        plain_ms, bound(mat * (3 * 1 + 2 * 2 + 1 * 1 + 2 * 2 + 1) + N * 4, OPS_FD * mat),
    ))
    del ops, f, live, ic16, args
    torch.cuda.empty_cache()
    return entries


# -- sweeps: the lane lift of the pairs kernels (phase 11) ---------------------

# sweep_bench.measure's scenario ladder at the headline width: 8 lanes,
# seeds 0-7, phi_threshold 7.0 + 0.25 i.
SWEEP_SEEDS = list(range(8))
SWEEP_PHIS = [7.0 + 0.25 * i for i in range(8)]
FANOUT_SWEEP = dict(fanout=[0, 1, 2, 3], writes_per_round=[0, 1, 2, 1])
FANOUT_SWEEP_ROUNDS = 16
NS_PAIR_SEEDS = [1, 2]
NS_PAIR_CHECK_ROUND = 20  # the north-star pair's w held against seed 2's here
NS_PAIR_LEADERS = 2048  # row pairs of each lane in its sampled round check
LANE_S = 3  # lanes of the side sweeps and of the timed lane entries
LANE_CHECK_S = len(SWEEP_SEEDS)  # lanes of the kernel checks: the phi ladder's
SIDE_SWEEP_ROUNDS = 6
# The lane modes' operands per rung (ladder_case), and the modes held.
LANE_RUNGS = {
    "int16": dict(wdt=torch.int16, hdt=torch.int16),
    "lean16": dict(wdt=torch.int16),
    "int8": dict(wdt=torch.int8),
    "u4r": dict(wdt="u4"),
    "shrunk": FD_RUNGS["shrunk"],
}
LANE_CHECKS = (
    ("int16", ("first", "middle", "last_fd", "only_fd")),
    ("lean16", ("first", "middle", "last")),
    ("int8", ("first", "middle", "last")),
    ("u4r", ("first", "middle", "last")),
    ("shrunk", ("last_fd",)),
)
# Bytes a pair of each rung's matrices: (w, hb, imean, icount, live).
LANE_SIZES = {
    "int16": (2, 2, 2, 2, 1), "lean16": (2, 0, 2, 2, 1), "int8": (1, 0, 2, 2, 1),
    "u4r": (0.5, 0, 2, 2, 1), "shrunk": (2, 2, 2, 1, 1 / 8),
}


def lane_case(n, lanes, seed, dev, *, void=True, **kw):
    """``ladder_case`` operands of ``lanes`` lanes (seeds ``seed ..``)
    stacked on a leading lane axis, each lane with its own salt, run salt
    and FD phi (7.0 + 0.5 s). With ``void``, lane 1's alive-pair mask is
    all 0 (a swept fanout below the bound voids the sub-exchange: the
    refresh, check and FD still run); the timed cases leave it out, so
    that every lane does the work its bound counts. Returns a factory of
    fresh copies: ``fresh()`` of every lane, ``fresh(s)`` of lane ``s``
    alone as one sub-exchange's operands (``call_pull``)."""
    cases = [ladder_case(n, seed + s, dev, **kw)() for s in range(lanes)]
    c0 = cases[0]

    def stack(get):
        return torch.stack([get(x) for x in cases])

    base = dict(
        w=stack(lambda x: x["w"]), hb=None if c0["hb"] is None else stack(lambda x: x["hb"]),
        gm=stack(lambda x: x["gm"]), c=stack(lambda x: x["c"]),
        valid=stack(lambda x: x["valid"]), budget=c0["budget"],
        salt_mix=prng.salt_mix(
            torch.tensor([x["salt"] for x in cases], device=dev),
            torch.tensor([x["run_salt"] + 977 * s for s, x in enumerate(cases)], device=dev),
        ),
    )
    if void and lanes > 1:
        base["valid"][1] = False
    for k in ("mv", "hbv"):
        if k in c0:
            base[k] = stack(lambda x, k=k: x[k])
    if "check" in c0:
        base["check"] = tuple(stack(lambda x, i=i: x["check"][i]) for i in range(3))
    fd = None
    if "fd" in c0:
        fd = pairs_pull.FdOperands(
            40, stack(lambda x: x["fd"].lc), stack(lambda x: x["fd"].im),
            stack(lambda x: x["fd"].ic), stack(lambda x: x["fd"].live),
            None if c0["fd"].hb0 is None else stack(lambda x: x["fd"].hb0), c0["fd"].params,
            phi=torch.tensor([7.0 + 0.5 * s for s in range(lanes)], device=dev),
        )
    if fd is not None:
        base["fd"] = fd
    del cases, c0

    def fresh(s=None):
        ops = base if s is None else lane_of(base, s)
        ops = dict(ops, w=ops["w"].clone(), hb=None if ops["hb"] is None else ops["hb"].clone())
        if fd is not None:
            f = ops["fd"]
            ops["fd"] = dataclasses.replace(f, lc=f.lc.clone(), im=f.im.clone(),
                                            ic=f.ic.clone(), live=f.live.clone())
        return ops

    return fresh


def call_lanes(fn, ops):
    return fn(
        ops["w"], ops["hb"], ops["gm"], ops["c"], ops["valid"], ops["salt_mix"], ops["budget"],
        mv=ops.get("mv"), hbv=ops.get("hbv"), check=ops.get("check"), fd=ops.get("fd"),
        totals=ops.get("totals"),
    )


def lane_of(ops, s):
    """Lane ``s`` of lane operands as one sub-exchange's (``call_pull``)."""
    out = {k: None if v is None else v[s] for k, v in ops.items()
           if k in ("w", "hb", "gm", "c", "valid", "mv", "hbv", "totals")}
    out.update(salt=int(ops["salt_mix"][s]) & prng.M32, run_salt=0, budget=ops["budget"])
    if "check" in ops:
        out["check"] = tuple(x[s] for x in ops["check"])
    if "fd" in ops:
        out["fd"] = ops["fd"].lane(s)
    return out


def lane_key(m, rung, totals=False, cluster=False) -> str:
    key = pairs_pull.counter_key(m["diag"], m["check"], m["fd"], totals, rung == "u4r",
                                 lanes=True, cluster=cluster)
    return f"{key} {rung}"


def lane_totals_key(diag, rung) -> str:
    return f"{pairs_totals.counter_key(diag, rung == 'u4r', lanes=True)} {rung}"


def check_lane_kernels(dev):
    """Phase 11a: the lane launches of S = 8 lanes (the phi ladder's)
    against their plain versions at N = 10,240, in every mode a sweep
    runs: int16 with hb (staged first, middle, check+FD, and the fanout-1
    round's only launch), lean int16, lean int8 and packed u4r (first,
    middle, check), and the FD epilogue on the shrunk bookkeeping; each
    staged and totals-fed (the totals lane launch against its plain
    version, the two-pass pull also against the staged lane launch). Lane
    s of every staged launch is also held against the single-lane kernel
    on lane s's operands. Returns each entry's max_abs_err."""
    errs: dict[str, float] = collections.defaultdict(float)
    seed = 400
    for rung, modes in LANE_CHECKS:
        for name in modes:
            m = LADDER_MODES[name]
            seed += 10
            fresh = lane_case(N, LANE_CHECK_S, seed, dev, **LANE_RUNGS[rung], **m)
            kern, plain = fresh(), fresh()
            fk = call_lanes(pairs_pull.pairs_pull_lanes, kern)
            fp = call_lanes(pairs_pull.pairs_pull_lanes_plain, plain)
            err = max_abs_err(outputs(kern, fk), outputs(plain, fp))
            del plain
            lane_err = 0.0
            got = outputs(kern, None)
            for s in range(LANE_CHECK_S):
                ops_s = fresh(s)
                f_s = call_pull(pairs_pull.pairs_pull, ops_s)
                want = [x[s] for x in got] + ([] if fk is None else [fk[s : s + 1]])
                lane_err = max(lane_err, max_abs_err(outputs(ops_s, f_s), want))
                del ops_s
            two, two_plain = fresh(), fresh()
            args = (two["w"], two["gm"], two["c"], two["valid"])
            two["totals"] = pairs_totals.pairs_totals_lanes(*args, mv=two.get("mv"))
            two_plain["totals"] = pairs_totals.pairs_totals_lanes_plain(*args, mv=two.get("mv"))
            t_err = max_abs_err([two["totals"]], [two_plain["totals"]])
            ft = call_lanes(pairs_pull.pairs_pull_lanes, two)
            fpt = call_lanes(pairs_pull.pairs_pull_lanes_plain, two_plain)
            torch.cuda.synchronize()
            p_err = max(max_abs_err(outputs(two, ft), outputs(two_plain, fpt)),
                        max_abs_err(outputs(two, ft), outputs(kern, fk)))
            key, t_key = lane_key(m, rung), lane_key(m, rung, totals=True)
            tot_key = lane_totals_key(m["diag"], rung)
            errs[key] = max(errs[key], err, lane_err)
            errs[t_key] = max(errs[t_key], p_err)
            errs[tot_key] = max(errs[tot_key], t_err)
            flags = "" if fk is None else f" flags={fk.tolist()}"
            log("lanes", f"n={N} S={LANE_CHECK_S} {rung} {name}: {key} max_abs_err={err} "
                f"(each lane against the single-lane kernel: {lane_err}); {tot_key} {t_err}; "
                f"{t_key} {p_err} (against the plain version and the staged launch){flags}")
            check(err == 0.0 and lane_err == 0.0 and t_err == 0.0 and p_err == 0.0,
                  f"lane launches of {rung} {name} disagree")
            del kern, two, two_plain, fresh
    torch.cuda.empty_cache()
    return errs


def lanes_equal_sequential(sweep, cfg, dev, per_lane, what):
    """Each lane of ``sweep`` equals a sequential ``Simulator`` run with
    the lane's seed and values (``per_lane``: field -> list) stepped to
    the sweep's tick, field for field."""
    for s, seed in enumerate(sweep.seeds):
        lane_cfg = dataclasses.replace(cfg, **{k: v[s] for k, v in per_lane.items()})
        seq = Simulator(lane_cfg, seed=seed, device=dev)
        seq.run(sweep.tick)
        torch.cuda.synchronize()
        check(states_equal(lane(sweep.states, s), seq.state),
              f"{what}: lane {s} differs from its sequential run")
        del seq


def side_sweeps(dev, card_line):
    """Phase 11e: short sweeps of S = 3 lanes at N = 10,240 through every
    lane mode that the main sweeps do not reach: lean int16, int8 and
    u4r, the shrunk FD bookkeeping, fanout 1 (the round's only launch
    refreshes, checks and runs the FD), and with no row staged (the
    shared-memory limit set to the static shared memory, as beyond
    57,984 int16) every two-pass form. Each lane equals its sequential
    run. Returns each run's (launches, rounds) by name."""
    runs = {}
    head = headline_config()
    phis = dict(phi_threshold=[7.0, 8.0, 9.0])
    table = (
        ("sweep_lean16", lean_config(N, budget=2618), dict(writes_per_round=[0, 1, 0])),
        ("sweep_int8", lean_config(N, "int8", budget=2618), {}),
        ("sweep_u4r", lean_config(N, "u4r", budget=2618), {}),
        ("sweep_shrunk", full_config(N, "shrunk", budget=2618), phis),
        ("sweep_fanout1", dataclasses.replace(head, fanout=1), phis),
    )
    saved = pairs_pull.SMEM_LIMIT
    for two_pass in (False, True):
        rows = table
        if two_pass:
            rows += (("sweep_headline", head, dict(fanout=[3, 2, 1], **phis)),)
        pairs_pull.SMEM_LIMIT = pairs_pull.STATIC_SMEM if two_pass else saved
        try:
            for name, cfg, per_lane in rows:
                name += "_two_pass" if two_pass else ""
                form = gossip.resolve_phases(cfg, dev, sweep=True).pull
                check(form == ("pairs_two_pass" if two_pass else "pairs"),
                      f"{name}: the lane kernels are not engaged ({form})")
                counters.reset()
                sweep = SweepSimulator(cfg, [0, 1, 2], device=dev, **per_lane)
                sweep.run_until_converged(max_rounds=SIDE_SWEEP_ROUNDS)  # tracked: the check
                torch.cuda.synchronize()
                launches = dict(counters.launches)
                check(not counters.plain_calls and not counters.fallbacks
                      and all("[lanes+" in k for k in launches)
                      and counters.kernel_launches("pairs_pull") == cfg.fanout * sweep.tick,
                      f"{name}: not one lane launch a sub-exchange ({launches})")
                lanes_equal_sequential(sweep, cfg, dev, per_lane, name)
                runs[name] = (launches, sweep.tick)
                log("side_sweeps", f"{name}: {sweep.tick} tracked rounds of 3 lanes, each lane "
                    f"equal to its sequential run; launches {launches}")
                del sweep
        finally:
            pairs_pull.SMEM_LIMIT = saved
    torch.cuda.empty_cache()
    log("side_sweeps", f"every lane mode ran on a sweep's path; {card_line}")
    return runs


def headline_sweep(dev, card_line):
    """Phase 11b: the reference's sweep_bench scenario at the headline
    width: 8 lanes (seeds 0-7, phi 7.0 + 0.25 i) to convergence through
    the lane launches (one a sub-exchange for all lanes, no plain call).
    Each lane converges where its sequential run does (lane 0 at 24) and
    its final state equals that run's stepped to the sweep's tick. Then
    the wall to convergence against 8 sequential runs (the reference's
    amortization_ratio), the untracked lane-rounds/s against the
    sequential rounds/s (both timed as phase 7 times the headline), a
    trace of 8 rounds, and the peak memory."""
    cfg = headline_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    sweep = SweepSimulator(cfg, SWEEP_SEEDS, phi_threshold=SWEEP_PHIS, device=dev)
    rounds = sweep.run_until_converged(max_rounds=200)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    ticks = sweep.tick
    launches = dict(counters.launches)
    check(not counters.plain_calls and not counters.fallbacks and not counters.refusals
          and all(k.startswith("pairs_pull[lanes+") for k in launches)
          and counters.kernel_launches("pairs_pull") == 3 * sweep.tick,
          f"the headline sweep did not take one lane launch a sub-exchange ({launches})")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    seq_rounds = []
    for seed, phi in zip(SWEEP_SEEDS, SWEEP_PHIS):
        seq = Simulator(dataclasses.replace(cfg, phi_threshold=phi), seed=seed, device=dev)
        seq_rounds.append(seq.run_until_converged(max_rounds=200))
        del seq
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    log("sweep", f"headline phi ladder, 8 lanes: converged at {rounds} (sequential runs: "
        f"{seq_rounds}) after {sweep.tick} rounds; {sweep_s:.3f} s to convergence with "
        f"init against {seq_s:.3f} s for the 8 sequential runs (amortization "
        f"{seq_s / sweep_s:.3f}); launches {launches}; peak {peak_gb:.2f} GB")
    check(rounds == seq_rounds, "a sweep lane converged at another round than its sequential run")
    check(rounds[0] == CONVERGED_ROUND, f"lane 0 converged at {rounds[0]}, expected 24")
    lanes_equal_sequential(sweep, cfg, dev, dict(phi_threshold=SWEEP_PHIS), "headline sweep")
    res = sweep.result()
    check(res.summary()["lanes_converged"] == 8 and all(
        r["min_fraction"] == 1.0 and r["version_spread"] == 0 for r in res.rows()),
        "the sweep's result table disagrees with its converged rounds")
    # The steady rates, each timed as phase 7 times the headline (chunks
    # of 16, 8 rounds of warm-up, 48 untracked rounds), in the order
    # sequential, sweep, sweep, sequential.
    rate_seq = Simulator(cfg, seed=0, device=dev, chunk=16)
    rate_sweep = SweepSimulator(cfg, SWEEP_SEEDS, phi_threshold=SWEEP_PHIS, device=dev,
                                chunk=16)
    seq_a, sweep_a, sweep_b, seq_b = (
        round_rate(x, 48, warmup=8) for x in (rate_seq, rate_sweep, rate_sweep, rate_seq))
    del rate_seq, rate_sweep
    sweep_ms, seq_ms = (sweep_a + sweep_b) / 2, (seq_a + seq_b) / 2
    lane_rounds_per_s = len(SWEEP_SEEDS) * 1e3 / sweep_ms
    log("sweep", f"untracked, chunks of 16: {sweep_ms:.3f} ms a sweep round ({sweep_a:.3f}, "
        f"{sweep_b:.3f}) = {lane_rounds_per_s:.2f} lane-rounds/s against {1e3 / seq_ms:.2f} "
        f"rounds/s sequential ({seq_ms:.3f} ms a round: {seq_a:.3f}, {seq_b:.3f}): "
        f"{lane_rounds_per_s * seq_ms / 1e3:.3f}x; {card_line}")
    prof_rounds = 8
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        with torch.profiler.record_function("chip_smoke.sweep"):
            sweep.run(prof_rounds)
            torch.cuda.synchronize()
    SWEEP_TRACE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(SWEEP_TRACE))
    tb = trace_breakdown(SWEEP_TRACE, "chip_smoke.sweep",
                         ("aiocluster_torch.draws", "aiocluster_torch.sweep_step"))
    busy = tb["device_busy_ms"] / tb["window_ms"] if tb["device_events"] else None
    host = {k: v / prof_rounds for k, v in tb["host_ms"].items()}
    if busy is not None:
        log("sweep", f"trace of {prof_rounds} rounds: {tb['window_ms'] / prof_rounds:.3f} ms a "
            f"round under the profiler, device busy {busy:.1%} "
            f"({tb['device_busy_ms'] / prof_rounds:.3f} ms a round); host per round: draws "
            f"{host['aiocluster_torch.draws']:.3f} ms, sweep_step "
            f"{host['aiocluster_torch.sweep_step']:.3f} ms")
    del sweep
    torch.cuda.empty_cache()
    return {
        "lanes": len(SWEEP_SEEDS), "seeds": SWEEP_SEEDS, "phi_threshold": SWEEP_PHIS,
        "rounds_to_convergence": rounds, "rounds_run": ticks,
        "sweep_wall_seconds": sweep_s, "sequential_wall_seconds": seq_s,
        "amortization_ratio": seq_s / sweep_s, "round_ms": sweep_ms,
        "sim_sweep_lane_rounds_per_sec": lane_rounds_per_s,
        "sequential_rounds_per_s": 1e3 / seq_ms, "sequential_round_ms": seq_ms,
        "round_ms_each": [sweep_a, sweep_b], "sequential_round_ms_each": [seq_a, seq_b],
        "peak_memory_gb": peak_gb,
        "device_busy_share": busy, "host_ms_per_round": host,
    }, launches


def fanout_sweep(dev, card_line):
    """Phase 11c: fanout and write-rate lanes at the headline width
    (fanout 0, 1, 2, 3; writes 0, 1, 2, 1), 16 rounds: the lane launches
    void each lane's sub-exchanges past its fanout, and every lane equals
    its sequential run (the fanout-0 lane's through C1: the plain pull
    and the standalone FD kernel)."""
    cfg = headline_config()
    counters.reset()
    sweep = SweepSimulator(cfg, [0, 1, 2, 3], device=dev, **FANOUT_SWEEP)
    sweep.run(FANOUT_SWEEP_ROUNDS)
    torch.cuda.synchronize()
    launches = dict(counters.launches)
    check(not counters.plain_calls and not counters.fallbacks
          and counters.kernel_launches("pairs_pull") == 3 * FANOUT_SWEEP_ROUNDS
          and all(k.startswith("pairs_pull[lanes+") for k in launches),
          f"the fanout sweep did not take one lane launch a sub-exchange ({launches})")
    counters.reset()
    lanes_equal_sequential(sweep, cfg, dev, FANOUT_SWEEP, "fanout sweep")
    check(counters.fallbacks.get("fanout") == FANOUT_SWEEP_ROUNDS
          and counters.launches.get("fd") == FANOUT_SWEEP_ROUNDS,
          "the fanout-0 sequential run did not take the plain pull and the FD kernel")
    log("sweep", f"fanout {FANOUT_SWEEP['fanout']} writes {FANOUT_SWEEP['writes_per_round']}, "
        f"{FANOUT_SWEEP_ROUNDS} rounds: every lane equals its sequential run (fanout 0 through "
        f"C1: fallbacks {dict(counters.fallbacks)}, fd launches {counters.launches['fd']}); "
        f"sweep launches {launches}; {card_line}")
    del sweep
    torch.cuda.empty_cache()
    return launches


def rows_equal(a, b) -> bool:
    """Two (n, n) matrices equal, compared over blocks of rows (no
    transient the size of a north-star matrix)."""
    step = max(1, (1 << 26) // a.shape[-1])
    return all(torch.equal(a[r0 : r0 + step], b[r0 : r0 + step])
               for r0 in range(0, a.shape[0], step))


def sampled_lane_round_check(dev, sweep, rung, errs, leaders=NS_PAIR_LEADERS, seed=9):
    """``sampled_round_check`` for a sweep's lane launches: one round's
    sub-exchanges of every lane in the sweep's form, chained as
    ``sweep_step`` chains them (the lanes' own draws and salts), then a
    fourth whose check every row passes. In the two-pass form each totals
    lane launch is held against ``pairs_totals_lanes_plain`` over every
    row of every lane; each pull lane launch runs on the lanes' state
    itself and is held lane by lane over a seeded sample of ``leaders``
    row pairs of that lane (``pairs_pull_plain(leaders=)`` on the rows
    put back). A seeded tenth of each lane's nodes is dead and half its
    owners wrote a key. Raises each mode's max_abs_err in ``errs`` under
    its lane key; returns the round's (key, max_abs_err) pairs."""
    st, cfg = sweep.states, sweep.cfg
    form, k = gossip.kernel_pull_form(cfg)
    two_pass = form == "pairs_two_pass"
    n, lanes = cfg.n_nodes, sweep.lanes
    gen = torch.Generator(device=dev).manual_seed(seed)
    alive = torch.rand(lanes, n, generator=gen, device=dev) < 0.9
    wrote = torch.rand(lanes, n, generator=gen, device=dev) < 0.5
    mv = st.max_version + wrote.to(torch.int32)
    hb = st.hb_known if cfg.track_heartbeats else None
    heartbeat = None if hb is None else st.heartbeat + alive.to(torch.int32)
    tick = sweep.tick + 1
    keys = prng.keys(sweep.seeds)
    gm_all, c_all, p_all = (t[0] for t in prng.round_draws(keys.to(dev), tick, 1, n, cfg.fanout))
    salts = gossip.lane_salt_table(
        tick, 1, cfg.fanout, torch.full((lanes,), cfg.fanout, dtype=torch.int64, device=dev),
        prng.run_salts(keys).to(dev),
    )[0]
    steps = [("first", 0)] + [("middle", c) for c in range(1, cfg.fanout - 1)]
    steps += [("last", cfg.fanout - 1), ("need 0", cfg.fanout - 1)]
    ids = torch.arange(n, device=dev)
    found = []
    for name, c in steps:
        mode = LADDER_MODES["last" if name == "need 0" else name]
        p = p_all[c].long()
        valid = alive & torch.gather(alive, 1, p)
        kw = {}
        if mode["diag"]:
            kw["mv"] = mv
            if hb is not None:
                kw["hbv"] = heartbeat
        if mode["check"]:
            kw["check"] = (torch.zeros_like(mv) if name == "need 0" else mv, alive, alive)
        tk = tp = None
        if two_pass:
            tk = pairs_totals.pairs_totals_lanes(st.w, gm_all[c], c_all[c], valid,
                                                 mv=kw.get("mv"))
            tp = pairs_totals.pairs_totals_lanes_plain(st.w, gm_all[c], c_all[c], valid,
                                                       mv=kw.get("mv"))
            t_key = lane_totals_key(mode["diag"], rung)
            t_err = max_abs_err([tk], [tp])
            errs[t_key] = max(errs[t_key], t_err)
            found.append((f"{t_key} ({name})", t_err))
        mats = [st.w] + ([] if hb is None else [hb])
        rows, leads, pre = [], [], []
        for s in range(lanes):
            lead = ids[ids <= p[s]]
            lead = lead[torch.randperm(lead.numel(), generator=gen, device=dev)[:leaders]]
            partners = p[s][lead]
            leads.append(lead)
            rows.append(torch.cat((lead, partners[partners != lead])))
            pre.append([m[s][rows[s]] for m in mats])
        fk = pairs_pull.pairs_pull_lanes(st.w, hb, gm_all[c], c_all[c], valid, salts[c],
                                         cfg.budget, totals=tk, **kw)
        torch.cuda.synchronize()
        key = lane_key(mode, rung, totals=two_pass, cluster=not two_pass and k > 1)
        err, flags = 0.0, []
        for s in range(lanes):
            post = [m[s][rows[s]] for m in mats]
            for m, x in zip(mats, pre[s]):
                m[s][rows[s]] = x

            def at(t, s=s):
                return None if t is None else t[s]

            fp = pairs_pull.pairs_pull_plain(
                st.w[s], at(hb), gm_all[c][s], c_all[c][s], valid[s], int(salts[c][s]), 0,
                cfg.budget, totals=at(tp), leaders=leads[s], mv=at(kw.get("mv")),
                hbv=at(kw.get("hbv")),
                check=None if "check" not in kw else tuple(t[s] for t in kw["check"]),
            )
            torch.cuda.synchronize()
            err = max(err, max_abs_err([m[s][rows[s]] for m in mats], post))
            if fp is not None:
                flags.append(int(fp[0]))
        errs[key] = max(errs[key], err)
        found.append((f"{key} ({name})" + ("" if fk is None else
                      f" flags {fk.tolist()} (samples {flags})"), err))
        if name == "need 0":
            check(fk.tolist() == [1] * lanes, "the check flag of a passing sub-exchange is 0")
        del pre
    torch.cuda.empty_cache()
    return found


def north_star_pair(dev, card_line, errs):
    """Phase 11d: the north star's lean_config(100_352, budget=2618) as
    a 2-lane sweep (seeds 1 and 2, 40.3 GB) in its form (``RUN_FORMS``:
    one lane launch a sub-exchange, each lane's row pairs staged by
    clusters of CTAs). At round 20 lane 1's w
    equals a sequential seed-2 run's (both held: about 60 GB); that run
    goes on to convergence, then the sweep: lane 0 at 209, lane 1 at
    the sequential run's round. Then ms a round, the lane launches' times
    at this width on the converged lanes beside their bounds, and the
    peak memory, and the round and the lane launches in the two-pass
    form (forced). Last, a new pair at round 20 holds one chained round
    of lane launches against the plain versions
    (``sampled_lane_round_check``, raising ``errs``): the only lane
    launches whose lane offsets pass 2**31 elements."""
    cfg = lean_config(NORTH_STAR_N, budget=2618)
    n = cfg.n_nodes
    form, k = expect_form(cfg, dev, "north_star_pair")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    sweep = SweepSimulator(cfg, NS_PAIR_SEEDS, device=dev)
    sweep.run(NS_PAIR_CHECK_ROUND)
    seq = Simulator(cfg, seed=NS_PAIR_SEEDS[1], device=dev)
    seq.run(NS_PAIR_CHECK_ROUND)
    torch.cuda.synchronize()
    check(rows_equal(sweep.states.w[1], seq.state.w),
          f"north-star lane 1's w differs from the sequential run at round {NS_PAIR_CHECK_ROUND}")
    both_gb = torch.cuda.max_memory_allocated() / 1e9
    seq_round = seq.run_until_converged(max_rounds=400)
    del seq
    torch.cuda.empty_cache()
    counters.reset()
    t1 = time.perf_counter()
    rounds = sweep.run_until_converged(max_rounds=400)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = dict(counters.launches)
    total_s = time.perf_counter() - t0
    log("sweep", f"north-star pair, seeds {NS_PAIR_SEEDS}: lane 1's w equals the sequential "
        f"seed-2 run at round {NS_PAIR_CHECK_ROUND} ({both_gb:.2f} GB held); converged at "
        f"{rounds} (sequential seed 2: {seq_round}) after {sweep.tick} rounds; {run_s:.2f} s "
        f"from round {NS_PAIR_CHECK_ROUND} ({total_s:.2f} s in all with the sequential run); "
        f"launches {launches}")
    check(rounds == [NORTH_STAR_ROUND, seq_round],
          f"the north-star pair converged at {rounds}, expected [209, {seq_round}]")
    ticks = sweep.tick
    subs = 3 * (ticks - NS_PAIR_CHECK_ROUND)
    check(not counters.plain_calls and not counters.fallbacks
          and counters.kernel_launches("pairs_pull") == subs
          and counters.kernel_launches("pairs_totals") == 0
          and all("[lanes+" in kk for kk in launches),
          "the north-star pair did not take one lane launch a sub-exchange")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    round_ms = round_rate(sweep, 8)
    with two_pass_forced():
        counters.reset()
        two_pass_round_ms = round_rate(sweep, 8)
        check(counters.kernel_launches("pairs_totals") == 3 * 10,
              "the forced north-star pair did not take the totals lane launch")
    # Each lane launch at this width, on the converged lanes.
    st, lanes = sweep.states, len(NS_PAIR_SEEDS)
    w, alive, mv = st.w, st.alive, st.max_version
    draws = [prng.grouped_matching(prng.key(9 + s), n) for s in range(lanes)]
    gm = torch.stack([d[0] for d in draws]).to(dev, torch.int32)
    c = torch.stack([d[1] for d in draws]).to(dev, torch.int32)
    salt = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    tot = pairs_totals.pairs_totals_lanes(w, gm, c, alive, mv=mv)
    times = {}
    for diag in (True, False):
        times[lane_totals_key(diag, "lean16")] = (
            cuda_ms(lambda: pairs_totals.pairs_totals_lanes(
                w, gm, c, alive, mv=mv if diag else None), 10),
            bound(lanes * totals_bytes(n, 2, diag=diag), lanes * OPS_TOTALS * n * n / 2),
        )
    for name in ("first", "middle", "last"):
        mm = LADDER_MODES[name]
        kw = {"mv": mv} if mm["diag"] else {}
        if mm["check"]:
            kw["check"] = (mv, alive, alive)
        for totals in (True, False):
            extra = {"totals": tot} if totals else {"cluster": k}
            times[lane_key(mm, "lean16", totals=totals, cluster=not totals and k > 1)] = (
                cuda_ms(lambda: pairs_pull.pairs_pull_lanes(
                    w, None, gm, c, alive, salt, cfg.budget, **extra, **kw), 10),
                bound(lanes * pull_bytes(n, 2, 0, diag=mm["diag"], check=mm["check"],
                                         fd=False, hb0=False, totals=totals),
                      lanes * OPS_PAIR_LEAN * n * n / 2),
            )
    torch.cuda.synchronize()
    for key, (ms, (b_ms, b_by)) in times.items():
        log("sweep", f"{key} at n={n} S={lanes}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by})")
    form_round = {}
    for f in ("staged", "two_pass"):
        per = {kk: (2 if "[lanes+sum]" in kk else 1) if kk.startswith("pairs_totals")
               else 1 for kk in times
               if (f == "two_pass") == ("totals" in kk or kk.startswith("pairs_totals"))}
        form_round[f] = (sum(per[kk] * times[kk][0] for kk in per),
                         sum(per[kk] * times[kk][1][0] for kk in per))
    kern_ms, bound_ms = form_round["staged"]
    log("sweep", f"north-star pair: {round_ms:.3f} ms a round ({2e3 / round_ms:.3f} "
        f"lane-rounds/s; the two-pass form {two_pass_round_ms:.3f}); lane launches "
        f"{kern_ms:.3f} ms a round by CUDA events against a {bound_ms:.3f} ms bound "
        f"({bound_ms / kern_ms:.1%}), the two-pass form's {form_round['two_pass'][0]:.3f} "
        f"against {form_round['two_pass'][1]:.3f}; peak {peak_gb:.2f} GB; {card_line}")
    del sweep, st, w, tot
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sweep = SweepSimulator(cfg, NS_PAIR_SEEDS, device=dev)
    sweep.run(NS_PAIR_CHECK_ROUND)
    round_errs = collections.defaultdict(float)
    found = sampled_lane_round_check(dev, sweep, "lean16", round_errs)
    for k, e in round_errs.items():
        errs[k] = max(errs[k], e)
    log("sweep", f"north-star pair, one chained round of lane launches {NS_PAIR_CHECK_ROUND} "
        f"rounds in, {NS_PAIR_LEADERS} row pairs a lane a pull: "
        + ", ".join(f"{k} max_abs_err={e}" for k, e in found)
        + f" ({time.perf_counter() - t0:.1f} s with the rounds)")
    check(all(e == 0.0 for e in round_errs.values()),
          f"the north-star pair's lane launches disagree: {found}")
    del sweep
    torch.cuda.empty_cache()
    return {
        "n": n, "seeds": NS_PAIR_SEEDS, "form": form, "cluster": k,
        "rounds_to_convergence": rounds,
        "sequential_seed2_round": seq_round, "rounds_run": ticks, "run_s": run_s,
        "run_round_ms": run_s / (ticks - NS_PAIR_CHECK_ROUND) * 1e3,
        "round_ms": round_ms, "lane_rounds_per_s": 2e3 / round_ms,
        "kernel_ms_per_round": kern_ms, "bound_ms_per_round": bound_ms,
        "two_pass": {"round_ms": two_pass_round_ms,
                     "kernel_ms_per_round": form_round["two_pass"][0],
                     "bound_ms_per_round": form_round["two_pass"][1]},
        "peak_memory_gb": peak_gb, "both_held_gb": both_gb,
        "round_check_max_abs_err": dict(round_errs), "round_check_leaders": NS_PAIR_LEADERS,
    }, launches, times


def sweep_counters(dev, card_line):
    """Phase 11f: what the counters show off the lane kernels. A sweep
    pinned to m8 (no lane lift, as in the reference) runs its pull plain
    with the fallback "sweep_needs_pairs" and its FD plain, and equals
    the pairs sweep; a fanout-0 headline round (C1) counts the fallback
    "fanout" and one fd.cu launch and equals the plain round."""
    cfg = headline_config()
    counters.reset()
    m8 = SweepSimulator(dataclasses.replace(cfg, pallas_variant="m8"), [0, 1], device=dev,
                        phi_threshold=[7.0, 9.0])
    m8.run(2)
    torch.cuda.synchronize()
    m8_counts = (dict(counters.fallbacks), dict(counters.plain_calls), dict(counters.launches))
    check(m8_counts == ({"sweep_needs_pairs": 2}, {"pull": 12, "fd": 4}, {}),
          f"the pinned-m8 sweep's counters: {m8_counts}")
    pairs = SweepSimulator(cfg, [0, 1], device=dev, phi_threshold=[7.0, 9.0])
    pairs.run(2)
    torch.cuda.synchronize()
    check(states_equal(m8.states, pairs.states), "the pinned-m8 sweep differs from the pairs sweep")
    del m8, pairs
    zero = dataclasses.replace(cfg, fanout=0)
    counters.reset()
    kern = Simulator(zero, seed=0, device=dev)
    kern.run(1)
    torch.cuda.synchronize()
    zero_counts = (dict(counters.fallbacks), dict(counters.launches), dict(counters.plain_calls))
    check(zero_counts == ({"fanout": 1}, {"fd": 1}, {}),
          f"a fanout-0 round's counters: {zero_counts}")
    plain = Simulator(dataclasses.replace(zero, use_pallas=False, use_pallas_fd=False), seed=0,
                      device=dev)
    plain.run(1)
    torch.cuda.synchronize()
    check(states_equal(kern.state, plain.state), "the fanout-0 round differs from the plain round")
    log("sweep", f"pinned-m8 sweep, 2 rounds: (fallbacks, plain calls, launches) {m8_counts}, "
        f"equal to the pairs sweep; fanout-0 headline round: (fallbacks, launches, plain "
        f"calls) {zero_counts}, equal to the plain round; {card_line}")
    del kern, plain
    torch.cuda.empty_cache()
    return {"pinned_m8_sweep": m8_counts, "fanout0_round": zero_counts}


def lane_bound(n, lanes, rung, m, totals):
    """The least time of one lane launch: ``lanes`` times one lane's bytes
    and operations at the rung's sizes."""
    wsize, hsize, imsize, icsize, livesize = LANE_SIZES[rung]
    b = pull_bytes(n, wsize, hsize, diag=m["diag"], check=m["check"], fd=m["fd"], hb0=m["hb0"],
                   imsize=imsize, icsize=icsize, livesize=livesize, totals=totals)
    ops = (OPS_PAIR if hsize else OPS_PAIR_LEAN) + (2 * OPS_FD if m["fd"] else 0)
    return bound(lanes * b, lanes * ops * n * n / 2)


def headline_lane_times(dev):
    """The headline sweep's lane launches at its own shapes (S = 8,
    N = 10,240, int16 with hb and the FD) by CUDA events, beside S times
    the single-lane bound: name -> (ms, bound)."""
    times = {}
    for i, name in enumerate(("first", "middle", "last_fd")):
        m = LADDER_MODES[name]
        ops = lane_case(N, len(SWEEP_SEEDS), 700 + 10 * i, dev, void=False,
                        **LANE_RUNGS["int16"], **m)()
        key = lane_key(m, "int16")
        times[key] = (cuda_ms(lambda: call_lanes(pairs_pull.pairs_pull_lanes, ops), 10),
                      lane_bound(N, len(SWEEP_SEEDS), "int16", m, False))
        log("time", f"{key} at S={len(SWEEP_SEEDS)} n={N}: {times[key][0]:.4f} ms (bound "
            f"{times[key][1][0]:.4f} ms by {times[key][1][1]})")
        del ops
    torch.cuda.empty_cache()
    return times


def lane_entries(dev, errs, runs, head_times, ns_times):
    """The kernel-line entries of every lane mode: each timed at
    N = 10,240 with S = 3 by CUDA events beside its plain version and
    its bound (S times one lane's), with the launches of the sweep whose
    path runs it (each must be > 0); the headline modes also at the phi
    ladder's S = 8 (``head_times``) and the north star's at its S = 2
    and width (``ns_times``)."""
    entries = []
    pull_line = "aiocluster_tpu/ops/pallas_pull.py:490 (lanes: fused_pull_pairs_lanes :1803)"
    totals_line = ("aiocluster_tpu/ops/pallas_pull.py:899 "
                   "(lanes: fused_pull_pairs_totals_lanes :1959)")

    def run_of(rung, mode, totals):
        if rung == "int16":
            if mode == "only_fd":
                return "sweep_fanout1" + ("_two_pass" if totals else "")
            return "sweep_headline_two_pass" if totals else "sweep_headline"
        return f"sweep_{rung}" + ("_two_pass" if totals else "")

    def entry(name, kernel, line, run, ms, plain_ms, b):
        launch_key = name.rsplit(" ", 1)[0]
        launches, rounds = runs[run]
        check(launches.get(launch_key, 0) > 0, f"{name} was not launched on {run}")
        extra, msg = {}, ""
        main = (len(SWEEP_SEEDS), N, *head_times[name]) if name in head_times else (
            (len(NS_PAIR_SEEDS), NORTH_STAR_N, *ns_times[name]) if name in ns_times else None)
        if main is not None:
            extra = dict(lanes_main=main[0], n_main=main[1], ms_main=main[2],
                         bound_ms_main=main[3][0])
            msg = f"; {main[2]:.4f} ms at S={main[0]} n={main[1]} (bound {main[3][0]:.4f} ms)"
        log("time", f"{name}: {ms:.4f} ms at S={LANE_S} n={N} (bound {b[0]:.4f} ms by {b[1]}; "
            f"plain {plain_ms:.3f} ms){msg}; {launches[launch_key]} launches on {run}")
        return dict(
            name=name, route="cuda", source=f"aiocluster_torch/ops/csrc/{kernel}.cu",
            replaces=line, launches=launches[launch_key],
            launches_per_round=launches[launch_key] / rounds, max_abs_err=errs[name],
            ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None,
            path=run, n=N, lanes=LANE_S, **extra,
        )

    seed = 500
    for rung, modes in LANE_CHECKS:
        for mode in modes:
            m = LADDER_MODES[mode]
            for totals in (False, True):
                seed += 10
                fresh = lane_case(N, LANE_S, seed, dev, void=False, **LANE_RUNGS[rung], **m)

                def prepared(plain=False):
                    ops = fresh()
                    if totals:
                        fn = (pairs_totals.pairs_totals_lanes_plain if plain
                              else pairs_totals.pairs_totals_lanes)
                        ops["totals"] = fn(ops["w"], ops["gm"], ops["c"], ops["valid"],
                                           mv=ops.get("mv"))
                    return ops

                ops = prepared()
                ms = cuda_ms(lambda: call_lanes(pairs_pull.pairs_pull_lanes, ops), 10)
                ops = prepared(plain=True)
                plain_ms = cuda_ms(lambda: call_lanes(pairs_pull.pairs_pull_lanes_plain, ops),
                                   1, 1)
                del ops
                entries.append(entry(lane_key(m, rung, totals), "pairs_pull", pull_line,
                                     run_of(rung, mode, totals), ms, plain_ms,
                                     lane_bound(N, LANE_S, rung, m, totals)))
        for diag in (True, False):
            ops = lane_case(N, LANE_S, 600 + diag, dev, void=False, **LANE_RUNGS[rung],
                            diag=diag, check=False, fd=False, hb0=False)()
            args = (ops["w"], ops["gm"], ops["c"], ops["valid"])
            mv = ops.get("mv")
            ms = cuda_ms(lambda: pairs_totals.pairs_totals_lanes(*args, mv=mv), 10)
            plain_ms = cuda_ms(lambda: pairs_totals.pairs_totals_lanes_plain(*args, mv=mv), 1, 1)
            entries.append(entry(
                lane_totals_key(diag, rung), "pairs_totals", totals_line,
                run_of(rung, "first", True), ms, plain_ms,
                bound(LANE_S * totals_bytes(N, LANE_SIZES[rung][0], diag=diag),
                      LANE_S * OPS_TOTALS * N * N / 2),
            ))
            del ops
    torch.cuda.empty_cache()
    return entries


# The cluster-staged modes on the full-width paths (the runs in their
# form, or in the other form beside them): (rung, ladder_case operands,
# modes, run, lanes). Each run's cluster size is RUN_FORMS's.
CLUSTER_PATHS = (
    ("lean16", dict(wdt=torch.int16), ("first", "middle", "last"), "north_star", 0),
    ("int8", dict(wdt=torch.int8), ("first", "middle", "last"), "north_star_int8_other", 0),
    ("u4r", dict(wdt="u4"), ("first", "middle", "last"), "widest_u4r_other", 0),
    ("shrunk", FD_RUNGS["shrunk"], ("first", "middle", "last_fd"), "full_shrunk", 0),
    ("full int16", dict(wdt=torch.int16, hdt=torch.int16), ("first", "middle", "last_fd"),
     "full_past_staged", 0),
    ("lean16", dict(wdt=torch.int16), ("first", "middle", "last"), "north_star_pair", LANE_S),
)


def cluster_entries(dev, errs, runs, main_times):
    """The kernel-line entries of the cluster-staged modes on the paths
    whose form is the cluster frame: each held bit-equal to its plain
    version at N = 10,240 on clusters of its path's size (raising
    ``errs``), timed there by CUDA events beside the plain version and
    its bound, with its time at its path's width (``main_times``: name ->
    (ms, bound)) and its path's launches (``runs``: run -> (launches,
    rounds); each must be > 0). Lane modes run S = ``LANE_S`` lanes."""
    entries = []
    line = "aiocluster_tpu/ops/pallas_pull.py:490"
    seed = 900
    for rung, operands, modes, run, lanes in CLUSTER_PATHS:
        form, k = RUN_FORMS[run]
        if form != "pairs_cluster":
            continue
        launches, rounds = runs[run]
        for mode in modes:
            m = LADDER_MODES[mode]
            seed += 1
            if lanes:
                fresh = lane_case(N, lanes, seed, dev, void=False, **operands, **m)
                kernel = functools.partial(pairs_pull.pairs_pull_lanes, cluster=k)
                name = lane_key(m, rung, cluster=True)

                def call(fn, ops):
                    return call_lanes(fn, ops)
                plain_fn = pairs_pull.pairs_pull_lanes_plain
                b = lane_bound(N, lanes, rung, m, False)
            else:
                fresh = ladder_case(N, seed, dev, **operands, **m)
                kernel = functools.partial(pairs_pull.pairs_pull, cluster=k)
                name = ladder_key(m, rung, cluster=True)
                call = call_pull
                plain_fn = pairs_pull.pairs_pull_plain
                b = ladder_pull_bound(N, rung, m, False)
            kern, plain = fresh(), fresh()
            fk, fp = call(kernel, kern), call(plain_fn, plain)
            torch.cuda.synchronize()
            err = max_abs_err(outputs(kern, fk), outputs(plain, fp))
            errs[name] = max(errs[name], err)
            check(err == 0.0, f"{name} on clusters of {k} disagrees with its plain version")
            ms = cuda_ms(lambda: call(kernel, kern), 20)
            plain_ms = cuda_ms(lambda: call(plain_fn, plain), 1 if lanes else 3, 1)
            del kern, plain
            key = name.rsplit(" ", 1)[0] if rung != "full int16" else name[:-len(" full int16")]
            check(launches.get(key, 0) > 0, f"{name} was not launched on {run}")
            extra = {}
            msg = ""
            if name in main_times:
                ms_main, b_main = main_times[name]
                extra = dict(ms_main=ms_main, bound_ms_main=b_main[0])
                msg = f"; {ms_main:.4f} ms at the path's width (bound {b_main[0]:.4f} ms)"
            log("time", f"{name} (clusters of {k}): {ms:.4f} ms at n={N} (bound {b[0]:.4f} ms "
                f"by {b[1]}; plain {plain_ms:.3f} ms){msg}; {launches[key]} launches on {run}")
            entries.append(dict(
                name=name, route="cuda", source="aiocluster_torch/ops/csrc/pairs_pull.cu",
                replaces=line + (" (lanes: fused_pull_pairs_lanes :1803)" if lanes else ""),
                launches=launches[key], launches_per_round=launches[key] / rounds,
                max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                bound_by=b[1], library_ms=None, path=run, n=N, cluster=k,
                **({"lanes": lanes} if lanes else {}), **extra,
            ))
    torch.cuda.empty_cache()
    return entries


# -- the full profile past the staged width (C2) ---------------------------------

C2_N, C2_ROUNDS, C2_LEADERS = 65_536, 10, 2048


def sampled_round_check(dev, sim, errs, rung="full int16", leaders=C2_LEADERS, seed=8):
    """One round's sub-exchanges at the simulator's width in its form
    (``gossip.kernel_pull_form``), chained as ``sim_step`` chains them (in
    the two-pass form each totals pass held against its plain version
    over every row; the first pull refreshes the diagonal, the last
    carries the check and, with the FD, the fused epilogue reading the
    round-start hb), then a fourth whose check every row passes (need 0:
    the flag stays 1 over every CTA). A second copy of every matrix does
    not fit beside a full profile at this width, so the kernel runs on
    the state itself and each pull is held over a seeded sample of
    ``leaders`` row pairs: their pre-exchange rows are kept, the kernel's
    outputs on them read, the rows put back and the plain version run
    over those pairs alone. A seeded tenth of the nodes is dead and half
    the owners wrote a key. Raises each mode's max_abs_err in ``errs``
    (names with ``rung``); returns the round's (key, max_abs_err) pairs."""
    st, cfg, n = sim.state, sim.cfg, sim.cfg.n_nodes
    form, k = gossip.kernel_pull_form(cfg)
    two_pass = form == "pairs_two_pass"
    packed = is_packed_w(st.w)
    gen = torch.Generator(device=dev).manual_seed(seed)
    alive = torch.rand(n, generator=gen, device=dev) < 0.9
    wrote = torch.rand(n, generator=gen, device=dev) < 0.5
    mv = st.max_version + wrote.to(torch.int32)
    heartbeat = st.heartbeat + alive.to(torch.int32)
    hb = st.hb_known if cfg.track_heartbeats else None
    tick = sim.tick + 1
    run_key = prng.key(sim.seed)
    gm_all, c_all, p_all = (
        t[0] for t in prng.round_draws(run_key.to(dev), tick, 1, n, cfg.fanout)
    )
    fd = None
    if cfg.track_failure_detector:
        fd = pairs_pull.FdOperands(tick, st.last_change, st.imean, st.icount, st.live_view,
                                   st.hb_known.clone(), FdParams.from_config(cfg))
    last = "last_fd" if fd is not None else "last"
    steps = [("first", 0)] + [("middle", s) for s in range(1, cfg.fanout - 1)]
    steps += [(last, cfg.fanout - 1), ("need 0", cfg.fanout - 1)]
    ids = torch.arange(n, device=dev)
    found = []
    for name, s in steps:
        mode = LADDER_MODES[last if name == "need 0" else name]
        p = p_all[s].long()
        valid = alive & alive[p]
        kw = {}
        if mode["diag"]:
            kw["mv"] = mv - st.max_version if packed else mv
            if hb is not None:
                kw["hbv"] = heartbeat
        if mode["check"]:
            # need 0 and every owner excused: the flag must stay 1 (a packed row
            # passes only where its owners are caught up or excused).
            kw["check"] = ((torch.zeros_like(mv), alive, torch.zeros_like(alive))
                           if name == "need 0" else (mv, alive, alive))
        if mode["fd"]:
            kw.update(hbv=heartbeat, fd=fd)
        tk = tp = None
        if two_pass:
            tk = pairs_totals.pairs_totals(st.w, gm_all[s], c_all[s], valid, mv=kw.get("mv"))
            tp = pairs_totals.pairs_totals_plain(st.w, gm_all[s], c_all[s], valid,
                                                 mv=kw.get("mv"))
            t_key = f"{pairs_totals.counter_key(mode['diag'], packed)} {rung}"
            t_err = max_abs_err([tk], [tp])
            errs[t_key] = max(errs[t_key], t_err)
            found.append((f"{t_key} ({name})", t_err))
        lead = ids[ids <= p]
        lead = lead[torch.randperm(lead.numel(), generator=gen, device=dev)[:leaders]]
        partners = p[lead]
        rows = torch.cat((lead, partners[partners != lead]))
        mats = [st.w] + ([] if hb is None else [hb]) + (
            [st.last_change, st.imean, st.icount, st.live_view] if mode["fd"] else [])
        pre = [m[rows] for m in mats]
        args = (gm_all[s], c_all[s], valid, tick * 2 * cfg.fanout + 2 * s,
                prng.run_salt(run_key), cfg.budget)
        fk = pairs_pull.pairs_pull(st.w, hb, *args, totals=tk, **kw)
        torch.cuda.synchronize()
        post = [m[rows] for m in mats]
        for m, x in zip(mats, pre):
            m[rows] = x
        fp = pairs_pull.pairs_pull_plain(st.w, hb, *args, totals=tp, leaders=lead, **kw)
        torch.cuda.synchronize()
        key = ladder_key(mode, rung, totals=two_pass, cluster=not two_pass and k > 1)
        err = max_abs_err([m[rows] for m in mats], post)
        errs[key] = max(errs[key], err)
        flags = "" if fk is None else f" flag {int(fk[0])} (sample {int(fp[0])})"
        found.append((f"{key} ({name}){flags}", err))
        if name == "need 0":
            check(int(fk[0]) == 1, "the check flag of a passing sub-exchange is 0")
        del pre, post
    del fd
    torch.cuda.empty_cache()
    return found


def full_past_staged(dev, card_line, errs):
    """Phase 12 (C2): the full profile past the one-CTA staged width,
    full_config(65_536) (int16, about 56 GB with the round-start hb
    copy), in its form (``RUN_FORMS``) with the fused FD epilogue.
    ``C2_ROUNDS`` tracked rounds from counters at 0, one chained round held
    against the plain versions (``sampled_round_check``, raising
    ``errs``), then its round time and peak memory, and the round time in
    the two-pass form (forced) on the same state."""
    cfg = full_config(C2_N, budget=2618)
    form, k = expect_form(cfg, dev, "full_past_staged")
    check(gossip.fd_phase_engaged(cfg, dev) == "fused",
          f"full_config({C2_N}) does not fuse the FD phase")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=NORTH_STAR_SEED, device=dev)
    sim.run_until_converged(max_rounds=C2_ROUNDS)  # tracked rounds: the check rides the last
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(counters.launches)
    check(counters.kernel_launches("pairs_pull") == 3 * C2_ROUNDS
          and counters.kernel_launches("pairs_totals") == 0
          and launches.get(pairs_pull.counter_key(False, True, True, cluster=k > 1)) == C2_ROUNDS
          and not counters.plain_calls and not counters.fallbacks,
          f"full_config({C2_N}) did not run one launch a sub-exchange ({launches})")
    round_errs = collections.defaultdict(float)
    found = sampled_round_check(dev, sim, round_errs)
    check(all(e == 0.0 for e in round_errs.values()), f"the C2 round disagrees: {found}")
    for key, e in round_errs.items():
        errs[key] = max(errs[key], e)
    round_ms = round_rate(sim, 8)
    with two_pass_forced():
        two_pass_round_ms = round_rate(sim, 8)
    m = sim.metrics()
    check(np.isfinite(float(m["mean_fraction"])) and int(m["alive_count"]) == C2_N,
          f"full_config({C2_N}) metrics are not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("c2", f"full_config({C2_N}) int16, {form} on clusters of {k}, with the fused FD: "
        f"{C2_ROUNDS} rounds in {run_s:.2f} s with init; launches {launches}; one chained "
        f"round {C2_ROUNDS} rounds in, {C2_LEADERS} row pairs a pull: "
        + ", ".join(f"{kk} max_abs_err={e}" for kk, e in found)
        + f"; {round_ms:.3f} ms a round (two-pass form {two_pass_round_ms:.3f} ms on the "
        f"later state); peak {peak_gb:.2f} GB; mean fraction "
        f"{float(m['mean_fraction']):.4f}; {card_line}")
    del sim
    torch.cuda.empty_cache()
    return {"n": C2_N, "form": form, "cluster": k, "round_ms": round_ms,
            "two_pass_round_ms": two_pass_round_ms, "peak_memory_gb": peak_gb,
            "max_abs_err": dict(round_errs), "sample_leaders": C2_LEADERS, "run_s": run_s}, (
        launches, C2_ROUNDS)


# -- the owner-sharded round: column blocks of the pairs and FD kernels (phase 13) ---

MESH_BLOCKS = 8  # the reference's test mesh and its certified north-star mesh
# sha256 of the north star's w as int8 (row-major, the whole N x N) after
# ticks 1 and 2 of the reference's 8-device mesh run at seed 1
# (benchmarks/records/r4_northstar_100k_certification.json; the digest is
# benchmarks/records/_r4_northstar_certify.py:_digest_int8).
NORTH_STAR_DIGESTS = {
    1: "2d8681fa6b99c95dbdd95b33e10a4e1062f0fcc5784302a2095e10c85d900b2f",
    2: "7b4564911975ad6d15bed267f6657ab00149d3861a05a76c57ad3781d4a6d217",
}
MESH_CHECK_ROUND = 20  # the mesh north star's w held against the unsharded run's here
# The w digests' hashing: one worker thread, so each digest's blocks of
# rows are fed to its sha256 in order.
HASHER = concurrent.futures.ThreadPoolExecutor(max_workers=1)
DIGEST_ROWS_HELD = 4  # blocks of rows held on the host while a digest is fed
# The column-block modes held on the card: (rung, ladder_case operands,
# modes), the modes an 8-block run of each rung launches.
BLOCK_CHECKS = (
    ("int16", dict(wdt=torch.int16, hdt=torch.int16), ("first", "middle", "last_fd")),
    ("lean int16", dict(wdt=torch.int16), ("first", "middle", "last")),
    ("int8", dict(wdt=torch.int8), ("first", "middle", "last")),
    ("u4r", dict(wdt="u4"), ("first", "middle", "last")),
    ("shrunk", FD_RUNGS["shrunk"], ("last_fd",)),
)
# Each rung's run on the mesh whose launches its entries report.
BLOCK_RUNS = {"int16": "headline_mesh", "lean int16": "north_star_mesh",
              "int8": "int8_mesh", "u4r": "u4r_mesh", "shrunk": "shrunk_mesh"}


def mesh_of(dev):
    """The reference's 8-shard mesh on this one card."""
    return make_mesh([dev] * MESH_BLOCKS)


def column_block(ops, k, width):
    """Block ``k`` (the owners ``k * width ..``) of whole-width pull
    operands: each matrix's columns copied out, each owner vector's
    slice, the rows' operands whole."""
    packed = ops["w"].dtype == torch.uint8

    def cut(t, owners_a_column=1):
        step = width // owners_a_column
        return t[:, k * step : (k + 1) * step].contiguous()

    cols = slice(k * width, (k + 1) * width)
    out = dict(ops, owner_offset=k * width, w=cut(ops["w"], 2 if packed else 1))
    if ops["hb"] is not None:
        out["hb"] = cut(ops["hb"])
    for name in ("mv", "hbv"):
        if name in ops:
            out[name] = ops[name][cols]
    if "check" in ops:
        need, alive, alive_owner = ops["check"]
        out["check"] = (need[cols], alive, alive_owner[cols])
    f = ops.get("fd")
    if f is not None:
        out["fd"] = pairs_pull.FdOperands(
            f.tick, cut(f.lc), cut(f.im), cut(f.ic),
            cut(f.live, 8 if f.live.dtype == torch.uint8 else 1),
            None if f.hb0 is None else cut(f.hb0), f.params,
        )
    return out


def half_excused(ops, width):
    """The check of a column-block case passes on the even blocks: their
    owners' need is 0 (packed: their owners are dead), so the blocks'
    flags differ and their min is the whole width's."""
    if "check" not in ops:
        return ops
    need, alive, alive_owner = ops["check"]
    odd = (torch.arange(need.shape[0], device=need.device) // width) % 2 == 1
    if ops["w"].dtype == torch.uint8:
        alive_owner = alive_owner & odd
    else:
        need = torch.where(odd, need, 0)
    return dict(ops, check=(need, alive, alive_owner))


def block_key(m, rung) -> str:
    return f"{pairs_pull.counter_key(m['diag'], m['check'], m['fd'], True, rung == 'u4r')} cols {rung}"


def block_totals_key(diag, rung) -> str:
    return f"{pairs_totals.counter_key(diag, rung == 'u4r')} cols {rung}"


def block_pull_bound(n, n_cols, rung, m):
    """(ms, by) bound of one column-block pull fed the totals."""
    wsize = {"int16": 2, "lean int16": 2, "int8": 1, "u4r": 0.5, "shrunk": 2}[rung]
    hsize = {"int16": 2, "shrunk": 2}.get(rung, 0)
    shrunk = rung == "shrunk"
    b = pull_bytes(n, wsize, hsize, diag=m["diag"], check=m["check"], fd=m["fd"],
                   hb0=m["hb0"], icsize=1 if shrunk else 2, livesize=1 / 8 if shrunk else 1,
                   totals=True, n_cols=n_cols)
    ops = (OPS_PAIR if hsize else OPS_PAIR_LEAN) + (2 * OPS_FD if m["fd"] else 0)
    return bound(b, ops * n * n_cols / 2)


def block_totals_bound(n, n_cols, rung, diag):
    wsize = {"u4r": 0.5, "int8": 1}.get(rung, 2)
    return bound(totals_bytes(n, wsize, diag=diag, n_cols=n_cols), OPS_TOTALS * n * n_cols / 2)


def check_column_block_kernels(dev, fd_fresh, params):
    """Phase 13a: every column-block mode of the pairs pull, the pairs
    totals and the FD kernel against its plain version at N = 10,240
    over 8 blocks of 1,280 owners (owner_offset k * 1,280). Per mode: the
    blocks' totals (kernel, each equal to its plain version) summed in
    float32 in block order must equal the whole width's bit for bit;
    each block's pull fed the whole width's totals must equal its plain
    version and, side by side, the whole-width kernel's output on its
    columns, and the blocks' flags' min the whole width's flag (the
    check passes on the even blocks: ``half_excused``). Block 1 of each
    mode is timed (CUDA events) beside its plain version and its
    bound. Returns (errs, times): key -> max_abs_err, key -> (ms,
    plain_ms, bound). ``fd_fresh`` and ``params`` are phase 4's FD
    operands."""
    errs: dict[str, float] = collections.defaultdict(float)
    times = {}
    width = N // MESH_BLOCKS
    seed = 400
    t0 = time.perf_counter()
    for rung, operands, modes in BLOCK_CHECKS:
        wrung = {"lean int16": "int16", "shrunk": "int16"}.get(rung, rung)
        for name in modes:
            m = LADDER_MODES[name]
            seed += 1
            case = ladder_case(N, seed, dev, **operands, **m)

            def fresh():
                return half_excused(case(), width)

            whole = fresh()
            tot = pairs_totals.pairs_totals(
                whole["w"], whole["gm"], whole["c"], whole["valid"], mv=whole.get("mv"))
            whole["totals"] = tot
            f_whole = call_pull(pairs_pull.pairs_pull, whole)
            base = fresh()
            summed = torch.zeros_like(tot)
            key, t_key = block_key(m, rung), block_totals_key(m["diag"], wrung)
            flags = []
            for k in range(MESH_BLOCKS):
                kern, plain = column_block(base, k, width), column_block(base, k, width)
                args = (kern["gm"], kern["c"], kern["valid"])
                part = pairs_totals.pairs_totals(kern["w"], *args, mv=kern.get("mv"),
                                                 owner_offset=k * width)
                part_plain = pairs_totals.pairs_totals_plain(
                    plain["w"], *args, mv=plain.get("mv"), owner_offset=k * width)
                errs[t_key] = max(errs[t_key], max_abs_err([part], [part_plain]))
                summed += part
                kern["totals"], plain["totals"] = tot, tot
                fk = call_pull(pairs_pull.pairs_pull, kern)
                fp = call_pull(pairs_pull.pairs_pull_plain, plain)
                torch.cuda.synchronize()
                errs[key] = max(errs[key], max_abs_err(outputs(kern, fk), outputs(plain, fp)),
                                max_abs_err(outputs(kern, None),
                                            outputs(column_block(whole, k, width), None)))
                if fk is not None:
                    flags.append(int(fk[0]))
                if k == 1:
                    ops = column_block(base, k, width)
                    ops["totals"] = tot
                    ms = cuda_ms(lambda: call_pull(pairs_pull.pairs_pull, ops), 20)
                    ops = column_block(base, k, width)
                    ops["totals"] = tot
                    plain_ms = cuda_ms(lambda: call_pull(pairs_pull.pairs_pull_plain, ops), 3, 1)
                    times[key] = (ms, plain_ms, block_pull_bound(N, width, rung, m))
                    if rung in ("int16", "int8", "u4r") and t_key not in times:
                        targs = (kern["w"], *args)
                        mv = kern.get("mv")
                        times[t_key] = (
                            cuda_ms(lambda: pairs_totals.pairs_totals(
                                *targs, mv=mv, owner_offset=width), 20),
                            cuda_ms(lambda: pairs_totals.pairs_totals_plain(
                                *targs, mv=mv, owner_offset=width), 3, 1),
                            block_totals_bound(N, width, wrung, m["diag"]),
                        )
                del kern, plain
            errs[t_key] = max(errs[t_key], max_abs_err([summed], [tot]))
            if f_whole is not None:
                check(min(flags) == int(f_whole[0]), f"{key}: the blocks' flags' min "
                      f"{min(flags)} != the whole width's {int(f_whole[0])}")
            log("columns", f"n={N} {rung} {name} over {MESH_BLOCKS} blocks of {width}: "
                f"{t_key} max_abs_err={errs[t_key]} (the blocks' sum against the whole "
                f"width's, each block against its plain version); {key} max_abs_err="
                f"{errs[key]} (against the plain version and the whole width's columns)"
                + ("" if f_whole is None else f"; flags {flags}, whole {int(f_whole[0])}"))
            check(errs[key] == 0.0 and errs[t_key] == 0.0, f"{key} disagrees")
            del whole, base
    # The standalone FD kernel at each block's offset.
    err_fd = 0.0
    whole = fd_fresh()
    fd_mod.fused_fd(40, *whole, params)
    base = fd_fresh()

    def fd_block(k):
        cols = slice(k * width, (k + 1) * width)
        return [t[cols].contiguous() if t.dim() == 1 else t[:, cols].contiguous() for t in base]

    for k in range(MESH_BLOCKS):
        a, b = fd_block(k), fd_block(k)
        fd_mod.fused_fd(40, *a, params, owner_offset=k * width)
        fd_mod.fused_fd_plain(40, *b, params, owner_offset=k * width)
        torch.cuda.synchronize()
        cols = slice(k * width, (k + 1) * width)
        err_fd = max(err_fd, max_abs_err(a[3:], b[3:]),
                     max_abs_err(a[3:], [t[:, cols] for t in whole[3:]]))
    a = fd_block(1)
    ms = cuda_ms(lambda: fd_mod.fused_fd(40, *a, params, owner_offset=width), 20)
    a = fd_block(1)
    plain_ms = cuda_ms(lambda: fd_mod.fused_fd_plain(40, *a, params, owner_offset=width), 3, 1)
    mat = N * width
    times["fd cols"] = (ms, plain_ms, bound(mat * (5 * 2 + 3 * 2 + 1) + width * 4, OPS_FD * mat))
    errs["fd cols"] = err_fd
    log("columns", f"n={N} fd over {MESH_BLOCKS} blocks at owner_offset k*{width}: "
        f"max_abs_err={err_fd} (against the plain version and the whole width's columns)")
    check(err_fd == 0.0, "the fd kernel at an offset disagrees")
    del whole, base, a
    torch.cuda.empty_cache()
    log("columns", f"every column-block mode equals its plain version and the whole width "
        f"({time.perf_counter() - t0:.1f} s)")
    return errs, times


def mesh_launches_ok(launches, rounds, tracked, *, fd=False, p=MESH_BLOCKS):
    """Every sub-exchange of every round on the two-pass pairs form: a
    totals and a pull launch a block, the check on the tracked rounds'
    last (with the FD epilogue when ``fd``)."""
    pulls = sum(v for k, v in launches.items() if k.startswith("pairs_pull["))
    totals = sum(v for k, v in launches.items() if k.startswith("pairs_totals["))
    last = [k for k in launches if k.startswith("pairs_pull[") and "check" in k]
    return (pulls == 3 * p * rounds and totals == 3 * p * rounds
            and sum(launches[k] for k in last) == p * tracked
            and all(("fd" in k) == fd for k in last))


def headline_mesh(dev, card_line):
    """Phase 13b: the headline config on 8 column blocks on this card
    (the two-pass pairs form, the fused FD epilogue at each block's
    offset, the check): it converges at round 24, field-equal (gathered)
    to the unsharded headline at that round; its round rate is timed as
    phase 7 times the headline's, and one chunk of 16 rounds is traced
    (``build/chip_smoke_trace_mesh.json``). Then pinned to m8 (the m8 column
    blocks, the FD kernel at each block's offset once a round): round
    24, field-equal to the pairs mesh run."""
    cfg = headline_config()
    mesh = mesh_of(dev)
    check(gossip.resolve_phases(cfg, dev, n_local=N // MESH_BLOCKS)
          == gossip.Phases("pairs_two_pass", None, "fused", None),
          "the headline on a mesh does not take the two-pass pairs form with the fused FD")
    sim, converged, launches, run_s, _ = run_to(cfg, dev, 0, CONVERGED_ROUND, "headline_mesh",
                                               max_rounds=200, mesh=mesh)
    rounds = sim.tick
    check(mesh_launches_ok(launches, rounds, rounds, fd=True),
          f"the headline mesh did not run 2 launches a block a sub-exchange ({launches})")
    ref = Simulator(cfg, seed=0, device=dev)
    ref.run(rounds)
    torch.cuda.synchronize()
    check(states_equal(sim.state, ref.state),
          f"the headline on {MESH_BLOCKS} blocks != the unsharded headline at round {rounds}")
    m, m_ref = sim.metrics(), gossip.convergence_metrics(ref.state)
    check(all(np.array_equal(m[k], m_ref[k].cpu().numpy()) for k in m_ref),
          "the mesh metrics differ from the unsharded run's")
    log("headline_mesh", f"round {rounds}: every state tensor (gathered) == the unsharded "
        f"headline's; metrics equal; version spread {int(m['version_spread'])}")
    del sim, ref
    rate = Simulator(cfg, seed=0, mesh=mesh, chunk=16)
    rate.run(8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rate.run(48)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) / 48 * 1e3
    # Where a mesh round's time goes: one profiled chunk, as phase 7's.
    prof_rounds = 16
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        with torch.profiler.record_function("chip_smoke.mesh"):
            rate.run(prof_rounds)
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(MESH_TRACE))
    del rate
    tb = trace_breakdown(MESH_TRACE, "chip_smoke.mesh",
                         ("aiocluster_torch.draws", "aiocluster_torch.sim_step"))
    host = {k: v / prof_rounds for k, v in tb["host_ms"].items()}
    dev_ms = {k: v / prof_rounds for k, v in tb["device_ms"].items()}
    busy = tb["device_busy_ms"] / tb["window_ms"] if tb["device_events"] else None
    if busy is None:
        log("headline_mesh", "the profiler recorded no device activity: busy share not measured")
    else:
        log("headline_mesh", f"{prof_rounds} profiled rounds: {tb['window_ms'] / prof_rounds:.3f} "
            f"ms/round under the profiler; device busy {busy:.1%} "
            f"({tb['device_busy_ms'] / prof_rounds:.3f} ms/round); host per round: draws "
            f"{host['aiocluster_torch.draws']:.3f} ms, sim_step "
            f"{host['aiocluster_torch.sim_step']:.3f} ms; device per round: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(dev_ms.items())))
    m8cfg = dataclasses.replace(cfg, pallas_variant="m8")
    sim8, conv8, m8_launches, _, _ = run_to(m8cfg, dev, 0, CONVERGED_ROUND, "headline_mesh_m8",
                                            max_rounds=200, mesh=mesh)
    r8 = sim8.tick
    check(sum(v for k, v in m8_launches.items() if k.startswith("m8_pull[")) == 3 * MESH_BLOCKS * r8
          and sum(v for k, v in m8_launches.items() if k.startswith("m8_totals["))
          == 3 * MESH_BLOCKS * r8
          and m8_launches.get("fd") == MESH_BLOCKS * r8
          and not any(k.startswith("pairs_") for k in m8_launches),
          f"the m8 mesh did not run the m8 column blocks and one FD launch a block a round "
          f"({m8_launches})")
    ref = Simulator(cfg, seed=0, device=dev)
    ref.run(r8)
    check(states_equal(sim8.state, ref.state), "the m8 mesh run != the unsharded headline")
    del sim8, ref
    torch.cuda.empty_cache()
    log("headline_mesh", f"{1e3 / round_ms:.2f} rounds/s on {MESH_BLOCKS} blocks "
        f"({round_ms:.3f} ms/round, chunks of 16, 48 rounds); m8 on the mesh: round {conv8}, "
        f"fd launches {m8_launches['fd']} ({MESH_BLOCKS} a round, one at each block's "
        f"offset), field-equal; {card_line}")
    record = {"n": N, "blocks": MESH_BLOCKS, "converged_round": converged,
              "rounds_run": rounds, "round_ms": round_ms, "rounds_per_s": 1e3 / round_ms,
              "run_s": run_s, "m8_converged_round": conv8, "m8_rounds_run": r8,
              "trace_round_ms": tb["window_ms"] / prof_rounds, "device_busy_share": busy,
              "host_ms_per_round": host, "device_ms_per_round": dev_ms}
    return record, launches, m8_launches


def w_digest(blocks) -> concurrent.futures.Future:
    """The sha256 of a state's w as int8, row-major over every owner (its
    column blocks side by side), as a future: w is copied to the host a
    block of rows at a time (about 64 MB) and each block fed to one
    sha256 in the hashing thread (hashlib releases the GIL), with at most
    ``DIGEST_ROWS_HELD`` blocks on the host at once: no copy of the whole
    matrix. The card's matrix may move on as soon as this returns."""
    n = blocks[0].w.shape[0]
    step = max(1, (1 << 26) // sum(b.w.shape[1] for b in blocks))
    digest = hashlib.sha256()
    fed = collections.deque()
    for r0 in range(0, n, step):
        rows = torch.cat([b.w[r0 : r0 + step] for b in blocks], dim=1)
        check(int(rows.max()) <= 127, "w does not fit int8 for the digest")
        fed.append(HASHER.submit(digest.update, rows.to(torch.int8).cpu().numpy()))
        while len(fed) > DIGEST_ROWS_HELD:
            fed.popleft().result()
    return HASHER.submit(digest.hexdigest)


def blocks_equal_whole(blocks, w) -> bool:
    """The blocks' w side by side equals the whole matrix ``w``, compared
    a block of rows at a time."""
    step = max(1, (1 << 26) // w.shape[1])
    return all(
        torch.equal(torch.cat([b.w[r0 : r0 + step] for b in blocks], dim=1), w[r0 : r0 + step])
        for r0 in range(0, w.shape[0], step)
    )


def sampled_mesh_round_check(dev, sim, errs, leaders=NS_PAIR_LEADERS, seed=10):
    """``sampled_round_check`` for a mesh's column blocks at their own
    shape: one round's sub-exchanges of every block, chained as
    ``step_blocks`` chains them (each block's totals at its offset, held
    against ``pairs_totals_plain(owner_offset=)`` over every row, then
    summed in block order; each block's pull fed the sum), then a fourth
    whose check every row passes (the blocks' flags' min stays 1). Each
    block's pull runs on the block itself and is held over a seeded
    sample of ``leaders`` row pairs of that block
    (``pairs_pull_plain(leaders=, owner_offset=)`` on the rows put back).
    A seeded tenth of the nodes is dead and half the owners wrote a key.
    The lean profile only (w is all a pull writes); the blocks' w moves
    on. Raises each mode's max_abs_err in ``errs`` under its column-block
    key; returns the round's (key, max_abs_err) pairs."""
    cfg, blocks, n = sim.cfg, sim.blocks, sim.cfg.n_nodes
    check(not cfg.track_heartbeats and not cfg.track_failure_detector,
          "the sampled mesh round holds the lean profile")
    width = n // len(blocks)
    gen = torch.Generator(device=dev).manual_seed(seed)
    alive = torch.rand(n, generator=gen, device=dev) < 0.9
    wrote = torch.rand(n, generator=gen, device=dev) < 0.5
    mv = blocks[0].max_version + wrote.to(torch.int32)
    tick = sim.tick + 1
    run_key = prng.key(sim.seed)
    gm_all, c_all, p_all = (
        t[0] for t in prng.round_draws(run_key.to(dev), tick, 1, n, cfg.fanout)
    )
    steps = [("first", 0)] + [("middle", s) for s in range(1, cfg.fanout - 1)]
    steps += [("last", cfg.fanout - 1), ("need 0", cfg.fanout - 1)]
    ids = torch.arange(n, device=dev)
    found = []
    for name, s in steps:
        mode = LADDER_MODES["last" if name == "need 0" else name]
        p = p_all[s].long()
        valid = alive & alive[p]
        args = (gm_all[s], c_all[s], valid)
        cols = [slice(k * width, (k + 1) * width) for k in range(len(blocks))]
        mvs = [mv[sl] if mode["diag"] else None for sl in cols]
        t_key = block_totals_key(mode["diag"], "int16")
        tks, tps, t_err = [], [], 0.0
        for k, b in enumerate(blocks):
            tks.append(pairs_totals.pairs_totals(b.w, *args, mv=mvs[k], owner_offset=k * width))
            tps.append(pairs_totals.pairs_totals_plain(b.w, *args, mv=mvs[k],
                                                       owner_offset=k * width))
            t_err = max(t_err, max_abs_err(tks[-1:], tps[-1:]))
        tk, tp = gossip.reduce_blocks(tks, "sum")[0], gossip.reduce_blocks(tps, "sum")[0]
        t_err = max(t_err, max_abs_err([tk], [tp]))
        errs[t_key] = max(errs[t_key], t_err)
        del tks, tps
        key = block_key(mode, "lean int16")
        err, flags, sample_flags = 0.0, [], []
        for k, b in enumerate(blocks):
            kw = {}
            if mode["diag"]:
                kw["mv"] = mvs[k]
            if mode["check"]:
                need = torch.zeros_like(mv) if name == "need 0" else mv
                kw["check"] = (need[cols[k]], alive, alive[cols[k]])
            lead = ids[ids <= p]
            lead = lead[torch.randperm(lead.numel(), generator=gen, device=dev)[:leaders]]
            partners = p[lead]
            rows = torch.cat((lead, partners[partners != lead]))
            pre = b.w[rows]
            pull_args = (b.w, None, *args, tick * 2 * cfg.fanout + 2 * s,
                         prng.run_salt(run_key), cfg.budget)
            fk = pairs_pull.pairs_pull(*pull_args, totals=tk, owner_offset=k * width, **kw)
            torch.cuda.synchronize()
            post = b.w[rows]
            b.w[rows] = pre
            fp = pairs_pull.pairs_pull_plain(*pull_args, totals=tp, leaders=lead,
                                             owner_offset=k * width, **kw)
            torch.cuda.synchronize()
            err = max(err, max_abs_err([b.w[rows]], [post]))
            if fk is not None:
                flags.append(int(fk[0]))
                sample_flags.append(int(fp[0]))
        errs[key] = max(errs[key], err)
        found.append((f"{t_key} ({name})", t_err))
        found.append((f"{key} ({name})" + (f" flags {flags} (samples {sample_flags})"
                                           if flags else ""), err))
        if name == "need 0":
            check(min(flags) == 1, "the check flag of a passing sub-exchange is 0")
    torch.cuda.empty_cache()
    return found


def north_star_mesh(dev, card_line, errs):
    """Phase 13c: the north star on 8 column blocks of 12,544 owners on
    this card (lean_config(100_352, budget=2618), seed 1, the two-pass
    pairs form at each block's offset). Its w digests at ticks 1 and 2
    must be the record's; at tick 20 its w equals the unsharded run's
    (compared a block of rows at a time), and one chained round of the
    blocks' launches at this shape is held against the plain versions
    (``sampled_mesh_round_check``, raising ``errs``), the blocks' w then
    put back from the unsharded run's; it converges at round 209. Then
    the round rate, each block pass's time on the converged state by
    CUDA events beside its bound, launches a round and peak memory."""
    cfg = lean_config(NORTH_STAR_N, budget=2618)
    n = cfg.n_nodes
    width = n // MESH_BLOCKS
    mesh = mesh_of(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=NORTH_STAR_SEED, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pending = {}
    for tick in sorted(NORTH_STAR_DIGESTS):
        sim.run(tick - sim.tick)
        pending[tick] = w_digest(sim.blocks)
    copy_s = time.perf_counter() - t0
    sim.run(MESH_CHECK_ROUND - sim.tick)
    ref = Simulator(cfg, seed=NORTH_STAR_SEED, device=dev)
    ref.run(MESH_CHECK_ROUND)
    torch.cuda.synchronize()
    check(blocks_equal_whole(sim.blocks, ref.state.w),
          f"the mesh north star's w != the unsharded run's at tick {MESH_CHECK_ROUND}")
    t_check = time.perf_counter()
    found = sampled_mesh_round_check(dev, sim, errs)
    for k, b in enumerate(sim.blocks):  # the run's own w back (the check moved it on)
        b.w.copy_(ref.state.w[:, k * width : (k + 1) * width])
    check(blocks_equal_whole(sim.blocks, ref.state.w), "the mesh north star's w was not put back")
    check_s = time.perf_counter() - t_check
    del ref
    torch.cuda.empty_cache()
    log("north_star_mesh", f"tick {MESH_CHECK_ROUND}: w on {MESH_BLOCKS} blocks == the "
        f"unsharded run's; one chained round of the blocks' launches at ({n}, {width}), "
        f"{NS_PAIR_LEADERS} row pairs a block's pull, the totals over every row "
        f"({check_s:.1f} s): " + ", ".join(f"{k} max_abs_err={e}" for k, e in found))
    torch.cuda.reset_peak_memory_stats()  # the mesh run's own peak from here
    counters.reset()
    t0 = time.perf_counter()
    converged = sim.run_until_converged(max_rounds=400)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(counters.launches)
    rounds = sim.tick - MESH_CHECK_ROUND
    log("north_star_mesh", f"run_until_converged -> {converged} ({rounds} tracked rounds in "
        f"{run_s:.2f} s, init {init_s:.2f} s); launches {launches}; plain calls "
        f"{dict(counters.plain_calls)}; refusals {dict(counters.refusals)}")
    check(converged == NORTH_STAR_ROUND,
          f"the mesh north star converged at {converged}, expected {NORTH_STAR_ROUND}")
    check(mesh_launches_ok(launches, rounds, rounds) and not counters.plain_calls
          and not counters.fallbacks, f"the mesh north star's launches are off ({launches})")
    m = sim.metrics()
    check(bool(m["all_converged"]) and float(m["min_fraction"]) == 1.0
          and int(m["version_spread"]) == 0 and int(m["alive_count"]) == n,
          "the mesh north star's metrics disagree with the converged flag")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    digests = {tick: f.result() for tick, f in pending.items()}
    log("north_star_mesh", f"w digests at ticks 1, 2 on {MESH_BLOCKS} blocks: {digests} "
        f"(host copies fed to sha256 {copy_s:.1f} s); the record's: "
        f"{NORTH_STAR_DIGESTS}")
    check(digests == NORTH_STAR_DIGESTS, "the mesh north star's w digests differ from the record's")
    round_ms = round_rate(sim, 16)
    # Each block pass on the converged state, block 1 (owner_offset
    # 12,544), fed the blocks' summed totals: a round is 8 of each.
    blocks = sim.blocks
    gm, c, _ = prng.grouped_matching(prng.key(9), n)
    gm, c = gm.to(dev, torch.int32), c.to(dev, torch.int32)
    alive, mv = blocks[0].alive, blocks[0].max_version
    mvs = [mv[k * width : (k + 1) * width] for k in range(MESH_BLOCKS)]
    tot = gossip.reduce_blocks([
        pairs_totals.pairs_totals(b.w, gm, c, alive, mv=mvs[k], owner_offset=k * width)
        for k, b in enumerate(blocks)
    ], "sum")[0]
    w1 = blocks[1].w
    times = {}
    for diag in (True, False):
        mv1 = mvs[1] if diag else None
        times[block_totals_key(diag, "int16")] = (
            cuda_ms(lambda: pairs_totals.pairs_totals(w1, gm, c, alive, mv=mv1,
                                                      owner_offset=width), 10),
            block_totals_bound(n, width, "int16", diag),
        )
    for name in ("first", "middle", "last"):
        mm = LADDER_MODES[name]
        kw = {"mv": mvs[1]} if mm["diag"] else {}
        if mm["check"]:
            kw["check"] = (mvs[1], alive, alive[width : 2 * width])
        times[block_key(mm, "lean int16")] = (
            cuda_ms(lambda: pairs_pull.pairs_pull(
                w1, None, gm, c, alive, 1, 0x9E3779B9, cfg.budget, totals=tot,
                owner_offset=width, **kw), 10),
            block_pull_bound(n, width, "lean int16", mm),
        )
    torch.cuda.synchronize()
    del sim, blocks, w1, tot
    torch.cuda.empty_cache()
    per_round = {k: MESH_BLOCKS * (2 if "[sum]" in k else 1) for k in times}
    kernel_ms = sum(per_round[k] * ms for k, (ms, _) in times.items())
    bound_ms = sum(per_round[k] * b[0] for k, (_, b) in times.items())
    log("north_star_mesh", f"{1e3 / round_ms:.3f} rounds/s ({round_ms:.3f} ms/round over 16 "
        f"untracked rounds) on {MESH_BLOCKS} blocks; kernels {kernel_ms:.3f} ms/round by CUDA "
        f"events against a {bound_ms:.3f} ms bound ({bound_ms / kernel_ms:.1%}); "
        f"{sum(per_round.values())} launches a round; peak memory {peak_gb:.2f} GB; "
        f"{card_line}")
    for key, (ms, (b_ms, b_by)) in times.items():
        log("north_star_mesh", f"{key} at n={n}, {width} owners a block: {ms:.4f} ms "
            f"(bound {b_ms:.4f} ms by {b_by})")
    record = {
        "n": n, "blocks": MESH_BLOCKS, "seed": NORTH_STAR_SEED, "converged_round": converged,
        "digests": digests, "digest_copy_s": copy_s, "rounds_run": rounds, "run_s": run_s,
        "sampled_round_max_abs_err": dict(found), "sample_leaders": NS_PAIR_LEADERS,
        "init_s": init_s, "round_ms": round_ms, "rounds_per_s": 1e3 / round_ms,
        "kernel_ms_per_round": kernel_ms, "bound_ms_per_round": bound_ms,
        "launches_per_round": sum(per_round.values()), "peak_memory_gb": peak_gb,
    }
    return record, launches, rounds, times


def side_meshes(dev, card_line):
    """Phase 13d: 4 tracked rounds of each other rung on 8 blocks at
    N = 10,240 (lean int8, lean u4r, full shrunk: the packed block
    codec and the FD epilogue on int8 counters and the live bitmap at
    each offset), each field-equal to its unsharded run. Returns each
    run's (launches, rounds)."""
    runs = {}
    mesh = mesh_of(dev)
    for run, cfg in (("int8_mesh", lean_config(N, "int8", budget=2618)),
                     ("u4r_mesh", lean_config(N, "u4r", budget=2618)),
                     ("shrunk_mesh", full_config(N, "shrunk", budget=2618))):
        counters.reset()
        sim = Simulator(cfg, seed=1, mesh=mesh)
        sim.run_until_converged(max_rounds=4)
        torch.cuda.synchronize()
        launches = dict(counters.launches)
        check(mesh_launches_ok(launches, 4, 4, fd=cfg.track_failure_detector)
              and not counters.plain_calls and not counters.fallbacks,
              f"{run} did not run 2 launches a block a sub-exchange ({launches})")
        ref = Simulator(cfg, seed=1, device=dev)
        ref.run(4)
        check(states_equal(sim.state, ref.state), f"{run} != its unsharded run after 4 rounds")
        log("side_mesh", f"{run}: 4 tracked rounds on {MESH_BLOCKS} blocks == unsharded; "
            f"launches {launches}")
        runs[run] = (launches, 4)
        del sim, ref
    torch.cuda.empty_cache()
    return runs


def column_block_entries(errs, times, runs):
    """The kernel-line entries of the column-block modes: timed at
    N = 10,240 (block 1 of 8) beside the plain versions and the bounds,
    the north star's at its width (``times`` of phase 13c under the
    ``main`` key), with the launches of each rung's mesh run (``runs``:
    name -> (launches, rounds); each must be > 0)."""
    entries = []
    fd_line = "aiocluster_tpu/ops/pallas_fd.py:51"
    for name, (ms, plain_ms, b) in times["blocks"].items():
        if name == "fd cols":
            run, launch_key, kernel, line = "headline_mesh_m8", "fd", "fd", fd_line
        else:
            rung = name.split(" cols ")[1]
            launch_key = name.split(" cols ")[0]
            kernel = launch_key.split("[")[0]
            run = BLOCK_RUNS[rung]
            line = "aiocluster_tpu/ops/pallas_pull.py:" + ("899" if kernel == "pairs_totals"
                                                            else "490")
        launches, rounds = runs[run]
        check(launches.get(launch_key, 0) > 0, f"{name} was not launched on {run}")
        extra = {}
        main = times["main"].get(name)
        msg = f"{name}: {ms:.4f} ms at n={N}, {N // MESH_BLOCKS} owners a block (bound {b[0]:.4f} ms by {b[1]}; plain {plain_ms:.3f} ms)"
        if main is not None:
            extra = dict(n_main=NORTH_STAR_N, ms_main=main[0], bound_ms_main=main[1][0])
            msg += f"; {main[0]:.4f} ms at n={NORTH_STAR_N} (bound {main[1][0]:.4f} ms)"
        log("time", msg + f"; {launches[launch_key]} launches on {run}")
        entries.append(dict(
            name=name, route="cuda", source=f"aiocluster_torch/ops/csrc/{kernel}.cu",
            replaces=line, launches=launches[launch_key],
            launches_per_round=launches[launch_key] / rounds, max_abs_err=errs[name],
            ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None,
            path=run, n=N, n_cols=N // MESH_BLOCKS, owner_offset=N // MESH_BLOCKS, **extra,
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
    m8_smem = pairs_pull.compiled_static_smem("m8_pull")
    log("build", f"m8_kernel static shared memory {m8_smem} bytes (its width check, the "
        f"pairs kernel's, assumes {pairs_pull.STATIC_SMEM})")
    check(m8_smem == pairs_pull.STATIC_SMEM,
          "the m8 kernel's static shared memory disagrees with its width check")
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
        if name.startswith(("m8_", "pairs_")):
            check(regs and spills == 0 and stacks == 0,
                  f"{name}.cu built with a spill or a stack frame")

    pull_err = check_pull_kernel(dev)
    two_pass_errs = check_two_pass_kernels(dev)
    fd_err, fd_fresh, fd_params = check_fd_kernel(dev)
    m8_errs = check_m8_kernels(dev)

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

    # Phase 9b: the headline config pinned to m8.
    head_m8, head_m8_launches = headline_m8(dev, card_line)

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
            (OPS_PAIR + (OPS_FD * 2 if m["fd"] else 0)) * N * N / 2,
        )
        kernels.append(dict(
            name=f"pairs_pull[{name}]", route="cuda",
            source="aiocluster_torch/ops/csrc/pairs_pull.cu",
            replaces="aiocluster_tpu/ops/pallas_pull.py:490",
            launches=main_launches.get(mode_keys[name], 0),
            launches_per_round=main_launches.get(mode_keys[name], 0) / rounds_run,
            max_abs_err=pull_err,
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
        launches=head_m8_launches["fd"],
        launches_per_round=head_m8_launches["fd"] / head_m8["rounds_run"],
        max_abs_err=fd_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, path="headline_m8", launches_seam=seam_fd_launches,
    ))
    log("time", f"fd: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; plain {plain_ms:.3f} ms)")

    # Phase 8: the two-pass path, the north star: its kernels against
    # their plain versions at its width, its run, then its kernels' times
    # at N = 10,240 (beside their plain versions) and at its own width.
    check_two_pass_full_width(dev, two_pass_errs)
    ns, ns_launches, ns_times, ns_two_pass = north_star(dev, card_line)

    kernels += two_pass_kernel_entries(dev, two_pass_errs, *ns_two_pass, ns_times)
    cluster_runs = {"north_star": (ns_launches, ns["rounds_run"])}
    cluster_times = dict(ns_times)

    # Phase 9c-e: the north star pinned to m8, then the int16 experiment.
    ns_m8, ns_m8_launches, ns_m8_times = north_star_m8(dev, card_line, m8_errs)
    experiment = i16_experiment(dev)
    kernels += m8_kernel_entries(
        dev, m8_errs, head_m8_launches, head_m8["rounds_run"], ns_m8_launches,
        ns_m8["rounds_run"], ns_m8_times, experiment,
    )

    # Phase 10: the memory ladder's rungs: their kernels against the plain
    # versions, then each rung's run at full width (counters at 0 just
    # before each, read just after), then their times.
    ladder_errs = check_ladder_kernels(dev)
    check_ladder_full_width(dev, ladder_errs)
    ns8, ns8_m8, ns8_times, ns8_other = lean_int8_north_star(dev, card_line)
    u4, u4_launches, u4_rounds, u4_times, u4_other = lean_u4r_north_star(dev, card_line)
    wide, wide_launches, wide_rounds, wide_times, wide_other = widest_u4r(
        dev, card_line, ladder_errs)
    full, full_runs, full_times = full_ladder(dev, card_line)
    head_deep = headline_deep_parity(dev)
    runs = int8_side_paths(dev, card_line)
    runs.update(
        north_star_int8=ns8[1:], north_star_int8_m8=ns8_m8[1:],
        north_star_u4r=(u4_launches, u4_rounds), widest_u4r=(wide_launches, wide_rounds),
        north_star_int8_other=ns8_other, north_star_u4r_other=u4_other,
        widest_u4r_other=wide_other,
        full_deep=full_runs["deep"], full_shrunk=full_runs["shrunk"],
    )
    kernels += ladder_entries(dev, ladder_errs, runs,
                              {**ns8_times, **u4_times, **wide_times, **full_times})

    # Phase 11: sweeps, the lane lift of the pairs kernels: every lane mode
    # against its plain version, then each sweep from counters at 0 (read
    # just after), then the lane modes' times.
    lane_errs = check_lane_kernels(dev)
    head_sweep, head_sweep_launches = headline_sweep(dev, card_line)
    fanout_sweep(dev, card_line)
    ns_pair, ns_pair_launches, ns_pair_times = north_star_pair(dev, card_line, lane_errs)
    sweep_runs = side_sweeps(dev, card_line)
    sweep_runs.update(
        sweep_headline=(head_sweep_launches, head_sweep["rounds_run"]),
        sweep_north_star=(ns_pair_launches, ns_pair["rounds_run"] - NS_PAIR_CHECK_ROUND),

    )
    sweep_counts = sweep_counters(dev, card_line)
    kernels += lane_entries(dev, lane_errs, sweep_runs, headline_lane_times(dev), ns_pair_times)

    # Phase 12 (C2): the full profile past the staged width.
    c2, c2_run = full_past_staged(dev, card_line, ladder_errs)

    # The cluster-staged modes of every run whose form is the cluster frame.
    cluster_runs.update(
        north_star_int8_other=ns8_other, widest_u4r_other=wide_other,
        full_shrunk=runs["full_shrunk"], full_past_staged=c2_run,
        north_star_pair=(ns_pair_launches, ns_pair["rounds_run"] - NS_PAIR_CHECK_ROUND),
    )
    for t in (ns8_times, u4_times, wide_times, full_times):
        cluster_times.update({kk: v[1:] for kk, v in t.items()})
    cluster_times.update(ns_pair_times)
    cluster_errs = collections.defaultdict(float)
    for src in (two_pass_errs, ladder_errs, lane_errs):
        for kk, e in src.items():
            cluster_errs[kk] = max(cluster_errs[kk], e)
    kernels += cluster_entries(dev, cluster_errs, cluster_runs, cluster_times)

    # Phase 13: the owner-sharded round on 8 column blocks of this card:
    # every column-block mode against its plain version and the whole
    # width, then each mesh run from counters at 0 (read just after).
    block_errs, block_times = check_column_block_kernels(dev, fd_fresh, fd_params)
    head_mesh, head_mesh_launches, head_mesh_m8_launches = headline_mesh(dev, card_line)
    ns_mesh, ns_mesh_launches, ns_mesh_rounds, ns_mesh_times = north_star_mesh(
        dev, card_line, block_errs)
    mesh_runs = side_meshes(dev, card_line)
    mesh_runs.update(
        headline_mesh=(head_mesh_launches, head_mesh["rounds_run"]),
        headline_mesh_m8=(head_mesh_m8_launches, head_mesh["m8_rounds_run"]),
        north_star_mesh=(ns_mesh_launches, ns_mesh_rounds),
    )
    kernels += column_block_entries(block_errs, {"blocks": block_times, "main": ns_mesh_times},
                                    mesh_runs)
    log("done", f"{time.perf_counter() - t_all:.1f} s in all; converged at "
        f"round {converged}; {rounds_per_s:.2f} rounds/s; the north star converged "
        f"at round {ns['converged_round']}, {ns['rounds_per_s']:.3f} rounds/s; m8: "
        f"headline {head_m8['converged_round']} at {head_m8['rounds_per_s']:.2f} "
        f"rounds/s, north star {ns_m8['converged_round']} at "
        f"{ns_m8['rounds_per_s']:.3f} rounds/s; ladder: int8 north star "
        f"{ns8[0]['converged_round']} (m8 {ns8_m8[0]['converged_round']}), u4r "
        f"{u4['converged_round']} (int16 keys 15: {u4['int16_keys15_round']}), full deep "
        f"{full['deep']['converged_round']}, shrunk {full['shrunk']['converged_round']}, "
        f"widest u4r {wide['rounds_per_s']:.3f} rounds/s at {wide['peak_memory_gb']:.1f} GB; "
        f"sweeps: headline ladder {head_sweep['rounds_to_convergence']} at "
        f"{head_sweep['sim_sweep_lane_rounds_per_sec']:.2f} lane-rounds/s, north-star pair "
        f"{ns_pair['rounds_to_convergence']} at {ns_pair['round_ms']:.3f} ms a round; "
        f"full_config({C2_N}) {c2['round_ms']:.3f} ms a round at {c2['peak_memory_gb']:.1f} GB; "
        f"{MESH_BLOCKS} column blocks: headline {head_mesh['converged_round']} at "
        f"{head_mesh['round_ms']:.3f} ms a round (m8 {head_mesh['m8_converged_round']}), north "
        f"star {ns_mesh['converged_round']} at {ns_mesh['round_ms']:.3f} ms a round")

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
        "headline_m8": head_m8,
        "north_star_m8": ns_m8,
        "i16_experiment": {a: {"ms_chained": t, "max_abs_err": e}
                           for a, (t, e) in experiment.items()},
        "ladder": {
            "north_star_int8": ns8[0], "north_star_int8_m8": ns8_m8[0],
            "north_star_u4r": u4, "widest_u4r": wide, "full_deep": full["deep"],
            "full_shrunk": full["shrunk"], "headline_deep_rounds": head_deep,
            "build_s": _build.build_seconds,
        },
        "sweeps": {
            "headline_phi_ladder": head_sweep, "north_star_pair": ns_pair,
            "counters": sweep_counts,
        },
        "full_past_staged": c2,
        "mesh": {"headline": head_mesh, "north_star": ns_mesh},
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
