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

Then the single-pass m8 path (``pallas_variant="m8"``), whose pull runs
the pairs pull's frame out of place and takes its forms by the same rule
("m8" staged by one CTA, "m8_cluster" on a cluster of CTAs, "m8_two_pass"
fed the m8 totals): the m8 pull and the m8 totals pass are held
bit-equal to their plain versions (and to the pairs kernel and the pairs
totals, the same functions) at N = 10,240 in every mode, int16 and
int32, staged on clusters of 1, 2, 4 and 8 CTAs and fed the totals
(also where a row is valid and its partner is not, and on self-matched
rows), with the inputs left untouched; the headline config pinned to m8
runs to convergence (round 24, one pull launch a sub-exchange and the
standalone FD kernel once a round), equals the pairs path after 4
rounds, and runs 4 rounds again in the other form; the north star pinned
to m8 (on 4-CTA clusters) runs 100 rounds, its pulls in both forms are
held against their plain versions at that width, the reference's
8-shard computation is done block by block on the card (8 column blocks
of 12,544 owners: their totals sum to the whole width's and their
outputs side by side are the whole width's), the run goes on to
convergence (round 209) and runs again in the two-pass form. Last, the
reference's int16 experiment (benchmarks/records/_i16_kernel_experiment.py)
on Hopper: the m8 pull's int16 variants bit-exact against the int32
kernel on every cluster size and timed as the experiment times them.

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

Then the round's remaining semantics (phase 14), each run from counters
at 0: the headline under churn (5% deaths, 20% revivals, one write a
round, seed 0) on the pairs kernels, 16 rounds equal round by round to
the plain round on the card, no fallback, then the next round's three
pull modes held against their plain versions and timed on the run's
own state (the kernel line's ``pairs_pull[churn ...]`` entries);
BASELINE config 4 (10,000
nodes on ``scale_free(attach=3)``, the choice path) to its converged
round, the reference's 22, with ``fd.cu`` every round (held against its
plain version on the run's state and timed there); BASELINE config 3
(the view draw, churn and the lifecycle) for 200 rounds at 1,000 nodes
and 4 at 10,240; ``lean_config(32_768, budget=2618, pairing="choice")``
at seed 1 to round 45 (the reference's certified round); the permutation
pairing and the greedy budget at 10,240; and the masked categorical and
the view draw timed at 10,240. Ticks 1-3 of every run (and tick 200 of
config 3) are held to the sha256 of the reference's state, field by
field (``REF_DIGESTS``, made by ``tools/torch_reference_digests.py``).

Then fault plans and heterogeneity (phase 15), each run from counters at
0, all at 10,240 nodes: ``benchmarks/fault_bench.py``'s sim arm
(split_brain(3) healing at tick 48, the lean profile, seed 0) unconverged
at the heal and converged at the reference's round; the headline under
flaky_links(0.2) (plain pulls, ``fd.cu`` a round, timed on the run's
state) and with cadence classes (on the pairs kernels, the cadence in
their pair validity: 3 launches a round and no plain pull; each mode on
the run's next round against its plain version; then pinned to m8) to
the reference's converged rounds; ticks 1-4 of an amnesiac rolling
restart, ticks 1-3 of the byzantine storm with the lifecycle, of a
quarantined choice draw and of zone bias with WAN classes; 3-lane
``fault_seeds``, ``byz_frac`` and cadence sweeps (every lane equal to
its sequential run); fault_bench's arm and the cadence headline on 8
column blocks (equal to the unsharded runs). ``python3 chip_smoke.py
--c4`` runs only ``lean_config(65_536, budget=2618, pairing="choice")``
at seed 1 to the reference's certified round 81 (ROADMAP C4) and prints
its peak memory.

Then the simulator's user surface (phase 16), each run from counters at
0, at 10,240 nodes unless noted: the headline run to tick 8 and saved
(``Simulator.save``; the file's bytes and the seconds to save and load),
resumed on the CPU for 2 rounds (equal to the card's tick 10), on 8
column blocks (converged at 24, the gathered state equal to the
uninterrupted run's) and on the card (ticks 9-11 equal to the
reference's own save and resume, ``REF_DIGESTS["resume_headline"]``;
converged at 24, every field equal to the uninterrupted run's; the
save runs on a thread of its own, started before phase 14, beside the
card's work); a
3-lane phi sweep at 2,048 nodes (budget 512) saved at tick 8 and
resumed, each lane equal to the uninterrupted sweep and
``SweepSimulator(metrics=)``'s gauges equal to ``result()``; the headline with a registry and a trace
writer at stride 4 (converged at 24; its series ticks 4-24 ending at
``metrics()``; one trace event a sample; its pull modes on its state
against their plain versions; ms a round without and with telemetry
interleaved, and one ``metrics_sample`` by CUDA events) and the north
star at stride 64 (209; its peak beside phase 8's); the headline under
``AIOCLUSTER_TPU_PALLAS_VARIANT=m8`` (the m8 pulls and ``fd.cu``, 24; a
bad value raises); ``SimCluster`` at 10,240 x 16 keys (24; a write
script whose state digests equal the reference's
``REF_DIGESTS["simcluster_headline"]``, 512 replica views equal to
their owners', compaction of every entry, 4 nodes killed out of a live
view and revived, ms a step); and BASELINE config 1's 3-node cluster
(which phases ran plain). Each resumed and SimCluster run's next round
through the kernels equals the plain round from the same state.

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
import os
import subprocess
import sys
import tempfile
import time
import unittest.mock
from pathlib import Path

import numpy as np
import torch

from aiocluster_torch import (
    HEADLINE_BUDGET, MetricsRegistry, SimCluster, SimConfig, Simulator, SweepSimulator,
    TraceWriter, full_config, headline_config, lean_config,
)
from aiocluster_torch.obs import read_trace
from aiocluster_torch.ops import (
    _build, counters, gossip, m8_pull, m8_totals, pairs_pull, pairs_totals, prng,
)
from aiocluster_torch.ops import fd as fd_mod
from aiocluster_torch.ops.fd import FdParams
from aiocluster_torch.faults import (
    FaultPlan, LinkFault, NodeSet, byzantine_storm, flaky_links, rolling_restart, split_brain,
)
from aiocluster_torch.faults import sim as fsim
from aiocluster_torch.models import Heterogeneity
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
    "headline_m8": ("m8", 1),
    "headline_m8_other": ("m8_two_pass", 1),
    "north_star_m8": ("m8_cluster", 4),
    "north_star_m8_other": ("m8_two_pass", 1),
    "north_star_int8_m8": ("m8_two_pass", 1),
    "north_star_int8_m8_other": ("m8_cluster", 2),
    "headline_int8_m8": ("m8", 1),
    "lean_int8_m8_staged": ("m8", 1),
}
COLUMN_BLOCKS = 8  # the reference's certified north-star mesh: 8 shards
TRACE_PATH = Path(__file__).resolve().parent / "build" / "chip_smoke_trace.json"
NORTH_STAR_TRACE = TRACE_PATH.with_name("chip_smoke_trace_north_star.json")
SWEEP_TRACE = TRACE_PATH.with_name("chip_smoke_trace_sweep.json")
MESH_TRACE = TRACE_PATH.with_name("chip_smoke_trace_mesh.json")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Integer/float operations per element, counted from the kernel source:
# per FD element ~22. The totals pass: per column of a pair 2 compares, 2
# subtracts, 2 adds. Both pulls (the pairs pull, and since its redesign
# the m8 pull in the same frame) take one advance per column pair: the
# receiving direction and its deficit (3), one hash and dither (13), one
# advance (7), and each row's heartbeat absorb (3).
OPS_FD, OPS_TOTALS = 22, 6
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
    if not gossip.kernel_pull_form(cfg)[0].endswith("two_pass"):
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
    """The launch key of a pull in ``form`` on clusters of ``k`` (an m8
    form's: the m8 pull's)."""
    two_pass = form.endswith("two_pass")
    if form in gossip.M8_FORMS:
        return m8_pull.counter_key(diag, two_pass, cluster=not two_pass and k > 1)
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
    gm_all, c_all, p_all = matchings(run_key.to(dev), tick, dataclasses.replace(cfg, fanout=4))
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


def matchings(run_key, tick, cfg):
    """The grouped matchings (gm, c, p) of the round at ``tick`` of
    ``cfg``, each (fanout, ...) (the first round of ``chunk_draws``)."""
    draws = prng.chunk_draws(run_key, tick, 1, cfg)
    return draws.gm[0], draws.c[0], draws.p[0]


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


M8_CLUSTERS = (1, 2, 4, 8)


def m8_bytes(n, n_local, wsize, hsize, *, diag, totals):
    """Bytes one m8 pull must move, which this design moves (each row
    pair read once and both output rows written once): w (and hb;
    ``hsize`` 0 when lean) read and written once, and the vectors."""
    mat = n * n_local
    b = 2 * mat * (wsize + hsize) + n * (4 + 4 + 1)
    if totals:
        b += n * 4
    if diag:
        b += n_local * 4 * (2 if hsize else 1)
    return b


def m8_pull_bound(n, n_local, wsize, hsize, *, diag, totals):
    """(ms, bound by) of one m8 pull: its bytes (``m8_bytes``) and one
    advance per column pair."""
    return bound(m8_bytes(n, n_local, wsize, hsize, diag=diag, totals=totals),
                 (OPS_PAIR if hsize else OPS_PAIR_LEAN) * n * n_local / 2)


def m8_totals_bytes(n, n_local, wsize, *, diag):
    """Bytes the m8 totals pass moves: w read once (this design visits
    each pair once, so its traffic is the function's bound), the totals
    written, the matching, valid and (diag) mv read."""
    return n * n_local * wsize + n * (4 + 4 + 1) + (n_local * 4 if diag else 0)


def self_matched(gm, c):
    """The grouped matching (gm, c) with groups 0 and 1 matched to
    themselves (group 0's rows each to itself, group 1's rows r <-> r + 4)
    and their old partners to each other."""
    gm, c = gm.clone(), c.clone()
    a, b = int(gm[0]), int(gm[1])
    if a != 1:
        gm[a], gm[b] = b, a
        c[min(a, b)], c[max(a, b)] = 3, 5
    gm[0], gm[1] = 0, 1
    c[0], c[1] = 0, 4
    return gm, c


def m8_case(n, wdt, seed, dev, *, diag, lean, asymmetric=False):
    """Random operands of one m8 sub-exchange in the ranges a run sees,
    drawn on the card from ``seed``, with a tenth of the nodes dead
    (``lean``: no heartbeat matrix; ``asymmetric``: a tenth of the rows'
    valid flipped, so that some rows are valid where their partner is
    not, and groups 0 and 1 self-matched). Returns a factory of fresh
    copies of w and hb, so every version starts from the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    w = draw(0, 17, (n, n)).to(wdt)
    hb = None if lean else draw(0, 40, (n, n)).to(wdt)
    alive = torch.rand(n, generator=gen, device=dev) < 0.9
    gm, c, _ = prng.grouped_matching(prng.key(seed), n)
    if asymmetric:
        gm, c = self_matched(gm, c)
    p = prng.rows_of_groups(gm.long(), c.long())
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
    staged on clusters of 1, 2, 4 and 8 CTAs and fed the totals, half the
    cases with asymmetric valid and self-matched rows, each against the
    plain version (itself held against the pairs kernel on a copy of the
    same operands) and with its inputs left untouched. Returns the
    max_abs_err of each launch key."""
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
        for i, (lean, diag) in enumerate((l, d) for l in (False, True) for d in (True, False)):
            asym = i % 2 == 1
            fresh = m8_case(N, wdt, 90 + i, dev, diag=diag, lean=lean, asymmetric=asym)
            ops, untouched, staged = fresh(), fresh(), fresh()
            want = call_m8(m8_pull.m8_pull_plain, ops)
            call_pull(pairs_pull.pairs_pull, staged)
            torch.cuda.synchronize()
            check(max_abs_err(want, [staged["w"]] + ([] if lean else [staged["hb"]])) == 0.0,
                  "the m8 plain version disagrees with the pairs kernel")
            del staged
            tot = m8_totals.m8_totals(ops["w"], ops["gm"], ops["c"], ops["valid"],
                                      mv=ops.get("mv"))
            found = []
            for k in (*M8_CLUSTERS, None):  # None: fed the totals
                kw = {"totals": tot} if k is None else {"cluster": k}
                got = call_m8(m8_pull.m8_pull, ops, **kw)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                key = m8_pull.counter_key(diag, k is None, cluster=k is not None and k > 1)
                errs[key] = max(errs[key], err)
                found.append(f"k={k or 'totals'} {err}")
                check(err == 0.0, f"{key} on clusters of {k} disagrees")
                del got
            check(torch.equal(ops["w"], untouched["w"])
                  and (lean or torch.equal(ops["hb"], untouched["hb"])),
                  "the m8 pull wrote its inputs")
            log("m8", f"n={N} {wdt} {'lean' if lean else 'hb'} diag={diag}"
                f"{' asymmetric valid, self-matched rows' if asym else ''}: max_abs_err "
                f"against the plain version (= the pairs kernel) " + ", ".join(found))
            del ops, untouched, want, tot
    return errs


def headline_m8(dev, card_line):
    """Phase 9b: the headline config pinned to m8 runs to convergence in
    its form (``RUN_FORMS``: staged by one CTA a pair, one launch a
    sub-exchange, the diagonal refresh on the first) and the standalone
    FD kernel (one launch a round), with no plain call: round 24, the
    pairs path's. Then 4 rounds of it equal 4 rounds of the pairs path on
    every state tensor, and the round rate is timed as the pairs path's
    is. Then the same in the other form (``other_form``: two-pass, from
    counters at 0): to convergence (24), 4 rounds equal to the pairs
    path's, the round rate."""
    cfg = dataclasses.replace(headline_config(), pallas_variant="m8")
    form, k = expect_form(cfg, dev, "headline_m8")
    counters.reset()
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=0, device=dev)
    converged = sim.run_until_converged(max_rounds=200)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, plain = dict(counters.launches), dict(counters.plain_calls)
    rounds = sim.tick
    log("headline_m8", f"pallas_variant='m8', {form} on clusters of {k}: run_until_converged "
        f"-> {converged} after {rounds} rounds ({run_s:.2f} s incl. setup); launches "
        f"{launches}; plain calls {plain}")
    check(converged == CONVERGED_ROUND,
          f"headline m8 converged at {converged}, expected {CONVERGED_ROUND}")
    check(counters.kernel_launches("m8_pull") == 3 * rounds
          and launches.get(form_key(form, k, diag=True)) == rounds and launches.get("fd") == rounds
          and counters.kernel_launches("pairs_pull") == 0 and not plain,
          "headline m8 did not run 3 m8 pulls and 1 FD kernel a round")
    m = sim.metrics()
    check(bool(m["all_converged"]) and float(m["min_fraction"]) == 1.0
          and np.isfinite(float(m["mean_fraction"])) and int(m["fd_false_positives"]) >= 0,
          "headline m8 metrics disagree with the converged flag")
    del sim
    b = Simulator(headline_config(), seed=0, device=dev)
    b.run(4)

    def four_rounds_and_rate(what):
        a = Simulator(cfg, seed=0, device=dev)
        a.run(4)
        torch.cuda.synchronize()
        check(states_equal(a.state, b.state), f"4 rounds of the {what} path != the pairs path")
        del a
        sim = Simulator(cfg, seed=0, device=dev, chunk=16)
        sim.run(8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(48)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 48 * 1e3

    round_ms = four_rounds_and_rate("m8")
    log("headline_m8", "4 rounds: m8 path == pairs path on every state tensor")
    with other_form(cfg) as (other, k_other):
        expect_form(cfg, dev, "headline_m8_other")
        timed = {}
        sim, conv2, other_launches, _, _ = run_to(cfg, dev, 0, CONVERGED_ROUND,
                                                  "headline_m8_other", timed=timed)
        other_rounds = sim.tick
        check(counters.kernel_launches("m8_totals") == 3 * other_rounds
              and other_launches.get(form_key(other, k_other, diag=True)) == other_rounds,
              "headline m8 in the other form did not take both passes a sub-exchange")
        del sim
        other_round_ms = four_rounds_and_rate("m8 two-pass")
    del b
    log("headline_m8", f"{1e3 / round_ms:.2f} rounds/s at N={N} ({round_ms:.3f} ms/round); "
        f"the other form ({other}) converged at {conv2}, 4 rounds == the pairs path, "
        f"{other_round_ms:.3f} ms/round; {card_line}")
    record = {"n": N, "seed": 0, "form": form, "cluster": k, "converged_round": converged,
              "rounds_run": rounds, "round_ms": round_ms, "rounds_per_s": 1e3 / round_ms,
              "other": {"form": other, "cluster": k_other, "converged_round": conv2,
                        "round_ms": other_round_ms, "run_round_ms": timed["round_ms"]}}
    return record, launches, (other_launches, other_rounds)


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
    gm, c, p = (t[s] for t in matchings(run_key.to(dev), tick, sim.cfg))
    salt = tick * 2 * sim.cfg.fanout + 2 * s
    return gm, c, alive & alive[p], mv, salt, prng.run_salt(run_key)


def check_m8_forms_full_width(dev, sim, errs, rung=""):
    """The m8 pulls at the simulator's width in both forms, on its state:
    the first sub-exchange of the next round (refresh) and a later one's,
    each from the state's w (the kernels never write it) against the plain
    version: staged on the cluster the rule takes for the width (its own
    or its other form), and the two-pass form (the m8 totals held too).
    Raises each launch key's max_abs_err in ``errs`` (names suffixed with
    `` {rung}`` where given); returns the (key, max_abs_err) pairs."""
    w, budget = sim.state.w, sim.cfg.budget
    k = pairs_pull.cluster_size(w.shape[1], w.element_size())
    sfx = f" {rung}" if rung else ""
    found = []
    for s, diag in ((0, True), (1, False)):
        gm, c, valid, mv, salt, run_salt = m8_subexchange(dev, sim, 8, s)
        mv = mv if diag else None
        args = (gm, c, valid, salt, run_salt, budget)
        wp = m8_pull.m8_pull_plain(w, None, *args, mv=mv)
        wk = m8_pull.m8_pull(w, None, *args, mv=mv, cluster=k)
        torch.cuda.synchronize()
        c_key = m8_pull.counter_key(diag, cluster=k > 1) + sfx
        found.append((c_key, max_abs_err([wk], [wp])))
        del wk
        tk = m8_totals.m8_totals(w, gm, c, valid, mv=mv)
        tp = m8_totals.m8_totals_plain(w, gm, c, valid, mv=mv)
        found.append((m8_totals.counter_key(diag) + sfx, max_abs_err([tk], [tp])))
        wk = m8_pull.m8_pull(w, None, *args, mv=mv, totals=tk)
        torch.cuda.synchronize()
        found.append((m8_pull.counter_key(diag, True) + sfx, max_abs_err([wk], [wp])))
        log("m8_full_width", f"n={w.shape[0]}{sfx} sub-exchange {s}: "
            + ", ".join(f"{kk} max_abs_err={e}" for kk, e in found[-3:])
            + f" (totals sum {float(tk.double().sum()):.0f}, max {float(tk.max()):.0f})")
        del wk, wp, tk, tp
    torch.cuda.empty_cache()
    for key, e in found:
        errs[key] = max(errs[key], e)
    check(all(e == 0.0 for _, e in found), f"an m8 pull at n={w.shape[0]}{sfx} disagrees")
    return found


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
    check(t_err == 0.0 and err == 0.0, "the m8 column blocks disagree with the whole width")
    del whole
    torch.cuda.empty_cache()


def m8_form_times(w, alive, mv, budget, k, wsize, rung=""):
    """A lean m8 round's passes at ``w``'s width by CUDA events, on the
    same state (read only): the pull staged on clusters of ``k`` CTAs, and
    the two-pass form's totals pass and pull fed them, each with and
    without the refresh. Returns name -> (ms, (bound ms, bound by)) (names
    the launch keys, suffixed with `` {rung}`` where given) and each
    form's (ms, bound) a round (3 sub-exchanges: one with the refresh)."""
    n = w.shape[0]
    sfx = f" {rung}" if rung else ""
    gm, c, _ = prng.grouped_matching(prng.key(9), n)
    gm, c = gm.to(w.device, torch.int32), c.to(w.device, torch.int32)
    tot = m8_totals.m8_totals(w, gm, c, alive, mv=mv)
    args = (gm, c, alive, 1, 0x9E3779B9, budget)
    times, per = {}, {}
    for diag in (True, False):
        mvk = mv if diag else None
        for key, fn, b, form in (
            (m8_totals.counter_key(diag),
             lambda: m8_totals.m8_totals(w, gm, c, alive, mv=mvk),
             bound(m8_totals_bytes(n, n, wsize, diag=diag), OPS_TOTALS * n * n / 2), "two_pass"),
            (m8_pull.counter_key(diag, True),
             lambda: m8_pull.m8_pull(w, None, *args, mv=mvk, totals=tot),
             m8_pull_bound(n, n, wsize, 0, diag=diag, totals=True), "two_pass"),
            (m8_pull.counter_key(diag, cluster=k > 1),
             lambda: m8_pull.m8_pull(w, None, *args, mv=mvk, cluster=k),
             m8_pull_bound(n, n, wsize, 0, diag=diag, totals=False), "staged"),
        ):
            times[key + sfx] = (cuda_ms(fn, 5), b)
            per[key + sfx] = (form, 1 if diag else 2)
    torch.cuda.synchronize()
    rounds = {}
    for form in ("staged", "two_pass"):
        rounds[form] = (sum(t[0] * per[kk][1] for kk, t in times.items() if per[kk][0] == form),
                        sum(t[1][0] * per[kk][1] for kk, t in times.items()
                            if per[kk][0] == form))
    return times, rounds


def north_star_m8(dev, card_line, errs):
    """Phase 9c-d: the north star pinned to m8 in its form (``RUN_FORMS``:
    each row pair staged by a cluster of CTAs, 3 m8 pull launches a round,
    no totals pass, no plain call). It runs ``FULL_WIDTH_ROUNDS`` rounds;
    the m8 pulls in both forms are held against their plain versions on
    that state and the column-block checks read it (their launches are
    not the run's); then it runs on to convergence, which must be round
    209. The round rate is timed over 16 more rounds and each pass at this
    width in both forms with CUDA events. Last, the same run in the other
    form (two-pass, from counters at 0) to 209, its wall time a round
    beside the run's. Returns the record, the run's launches, the
    per-key times and the other form's (launches, rounds)."""
    cfg = lean_config(NORTH_STAR_N, budget=2618, pallas_variant="m8")
    n = cfg.n_nodes
    form, k = expect_form(cfg, dev, "north_star_m8")
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
    t1 = time.perf_counter()
    found = check_m8_forms_full_width(dev, sim, errs)
    log("north_star_m8", f"both forms' m8 pulls equal their plain versions on the north "
        f"star's state {sim.tick} rounds in ({time.perf_counter() - t1:.1f} s): "
        + ", ".join(f"{kk} {e}" for kk, e in found))
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
        f"{NORTH_STAR_SEED}, {form} on clusters of {k}: converged at round {converged} after "
        f"{rounds} rounds in {run_s:.2f} s of rounds (init {init_s:.2f} s); launches "
        f"{launches}; plain calls {plain}; refusals {dict(counters.refusals)}")
    check(converged == NORTH_STAR_ROUND,
          f"north star m8 converged at {converged}, expected {NORTH_STAR_ROUND}")

    def total(kernel):
        return sum(v for kk, v in launches.items() if kk.startswith(kernel + "["))

    check(total("m8_totals") == 0 and total("m8_pull") == 3 * rounds
          and launches.get(form_key(form, k, diag=True)) == rounds
          and total("pairs_pull") == 0 and not plain and not counters.refusals,
          "the north star m8 did not run every sub-exchange as one m8 pull launch")
    m = sim.metrics()
    check(bool(m["all_converged"]) and float(m["min_fraction"]) == 1.0
          and np.isfinite(float(m["mean_fraction"])) and int(m["alive_count"]) == n,
          "north-star m8 metrics disagree with the converged flag")

    win = 16
    round_ms = round_rate(sim, win)
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

    # Each pass at this width in both forms, on the converged state.
    times, form_rounds = m8_form_times(sim.state.w, sim.state.alive, sim.state.max_version,
                                       cfg.budget, k, 2)
    del sim
    torch.cuda.empty_cache()
    # The same run in the other form, from counters at 0, stepped as the
    # run above is (``FULL_WIDTH_ROUNDS`` untracked rounds, then tracked
    # ones), so that the two whole runs' ms a round compare.
    with other_form(cfg) as (other, k_other):
        expect_form(cfg, dev, "north_star_m8_other")
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        sim = Simulator(cfg, seed=NORTH_STAR_SEED, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(FULL_WIDTH_ROUNDS)
        conv2 = sim.run_until_converged(max_rounds=400)
        torch.cuda.synchronize()
        run2_s = time.perf_counter() - t0
        rounds2 = sim.tick
        other_launches = dict(counters.launches)
        check(conv2 == NORTH_STAR_ROUND and not counters.plain_calls
              and counters.kernel_launches("m8_totals") == 3 * rounds2
              and counters.kernel_launches("m8_pull") == 3 * rounds2
              and other_launches.get(form_key(other, k_other, diag=True)) == rounds2,
              f"the north star m8 in the other form converged at {conv2} or did not take "
              "both passes a sub-exchange")
        other_round_ms = round_rate(sim, win)
        peak2 = torch.cuda.max_memory_allocated() / 1e9
    log("north_star_m8_other", f"{other}: converged at round {conv2} after {rounds2} rounds in "
        f"{run2_s:.2f} s of rounds; launches {other_launches}")
    del sim
    torch.cuda.empty_cache()
    (k_ms, k_bound), (t_ms, t_bound) = form_rounds["staged"], form_rounds["two_pass"]
    log("north_star_m8", f"{1e3 / round_ms:.3f} rounds/s ({round_ms:.3f} ms/round over {win} "
        f"untracked rounds; the other form, {other}, {other_round_ms:.3f}); whole run "
        f"{run_s / rounds * 1e3:.3f} ms a round ({FULL_WIDTH_ROUNDS} untracked rounds, then "
        f"tracked ones taking the plain flag), the other form's {run2_s / rounds2 * 1e3:.3f}; "
        "kernels by CUDA "
        f"events: {k_ms:.3f} ms a round on clusters of {k} against a {k_bound:.3f} ms bound "
        f"({k_bound / k_ms:.1%}), the two-pass form {t_ms:.3f} against {t_bound:.3f} "
        f"({t_bound / t_ms:.1%}); peak memory {peak_gb:.2f} GB (the two-pass run "
        f"{peak2:.2f}); {card_line}")
    for key, (ms, (b_ms, b_by)) in times.items():
        log("north_star_m8", f"{key} at n={n}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by})")
    record = {
        "n": n, "seed": NORTH_STAR_SEED, "form": form, "cluster": k,
        "converged_round": converged, "rounds_run": rounds, "run_s": run_s, "init_s": init_s,
        "run_round_ms": run_s / rounds * 1e3, "round_ms": round_ms,
        "rounds_per_s": 1e3 / round_ms,
        "kernel_ms_per_round": k_ms, "bound_ms_per_round": k_bound, "peak_memory_gb": peak_gb,
        "flag_ms": flag_ms, "metrics_ms": metrics_ms,
        "other": {"form": other, "cluster": k_other, "converged_round": conv2,
                  "run_round_ms": run2_s / rounds2 * 1e3, "round_ms": other_round_ms,
                  "kernel_ms_per_round": t_ms, "bound_ms_per_round": t_bound,
                  "peak_memory_gb": peak2},
    }
    return record, launches, times, (other_launches, rounds2)


def i16_experiment(dev):
    """Phase 9e: the reference's int16 experiment on Hopper. Its inputs
    (N = 10,240, w in [0, 2000), hb in [0, 500), everyone alive, budget
    2618; from a numpy seed), the m8 pull's int16 variants against the
    int32 kernel (bit-exact) and its plain version, on clusters of 1, 2,
    4 and 8 CTAs, then each timed as the experiment's ``main()`` times
    them (in the rule's form at this width): 64 chained calls, best of 2,
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
        errs[arith] = 0.0
        for k in M8_CLUSTERS:
            out = m8_pull.m8_pull(w0, hb0, *args, arith=arith, cluster=k)
            torch.cuda.synchronize()
            errs[arith] = max(errs[arith], max_abs_err(list(out), list(ref)))
            del out
        log("i16", f"variant {arith} on clusters of {M8_CLUSTERS}: max_abs_err={errs[arith]} "
            "against the int32 kernel")
        check(errs[arith] == 0.0, f"the {arith} variant is not bit-exact")
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


def m8_kernel_entries(dev, errs, head, ns, ns_times, experiment):
    """The kernel-line entries of the m8 path: the headline's staged modes
    (with hb; one CTA a pair), the north star's cluster modes (lean, on
    its clusters) and the two-pass modes (lean; the north star's other
    form), each timed at N = 10,240 beside its plain version and its
    bound (the bytes the function must move, which this design moves);
    the north star's modes also at its width (``ns_times``); launches and
    launches a round from the runs (``head`` and ``ns``: name ->
    (launches, rounds); each must be > 0). The int16 variants ride the
    entry of the mode they run in."""
    entries = []

    def entry(key, kernel, line, run, ms, plain_ms, b, **extra):
        launches, rounds = (head if run.startswith("headline") else ns)[run]
        check(launches.get(key, 0) > 0, f"{key} was not launched on {run}")
        log("time", f"{key}: {ms:.4f} ms at n={N} (bound {b[0]:.4f} ms by {b[1]}; plain "
            f"{plain_ms:.3f} ms)"
            + ("" if "ms_main" not in extra else
               f"; {extra['ms_main']:.4f} ms at n={NORTH_STAR_N} (bound "
               f"{extra['bound_ms_main']:.4f} ms)") + f"; {launches[key]} launches on {run}")
        return dict(
            name=key, route="cuda", source=f"aiocluster_torch/ops/csrc/{kernel}.cu",
            replaces=f"aiocluster_tpu/ops/pallas_pull.py:{line}",
            launches=launches[key], launches_per_round=launches[key] / rounds,
            max_abs_err=errs[key], ms=ms, plain_ms=plain_ms, bound_ms=b[0],
            bound_by=b[1], library_ms=None, path=run, n=N, **extra,
        )

    for i, diag in enumerate((True, False)):
        ops = m8_case(N, torch.int16, 100 + i, dev, diag=diag, lean=False)()
        ms = cuda_ms(lambda: call_m8(m8_pull.m8_pull, ops), 20)
        plain_ms = cuda_ms(lambda: call_m8(m8_pull.m8_pull_plain, ops), 3, 1)
        del ops
        key = m8_pull.counter_key(diag)
        extra = {}
        if not diag:  # the experiment's mode
            extra["ms_chained"] = experiment["i32"][0]
            extra["variants"] = {
                a: dict(ms_chained=t, max_abs_err=e,
                        replaces="benchmarks/records/_i16_kernel_experiment.py:43")
                for a, (t, e) in experiment.items() if a != "i32"
            }
        entries.append(entry(key, "m8_pull", 263, "headline_m8", ms, plain_ms,
                             m8_pull_bound(N, N, 2, 2, diag=diag, totals=False), **extra))
    k = RUN_FORMS["north_star_m8"][1]
    for i, diag in enumerate((True, False)):
        ops = m8_case(N, torch.int16, 110 + i, dev, diag=diag, lean=True)()
        targs = (ops["w"], ops["gm"], ops["c"], ops["valid"])
        mv = ops.get("mv")
        tot = m8_totals.m8_totals(*targs, mv=mv)
        for key, kernel, line, run, fn, plain_fn, b in (
            (m8_pull.counter_key(diag, cluster=k > 1), "m8_pull", 263, "north_star_m8",
             lambda: call_m8(m8_pull.m8_pull, ops, cluster=k),
             lambda: call_m8(m8_pull.m8_pull_plain, ops),
             m8_pull_bound(N, N, 2, 0, diag=diag, totals=False)),
            (m8_totals.counter_key(diag), "m8_totals", 374, "north_star_m8_other",
             lambda: m8_totals.m8_totals(*targs, mv=mv),
             lambda: m8_totals.m8_totals_plain(*targs, mv=mv),
             bound(m8_totals_bytes(N, N, 2, diag=diag), OPS_TOTALS * N * N / 2)),
            (m8_pull.counter_key(diag, True), "m8_pull", 263, "north_star_m8_other",
             lambda: call_m8(m8_pull.m8_pull, ops, totals=tot),
             lambda: call_m8(m8_pull.m8_pull_plain, ops, totals=tot),
             m8_pull_bound(N, N, 2, 0, diag=diag, totals=True)),
        ):
            ms = cuda_ms(fn, 20)
            plain_ms = cuda_ms(plain_fn, 3, 1)
            ms_main, b_main = ns_times[key]
            extra = dict(n_main=NORTH_STAR_N, ms_main=ms_main, bound_ms_main=b_main[0],
                         parity_n=[N, NORTH_STAR_N])
            if run == "north_star_m8":
                extra["cluster"] = k
            entries.append(entry(key, kernel, line, run, ms, plain_ms, b, **extra))
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
    for hdt, diag in ((h, d) for h in (None, torch.int8) for d in (True, False)):
        ops = ladder_case(N, 240 + diag + 2 * (hdt is None), dev, wdt=torch.int8, hdt=hdt,
                          diag=diag, check=False, fd=False, hb0=False)()
        targs = (ops["w"], ops["gm"], ops["c"], ops["valid"])
        tot = m8_totals.m8_totals(*targs, mv=ops.get("mv"))
        t_want = m8_totals.m8_totals_plain(*targs, mv=ops.get("mv"))
        t_key = f"{m8_totals.counter_key(diag)} int8"
        errs[t_key] = max(errs[t_key], max_abs_err([tot], [t_want]))
        want = call_m8(m8_pull.m8_pull_plain, ops)
        # Staged by one CTA (the 10,240-wide rule's), on the int8 north
        # star's cluster (its other form's), and fed the totals.
        for k in (1, pairs_pull.cluster_size(NORTH_STAR_N, 1), None):
            got = call_m8(m8_pull.m8_pull, ops, **({"totals": tot} if k is None else
                                                    {"cluster": k}))
            torch.cuda.synchronize()
            key = (f"{m8_pull.counter_key(diag, k is None, cluster=k is not None and k > 1)} "
                   f"int8{'' if hdt is None else '+hb'}")
            errs[key] = max(errs[key], max_abs_err(got, want))
            log("ladder", f"n={N} {key}: max_abs_err={errs[key]}")
            check(errs[key] == 0.0, f"{key} disagrees")
            del got
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
    gm_all, c_all, p_all = matchings(run_key.to(dev), tick, cfg)
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
    rounds in (rows of 100,352 bytes): the m8 pulls in both forms and
    modes from that state, then one round of pairs pulls chained in each
    form; the full
    deep and shrunk rungs at N = 49,152, ``FULL_CHECK_ROUNDS`` rounds in:
    one round chained in each form, the last with the fused FD epilogue
    on the int8 counters and the live bitmap (last_change, imean, icount
    and the bitmap compared). Raises each mode's max_abs_err in
    ``errs``."""
    t0 = time.perf_counter()
    cfg = lean_config(NORTH_STAR_N, "int8", budget=2618)
    sim = Simulator(cfg, seed=NORTH_STAR_SEED, device=dev)
    sim.run(FULL_WIDTH_ROUNDS)
    found = check_m8_forms_full_width(dev, sim, errs, "int8")
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
    p = matchings(prng.key(sim.seed).to(dev), sim.tick + 1, sim.cfg)[2][0]
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
    deficits could save), to 209; then pinned to m8 in its form (the m8
    totals and the pull fed them, and the plain flag, as in the
    reference): round 209 again, and again in the other form (a cluster
    of CTAs a pair). Each path's passes are timed at this width on the
    converged state in both forms."""
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

    m8_cfg = dataclasses.replace(cfg, pallas_variant="m8")
    form8, k8 = expect_form(m8_cfg, dev, "north_star_int8_m8")
    timed8 = {}
    sim, conv8, launches8, run8_s, peak8 = run_to(m8_cfg, dev, NORTH_STAR_SEED,
                                                  LADDER_NS_ROUND, "north_star_int8_m8",
                                                  timed=timed8)
    rounds8 = sim.tick
    two8 = form8 == "m8_two_pass"
    check(counters.kernel_launches("m8_pull") == 3 * rounds8
          and counters.kernel_launches("m8_totals") == (3 * rounds8 if two8 else 0)
          and launches8.get(form_key(form8, k8, diag=True)) == rounds8,
          "the int8 north star m8 did not run its form's launches a sub-exchange")
    round8_ms = round_rate(sim)
    k8_staged = pairs_pull.cluster_size(NORTH_STAR_N, 1)
    m8_times, m8_rounds = m8_form_times(sim.state.w, sim.state.alive, sim.state.max_version,
                                        cfg.budget, k8_staged, 1, "int8")
    times.update({key: (NORTH_STAR_N, *t) for key, t in m8_times.items()})
    del sim
    torch.cuda.empty_cache()
    with other_form(m8_cfg) as (other8, k_other8):
        expect_form(m8_cfg, dev, "north_star_int8_m8_other")
        timed8o = {}
        sim, conv8o, launches8o, _, _ = run_to(m8_cfg, dev, NORTH_STAR_SEED, LADDER_NS_ROUND,
                                               "north_star_int8_m8_other", timed=timed8o)
        rounds8o = sim.tick
        check(counters.kernel_launches("m8_pull") == 3 * rounds8o
              and launches8o.get(form_key(other8, k_other8, diag=True)) == rounds8o,
              "the int8 north star m8 in the other form did not take its launches")
        round8o_ms = round_rate(sim)
    del sim
    torch.cuda.empty_cache()
    staged8, two8r = m8_rounds["staged"], m8_rounds["two_pass"]
    mine8, theirs8 = (two8r, staged8) if two8 else (staged8, two8r)
    record_m8 = dict(n=NORTH_STAR_N, seed=NORTH_STAR_SEED, form=form8, cluster=k8,
                     converged_round=conv8, rounds_run=rounds8, run_s=run8_s,
                     run_round_ms=timed8["round_ms"], round_ms=round8_ms,
                     rounds_per_s=1e3 / round8_ms, peak_memory_gb=peak8,
                     kernel_ms_per_round=mine8[0], bound_ms_per_round=mine8[1],
                     other=dict(form=other8, cluster=k_other8, converged_round=conv8o,
                                run_round_ms=timed8o["round_ms"], round_ms=round8o_ms,
                                kernel_ms_per_round=theirs8[0], bound_ms_per_round=theirs8[1]))
    log("north_star_int8_m8", f"{form8}: {1e3 / round8_ms:.3f} rounds/s ({round8_ms:.3f} "
        f"ms/round over 16 untracked rounds; in the other form, {other8} on clusters of "
        f"{k_other8}, {round8o_ms:.3f}); whole run {timed8['round_ms']:.3f} ms a round (every "
        f"round tracked, taking the plain flag), in the other form {timed8o['round_ms']:.3f}; "
        "kernels a round by "
        f"CUDA events: two-pass {two8r[0]:.3f} ms (bound {two8r[1]:.3f}), on clusters of "
        f"{k8_staged} {staged8[0]:.3f} (bound {staged8[1]:.3f}); peak memory {peak8:.2f} GB; "
        f"m8 passes at n={NORTH_STAR_N}: "
        + ", ".join(f"{kk} {v[0]:.4f} ms (bound {v[1][0]:.4f})" for kk, v in m8_times.items())
        + f"; {card_line}")
    return ((record, launches, rounds), (record_m8, launches8, rounds8), times,
            (other_launches, other_rounds), (launches8o, rounds8o))


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
        staged_bound, two_pass_bound = full_round_bounds(FULL_N, rung)
        bounds = {"pairs_two_pass": two_pass_bound}
        records[rung] = dict(n=FULL_N, seed=NORTH_STAR_SEED, form=form, cluster=k,
                             converged_round=conv,
                             rounds_run=rounds, run_s=run_s, round_ms=round_ms,
                             rounds_per_s=1e3 / round_ms, peak_memory_gb=peak,
                             fd_false_positives=fp,
                             bound_ms_per_round=bounds.get(form, staged_bound),
                             other=dict(form=other, cluster=k_other, round_ms=other_round_ms,
                                        bound_ms_per_round=bounds.get(other, staged_bound)))
        all_launches[rung] = (launches, rounds)
        log(what, f"{form} on clusters of {k}: {1e3 / round_ms:.3f} rounds/s ({round_ms:.3f} "
            f"ms/round; the other form, {other} on clusters of {k_other}, {other_round_ms:.3f}; "
            f"the kernels' bound a round {staged_bound:.3f} ms staged, {two_pass_bound:.3f} "
            "two-pass); peak memory "
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
    int8 and u4r, pinned to m8 the lean int8, deep and shrunk). Returns
    each run's (launches, rounds) by name."""
    runs = {}
    cfg = full_config(N, "deep", budget=2618, icount_dtype="int16", live_bits=False,
                      pallas_variant="m8")
    expect_form(cfg, dev, "headline_int8_m8")
    check(gossip.fd_phase_engaged(cfg, dev) == "kernel",
          "the int8 m8 headline does not take the FD kernel")
    sim, _, launches, _, _ = run_to(cfg, dev, 0, CONVERGED_ROUND, "headline_int8_m8")
    check(launches.get("fd") == sim.tick and counters.kernel_launches("m8_pull") == 3 * sim.tick,
          "the int8 m8 headline did not run 3 m8 pulls and 1 FD kernel a round")
    runs["headline_int8_m8"] = (launches, sim.tick)
    del sim
    # Each rung at this width staged by one CTA a pair: the one-CTA staged
    # modes' path (their full-width runs take other forms).
    for name, c0, want in (
        ("lean_int8_staged", lean_config(N, "int8", budget=2618), None),
        ("lean_int8_m8_staged", lean_config(N, "int8", budget=2618, pallas_variant="m8"), None),
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


def full_round_bounds(n, rung):
    """The bound of a full-profile round's kernels (3 sub-exchanges: the
    refresh, a middle one, the check with the fused FD reading hb0) in
    ms, computed from the shapes: (staged, two-pass), the two-pass form
    adding its totals passes (one with the refresh)."""
    wsize = {"deep": 1, "shrunk": 2, "full int16": 2}[rung]
    modes = [LADDER_MODES[m] for m in ("first", "middle", "last_fd")]
    totals = sum(bound(totals_bytes(n, wsize, diag=diag), OPS_TOTALS * n * n / 2)[0]
                 for diag in (True, False, False))
    return (sum(ladder_pull_bound(n, rung, m, False)[0] for m in modes),
            totals + sum(ladder_pull_bound(n, rung, m, True)[0] for m in modes))


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
    k_int8 = RUN_FORMS["north_star_int8_m8_other"][1]
    # (hb dtype, form: a cluster size or None fed the totals, run of its path)
    m8_modes = ((torch.int8, 1, "headline_int8_m8"), (None, 1, "lean_int8_m8_staged"),
                (None, k_int8, "north_star_int8_m8_other"), (None, None, "north_star_int8_m8"))
    for (hdt, k, run), diag in ((m, d) for m in m8_modes for d in (True, False)):
        given = k is None
        ops = ladder_case(N, 330 + diag + 2 * given, dev, wdt=torch.int8, hdt=hdt, diag=diag,
                          check=False, fd=False, hb0=False)()
        targs = (ops["w"], ops["gm"], ops["c"], ops["valid"])
        tot = m8_totals.m8_totals(*targs, mv=ops.get("mv")) if given else None
        kw = {"totals": tot} if given else {"cluster": k}
        ms = cuda_ms(lambda: call_m8(m8_pull.m8_pull, ops, **kw), 20)
        plain_ms = cuda_ms(lambda: call_m8(m8_pull.m8_pull_plain, ops, totals=tot), 3, 1)
        key = m8_pull.counter_key(diag, given, cluster=not given and k > 1)
        name = f"{key} int8{'' if hdt is None else '+hb'}"
        hsize = 0 if hdt is None else 1
        entries.append(entry(
            name, "m8_pull", m8_line, run, key, ms, plain_ms,
            m8_pull_bound(N, N, 1, hsize, diag=diag, totals=given),
            **({"cluster": k} if not given and k > 1 else {}),
        ))
        if given:
            tkey = m8_totals.counter_key(diag)
            t_ms = cuda_ms(lambda: m8_totals.m8_totals(*targs, mv=ops.get("mv")), 20)
            t_plain = cuda_ms(lambda: m8_totals.m8_totals_plain(*targs, mv=ops.get("mv")), 3, 1)
            entries.append(entry(
                f"{tkey} int8", "m8_totals", "aiocluster_tpu/ops/pallas_pull.py:374",
                run, tkey, t_ms, t_plain,
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
    gm_all, c_all, p_all = matchings(keys.to(dev), tick, cfg)
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
    gm_all, c_all, p_all = matchings(run_key.to(dev), tick, cfg)
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
    staged_bound, two_pass_bound = full_round_bounds(C2_N, "full int16")
    log("c2", f"full_config({C2_N}) int16, {form} on clusters of {k}, with the fused FD: "
        f"{C2_ROUNDS} rounds in {run_s:.2f} s with init; launches {launches}; one chained "
        f"round {C2_ROUNDS} rounds in, {C2_LEADERS} row pairs a pull: "
        + ", ".join(f"{kk} max_abs_err={e}" for kk, e in found)
        + f"; {round_ms:.3f} ms a round (two-pass form {two_pass_round_ms:.3f} ms on the "
        f"later state; the kernels' bound a round {staged_bound:.3f} ms staged, "
        f"{two_pass_bound:.3f} two-pass); peak {peak_gb:.2f} GB; mean fraction "
        f"{float(m['mean_fraction']):.4f}; {card_line}")
    del sim
    torch.cuda.empty_cache()
    return {"n": C2_N, "form": form, "cluster": k, "round_ms": round_ms,
            "two_pass_round_ms": two_pass_round_ms, "peak_memory_gb": peak_gb,
            "bound_ms_per_round": staged_bound, "two_pass_bound_ms_per_round": two_pass_bound,
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
    gm_all, c_all, p_all = matchings(run_key.to(dev), tick, cfg)
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


# -- the round's remaining semantics (phase 14) -----------------------------------
#
# Churn on the pairs kernels, the permutation and choice pairings, an
# adjacency topology, the greedy budget and the dead-node lifecycle at full
# width (phase 14), fault plans (phase 15), a resumed checkpoint and
# SimCluster's script (phase 16). The reference's values are the first 16 hex digits of the sha256
# of every state field after ticks 1-3 (and tick 200 of config 3 at 1,000
# nodes), and config 4's converged round, made by the reference's XLA path
# on JAX's CPU backend with
#     JAX_PLATFORMS=cpu python -m tools.torch_reference_digests <case>
# (the case names are the keys of REF_DIGESTS; the dict is that script's
# output, pasted).

REF_DIGESTS: dict = {
    "churn_headline": {"ticks": {
        "1": {
            "tick": "67abdd721024f0ff", "max_version": "5c728cba3a5e59d6", "heartbeat": "d4c3bec662e68f66",
            "alive": "71735dd44b8e957b", "w": "ab878e25106cebd4", "hb_known": "f7f8fcd94f1e706d",
            "last_change": "77e51b04bc3228f9", "imean": "72abf2ca8f36943e", "icount": "72abf2ca8f36943e",
            "live_view": "d0cdbab1ca66c775", "dead_since": "e3b0c44298fc1c14",
        },
        "2": {
            "tick": "26b25d457597a7b0", "max_version": "6841539b96d9d6a0", "heartbeat": "85694fcbebeda441",
            "alive": "549cd1825e163a6a", "w": "a7d5d697c4bdb2fb", "hb_known": "a971bca5f2c335f9",
            "last_change": "79b6b50322ece234", "imean": "751fdbebd7395aa5", "icount": "78684759e4f5323a",
            "live_view": "2b22dd9188485d95", "dead_since": "e3b0c44298fc1c14",
        },
        "3": {
            "tick": "9d9f290527a6be62", "max_version": "62b8ea4c83ca35f1", "heartbeat": "cee80422112435e7",
            "alive": "4dcce8f12edadd7c", "w": "e018e4eead1b7dcb", "hb_known": "28e4f215ffa2fe88",
            "last_change": "1ed4d1abb89698bc", "imean": "7a35770824a22e0b", "icount": "604778c3f2c6a73d",
            "live_view": "6055074debc714aa", "dead_since": "e3b0c44298fc1c14",
        },
    }},
    "config3_1000": {"ticks": {
        "1": {
            "tick": "67abdd721024f0ff", "max_version": "5e2fb05ce8dece93", "heartbeat": "ec1432188e1c6a33",
            "alive": "f59d9fdaf942ffc6", "w": "f21f1559d6ec2fb1", "hb_known": "4f8783615dbd02a8",
            "last_change": "28f7ee714ab9db14", "imean": "8dbe5f139fd946d4", "icount": "13aea96040f21330",
            "live_view": "f3b0177e3e7756e9", "dead_since": "28f7ee714ab9db14",
        },
        "2": {
            "tick": "26b25d457597a7b0", "max_version": "19af4c1b8e30ad00", "heartbeat": "c7fac83b9cdb4fdc",
            "alive": "00ef337964cb369c", "w": "24a0a69c8b3fd6f5", "hb_known": "ad1d9cba111f2271",
            "last_change": "7b22bcea11a9dc16", "imean": "021fdcc7c6408674", "icount": "477f35a558b48d4e",
            "live_view": "90895866c9ed4cc6", "dead_since": "0456ffcb78f5fd94",
        },
        "3": {
            "tick": "9d9f290527a6be62", "max_version": "3546c25dd15f9b68", "heartbeat": "a7cd2a69ff5973dc",
            "alive": "e4a2e1220e1f029d", "w": "fe910b5ca8d23a23", "hb_known": "14e3ec48cc19a38b",
            "last_change": "e0fc5c8a40dcb047", "imean": "252f8b99f85cf7d5", "icount": "70ad9607a0671877",
            "live_view": "d9e3959582a7f529", "dead_since": "6ad899c806902c35",
        },
        "200": {
            "tick": "a77802d8305178be", "max_version": "b8b803e567e9a5e6", "heartbeat": "8f4a44867a1d4aae",
            "alive": "3dcd4e1116ea1611", "w": "97c114df2950f137", "hb_known": "494ac8b6e0c7230d",
            "last_change": "ed78bf5753428cf6", "imean": "065479b181491cca", "icount": "96214b24a82f563a",
            "live_view": "57c00a9d10c222cd", "dead_since": "bb0e5c6da58cc893",
        },
    }},
    "config3_10240": {"ticks": {
        "1": {
            "tick": "67abdd721024f0ff", "max_version": "5c728cba3a5e59d6", "heartbeat": "d4c3bec662e68f66",
            "alive": "71735dd44b8e957b", "w": "1025b483da136b82", "hb_known": "5af4f1f00210a2f8",
            "last_change": "d26daf337feea82a", "imean": "6ed5e85372e48880", "icount": "72abf2ca8f36943e",
            "live_view": "d0cdbab1ca66c775", "dead_since": "d26daf337feea82a",
        },
        "2": {
            "tick": "26b25d457597a7b0", "max_version": "6841539b96d9d6a0", "heartbeat": "85694fcbebeda441",
            "alive": "549cd1825e163a6a", "w": "54d3a49c112ede45", "hb_known": "95e31525c0d95399",
            "last_change": "6857a3ea84216a0e", "imean": "45a81ccabdf203ea", "icount": "cad91d98d9b0f934",
            "live_view": "7adcbb9454f6d99c", "dead_since": "2b224208ab2b0c29",
        },
        "3": {
            "tick": "9d9f290527a6be62", "max_version": "62b8ea4c83ca35f1", "heartbeat": "cee80422112435e7",
            "alive": "4dcce8f12edadd7c", "w": "3c046ea66dd1047a", "hb_known": "115b564234c56d25",
            "last_change": "a418eb59844abf56", "imean": "75be1bf51278482b", "icount": "35f545f83ba665a1",
            "live_view": "f41f9662c11203f9", "dead_since": "9cd6e769418e392a",
        },
    }},
    "permutation_headline": {"ticks": {
        "1": {
            "tick": "67abdd721024f0ff", "max_version": "3855e96afa8c8c55", "heartbeat": "21b592d5143ce8cd",
            "alive": "445d72bc039eaa0e", "w": "db119d860b29f1d5", "hb_known": "e376378e4707a008",
            "last_change": "41092637e098b8d8", "imean": "72abf2ca8f36943e", "icount": "72abf2ca8f36943e",
            "live_view": "d0cdbab1ca66c775", "dead_since": "e3b0c44298fc1c14",
        },
        "2": {
            "tick": "26b25d457597a7b0", "max_version": "3855e96afa8c8c55", "heartbeat": "2292e30b6e5f215c",
            "alive": "445d72bc039eaa0e", "w": "8df7f3fbb8c9bc89", "hb_known": "de5a93fcd582a5dc",
            "last_change": "bacd4d1f1d000a14", "imean": "af0e015b89d2b195", "icount": "d35b078ef404891c",
            "live_view": "b65625a7e737c0c3", "dead_since": "e3b0c44298fc1c14",
        },
        "3": {
            "tick": "9d9f290527a6be62", "max_version": "3855e96afa8c8c55", "heartbeat": "a6cb8d915ed4c5cd",
            "alive": "445d72bc039eaa0e", "w": "f6f6d200483005c0", "hb_known": "317ad857f5d86756",
            "last_change": "da6a10d8916bcf6f", "imean": "1a0e4c1ba7676a4a", "icount": "c5fc53f28c524016",
            "live_view": "a99a4611b6b53e70", "dead_since": "e3b0c44298fc1c14",
        },
    }},
    "greedy_headline": {"ticks": {
        "1": {
            "tick": "67abdd721024f0ff", "max_version": "3855e96afa8c8c55", "heartbeat": "21b592d5143ce8cd",
            "alive": "445d72bc039eaa0e", "w": "6a524e66701e1f4e", "hb_known": "eaeeb4a2492882d6",
            "last_change": "915ad5e37cad9b1f", "imean": "72abf2ca8f36943e", "icount": "72abf2ca8f36943e",
            "live_view": "d0cdbab1ca66c775", "dead_since": "e3b0c44298fc1c14",
        },
        "2": {
            "tick": "26b25d457597a7b0", "max_version": "3855e96afa8c8c55", "heartbeat": "2292e30b6e5f215c",
            "alive": "445d72bc039eaa0e", "w": "8d125a73a1153e9b", "hb_known": "624a4a1389430fd9",
            "last_change": "910ad2cce33d407b", "imean": "d38d193b7b85b045", "icount": "fd07ed1bd0f43207",
            "live_view": "5bbdd79edce2f6da", "dead_since": "e3b0c44298fc1c14",
        },
        "3": {
            "tick": "9d9f290527a6be62", "max_version": "3855e96afa8c8c55", "heartbeat": "a6cb8d915ed4c5cd",
            "alive": "445d72bc039eaa0e", "w": "19c1c45fd879dd92", "hb_known": "5ac3bdafc49ff88b",
            "last_change": "b01c475d0ca517cf", "imean": "604eb882be17643b", "icount": "806cac8808df54a7",
            "live_view": "82a7ccb783f312a1", "dead_since": "e3b0c44298fc1c14",
        },
    }},
    "config4": {"ticks": {
        "1": {
            "tick": "67abdd721024f0ff", "max_version": "9363b41212643713", "heartbeat": "e9bf3a5f000cb690",
            "alive": "684ad25fdc2bbb80", "w": "8f46a37caf7f1776", "hb_known": "fd2e42c7c21277c5",
            "last_change": "871601112e2b477c", "imean": "36286c9dd45c90a7", "icount": "d162f6594b643795",
            "live_view": "f74f260d4586ed56", "dead_since": "e3b0c44298fc1c14",
        },
        "2": {
            "tick": "26b25d457597a7b0", "max_version": "9363b41212643713", "heartbeat": "13334ca230f46cd8",
            "alive": "684ad25fdc2bbb80", "w": "2ea3aa254d06a479", "hb_known": "a3c3c3506adbba2d",
            "last_change": "d8b8f6200ab679d2", "imean": "add45f2ee006e07c", "icount": "9198cd536c984a76",
            "live_view": "59bf40d1d0998496", "dead_since": "e3b0c44298fc1c14",
        },
        "3": {
            "tick": "9d9f290527a6be62", "max_version": "9363b41212643713", "heartbeat": "0ca1a64224eebfed",
            "alive": "684ad25fdc2bbb80", "w": "abbb5bd4467b5a1f", "hb_known": "d687a72a18e8cf6e",
            "last_change": "9ce39cfb1fab38a4", "imean": "d1a1f1a5b1f4c82f", "icount": "69d42e971c303ed2",
            "live_view": "8a442ebbce4fafe7", "dead_since": "e3b0c44298fc1c14",
        },
    }, "converged_round": 22},
    "fault_bench_split": {"ticks": {
        "1": {
            "tick": "67abdd721024f0ff", "max_version": "3855e96afa8c8c55", "heartbeat": "21b592d5143ce8cd",
            "alive": "445d72bc039eaa0e", "w": "9975cc1ae3611fdb", "hb_known": "e3b0c44298fc1c14",
            "last_change": "e3b0c44298fc1c14", "imean": "e3b0c44298fc1c14", "icount": "e3b0c44298fc1c14",
            "live_view": "e3b0c44298fc1c14", "dead_since": "e3b0c44298fc1c14",
        },
        "2": {
            "tick": "26b25d457597a7b0", "max_version": "3855e96afa8c8c55", "heartbeat": "2292e30b6e5f215c",
            "alive": "445d72bc039eaa0e", "w": "78657e22bf9618ed", "hb_known": "e3b0c44298fc1c14",
            "last_change": "e3b0c44298fc1c14", "imean": "e3b0c44298fc1c14", "icount": "e3b0c44298fc1c14",
            "live_view": "e3b0c44298fc1c14", "dead_since": "e3b0c44298fc1c14",
        },
        "3": {
            "tick": "9d9f290527a6be62", "max_version": "3855e96afa8c8c55", "heartbeat": "a6cb8d915ed4c5cd",
            "alive": "445d72bc039eaa0e", "w": "b645e862dfa0a1de", "hb_known": "e3b0c44298fc1c14",
            "last_change": "e3b0c44298fc1c14", "imean": "e3b0c44298fc1c14", "icount": "e3b0c44298fc1c14",
            "live_view": "e3b0c44298fc1c14", "dead_since": "e3b0c44298fc1c14",
        },
    }, "converged_round": 63},
    "flaky_headline": {"ticks": {
        "1": {
            "tick": "67abdd721024f0ff", "max_version": "3855e96afa8c8c55", "heartbeat": "21b592d5143ce8cd",
            "alive": "445d72bc039eaa0e", "w": "03e2513b0eda5e14", "hb_known": "e70fb65db57bf030",
            "last_change": "d0b8efdb8e1a36d3", "imean": "72abf2ca8f36943e", "icount": "72abf2ca8f36943e",
            "live_view": "d0cdbab1ca66c775", "dead_since": "e3b0c44298fc1c14",
        },
        "2": {
            "tick": "26b25d457597a7b0", "max_version": "3855e96afa8c8c55", "heartbeat": "2292e30b6e5f215c",
            "alive": "445d72bc039eaa0e", "w": "97d63bd2e16b1e73", "hb_known": "d387035529208312",
            "last_change": "39126084d6627fb1", "imean": "3e9f60ff3f970cc4", "icount": "37d22d78b153d52b",
            "live_view": "1eae771a174a9db2", "dead_since": "e3b0c44298fc1c14",
        },
        "3": {
            "tick": "9d9f290527a6be62", "max_version": "3855e96afa8c8c55", "heartbeat": "a6cb8d915ed4c5cd",
            "alive": "445d72bc039eaa0e", "w": "da1a70c0bc8a4cfb", "hb_known": "678fd739492cc202",
            "last_change": "c660385383380667", "imean": "b380b02f542263da", "icount": "ddad6010071cd80f",
            "live_view": "7e66435d828ebde8", "dead_since": "e3b0c44298fc1c14",
        },
    }, "converged_round": 35},
    "cadence_headline": {"ticks": {
        "1": {
            "tick": "67abdd721024f0ff", "max_version": "3855e96afa8c8c55", "heartbeat": "21b592d5143ce8cd",
            "alive": "445d72bc039eaa0e", "w": "e5c476cc463e869f", "hb_known": "0f59ad387cfd6505",
            "last_change": "8ccd405f86c780ec", "imean": "72abf2ca8f36943e", "icount": "72abf2ca8f36943e",
            "live_view": "d0cdbab1ca66c775", "dead_since": "e3b0c44298fc1c14",
        },
        "2": {
            "tick": "26b25d457597a7b0", "max_version": "3855e96afa8c8c55", "heartbeat": "2292e30b6e5f215c",
            "alive": "445d72bc039eaa0e", "w": "7e947ce009c1e8a9", "hb_known": "97e4e6b4b81eacfa",
            "last_change": "7ff248d8ffc3a6bd", "imean": "456a6ba4029493fb", "icount": "1ca90f97ef48c1c3",
            "live_view": "064d6d4038602e05", "dead_since": "e3b0c44298fc1c14",
        },
        "3": {
            "tick": "9d9f290527a6be62", "max_version": "3855e96afa8c8c55", "heartbeat": "a6cb8d915ed4c5cd",
            "alive": "445d72bc039eaa0e", "w": "01ee2bd8d5b040e3", "hb_known": "ac9d02264a1e0b3d",
            "last_change": "fd62cd699ce84b62", "imean": "d9f7f588b8920608", "icount": "dd5168b243ee2826",
            "live_view": "c684809a653cf4ce", "dead_since": "e3b0c44298fc1c14",
        },
    }, "converged_round": 44},
    "amnesia_headline": {"ticks": {
        "1": {
            "tick": "67abdd721024f0ff", "max_version": "3855e96afa8c8c55", "heartbeat": "21b592d5143ce8cd",
            "alive": "445d72bc039eaa0e", "w": "6a524e66701e1f4e", "hb_known": "eaeeb4a2492882d6",
            "last_change": "915ad5e37cad9b1f", "imean": "72abf2ca8f36943e", "icount": "72abf2ca8f36943e",
            "live_view": "d0cdbab1ca66c775", "dead_since": "e3b0c44298fc1c14",
        },
        "2": {
            "tick": "26b25d457597a7b0", "max_version": "3855e96afa8c8c55", "heartbeat": "d80cb6812da672b2",
            "alive": "445d72bc039eaa0e", "w": "2ff219e1749054e4", "hb_known": "2c99a52ae3786a10",
            "last_change": "521e7dc129cbe382", "imean": "af3d214b63618db1", "icount": "616e5e9d23bba33d",
            "live_view": "120be899566dc676", "dead_since": "e3b0c44298fc1c14",
        },
        "3": {
            "tick": "9d9f290527a6be62", "max_version": "3855e96afa8c8c55", "heartbeat": "9a66fd6539a453e3",
            "alive": "445d72bc039eaa0e", "w": "f99758b52ed14823", "hb_known": "c3f83966cb086cbc",
            "last_change": "9cdc6540d1c93c04", "imean": "380cb20cdac9664c", "icount": "b7a23dcb6c69779c",
            "live_view": "a67cc720f294798b", "dead_since": "e3b0c44298fc1c14",
        },
        "4": {
            "tick": "fb5e512425fc9449", "max_version": "3855e96afa8c8c55", "heartbeat": "3946e7176fd3a346",
            "alive": "445d72bc039eaa0e", "w": "a56bce8e9cc1a7b0", "hb_known": "1350e39ee69974d3",
            "last_change": "2450782cddac5c69", "imean": "1c2997a005306677", "icount": "51e173ee96d777dc",
            "live_view": "c22fa591ff0aac71", "dead_since": "e3b0c44298fc1c14",
        },
    }},
    "storm_headline": {"ticks": {
        "1": {
            "tick": "67abdd721024f0ff", "max_version": "3855e96afa8c8c55", "heartbeat": "21b592d5143ce8cd",
            "alive": "445d72bc039eaa0e", "w": "f30fa416158d3053", "hb_known": "6b494e9d053c2296",
            "last_change": "3e582402ba5d6071", "imean": "72abf2ca8f36943e", "icount": "72abf2ca8f36943e",
            "live_view": "d0cdbab1ca66c775", "dead_since": "3e582402ba5d6071",
        },
        "2": {
            "tick": "26b25d457597a7b0", "max_version": "3855e96afa8c8c55", "heartbeat": "2292e30b6e5f215c",
            "alive": "445d72bc039eaa0e", "w": "808e43d1b37ff986", "hb_known": "6aeb72d44abc46b5",
            "last_change": "fea75f7785a61d2c", "imean": "af7a238724ca10e8", "icount": "64608f4459c1b84f",
            "live_view": "2b378075992172d6", "dead_since": "a6e63bf3339ad49d",
        },
        "3": {
            "tick": "9d9f290527a6be62", "max_version": "3855e96afa8c8c55", "heartbeat": "a6cb8d915ed4c5cd",
            "alive": "445d72bc039eaa0e", "w": "f8fc83f4cd9f055e", "hb_known": "7c40ac988443dd83",
            "last_change": "b534bf8ade39590a", "imean": "e305baeda171f224", "icount": "0efb42df172e5a2e",
            "live_view": "00e74ffd518737a0", "dead_since": "deb2ba8c193548cd",
        },
    }},
    "quarantine_choice": {"ticks": {
        "1": {
            "tick": "67abdd721024f0ff", "max_version": "3855e96afa8c8c55", "heartbeat": "21b592d5143ce8cd",
            "alive": "445d72bc039eaa0e", "w": "c4211534ffb71eb1", "hb_known": "e3b0c44298fc1c14",
            "last_change": "e3b0c44298fc1c14", "imean": "e3b0c44298fc1c14", "icount": "e3b0c44298fc1c14",
            "live_view": "e3b0c44298fc1c14", "dead_since": "e3b0c44298fc1c14",
        },
        "2": {
            "tick": "26b25d457597a7b0", "max_version": "3855e96afa8c8c55", "heartbeat": "2292e30b6e5f215c",
            "alive": "445d72bc039eaa0e", "w": "632bcdb66c06e2a1", "hb_known": "e3b0c44298fc1c14",
            "last_change": "e3b0c44298fc1c14", "imean": "e3b0c44298fc1c14", "icount": "e3b0c44298fc1c14",
            "live_view": "e3b0c44298fc1c14", "dead_since": "e3b0c44298fc1c14",
        },
        "3": {
            "tick": "9d9f290527a6be62", "max_version": "3855e96afa8c8c55", "heartbeat": "a6cb8d915ed4c5cd",
            "alive": "445d72bc039eaa0e", "w": "95e497c52e0d4da6", "hb_known": "e3b0c44298fc1c14",
            "last_change": "e3b0c44298fc1c14", "imean": "e3b0c44298fc1c14", "icount": "e3b0c44298fc1c14",
            "live_view": "e3b0c44298fc1c14", "dead_since": "e3b0c44298fc1c14",
        },
    }},
    "zone_choice": {"ticks": {
        "1": {
            "tick": "67abdd721024f0ff", "max_version": "3855e96afa8c8c55", "heartbeat": "21b592d5143ce8cd",
            "alive": "445d72bc039eaa0e", "w": "c7d9651653981729", "hb_known": "e3b0c44298fc1c14",
            "last_change": "e3b0c44298fc1c14", "imean": "e3b0c44298fc1c14", "icount": "e3b0c44298fc1c14",
            "live_view": "e3b0c44298fc1c14", "dead_since": "e3b0c44298fc1c14",
        },
        "2": {
            "tick": "26b25d457597a7b0", "max_version": "3855e96afa8c8c55", "heartbeat": "2292e30b6e5f215c",
            "alive": "445d72bc039eaa0e", "w": "5f8378442b124c24", "hb_known": "e3b0c44298fc1c14",
            "last_change": "e3b0c44298fc1c14", "imean": "e3b0c44298fc1c14", "icount": "e3b0c44298fc1c14",
            "live_view": "e3b0c44298fc1c14", "dead_since": "e3b0c44298fc1c14",
        },
        "3": {
            "tick": "9d9f290527a6be62", "max_version": "3855e96afa8c8c55", "heartbeat": "a6cb8d915ed4c5cd",
            "alive": "445d72bc039eaa0e", "w": "692455e3c9086282", "hb_known": "e3b0c44298fc1c14",
            "last_change": "e3b0c44298fc1c14", "imean": "e3b0c44298fc1c14", "icount": "e3b0c44298fc1c14",
            "live_view": "e3b0c44298fc1c14", "dead_since": "e3b0c44298fc1c14",
        },
    }},
    "resume_headline": {"ticks": {
        "9": {
            "tick": "9f076b7eb7fdc031", "max_version": "3855e96afa8c8c55", "heartbeat": "b5923dd439be6169",
            "alive": "445d72bc039eaa0e", "w": "99c5771120294fa9", "hb_known": "ca712c9be955e5f1",
            "last_change": "abac9cfe049adb84", "imean": "3ebe2046f9b7834d", "icount": "22625d8c6209af12",
            "live_view": "84ec7f9c3d02e7b1", "dead_since": "e3b0c44298fc1c14",
        },
        "10": {
            "tick": "075de2b906dbd706", "max_version": "3855e96afa8c8c55", "heartbeat": "d19e1a7c21bb2d07",
            "alive": "445d72bc039eaa0e", "w": "7452102b59a4acdb", "hb_known": "940d6748fbb543c9",
            "last_change": "f9a36728b5497e23", "imean": "875ff0d73aa97ce7", "icount": "2e24516f11f60a61",
            "live_view": "367222cbe7e0d88d", "dead_since": "e3b0c44298fc1c14",
        },
        "11": {
            "tick": "cb30e91817239109", "max_version": "3855e96afa8c8c55", "heartbeat": "c841ccb54a03846b",
            "alive": "445d72bc039eaa0e", "w": "1ddb015e4e25d4c3", "hb_known": "30c551be88839b18",
            "last_change": "9df4458757c87ba2", "imean": "1082f3b8276eb10d", "icount": "c981d814d48a2122",
            "live_view": "1e4eb838635ffe06", "dead_since": "e3b0c44298fc1c14",
        },
    }, "converged_round": 24},
    "simcluster_headline": {"ticks": {
        "28": {
            "tick": "b01099398ce27bbc", "max_version": "d91b01dd04041f57", "heartbeat": "fc8a1edb8f8650d3",
            "alive": "445d72bc039eaa0e", "w": "4f866ccda3d3d4dd", "hb_known": "7714241ef0b75933",
            "last_change": "1cff7212eb0b6a51", "imean": "5fbc56c16aac8202", "icount": "5cc74bcbb504fa87",
            "live_view": "1b555814cab1315d", "dead_since": "e3b0c44298fc1c14",
        },
        "68": {
            "tick": "d16a7ad80717a9e7", "max_version": "87c9bc2a17ba4d52", "heartbeat": "4bb1a472942de032",
            "alive": "ecba60c89dc89d43", "w": "d0646522b9ebe9cf", "hb_known": "5e42c755b2cb1ed1",
            "last_change": "0888779a46c133af", "imean": "a9d3f9fd244de90e", "icount": "6a1bce4a53c196ee",
            "live_view": "a1c2854c6a0a96d8", "dead_since": "e3b0c44298fc1c14",
        },
    }, "converged_round": 24, "script_converged_round": 34},
}
CONFIG4_N = 10_000
CONFIG4_ROUND = REF_DIGESTS["config4"]["converged_round"]  # the reference's, the same script
CHOICE_N, CHOICE_SEED, CHOICE_ROUND = 32_768, 1, 45  # r5_full_profile_certification.json
# The choice run's peak before the choice branch applied its advances a
# block of rows at a time (PERF.md §4, PR 10, one H100 80GB HBM3 at 700 W):
# the state and four (N, N) matrices.
CHOICE_PEAK_BEFORE_GB = 20.0
# C4: the certified choice round at 65,536 (r5_full_profile_convergence.json,
# choice_65536), run by ``chip_smoke.py --c4``.
C4_N, C4_ROUND = 65_536, 81
CONFIG3_ROUNDS = 200


def host_digests(state) -> dict:
    """The reference script's digest of every state field (sha256 of its
    bytes, bfloat16 as raw 16-bit words, first 16 hex digits)."""
    out = {}
    for f in STATE_FIELDS:
        t = getattr(state, f).detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[f] = hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def check_digests(case: str, state, tick: int) -> None:
    want = REF_DIGESTS[case]["ticks"][str(tick)]
    got = host_digests(state)
    bad = [f for f in STATE_FIELDS if got[f] != want[f]]
    check(not bad, f"{case}: fields {bad} differ from the reference's at tick {tick}")


def config3(n: int):
    """BASELINE config 3 (benchmarks/run_all.py::config3): 5% churn a round
    with revival, the view draw, the lifecycle with a 40-round grace."""
    return SimConfig(n_nodes=n, keys_per_node=16, fanout=3, budget=HEADLINE_BUDGET,
                     death_rate=0.05, revival_rate=0.2, writes_per_round=1,
                     peer_mode="view", pairing="choice", dead_grace_ticks=40)


def config4():
    """BASELINE config 4 (benchmarks/run_all.py::config4): 10,000 nodes on a
    scale-free topology, the choice path with the failure detector."""
    return SimConfig(n_nodes=CONFIG4_N, keys_per_node=16, fanout=3, budget=HEADLINE_BUDGET,
                     pairing="choice")


def digest_prefix(case, cfg, dev, seed, topology=None, ticks=(1, 2, 3)):
    """Ticks 1-3 (or ``ticks``) of ``cfg`` a round at a time, each state's
    digests held against the reference's. Returns the simulator at the
    last of them."""
    sim = Simulator(cfg, seed=seed, device=dev, chunk=1, topology=topology)
    for tick in ticks:
        sim.run(tick - sim.tick)
        check_digests(case, sim.state, tick)
    return sim


def round_entries(dev, sim, launches, tag, check_last=False):
    """The pairs pull launches of a run on its own state (``sim`` after its
    rounds): the next round's draws (its churn flips and matchings), its
    post-churn alive mask, cadence gate, heartbeats and writes, and its
    sub-exchanges chained as ``step_blocks`` chains them (the first
    refreshes the diagonal, the last carries the FD epilogue on the
    round-start hb, and with ``check_last`` the convergence check, as a
    tracked round does). Each mode's kernel against its plain version on
    the same inputs, then both timed by CUDA events on a copy of that
    mode's inputs. Returns one kernels-line entry a mode, named
    ``pairs_pull[<tag> <mode>]``, its launches the run's count of that
    mode (``launches``)."""
    st, cfg, n = sim.state, sim.cfg, sim.cfg.n_nodes
    form, k = gossip.kernel_pull_form(cfg)
    check(form in ("pairs", "pairs_cluster"), f"the {tag} run's form is {form}")
    tick = sim.tick + 1
    run_key = prng.key(sim.seed)
    draws = prng.chunk_draws(run_key.to(dev), tick, 1, cfg, alive=st.alive).round(0)
    alive = st.alive if draws.dies is None else torch.where(st.alive, ~draws.dies, draws.revives)
    cadence = gossip.round_faults(cfg).cadence
    cad = None if cadence is None else fsim.cadence_on(cadence, n, tick, dev)
    alive_i32 = alive.to(torch.int32)
    heartbeat = st.heartbeat + alive_i32
    mv = st.max_version + cfg.writes_per_round * alive_i32
    params = FdParams.from_config(cfg)
    start = dict(w=st.w, hb=st.hb_known, hb0=st.hb_known, lc=st.last_change, im=st.imean,
                 ic=st.icount, live=st.live_view)
    kern = {f: t.clone() for f, t in start.items()}
    plain = {f: t.clone() for f, t in start.items()}
    entries = []
    for c in range(cfg.fanout):
        last = c == cfg.fanout - 1
        mode = dict(diag=c == 0, check=check_last and last, fd=last)
        p = draws.p[c]
        valid = alive & alive[p]
        if cad is not None:
            valid = valid & (cad | cad[p])
        args = (draws.gm[c], draws.c[c], valid, tick * 2 * cfg.fanout + 2 * c,
                prng.run_salt(run_key), cfg.budget)

        def call(fn, ops, mode=mode, args=args):
            kw = {}
            if mode["diag"]:
                kw.update(mv=mv, hbv=heartbeat)
            if mode["check"]:
                kw["check"] = (mv, alive, alive)
            if mode["fd"]:
                kw.update(hbv=heartbeat, fd=pairs_pull.FdOperands(
                    tick, ops["lc"], ops["im"], ops["ic"], ops["live"], ops["hb0"], params))
            return fn(ops["w"], ops["hb"], *args, **kw)

        inputs = {f: t.clone() for f, t in kern.items()}
        flags = [call(pairs_pull.pairs_pull, kern), call(pairs_pull.pairs_pull_plain, plain)]
        torch.cuda.synchronize()
        err = max_abs_err(list(kern.values()), list(plain.values()))
        if mode["check"]:
            err = max(err, max_abs_err([flags[0]], [flags[1]]))
        key = pairs_pull.counter_key(**mode, cluster=k > 1)
        check(err == 0.0, f"{tag}: {key} (sub-exchange {c}) disagrees")
        ms = cuda_ms(lambda: call(pairs_pull.pairs_pull, inputs), 20)
        plain_ms = cuda_ms(lambda: call(pairs_pull.pairs_pull_plain, inputs), 3, 1)
        del inputs
        b_ms, b_by = bound(pull_bytes(n, 2, 2, **mode, hb0=mode["fd"]),
                           (OPS_PAIR + (OPS_FD * 2 if mode["fd"] else 0)) * n * n / 2)
        name = key[len("pairs_pull["):-1]
        entries.append(dict(
            name=f"pairs_pull[{tag} {name}]", route="cuda",
            source="aiocluster_torch/ops/csrc/pairs_pull.cu",
            replaces="aiocluster_tpu/ops/pallas_pull.py:490",
            launches=launches.get(key, 0), launches_per_round=launches.get(key, 0) / sim.tick,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, path=f"{tag}_headline", tick=tick,
        ))
        log(tag, f"{key} at tick {tick} (sub-exchange {c}, {int(valid.sum())} valid rows): "
            f"max_abs_err={err}; {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; plain "
            f"{plain_ms:.3f} ms)")
    del kern, plain
    torch.cuda.empty_cache()
    return entries


def churn_headline(dev, card_line):
    """(a) The headline under churn on the pairs kernels: 16 rounds equal
    round by round to the plain round on the card, ticks 1-3 equal to the
    reference's digests, no fallback; then its round time."""
    cfg = dataclasses.replace(headline_config(), death_rate=0.05, revival_rate=0.2,
                              writes_per_round=1)
    plain_cfg = dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=False)
    counters.reset()
    kern = Simulator(cfg, seed=0, device=dev, chunk=1)
    plain = Simulator(plain_cfg, seed=0, device=dev, chunk=1)
    launches = collections.Counter()
    alive_counts = []
    for tick in range(1, 17):
        before = collections.Counter(counters.launches)
        plain_before = dict(counters.plain_calls)
        kern.run(1)
        check(dict(counters.plain_calls) == plain_before,
              "the churned kernel round ran a plain phase")
        launches.update(collections.Counter(counters.launches) - before)
        plain.run(1)
        check(states_equal(kern.state, plain.state),
              f"churned headline: kernel round != plain round at tick {tick}")
        if tick <= 3:
            check_digests("churn_headline", kern.state, tick)
        alive_counts.append(int(kern.state.alive.sum()))
    check(not counters.fallbacks and not counters.refusals, "the churned headline fell back")
    check(sum(v for k, v in launches.items() if k.startswith("pairs_pull[")) == 16 * 3,
          "the churned headline did not launch a pull a sub-exchange")
    check(len(set(alive_counts)) > 1, "churn flipped no node")
    del plain
    entries = round_entries(dev, kern, launches, "churn")
    del kern
    round_ms = round_rate(Simulator(cfg, seed=0, device=dev, chunk=16))
    log("churn", f"headline under churn: 16 rounds kernel == plain every round, ticks 1-3 == "
        f"the reference's digests; alive {alive_counts[0]} -> {alive_counts[-1]}; launches "
        f"{dict(launches)}; {round_ms:.3f} ms a round ({card_line})")
    return {"rounds": 16, "round_ms": round_ms, "launches": dict(launches),
            "alive_first_last": [alive_counts[0], alive_counts[-1]]}, entries


def fd_on_state(sim, what):
    """fd.cu on a run's own state (``sim`` after its rounds): the next FD
    phase (its heartbeats one row-rolled max ahead of the round-start
    matrix) against its plain version, then both timed by CUDA events.
    Returns (max_abs_err, ms, plain ms, bound ms, bound by, a factory of
    fresh operands)."""
    s, cfg = sim.state, sim.cfg
    n, params = cfg.n_nodes, FdParams.from_config(cfg)
    hbv = s.heartbeat.clone()
    hb0 = s.hb_known.clone()
    hb = torch.maximum(s.hb_known, torch.roll(s.hb_known, 1, 0))
    fresh = lambda: (hb, hb0, hbv, s.last_change.clone(), s.imean.clone(),  # noqa: E731
                     s.icount.clone(), s.live_view.clone())
    got, want = fresh(), fresh()
    tick = sim.tick + 1
    fd_mod.fused_fd(tick, *got, params)
    fd_mod.fused_fd_plain(tick, *want, params)
    torch.cuda.synchronize()
    err = max_abs_err(got[3:], want[3:])
    check(err == 0.0, f"fd.cu != plain on {what}'s state (max abs err {err})")
    args = fresh()
    fd_ms = cuda_ms(lambda: fd_mod.fused_fd(tick, *args, params), 10)
    args = fresh()
    fd_plain_ms = cuda_ms(lambda: fd_mod.fused_fd_plain(tick, *args, params), 3, 1)
    del args, got, want
    # hb, hb0, last_change read, last_change written, imean read and
    # written, icount read and written (int16), live written.
    hs, ims = s.hb_known.element_size(), s.imean.element_size()
    b_ms, b_by = bound(n * n * (4 * hs + 2 * ims + 2 * 2 + 1) + n * 4, OPS_FD * n * n)
    return err, fd_ms, fd_plain_ms, b_ms, b_by, fresh


def config4_run(dev, card_line):
    """(b) BASELINE config 4 to convergence: plain pulls on the adjacency
    ("topology"), the FD phase through fd.cu every round. Its round time,
    and fd.cu's time and share of a round on the run's state, fd.cu held
    against its plain version there."""
    from aiocluster_torch.models import scale_free

    topo = scale_free(CONFIG4_N, attach=3, seed=0)
    cfg = config4()
    digest_prefix("config4", cfg, dev, 0, topo)
    counters.reset()
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=0, device=dev, chunk=8, topology=topo)
    converged = sim.run_until_converged(max_rounds=4 * CONFIG4_N)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, rounds = dict(counters.launches), sim.tick
    log("config4", f"converged at round {converged} after {rounds} rounds in {run_s:.2f} s; "
        f"launches {launches}; plain calls {dict(counters.plain_calls)}; fallbacks "
        f"{dict(counters.fallbacks)}")
    check(converged == CONFIG4_ROUND,
          f"config 4 converged at {converged}, the reference at {CONFIG4_ROUND}")
    check(converged is not None and launches == {"fd": rounds}
          and dict(counters.fallbacks) == {"topology": rounds},
          "config 4 did not run its FD phase through fd.cu every round")
    round_ms = round_rate(sim, rounds=8, warmup=1)
    err, fd_ms, fd_plain_ms, b_ms, b_by, fresh = fd_on_state(sim, "config 4")
    # What the fused liveness bound (fd.fma32, float64 with a tie fix-up)
    # costs the plain FD: the same call with the bound's product and sum
    # rounded apart, the plain arithmetic before the fusion.
    args, tick = fresh(), sim.tick + 1
    with unittest.mock.patch.object(fd_mod, "fma32", lambda a, b, c: a * b + c):
        fd_plain_unfused_ms = cuda_ms(
            lambda: fd_mod.fused_fd_plain(tick, *args, FdParams.from_config(cfg)), 3, 1)
    del args
    log("config4", f"{round_ms:.3f} ms a round; fd.cu {fd_ms:.4f} ms ({fd_ms / round_ms:.1%} "
        f"of a round; bound {b_ms:.4f} ms by {b_by}; plain {fd_plain_ms:.3f} ms, "
        f"{fd_plain_unfused_ms:.3f} ms with the bound unfused), equal to its plain version "
        f"on the run's state ({card_line})")
    entry = dict(
        name="fd[config4]", route="cuda", source="aiocluster_torch/ops/csrc/fd.cu",
        replaces="aiocluster_tpu/ops/pallas_fd.py:51", launches=launches.get("fd", 0),
        launches_per_round=launches.get("fd", 0) / rounds, max_abs_err=err, ms=fd_ms,
        plain_ms=fd_plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, path="config4",
        plain_unfused_ms=fd_plain_unfused_ms,
    )
    out = {"converged_round": converged, "rounds_run": rounds, "round_ms": round_ms,
           "run_s": run_s, "fd_ms": fd_ms, "fd_share": fd_ms / round_ms}
    return out, entry


def config3_runs(dev, card_line):
    """(c) BASELINE config 3: 200 rounds at 1,000 nodes (digests at ticks
    1-3 and 200), then 4 rounds at 10,240 (ticks 1-3); every phase plain
    (the pull's reason "pairing", the lifecycle's FD), as in the
    reference. Round times, and the view draw's
    time at 10,240."""
    counters.reset()
    sim = digest_prefix("config3_1000", config3(1000), dev, 0)
    t0 = time.perf_counter()
    sim.run(CONFIG3_ROUNDS - 3)
    torch.cuda.synchronize()
    small_ms = (time.perf_counter() - t0) / (CONFIG3_ROUNDS - 3) * 1e3
    check_digests("config3_1000", sim.state, CONFIG3_ROUNDS)
    m = sim.metrics()
    alive = int(m["alive_count"])
    check(0 < alive < 1000 and np.isfinite(float(m["mean_fraction"])),
          "config 3's metrics are not finite")
    check(not counters.launches and dict(counters.fallbacks) == {"pairing": CONFIG3_ROUNDS},
          "config 3 did not run plain with the reason 'pairing'")
    del sim
    big = digest_prefix("config3_10240", config3(N), dev, 0)
    t0 = time.perf_counter()
    big.run(1)
    torch.cuda.synchronize()
    big_ms = (time.perf_counter() - t0) * 1e3
    s = big.state
    cfg = config3(N)
    view = lambda: gossip.view_peers(cfg, [s], [0], -7, 12345)  # noqa: E731
    view_dev_ms = cuda_ms(view, 2, 1)
    t0 = time.perf_counter()
    view()
    torch.cuda.synchronize()
    view_host_ms = (time.perf_counter() - t0) * 1e3
    log("config3", f"1,000 nodes: ticks 1-3 and {CONFIG3_ROUNDS} == the reference's digests, "
        f"{small_ms:.3f} ms a round, {alive} alive at the end; 10,240: ticks 1-3 == the "
        f"reference's, round 4 {big_ms:.3f} ms; the view draw (3 peers a row) at 10,240: "
        f"{view_dev_ms:.3f} ms device, {view_host_ms:.3f} ms host ({card_line})")
    return {"round_ms_1000": small_ms, "round_ms_10240": big_ms, "alive_1000": alive,
            "view_draw_device_ms": view_dev_ms, "view_draw_host_ms": view_host_ms}


def choice_north(dev, card_line):
    """(d) The certified choice run: lean_config(32,768, budget=2618,
    pairing="choice") at seed 1 converges at round 45."""
    cfg = lean_config(CHOICE_N, budget=HEADLINE_BUDGET, pairing="choice")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=CHOICE_SEED, device=dev, chunk=8)
    converged = sim.run_until_converged(max_rounds=200)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    rounds = sim.tick
    peak = torch.cuda.max_memory_allocated() / 1e9
    log("choice", f"lean_config({CHOICE_N}, pairing='choice') seed {CHOICE_SEED}: converged "
        f"at round {converged} in {run_s:.2f} s ({run_s / rounds * 1e3:.1f} ms a round with the "
        f"check), {peak:.1f} GB peak; fallbacks {dict(counters.fallbacks)} ({card_line})")
    check(converged == CHOICE_ROUND, f"the choice run converged at {converged}, "
          f"the reference's certified round is {CHOICE_ROUND}")
    check(dict(counters.fallbacks) == {"pairing": rounds} and not counters.launches,
          "the choice run did not take the plain pull with the reason 'pairing'")
    log("choice", f"peak {peak:.2f} GB against {CHOICE_PEAK_BEFORE_GB:.1f} GB before the "
        "choice branch applied its advances a block of rows at a time")
    check(peak < CHOICE_PEAK_BEFORE_GB, "the choice run's peak did not fall")
    del sim
    torch.cuda.empty_cache()
    return {"converged_round": converged, "run_s": run_s, "round_ms": run_s / rounds * 1e3,
            "peak_memory_gb": peak}


def categorical_draw_times(dev, card_line):
    """The masked categorical draw (choice under churn) of one round at
    10,240 nodes, fanout 3: device and host time."""
    alive = torch.rand(N, generator=torch.Generator().manual_seed(0)) < 0.8
    alive, key = alive.to(dev), prng.key(0).to(dev)
    draw = lambda: prng.categorical(key, alive, 3)  # noqa: E731
    dev_ms = cuda_ms(draw, 2, 1)
    t0 = time.perf_counter()
    draw()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    check(bool(alive[draw()].all()), "the categorical draw picked a dead node")
    log("draws", f"categorical over {N} nodes x 3 peers: {dev_ms:.3f} ms device, "
        f"{host_ms:.3f} ms host ({card_line})")
    return {"device_ms": dev_ms, "host_ms": host_ms}


def headline_variants(dev, card_line):
    """(e) The permutation pairing and the greedy budget at the headline
    width: ticks 1-3 equal to the reference's digests, the plain pull with
    the reference's reason, the FD phase through fd.cu; round times."""
    out, launches = {}, collections.Counter()
    for case, over, reason in (("permutation_headline", dict(pairing="permutation"), "pairing"),
                               ("greedy_headline", dict(budget_policy="greedy"),
                                "budget_policy")):
        cfg = dataclasses.replace(headline_config(), **over)
        counters.reset()
        sim = digest_prefix(case, cfg, dev, 0)
        check(dict(counters.launches) == {"fd": 3} and dict(counters.fallbacks) == {reason: 3},
              f"{case} did not run the plain pull ({reason}) and fd.cu")
        launches.update(counters.launches)
        round_ms = round_rate(sim, rounds=8, warmup=1)
        out[case] = {"round_ms": round_ms}
        log("variants", f"{case}: ticks 1-3 == the reference's digests; {round_ms:.3f} ms a "
            f"round ({card_line})")
        del sim
    return out, launches


def remaining_semantics(dev, card_line):
    """Phase 14: (a)-(e) above, each run from counters at 0."""
    t0 = time.perf_counter()
    churn, churn_entries = churn_headline(dev, card_line)
    c4, fd_entry = config4_run(dev, card_line)
    c3 = config3_runs(dev, card_line)
    choice = choice_north(dev, card_line)
    variants, variant_launches = headline_variants(dev, card_line)
    draws = categorical_draw_times(dev, card_line)
    fd_entry["launches_variants"] = variant_launches["fd"]
    log("phase14", f"{time.perf_counter() - t0:.1f} s")
    return {"churn_headline": churn, "config4": c4, "config3": c3, "choice_32768": choice,
            "headline_variants": variants, "categorical_draw": draws}, churn_entries, fd_entry


# -- fault plans and heterogeneity (phase 15) --------------------------------------
#
# fault_bench's split-brain arm and the headline under flaky links and under
# cadence classes to the reference's converged rounds; ticks 1-3 (1-4) of an
# amnesiac rolling restart, the byzantine storm with the lifecycle, a
# quarantined choice draw and zone bias; fault-seed, attacker-fraction and
# cadence sweeps; fault_bench's arm and the cadence headline on 8 column
# blocks. The reference's values are REF_DIGESTS' entries of the same names.

FAULT_HEAL_TICK = 48  # benchmarks/fault_bench.py SIM_HEAL_TICK
FAULT_MAX_ROUNDS = 400  # benchmarks/fault_bench.py SIM_MAX_ROUNDS
CADENCE = Heterogeneity(gossip_every=(1, 4), class_frac=(0.5, 0.5))


def fault_config(case: str) -> SimConfig:
    """Phase 15's configurations, as tools/torch_reference_digests.py
    builds the reference's."""
    lean = lean_config(N, budget=HEADLINE_BUDGET)
    head = headline_config(N)
    if case == "fault_bench_split":  # benchmarks/fault_bench.py's sim arm
        return dataclasses.replace(
            lean, fault_plan=split_brain(3, start=0.0, heal=float(FAULT_HEAL_TICK)))
    if case == "flaky_headline":
        return dataclasses.replace(head, fault_plan=flaky_links(0.2))
    if case == "cadence_headline":
        return dataclasses.replace(head, heterogeneity=CADENCE)
    if case == "amnesia_headline":
        return dataclasses.replace(head, fault_plan=rolling_restart(4, recovery="amnesia"))
    if case == "storm_headline":
        return dataclasses.replace(head, fault_plan=byzantine_storm(0.25), dead_grace_ticks=40)
    if case == "quarantine_choice":
        return dataclasses.replace(lean, pairing="choice", quarantine=True, fault_plan=FaultPlan(
            links=(LinkFault(dst=NodeSet(frac=(0.0, 0.1)), drop=1.0),)))
    if case == "zone_choice":
        return dataclasses.replace(lean, pairing="choice", heterogeneity=Heterogeneity(
            zones=4, wan_loss=0.1, wan_delay=1.5, zone_bias=0.5))
    raise KeyError(case)


def fault_bench_arm(dev, card_line):
    """(a) fault_bench's sim arm: split_brain(3) healing at tick 48 on the
    lean profile at 10,240, seed 0. Ticks 1-3 equal the reference's
    digests, the run is not converged at the heal, and converges at the
    reference's round; every pull plain ("fault_plan"), no kernel."""
    case = "fault_bench_split"
    cfg, want = fault_config(case), REF_DIGESTS[case]["converged_round"]
    counters.reset()
    sim = digest_prefix(case, cfg, dev, 0)
    sim.chunk = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(FAULT_HEAL_TICK - sim.tick)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) / (FAULT_HEAL_TICK - 3) * 1e3
    at_heal = sim.metrics()
    check(not bool(at_heal["all_converged"]), "fault_bench's arm converged while partitioned")
    converged = sim.run_until_converged(max_rounds=FAULT_MAX_ROUNDS)
    rounds = sim.tick
    log("faults", f"fault_bench split_brain(3) heal {FAULT_HEAL_TICK}: ticks 1-3 == the "
        f"reference's digests; unconverged at the heal (min fraction "
        f"{float(at_heal['min_fraction']):.4f}); converged at round {converged} (the "
        f"reference's {want}); {round_ms:.3f} ms a plain round; plain calls "
        f"{dict(counters.plain_calls)}; fallbacks {dict(counters.fallbacks)} ({card_line})")
    check(converged == want, f"fault_bench's arm converged at {converged}, the reference at {want}")
    check(not counters.launches and dict(counters.fallbacks) == {"fault_plan": rounds},
          "fault_bench's arm did not run plain with the reason 'fault_plan'")
    return {"converged_round": converged, "reconverge_rounds": converged - FAULT_HEAL_TICK,
            "min_fraction_at_heal": float(at_heal["min_fraction"]), "round_ms": round_ms}


def flaky_headline(dev, card_line):
    """(b) The headline under flaky_links(0.2): plain pulls ("fault_plan")
    and fd.cu once a round, to the reference's converged round; fd.cu held
    against its plain version on the run's state and timed there."""
    case = "flaky_headline"
    cfg, want = fault_config(case), REF_DIGESTS[case]["converged_round"]
    counters.reset()
    sim = digest_prefix(case, cfg, dev, 0)
    sim.chunk = 8
    converged = sim.run_until_converged(max_rounds=FAULT_MAX_ROUNDS)
    rounds, launches = sim.tick, dict(counters.launches)
    check(converged == want, f"the flaky headline converged at {converged}, the reference at {want}")
    check(launches == {"fd": rounds} and dict(counters.fallbacks) == {"fault_plan": rounds},
          "the flaky headline did not run its FD phase through fd.cu every round")
    round_ms = round_rate(sim, rounds=8, warmup=1)
    err, fd_ms, fd_plain_ms, b_ms, b_by, _ = fd_on_state(sim, "the flaky headline")
    log("faults", f"headline under flaky_links(0.2): converged at round {converged} (the "
        f"reference's {want}); {round_ms:.3f} ms a round; fd.cu {fd_ms:.4f} ms (bound "
        f"{b_ms:.4f} ms by {b_by}; plain {fd_plain_ms:.3f} ms) on the run's state ({card_line})")
    entry = dict(
        name="fd[flaky]", route="cuda", source="aiocluster_torch/ops/csrc/fd.cu",
        replaces="aiocluster_tpu/ops/pallas_fd.py:51", launches=launches["fd"],
        launches_per_round=launches["fd"] / rounds, max_abs_err=err, ms=fd_ms,
        plain_ms=fd_plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        path="flaky_headline",
    )
    return {"converged_round": converged, "round_ms": round_ms, "fd_ms": fd_ms,
            "fd_bound_ms": b_ms}, entry


def m8_round_entries(dev, sim, launches, tag):
    """The m8 pull launches of a pinned-m8 run on its own state: the next
    round's sub-exchanges (their validity cadence-gated under cadence
    classes, the first refreshing the diagonal) chained out of place, each against its plain version on
    the same inputs and both timed. One kernels-line entry a mode."""
    st, cfg, n = sim.state, sim.cfg, sim.cfg.n_nodes
    form, k = gossip.kernel_pull_form(cfg)
    check(form == "m8", f"the {tag} m8 run's form is {form}")
    tick = sim.tick + 1
    run_key = prng.key(sim.seed)
    draws = prng.chunk_draws(run_key.to(dev), tick, 1, cfg, alive=st.alive).round(0)
    cadence = gossip.round_faults(cfg).cadence
    cad = None if cadence is None else fsim.cadence_on(cadence, n, tick, dev)
    alive = st.alive
    hbv = st.heartbeat + alive.to(torch.int32)
    mv = st.max_version + cfg.writes_per_round * alive.to(torch.int32)
    w, hb = st.w, st.hb_known
    entries, errs = [], {}
    for c in range(cfg.fanout):
        p = draws.p[c]
        valid = alive & alive[p]
        ops = dict(w=w, hb=hb, gm=draws.gm[c], c=draws.c[c],
                   valid=valid if cad is None else valid & (cad | cad[p]),
                   salt=tick * 2 * cfg.fanout + 2 * c, run_salt=prng.run_salt(run_key),
                   budget=cfg.budget)
        if c == 0:
            ops.update(mv=mv, hbv=hbv)
        got = call_m8(m8_pull.m8_pull, ops)
        want = call_m8(m8_pull.m8_pull_plain, ops)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        key = m8_pull.counter_key(diag=c == 0)
        check(err == 0.0, f"{tag}: {key} (sub-exchange {c}) disagrees")
        errs[key] = max(errs.get(key, 0.0), err)
        ms = cuda_ms(lambda: call_m8(m8_pull.m8_pull, ops), 20)
        plain_ms = cuda_ms(lambda: call_m8(m8_pull.m8_pull_plain, ops), 3, 1)
        b_ms, b_by = m8_pull_bound(n, n, 2, 2, diag=c == 0, totals=False)
        if c < 2:  # the later sub-exchanges repeat sub-exchange 1's mode
            entries.append(dict(
                name=f"m8_pull[{tag} {key[len('m8_pull['):-1]}]", route="cuda",
                source="aiocluster_torch/ops/csrc/m8_pull.cu",
                replaces="aiocluster_tpu/ops/pallas_pull.py:263",
                launches=launches.get(key, 0), launches_per_round=launches.get(key, 0) / sim.tick,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, path=f"{tag}_headline_m8", tick=tick,
            ))
        else:
            entries[-1]["max_abs_err"] = errs[key]
        log(tag, f"{key} at tick {tick} (sub-exchange {c}): max_abs_err={err}; {ms:.4f} ms "
            f"(bound {b_ms:.4f} ms by {b_by}; plain {plain_ms:.3f} ms)")
        w, hb = got
    del w, hb
    torch.cuda.empty_cache()
    return entries


def cadence_headline(dev, card_line):
    """(c) The headline with cadence classes gossip_every=(1, 4): the pairs
    kernels with the cadence folded into their pair validity (3 launches a
    round, the FD fused, no plain pull, no fallback) to the reference's
    converged round; each launched mode on the run's next round against
    its plain version; then pinned to m8 (fd.cu a round) to the same
    round, its modes likewise."""
    case = "cadence_headline"
    cfg, want = fault_config(case), REF_DIGESTS[case]["converged_round"]
    counters.reset()
    sim = digest_prefix(case, cfg, dev, 0)
    sim.chunk = 8
    converged = sim.run_until_converged(max_rounds=FAULT_MAX_ROUNDS)
    rounds, launches = sim.tick, dict(counters.launches)
    log("cadence", f"converged at round {converged} (the reference's {want}) after {rounds} "
        f"rounds; launches {launches}; plain calls {dict(counters.plain_calls)}; fallbacks "
        f"{dict(counters.fallbacks)}")
    check(converged == want, f"the cadence headline converged at {converged}, the reference at {want}")
    check(counters.kernel_launches("pairs_pull") == 3 * rounds and not counters.plain_calls
          and not counters.fallbacks, "the cadence headline left the pairs kernels")
    entries = round_entries(dev, sim, launches, "cadence", check_last=True)
    del sim
    round_ms = round_rate(Simulator(cfg, seed=0, device=dev, chunk=16))
    m8_cfg = dataclasses.replace(cfg, pallas_variant="m8")
    counters.reset()
    sim = Simulator(m8_cfg, seed=0, device=dev)
    m8_converged = sim.run_until_converged(max_rounds=FAULT_MAX_ROUNDS)
    m8_rounds, m8_launches = sim.tick, dict(counters.launches)
    log("cadence", f"pinned to m8: converged at round {m8_converged} after {m8_rounds} rounds; "
        f"launches {m8_launches}; plain calls {dict(counters.plain_calls)}")
    check(m8_converged == want, f"the cadence headline on m8 converged at {m8_converged}")
    check(counters.kernel_launches("m8_pull") == 3 * m8_rounds
          and m8_launches.get("fd") == m8_rounds and not counters.plain_calls
          and not counters.fallbacks, "the cadence m8 run left the m8 kernel and fd.cu")
    entries += m8_round_entries(dev, sim, m8_launches, "cadence")
    del sim
    log("cadence", f"{round_ms:.3f} ms a round on the pairs kernels ({card_line})")
    return {"converged_round": converged, "m8_converged_round": m8_converged,
            "round_ms": round_ms, "launches": launches, "m8_launches": m8_launches}, entries


def fault_digest_cases(dev, card_line):
    """(d) Ticks 1-3 (1-4) against the reference's digests: the headline
    under rolling_restart(4, recovery="amnesia") (the first restart at
    tick 3; fd.cu every round, held against its plain version on the
    reset bookkeeping at tick 4), under byzantine_storm(0.25) with the
    lifecycle (the FD plain), and lean choice under a quarantining link
    fault and under zone bias with WAN classes."""
    out, entry = {}, None
    for case, ticks, fd_launches in (("amnesia_headline", (1, 2, 3, 4), True),
                                     ("storm_headline", (1, 2, 3), False),
                                     ("quarantine_choice", (1, 2, 3), False),
                                     ("zone_choice", (1, 2, 3), False)):
        cfg = fault_config(case)
        counters.reset()
        t0 = time.perf_counter()
        sim = digest_prefix(case, cfg, dev, 0, ticks=ticks)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rounds, launches = ticks[-1], dict(counters.launches)
        check(launches == ({"fd": rounds} if fd_launches else {})
              and dict(counters.fallbacks) == {"fault_plan": rounds},
              f"{case} did not run plain ('fault_plan') with its FD phase where expected")
        out[case] = {"ticks": list(ticks), "seconds": secs, "launches": launches}
        log("faults", f"{case}: ticks {list(ticks)} == the reference's digests in {secs:.2f} s; "
            f"launches {launches}; plain calls {dict(counters.plain_calls)} ({card_line})")
        if case == "amnesia_headline":
            err, ms, plain_ms, b_ms, b_by, _ = fd_on_state(sim, "the amnesia headline")
            entry = dict(
                name="fd[amnesia]", route="cuda", source="aiocluster_torch/ops/csrc/fd.cu",
                replaces="aiocluster_tpu/ops/pallas_fd.py:51", launches=launches["fd"],
                launches_per_round=launches["fd"] / rounds, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                path="amnesia_headline",
            )
        del sim
    return out, entry


def fault_sweeps(dev, card_line):
    """(e) Sweeps, 4 rounds each, every lane field-equal to its sequential
    run: 3 ``fault_seeds`` lanes of the flaky headline and 3 ``byz_frac``
    lanes (0, 0.25, 0.5) of the storm headline (each lane's round plain,
    "fault_plan"), and 3 lanes of the cadence headline on the pairs lane
    launches."""
    out = {}
    flaky = fault_config("flaky_headline")
    storm = fault_config("storm_headline")
    for what, cfg, lanes, per_lane in (
        ("fault_seeds", flaky, dict(fault_seeds=[0, 7, 9]),
         {"fault_plan": [dataclasses.replace(flaky.fault_plan, seed=s) for s in (0, 7, 9)]}),
        ("byz_frac", storm, dict(byz_frac=[0.0, 0.25, 0.5]),
         {"fault_plan": [fsim.with_byz_frac(storm.fault_plan, f) for f in (0.0, 0.25, 0.5)]}),
        ("cadence", fault_config("cadence_headline"), {}, {}),
    ):
        counters.reset()
        t0 = time.perf_counter()
        sweep = SweepSimulator(cfg, [0, 1, 2], device=dev, **lanes)
        sweep.run(4)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, fallbacks = dict(counters.launches), dict(counters.fallbacks)
        if what == "cadence":
            check(counters.kernel_launches("pairs_pull") == 4 * 3 and not counters.plain_calls
                  and not fallbacks, "the cadence sweep left the lane launches")
        else:
            check(not launches and fallbacks == {"fault_plan": 4},
                  f"the {what} sweep did not run its lanes plain ('fault_plan')")
        lanes_equal_sequential(sweep, cfg, dev, per_lane, f"the {what} sweep")
        out[what] = {"seconds": secs, "launches": launches}
        log("faults", f"{what} sweep, 3 lanes x 4 rounds in {secs:.2f} s, each lane == its "
            f"sequential run; launches {launches}; fallbacks {fallbacks} ({card_line})")
        del sweep
    return out


def fault_meshes(dev, card_line):
    """(f) fault_bench's arm on 8 column blocks for 8 rounds (the plain
    pulls block by block) and the cadence headline on 8 blocks for 4
    rounds (the two-pass kernels at each block's owner offset, the FD
    fused): each gathered state field-equal to its unsharded run."""
    out = {}
    for case, rounds in (("fault_bench_split", 8), ("cadence_headline", 4)):
        cfg = fault_config(case)
        counters.reset()
        mesh = Simulator(cfg, seed=0, mesh=mesh_of(dev))
        mesh.run(rounds)
        torch.cuda.synchronize()
        launches = dict(counters.launches)
        if case == "cadence_headline":
            check(counters.kernel_launches("pairs_totals") == rounds * 3 * MESH_BLOCKS
                  and counters.kernel_launches("pairs_pull") == rounds * 3 * MESH_BLOCKS
                  and not counters.plain_calls and not counters.fallbacks,
                  "the cadence mesh left the column-block kernels")
        else:
            check(not launches and dict(counters.fallbacks) == {"fault_plan": rounds},
                  "fault_bench's mesh did not run plain ('fault_plan')")
        whole = Simulator(cfg, seed=0, device=dev)
        whole.run(rounds)
        torch.cuda.synchronize()
        check(states_equal(mesh.state, whole.state),
              f"{case} on {MESH_BLOCKS} blocks differs from the unsharded run")
        out[case] = {"rounds": rounds, "launches": launches}
        log("faults", f"{case} on {MESH_BLOCKS} column blocks, {rounds} rounds == the unsharded "
            f"run; launches {launches} ({card_line})")
        del mesh, whole
    return out


def fault_plans(dev, card_line):
    """Phase 15: (a)-(f) above, each run from counters at 0."""
    t0 = time.perf_counter()
    arm = fault_bench_arm(dev, card_line)
    flaky, flaky_fd = flaky_headline(dev, card_line)
    cadence, cadence_entries = cadence_headline(dev, card_line)
    digests, amnesia_fd = fault_digest_cases(dev, card_line)
    sweeps = fault_sweeps(dev, card_line)
    meshes = fault_meshes(dev, card_line)
    secs = time.perf_counter() - t0
    log("phase15", f"{secs:.1f} s")
    return {"fault_bench": arm, "flaky_headline": flaky, "cadence_headline": cadence,
            "digest_cases": digests, "sweeps": sweeps, "meshes": meshes,
            "seconds": secs}, cadence_entries + [flaky_fd, amnesia_fd]


# -- the simulator's user surface (phase 16) ----------------------------------------
#
# Checkpoints (the headline saved at tick 8 and resumed on the card, on 8
# column blocks and on the CPU; a 3-lane sweep), telemetry (the stride
# sampler and the trace writer on the headline and the north star, timed
# against untracked runs), the variant override and SimCluster at the
# headline's width, and BASELINE config 1's 3-node counterpart. The
# reference's values are REF_DIGESTS' "resume_headline" and
# "simcluster_headline", from tools/torch_reference_digests.py.

RESUME_TICK = 8  # tools/torch_reference_digests.py RESUME_SAVE_TICK
# The sweep checkpoint's lanes: the headline profile at 2,048 nodes with
# its budget cut to 512 key-versions, so they converge (round 24) well
# after the save at tick 8 (at 2,618 they converge at 8).
SWEEP_CKPT_N, SWEEP_CKPT_BUDGET, SWEEP_CKPT_PHIS = 2_048, 512, [7.0, 8.0, 9.0]
TELEMETRY_STRIDE, NS_TELEMETRY_STRIDE = 4, 64
TELEMETRY_ARMS = ("off", 4, 64, 64, 4, "off")  # interleaved: no trend favours an arm
TELEMETRY_ROUNDS = 96
# SimCluster's script, tools/torch_reference_digests.py SIMCLUSTER_*.
SC_OWNERS = tuple(k * 640 for k in range(16))
SC_KILLED = (7, 2_001, 5_003, 10_239)
SC_KILL_ROUNDS, SC_PAIRS, SC_STEPS = 32, 512, 16
SAVER = concurrent.futures.ThreadPoolExecutor(max_workers=1)  # the headline's save


def states_equal_host(a, b) -> bool:
    """Field equality of two states on any devices."""
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()) for f in STATE_FIELDS)


def plain_round_equal(sim, what) -> dict:
    """One more round from ``sim``'s state (gathered on a mesh) through the
    kernels and through the plain path, each from its own copy, on the
    run's layout: every mode the round launches, composed as the round
    composes them, held against its plain version on the run's own state.
    Returns the kernel round's launches (the counters are reset)."""
    st = sim.state
    plain_cfg = dataclasses.replace(sim.cfg, use_pallas=False, use_pallas_fd=False)
    place = {"mesh": sim.mesh} if sim.mesh is not None else {"device": sim.device}
    out = []
    for cfg in (sim.cfg, plain_cfg):
        counters.reset()
        copy = st.replace(**{f: getattr(st, f).clone() for f in STATE_FIELDS})
        one = Simulator(cfg, seed=sim.seed, state=copy, **place)
        one.run(1)
        torch.cuda.synchronize()
        out.append((one.state, dict(counters.launches)))
    check(states_equal(out[0][0], out[1][0]),
          f"{what}: a round through the kernels differs from the plain round")
    check(not out[1][1], f"{what}: the plain round launched a kernel")
    del out[1], st
    torch.cuda.empty_cache()
    return out[0][1]


def start_headline_save(dev, tmp):
    """The headline run to tick 8 on the card, its state copied to the
    host, then ``Simulator.save`` of that copy on a thread of its own: one
    host core's compression (about two minutes), which the card work
    after it overlaps. The copy frees the card of it and the save counts
    nothing in ``counters``. Returns the save's future: (path, bytes,
    seconds)."""
    path = tmp / "headline.npz"
    sim = Simulator(headline_config(), seed=0, device=dev)
    sim.run(RESUME_TICK)
    st = sim.state
    host = Simulator(sim.cfg, seed=0, device="cpu",
                     state=st.replace(**{f: getattr(st, f).cpu() for f in STATE_FIELDS}))
    del sim, st
    torch.cuda.empty_cache()
    counters.reset()

    def save():
        t0 = time.perf_counter()
        host.save(path)
        return path, path.stat().st_size, time.perf_counter() - t0

    return SAVER.submit(save)


def checkpoint_headline(dev, card_line, saving):
    """(a) The headline saved at tick 8 (``saving``), resumed on the CPU
    for 2 rounds, on 8 column blocks to convergence, and on the card,
    where ticks 9-11 equal the reference's digests (its own save and
    resume) and the run converges at 24 with every field equal to the
    uninterrupted run's."""
    cfg, want = headline_config(), REF_DIGESTS["resume_headline"]["converged_round"]
    counters.reset()
    sim = Simulator(cfg, seed=0, device=dev)
    whole = sim.run_until_converged(max_rounds=200)
    check(whole == want, f"the uninterrupted headline converged at {whole}")
    t0 = time.perf_counter()
    path, size, save_s = saving.result()
    wait_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = Simulator.resume(path, device="cpu")
    on_cpu.run(2)
    cpu_s = time.perf_counter() - t0
    counters.reset()
    t0 = time.perf_counter()
    mesh = Simulator.resume(path, mesh=mesh_of(dev))
    torch.cuda.synchronize()
    mesh_load_s = time.perf_counter() - t0
    mesh_round = mesh.run_until_converged(max_rounds=200)
    mesh_launches = dict(counters.launches)
    check(mesh_round == want, f"the headline resumed on {MESH_BLOCKS} blocks converged at "
          f"{mesh_round}, the reference at {want}")
    check(counters.kernel_launches("pairs_totals") == 3 * MESH_BLOCKS * (mesh.tick - RESUME_TICK)
          and not counters.plain_calls and not counters.fallbacks,
          "the resumed mesh left the column-block kernels")
    check(mesh.tick == sim.tick and states_equal(mesh.state, sim.state),
          "the resumed mesh's gathered state != the uninterrupted run's")
    plain_round_equal(mesh, "the resumed mesh")
    del mesh
    counters.reset()
    t0 = time.perf_counter()
    resumed = Simulator.resume(path, device=dev, chunk=1)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(resumed.cfg == cfg and resumed.seed == 0 and resumed.tick == RESUME_TICK,
          "the resumed headline is not the saved run")
    for tick in (9, 10, 11):
        resumed.run(1)
        check_digests("resume_headline", resumed.state, tick)
        if tick == 10:
            check(states_equal_host(resumed.state, on_cpu.state),
                  "the headline resumed on the CPU != the card's at tick 10")
    del on_cpu
    resumed.chunk = 8
    converged = resumed.run_until_converged(max_rounds=200)
    launches = dict(counters.launches)
    check(converged == want, f"the resumed headline converged at {converged}, the reference "
          f"at {want}")
    check(counters.kernel_launches("pairs_pull") == 3 * (resumed.tick - RESUME_TICK)
          and not counters.plain_calls and not counters.fallbacks,
          "the resumed headline left the pairs kernels")
    sim.run(resumed.tick - sim.tick)
    check(states_equal(resumed.state, sim.state),
          "the resumed headline != the uninterrupted run")
    plain_round_equal(resumed, "the resumed headline")
    log("resume", f"headline saved at tick {RESUME_TICK}: {size} bytes in {save_s:.2f} s (on a "
        f"thread of its own beside the card's work; {wait_s:.2f} s waited for it); loaded "
        f"in {load_s:.2f} s (card), {mesh_load_s:.2f} s ({MESH_BLOCKS} blocks); ticks 9-11 == "
        f"the reference's digests; converged at {converged} (the reference's {want}), every "
        f"field == the uninterrupted run's; on {MESH_BLOCKS} blocks {mesh_round}, gathered "
        f"state equal; on the CPU 2 rounds in {cpu_s:.1f} s == the card's tick 10; launches "
        f"{launches}, mesh {mesh_launches} ({card_line})")
    del sim, resumed
    torch.cuda.empty_cache()
    return {"bytes": size, "save_s": save_s, "save_wait_s": wait_s, "load_s": load_s,
            "mesh_load_s": mesh_load_s,
            "cpu_two_rounds_s": cpu_s, "converged_round": converged,
            "mesh_converged_round": mesh_round, "launches": launches,
            "mesh_launches": mesh_launches}


def sweep_checkpoint(dev, card_line, tmp):
    """(b) A 3-lane phi sweep at 2,048 nodes (budget 512) saved at tick 8
    and resumed (with ``metrics=``): each lane's converged round and
    state equal the uninterrupted sweep's, and the gauges equal
    ``result()``."""
    cfg = dataclasses.replace(headline_config(SWEEP_CKPT_N), budget=SWEEP_CKPT_BUDGET)
    seeds = list(range(len(SWEEP_CKPT_PHIS)))
    path = tmp / "sweep.npz"
    counters.reset()
    whole = SweepSimulator(cfg, seeds, phi_threshold=SWEEP_CKPT_PHIS, device=dev)
    rounds = whole.run_until_converged(max_rounds=400)
    part = SweepSimulator(cfg, seeds, phi_threshold=SWEEP_CKPT_PHIS, device=dev)
    part.run(RESUME_TICK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part.save(path)
    save_s, size = time.perf_counter() - t0, path.stat().st_size
    reg = MetricsRegistry()
    t0 = time.perf_counter()
    resumed = SweepSimulator.resume(path, device=dev, metrics=reg)
    load_s = time.perf_counter() - t0
    got = resumed.run_until_converged(max_rounds=400)
    check(got == rounds and min(got) > RESUME_TICK and resumed.tick == whole.tick,
          f"the resumed sweep converged at {got}, the uninterrupted one at {rounds}")
    for s in range(len(seeds)):
        check(states_equal(lane(resumed.states, s), lane(whole.states, s)),
              f"lane {s} of the resumed sweep != the uninterrupted sweep's")
    check(counters.kernel_launches("pairs_pull") > 0 and not counters.plain_calls,
          "the sweeps left the lane launches")
    rows, snap = resumed.result().rows(), reg.snapshot()
    gauge = "aiocluster_sim_{}{{engine=torch,lane={}}}"
    check(snap["aiocluster_sim_sweep_lanes{engine=torch}"] == len(rows)
          and snap["aiocluster_sim_sweep_lanes_converged{engine=torch}"] == len(rows)
          and all(snap[gauge.format("lane_rounds_to_convergence", r["lane"])]
                  == r["rounds_to_convergence"]
                  and snap[gauge.format("lane_version_spread", r["lane"])] == r["version_spread"]
                  for r in rows), "the sweep's gauges != its result()")
    log("resume", f"{len(seeds)}-lane phi sweep at {SWEEP_CKPT_N} saved at tick {RESUME_TICK}: "
        f"{size} bytes in {save_s:.2f} s, loaded in {load_s:.2f} s; converged at {got}, each "
        f"lane == the uninterrupted sweep's; gauges == result() ({card_line})")
    del whole, part, resumed
    return {"bytes": size, "save_s": save_s, "load_s": load_s, "rounds_to_convergence": got}


def telemetry_headline(dev, card_line, tmp):
    """(c) The headline with a registry, a trace writer and stride 4 (chunk
    4): converges at 24, its series holds ticks 4, 8, ..., 24 and ends
    at ``metrics()``, the trace one header and one event a sample; its
    launched modes on its state against their plain versions; one
    ``metrics_sample`` timed by CUDA events; ms a round without and with
    the sampler at strides 4 and 64, interleaved."""
    cfg = headline_config()
    reg, trace_path = MetricsRegistry(), tmp / "telemetry.jsonl"
    counters.reset()
    with TraceWriter(trace_path) as tw:
        sim = Simulator(cfg, seed=0, device=dev, chunk=TELEMETRY_STRIDE, metrics=reg,
                        metrics_stride=TELEMETRY_STRIDE, trace_writer=tw)
        converged = sim.run_until_converged(max_rounds=200)
        launches = dict(counters.launches)
        series = sim.flush_metrics()
    check(converged == CONVERGED_ROUND, f"the telemetry headline converged at {converged}")
    check(counters.kernel_launches("pairs_pull") == 3 * sim.tick and not counters.plain_calls,
          "the telemetry headline left the pairs kernels")
    ticks = [s["tick"] for s in series]
    check(ticks == list(range(TELEMETRY_STRIDE, CONVERGED_ROUND + 1, TELEMETRY_STRIDE)),
          f"the telemetry series holds ticks {ticks}")
    last = sim.metrics()
    check(all(float(v) == series[-1][k] for k, v in last.items()),
          "the series' last sample != metrics()")
    events = read_trace(trace_path)
    check(events[0]["event"] == "trace_header"
          and [e["event"] for e in events[1:]] == ["sim_round"] * len(series)
          and [e["tick"] for e in events[1:]] == ticks, "the trace file is not one header "
          "and one sim_round event a sample")
    snap = reg.snapshot()
    check(snap["aiocluster_sim_tick{engine=torch}"] == CONVERGED_ROUND
          and snap["aiocluster_sim_converged_owners{engine=torch}"] == N
          and snap["aiocluster_sim_rounds_total{engine=torch}"] == CONVERGED_ROUND,
          "the registry's gauges disagree with the run")
    entries = round_entries(dev, sim, launches, "telemetry", check_last=True)
    sample_ms = cuda_ms(lambda: gossip.metrics_sample(sim.state), 20)
    del sim
    times = collections.defaultdict(list)
    for arm in TELEMETRY_ARMS:
        kw = {} if arm == "off" else {"metrics": MetricsRegistry(), "metrics_stride": arm}
        rate = Simulator(cfg, seed=0, device=dev, chunk=TELEMETRY_STRIDE, **kw)
        times[str(arm)].append(round_rate(rate, rounds=TELEMETRY_ROUNDS, warmup=8))
        rate.flush_metrics()
        del rate
    log("telemetry", f"headline, stride {TELEMETRY_STRIDE}: converged at {converged}; series "
        f"ticks {ticks}, last == metrics(); trace {len(events)} lines; metrics_sample "
        f"{sample_ms:.4f} ms (CUDA events); ms a round (chunk {TELEMETRY_STRIDE}, arms "
        f"{TELEMETRY_ARMS}): " + ", ".join(f"{k} {v}" for k, v in times.items())
        + f" ({card_line})")
    return {"converged_round": converged, "ticks": ticks, "trace_lines": len(events),
            "metrics_sample_ms": sample_ms, "round_ms": dict(times)}, entries


def telemetry_north_star(dev, card_line, untracked_peak_gb):
    """(d) The north star with a registry at stride 64: converges at 209;
    its peak memory beside the run without telemetry (phase 8's)."""
    cfg = lean_config(NORTH_STAR_N, budget=HEADLINE_BUDGET)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    reg = MetricsRegistry()
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=NORTH_STAR_SEED, device=dev, metrics=reg,
                    metrics_stride=NS_TELEMETRY_STRIDE)
    converged = sim.run_until_converged(max_rounds=400)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    series = sim.flush_metrics()
    peak = torch.cuda.max_memory_allocated() / 1e9
    ticks = [s["tick"] for s in series]
    check(converged == NORTH_STAR_ROUND, f"the telemetry north star converged at {converged}")
    check(ticks[-1] == sim.tick and series[-1]["all_converged"] == 1.0
          and series[-1]["converged_owners"] == NORTH_STAR_N,
          "the north star's series does not close converged at its final tick")
    log("telemetry", f"north star, stride {NS_TELEMETRY_STRIDE}: converged at {converged} in "
        f"{run_s:.2f} s ({run_s / sim.tick * 1e3:.3f} ms a round with set-up); series ticks "
        f"{ticks}; peak {peak:.2f} GB (without telemetry {untracked_peak_gb:.2f} GB) "
        f"({card_line})")
    del sim
    torch.cuda.empty_cache()
    return {"converged_round": converged, "ticks": ticks, "run_s": run_s,
            "peak_memory_gb": peak, "untracked_peak_memory_gb": untracked_peak_gb}


def variant_override(dev, card_line):
    """(e) The headline under AIOCLUSTER_TPU_PALLAS_VARIANT=m8, set for the
    constructor only: ``sim.cfg`` says m8, the m8 pulls and fd.cu (once a
    round) serve every round, no pairs pull, converged at 24; each
    launched mode on the run's state against its plain version; a bad
    value raises."""
    cfg = headline_config()
    with unittest.mock.patch.dict(os.environ, {gossip.VARIANT_ENV: "m8"}):
        sim = Simulator(cfg, seed=0, device=dev)
    check(sim.cfg.pallas_variant == "m8" and cfg.pallas_variant == "auto",
          "the variant override did not reach sim.cfg")
    counters.reset()
    converged = sim.run_until_converged(max_rounds=200)
    launches, rounds = dict(counters.launches), sim.tick
    check(converged == CONVERGED_ROUND, f"the m8 override converged at {converged}")
    check(counters.kernel_launches("m8_pull") > 0 and counters.kernel_launches("pairs_pull") == 0
          and launches.get("fd") == rounds and not counters.plain_calls,
          f"the m8 override ran {launches}")
    with unittest.mock.patch.dict(os.environ, {gossip.VARIANT_ENV: "m9"}):
        try:
            Simulator(cfg, seed=0, device=dev)
        except ValueError as err:
            refused = str(err)
        else:
            refused = None
    check(refused is not None and "must be auto/m8/pairs" in refused,
          "a bad variant override did not raise")
    entries = m8_round_entries(dev, sim, launches, "override")
    err, ms, plain_ms, b_ms, b_by, _ = fd_on_state(sim, "the m8 override")
    entries.append(dict(
        name="fd[override]", route="cuda", source="aiocluster_torch/ops/csrc/fd.cu",
        replaces="aiocluster_tpu/ops/pallas_fd.py:51", launches=launches.get("fd", 0),
        launches_per_round=launches.get("fd", 0) / rounds, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        path="override_headline_m8",
    ))
    log("override", f"{gossip.VARIANT_ENV}=m8: sim.cfg.pallas_variant {sim.cfg.pallas_variant!r}; "
        f"converged at {converged}; launches {launches}; fd.cu {ms:.4f} ms (bound {b_ms:.4f}; "
        f"plain {plain_ms:.3f}); a bad value raised: {refused} ({card_line})")
    del sim
    return {"converged_round": converged, "launches": launches}, entries


def simcluster_headline(dev, card_line):
    """(f) SimCluster at 10,240 x 16 keys: converges at 24 with no writes,
    then the script (tools/torch_reference_digests.py): the state's
    digests at ticks 28 and 68 equal the reference's; 512 seeded
    replica views equal the owners' own; compaction folds every entry;
    4 killed nodes leave an observer's live view in 32 rounds and are
    revived; its next round through the kernels equals the plain round.
    Returns (numbers, the cluster) for ``simcluster_step_ms``."""
    cfg, ref = headline_config(), REF_DIGESTS["simcluster_headline"]
    counters.reset()
    t0 = time.perf_counter()
    sc = SimCluster(cfg, seed=0, device=dev)
    setup_s = time.perf_counter() - t0
    names = sc.names
    converged = sc.run_until_converged(max_rounds=400)
    check(converged == ref["converged_round"], f"SimCluster converged at {converged}")
    owners = [names[i] for i in SC_OWNERS]
    for k, o in enumerate(owners):
        sc.set(o, f"key-{k:04d}", f"new-{k}")
        sc.set(o, "extra", f"x{k}")
    sc.step(2)
    for o in owners:
        sc.delete(o, "key-0001")
    sc.step(2)
    check_digests("simcluster_headline", sc.sim.state, sc.tick)
    first_digest_tick = sc.tick
    for k, o in enumerate(owners):
        sc.set_with_ttl(o, "ttl", f"t{k}")
    script_round = sc.run_until_converged(max_rounds=400)
    check(script_round == ref["script_converged_round"],
          f"SimCluster's script converged at {script_round}, the reference at "
          f"{ref['script_converged_round']}")
    rounds, launches = sc.tick, dict(counters.launches)
    check(counters.kernel_launches("pairs_pull") == 3 * rounds and not counters.plain_calls
          and not counters.fallbacks, "SimCluster left the pairs kernels")
    gen = np.random.default_rng(16)
    observers = gen.integers(0, N, SC_PAIRS)
    owned = np.concatenate([SC_OWNERS, gen.integers(0, N, SC_PAIRS - len(SC_OWNERS))])
    t0 = time.perf_counter()
    for i, j in zip(observers, owned):
        view = sc.replica_view(names[i], names[j])
        check(view == sc.replica_view(names[j], names[j]),
              f"replica_view({names[i]}, {names[j]}) != the owner's own")
    views_s = time.perf_counter() - t0
    first = sc.replica_view(names[int(observers[0])], owners[0])
    check(first.get("key-0000") == "new-0" and first.get("extra") == "x0"
          and "key-0001" not in first and "ttl" not in first,
          f"the written owner's view reads {sorted(first.items())[:4]}")
    total = int(sc.sim.blocks[0].max_version.sum())
    t0 = time.perf_counter()
    folded = sc.compact()
    compact_s = time.perf_counter() - t0
    check(folded == total and sc.compact() == 0,
          f"compact() folded {folded} of {total} entries")
    check(sc.replica_view(names[int(observers[1])], owners[1]) == sc.replica_view(
        owners[1], owners[1]), "a view changed across compaction")
    killed = {names[i] for i in SC_KILLED}
    for name in killed:
        sc.kill(name)
    sc.step(SC_KILL_ROUNDS)
    check_digests("simcluster_headline", sc.sim.state, sc.tick)
    digest_ticks = (first_digest_tick, sc.tick)
    live = set(sc.live_view(names[0]))
    check(not live & killed and len(live) == N - len(killed),
          "an observer's live view keeps killed nodes after 32 rounds")
    check(not set(sc.alive_nodes()) & killed, "alive_nodes() lists killed nodes")
    for name in killed:
        sc.revive(name)
    check(len(sc.alive_nodes()) == N, "revived nodes are not alive")
    plain_round_equal(sc.sim, "SimCluster")
    log("simcluster", f"{N} nodes x {cfg.keys_per_node} keys: set-up {setup_s:.2f} s; converged "
        f"at {converged}; script: ticks {digest_ticks} == the reference's digests, converged "
        f"at {script_round}; {SC_PAIRS} replica views == "
        f"the owners' own ({views_s:.2f} s); compact folded {folded} entries in "
        f"{compact_s:.2f} s; {len(killed)} killed nodes out of node-0's live view after "
        f"{SC_KILL_ROUNDS} rounds, revived; launches {launches} ({card_line})")
    return {"converged_round": converged, "script_converged_round": script_round,
            "folded": folded, "compact_s": compact_s, "views_s": views_s,
            "launches": launches}, sc


def simcluster_step_ms(sc, card_line, head_round_ms):
    """ms a ``step(1)`` of SimCluster (no write pending) on the host clock,
    beside the headline's ms a round (phase 7)."""
    sc.step(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SC_STEPS):
        sc.step(1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / SC_STEPS * 1e3
    log("simcluster", f"{step_ms:.3f} ms a step(1) over {SC_STEPS} steps (the headline "
        f"{head_round_ms:.3f} ms a round) ({card_line})")
    return step_ms


def baseline_config1(dev, card_line):
    """(g) BASELINE config 1's counterpart (examples/simple.py): 3 named
    nodes with one key each; it converges and every replica view is
    equal. At n % 128 != 0 the reference serves it with XLA: the
    counters say which phases ran plain."""
    names = ["simple1", "simple2", "simple3"]
    cfg = SimConfig(n_nodes=3, keys_per_node=1, fanout=3, budget=HEADLINE_BUDGET)
    counters.reset()
    sc = SimCluster(cfg, names=names, seed=0, device=dev,
                    initial_key_values={n: {"cluster": str(i + 1)} for i, n in enumerate(names)})
    converged = sc.run_until_converged(max_rounds=50)
    views = {(a, b): sc.replica_view(a, b) for a in names for b in names}
    check(converged is not None and all(v == views[(b, b)] for (_, b), v in views.items()),
          "the 3-node SimCluster did not converge to equal views")
    check(all(sc.live_view(n) == names for n in names), "a live view misses a node")
    out = {"converged_round": converged, "plain_calls": dict(counters.plain_calls),
           "fallbacks": dict(counters.fallbacks), "launches": dict(counters.launches)}
    log("config1", f"3 nodes x 1 key: converged at {converged}; every replica view equal; "
        f"plain calls {out['plain_calls']}, fallbacks {out['fallbacks']}, launches "
        f"{out['launches']} ({card_line})")
    return out


def user_surface(dev, card_line, head_round_ms, ns_peak_gb, saving=None):
    """Phase 16: (a)-(g) above, each run from counters at 0. The
    headline's save (``start_headline_save``; started here unless
    ``saving`` is the one main() started before phase 14) runs on its own
    thread beside the card work; the timed comparisons ((c)'s arms,
    SimCluster's steps) run after it."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if saving is None:
            saving = start_headline_save(dev, tmp)
        sweep_ckpt = sweep_checkpoint(dev, card_line, tmp)
        ns = telemetry_north_star(dev, card_line, ns_peak_gb)
        override, override_entries = variant_override(dev, card_line)
        cluster, sc = simcluster_headline(dev, card_line)
        ckpt = checkpoint_headline(dev, card_line, saving)
        telemetry, telemetry_entries = telemetry_headline(dev, card_line, tmp)
    cluster["step_ms"] = simcluster_step_ms(sc, card_line, head_round_ms)
    cluster["headline_round_ms"] = head_round_ms
    del sc
    config1 = baseline_config1(dev, card_line)
    secs = time.perf_counter() - t0
    log("phase16", f"{secs:.1f} s")
    return {"checkpoint": ckpt, "sweep_checkpoint": sweep_ckpt, "telemetry": telemetry,
            "telemetry_north_star": ns, "variant_override": override, "simcluster": cluster,
            "baseline_config1": config1, "seconds": secs}, telemetry_entries + override_entries


def c4_run(dev, card_line):
    """``--c4`` (ROADMAP C4): lean_config(65,536, budget=2618,
    pairing="choice") at seed 1 to the reference's certified round 81, on
    the plain choice path; its peak memory and time a round."""
    cfg = lean_config(C4_N, budget=HEADLINE_BUDGET, pairing="choice")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    sim = Simulator(cfg, seed=CHOICE_SEED, device=dev, chunk=8)
    converged = sim.run_until_converged(max_rounds=200)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    rounds, peak = sim.tick, torch.cuda.max_memory_allocated() / 1e9
    log("c4", f"lean_config({C4_N}, pairing='choice') seed {CHOICE_SEED}: converged at round "
        f"{converged} in {run_s:.2f} s ({run_s / rounds * 1e3:.1f} ms a round with the check), "
        f"{peak:.2f} GB peak; fallbacks {dict(counters.fallbacks)} ({card_line})")
    check(converged == C4_ROUND, f"the choice run at {C4_N} converged at {converged}, the "
          f"reference's certified round is {C4_ROUND}")
    return {"n": C4_N, "converged_round": converged, "run_s": run_s,
            "round_ms": run_s / rounds * 1e3, "peak_memory_gb": peak}


def device_record() -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    t_all = time.perf_counter()
    card_line = card()
    log("device", f"{card_line}; torch {torch.__version__} cuda {torch.version.cuda}")
    if sys.argv[1:] == ["--c4"]:
        # C4 alone: the certified choice run at 65,536 (plain PyTorch, no
        # kernel), outside the default run.
        c4 = c4_run(dev, card_line)
        print(card_line)
        print(json.dumps({"c4": c4}))
        print(device_record())
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (only --c4)", file=sys.stderr)
        return 2

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
        if name in ("pairs_pull", "m8_pull"):
            # The frame's rule lets two CTAs of 256 threads share an SM.
            check(max(regs) <= 128, f"{name}.cu takes more than 128 registers a thread")

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
    on_dev = prng.chunk_draws(key0.to(dev), 1, 16, cfg)
    on_cpu = prng.chunk_draws(key0, 1, 16, cfg)
    check(all(torch.equal(getattr(on_dev, f).cpu(), getattr(on_cpu, f)) for f in ("gm", "c", "p")),
          "device draws differ from host draws")
    log("draws", f"16 rounds x {cfg.fanout} matchings at N={N}: device == host")

    # Phase 9b: the headline config pinned to m8.
    head_m8, head_m8_launches, head_m8_other = headline_m8(dev, card_line)

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
    ns_m8, ns_m8_launches, ns_m8_times, ns_m8_other = north_star_m8(dev, card_line, m8_errs)
    experiment = i16_experiment(dev)
    kernels += m8_kernel_entries(
        dev, m8_errs, {"headline_m8": (head_m8_launches, head_m8["rounds_run"]),
                       "headline_m8_other": head_m8_other},
        {"north_star_m8": (ns_m8_launches, ns_m8["rounds_run"]),
         "north_star_m8_other": ns_m8_other},
        ns_m8_times, experiment,
    )

    # Phase 10: the memory ladder's rungs: their kernels against the plain
    # versions, then each rung's run at full width (counters at 0 just
    # before each, read just after), then their times.
    ladder_errs = check_ladder_kernels(dev)
    check_ladder_full_width(dev, ladder_errs)
    ns8, ns8_m8, ns8_times, ns8_other, ns8_m8_other = lean_int8_north_star(dev, card_line)
    u4, u4_launches, u4_rounds, u4_times, u4_other = lean_u4r_north_star(dev, card_line)
    wide, wide_launches, wide_rounds, wide_times, wide_other = widest_u4r(
        dev, card_line, ladder_errs)
    full, full_runs, full_times = full_ladder(dev, card_line)
    head_deep = headline_deep_parity(dev)
    runs = int8_side_paths(dev, card_line)
    runs.update(
        north_star_int8=ns8[1:], north_star_int8_m8=ns8_m8[1:],
        north_star_int8_m8_other=ns8_m8_other,
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

    # Phase 14: churn, the other pairings, greedy and the lifecycle at
    # full width. The churned headline runs the pairs kernels (each mode
    # held and timed on the run's own state) and config 4 the standalone
    # FD kernel.
    # Phase 16's checkpoint, started here: the headline run to tick 8 and
    # its save on a thread of its own (one host core's compression, about
    # two minutes) beside phases 14 and 15 on the card.
    ckpt_dir = tempfile.TemporaryDirectory()
    saving = start_headline_save(dev, Path(ckpt_dir.name))
    remaining, churn_entries, fd_entry = remaining_semantics(dev, card_line)
    kernels += churn_entries + [fd_entry]

    # Phase 15: fault plans and heterogeneity at full width. The cadence
    # headline runs the pairs kernels and the m8 pull with the cadence in
    # their pair validity (each mode held and timed on the run's own
    # state); the faulted runs' FD phase is fd.cu.
    fault_out, fault_entries = fault_plans(dev, card_line)
    kernels += fault_entries

    # Phase 16: the simulator's user surface at full width: checkpoints,
    # telemetry, the variant override and SimCluster. The telemetry
    # headline's pairs modes and the override's m8 modes and fd.cu are
    # held and timed on their runs' own states.
    surface, surface_entries = user_surface(dev, card_line, round_ms, ns["peak_memory_gb"],
                                            saving)
    ckpt_dir.cleanup()
    kernels += surface_entries
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
        f"star {ns_mesh['converged_round']} at {ns_mesh['round_ms']:.3f} ms a round; faults: "
        f"fault_bench split brain {fault_out['fault_bench']['converged_round']}, flaky "
        f"headline {fault_out['flaky_headline']['converged_round']}, cadence headline "
        f"{fault_out['cadence_headline']['converged_round']}; user surface: resumed "
        f"{surface['checkpoint']['converged_round']} (mesh "
        f"{surface['checkpoint']['mesh_converged_round']}), telemetry "
        f"{surface['telemetry']['converged_round']} / north star "
        f"{surface['telemetry_north_star']['converged_round']}, m8 override "
        f"{surface['variant_override']['converged_round']}, SimCluster "
        f"{surface['simcluster']['converged_round']}")

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
        "remaining_semantics": remaining,
        "fault_plans": fault_out,
        "user_surface": surface,
    }))
    print(device_record())
    return 0


if __name__ == "__main__":
    sys.exit(main())
