"""The harness of the port's benchmark, driven by data: a cell of
``BENCHMARK.json`` names a configuration (``configs/<name>.json``: the
simulator's fields, where it comes from, how its outputs are checked)
and a traffic mix (``traffic/<name>.json``: how studies are driven, how
long a study may run, the traced slice, how many studies are checked);
its metrics are read by ``e2e/<name>.py`` and ``metrics/<name>.py``.

A run is: set-up (imports, the kernels built or loaded, one short study
that warms this cell's shapes), a measured window of whole studies in a
closed loop, then the check of what the window produced against the
plain reference (``reference/``), and one JSON line. With tracing on, a
fixed slice of whole studies runs under ``torch.profiler`` in place of
the window, and the per-layer metrics are read from its trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import json
import random
import sys
import time
import types
from pathlib import Path

import torch

from .reference import sim as ref

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aiocluster_tpu")


# -- the manifest and the files it names ------------------------------------------


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def entry(items: list[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path):
    """A module loaded from its file (names may hold dots)."""
    tag = "gossipbench_file_" + hashlib.sha1(str(path).encode()).hexdigest()[:12]
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with its configuration and traffic."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    bench: Path

    @property
    def fields(self) -> dict:
        return self.config["sim_config"]


def reports(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    """Whether a metric is reported in ``cell``: its ``workloads`` list,
    or without one every cell (a per-layer metric: every cell that
    reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(workload: str, root: Path = ROOT, bench: Path = BENCH,
              overrides: dict | None = None, traffic_overrides: dict | None = None) -> Cell:
    """The cell ``workload`` of the manifest under ``root``, its files
    read from ``bench``; ``overrides`` replace simulator fields and
    ``traffic_overrides`` traffic parameters (tests shrink a cell with
    them)."""
    man = load_manifest(root)
    wl = entry(man["workloads"], workload, "workload")
    cfg = entry(man["configs"], wl["config"], "configuration")
    config = json.loads((root / cfg["file"]).read_text())
    config["sim_config"] = {**config["sim_config"], **(overrides or {})}
    traffic = json.loads((bench / "traffic" / f"{wl['traffic']}.json").read_text())
    traffic.update(traffic_overrides or {})
    e2e = [m for m in man["end_to_end"] if reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if reports(m, workload, names)]
    return Cell(workload, wl["chips"], config, traffic, e2e, per_layer, bench)


def derive_seed(seed: int, *path) -> int:
    """A 32-bit seed drawn from the run's ``--seed`` and a path of
    indices: the same path gives the same seed."""
    text = ":".join(str(x) for x in (seed, *path)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=4).digest(), "little")


def span(name: str, on: bool):
    """A ``torch.profiler`` range where tracing is on."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def log(msg: str) -> None:
    """A progress line on standard error."""
    print(f"gossipbench: {msg}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# -- the program under test, driven as the traffic mix says -------------------------


@dataclasses.dataclass
class Study:
    """One study: its seeds (one a lane), each lane's first converged
    round (None: not within the cap), the rounds simulated, its wall time
    from the simulator's construction to its answer, and the time of the
    construction alone; the flushed metric series of a sampling study,
    the error of one that raised, and the final state where kept."""

    index: int
    seeds: list[int]
    first: list[int | None] = dataclasses.field(default_factory=list)
    ticks: int = 0
    wall_s: float = 0.0
    init_s: float = 0.0
    series: list[dict] | None = None
    error: str | None = None
    state: object = None

    @property
    def failed(self) -> bool:
        return self.error is not None or not self.first or any(f is None for f in self.first)

    @property
    def lanes(self) -> int:
        return len(self.seeds)


class Program:
    """``aiocluster_torch``'s entry points as a traffic mix drives them:
    kind ``simulator`` builds ``Simulator(cfg, seed, chunk, [metrics,
    metrics_stride])`` a study and runs ``run_until_converged`` (then
    ``flush_metrics`` when the mix samples); kind ``sweep`` builds
    ``SweepSimulator(cfg, seeds, <lane values>, chunk)`` and runs it until
    every lane has converged."""

    def __init__(self, cell: Cell, device) -> None:
        import aiocluster_torch as port

        self.port = port
        self.cell, self.device = cell, torch.device(device)
        self.cfg = port.SimConfig(**cell.fields)
        t = cell.traffic
        self.kind, self.chunk, self.cap = t["kind"], int(t["chunk"]), int(t["cap"])
        self.lanes = int(t.get("lanes", 1))
        self.stride = t.get("metrics_stride")
        self.lane_values = {
            name: [spec["start"] + spec["step"] * i for i in range(self.lanes)]
            for name, spec in t.get("lane_values", {}).items()
        }

    def seeds(self, run_seed: int, k) -> list[int]:
        return [derive_seed(run_seed, k, s) for s in range(self.lanes)]

    def lane_fields(self, s: int) -> dict:
        """The simulator fields lane ``s`` runs with."""
        return {**self.cell.fields, **{n: v[s] for n, v in self.lane_values.items()}}

    def build(self, seeds: list[int]):
        port = self.port
        if self.kind == "sweep":
            return port.SweepSimulator(self.cfg, seeds, chunk=self.chunk, device=self.device,
                                       **self.lane_values)
        metrics = {}
        if self.stride is not None:
            metrics = dict(metrics=port.MetricsRegistry(), metrics_stride=int(self.stride))
        return port.Simulator(self.cfg, seed=seeds[0], chunk=self.chunk, device=self.device,
                              **metrics)

    def study(self, index: int, seeds: list[int], *, traced: bool = False,
              keep: bool = False, max_rounds: int | None = None) -> Study:
        """Run one study; ``keep`` holds its final state in the result."""
        out = Study(index, seeds)
        t0 = time.perf_counter()
        try:
            with span("gossipbench.study_init", traced):
                sim = self.build(seeds)
                if traced:
                    sync(self.device)
            out.init_s = time.perf_counter() - t0
            with span("gossipbench.run_until_converged", traced):
                first = sim.run_until_converged(max_rounds=max_rounds or self.cap)
            if self.stride is not None:
                with span("gossipbench.flush_metrics", traced):
                    out.series = sim.flush_metrics()
            out.wall_s = time.perf_counter() - t0
            out.first = list(first) if isinstance(first, list) else [first]
            out.ticks = int(sim.tick)
            if keep:
                out.state = sim.states if self.kind == "sweep" else sim.state
        except Exception as exc:  # a study that raises is a failed answer
            out.wall_s = time.perf_counter() - t0
            out.error = f"{type(exc).__name__}: {exc}"
        return out

    def warm_up(self, run_seed: int) -> None:
        """One short study of this cell's shapes: every kernel of its
        rounds built or loaded, every plain path run once."""
        rounds = int(self.cell.traffic["warmup_rounds"])
        st = self.study(-1, self.seeds(run_seed, "warmup"), max_rounds=rounds)
        if st.error:
            raise RuntimeError(f"warm-up study failed: {st.error}")


def run_window(program: Program, run_seed: int, seconds: float) -> tuple[list[Study], float]:
    """Whole studies in a closed loop until ``seconds`` have passed; the
    study in flight then is finished and counted. Returns the studies
    and the window's length, which ends in a device sync."""
    studies: list[Study] = []
    t0 = time.perf_counter()
    k = 0
    while True:
        st = program.study(k, program.seeds(run_seed, k))
        studies.append(st)
        k += 1
        if st.error is not None or time.perf_counter() - t0 >= seconds:
            break
    sync(program.device)
    return studies, time.perf_counter() - t0


def run_slice(program: Program, run_seed: int, path: Path) -> tuple[list[Study], Path]:
    """The traffic's traced slice: whole studies under ``torch.profiler``
    until ``trace_rounds`` rounds have run, inside one
    ``gossipbench.slice`` range; the chrome trace is written to
    ``path``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import SLICE

    acts = [ProfilerActivity.CPU]
    if program.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    want = int(program.cell.traffic["trace_rounds"])
    studies: list[Study] = []
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            k = 0
            while sum(s.ticks for s in studies) < want:
                st = program.study(k, program.seeds(run_seed, k), traced=True)
                studies.append(st)
                k += 1
                if st.error is not None:
                    break
            sync(program.device)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return studies, path


# -- the check against the plain reference ----------------------------------------


# Every number compared is an exact count: the trajectory is
# deterministic, so each limit is 0.
LIMITS = {"rounds_off": 0, "state_diff": 0, "series_diff": 0}
STATE_FIELDS = ("w", "hb_known", "last_change", "imean", "icount", "live_view")


def _rows(n: int) -> int:
    return max(1, (1 << 26) // max(n, 1))


def count_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements that differ between two tensors of one shape (a shape
    that differs counts every element), a block of rows at a time."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel(), 1)
    if a.dim() < 2 or a.numel() == 0:
        return int((a.to(b.device) != b).sum())
    step = _rows(a.shape[-1])
    return sum(int((a[r:r + step].to(b.device) != b[r:r + step]).sum())
               for r in range(0, a.shape[0], step))


def diff_state(got, want, nums: dict) -> None:
    """Add the differing elements of the watermarks, the heartbeat
    knowledge and the failure detector's matrices of ``got`` (the
    program's state or a lane of it) against the reference's ``want``."""
    nums["state_diff"] += sum(count_diff(getattr(got, f), getattr(want, f)) for f in STATE_FIELDS)


def lane_of(states, s: int):
    """Lane ``s`` of a lane-batched state, field by field."""
    return types.SimpleNamespace(**{f: getattr(states, f)[s] for f in STATE_FIELDS})


def off(a: int | None, b: int | None, cap: int) -> int:
    """How far two first converged rounds lie apart (None: past the cap)."""
    return abs((cap + 1 if a is None else a) - (cap + 1 if b is None else b))


def diff_series(got: list[dict] | None, want: list[dict]) -> int:
    """Values that differ between a flushed metric series and the
    reference's samples (tick by tick, every metric of the sample; the
    series' wall-clock and derived keys are not the reference's)."""
    if got is None or len(got) != len(want):
        return max(len(want), 1)
    bad = 0
    for g, w in zip(got, want):
        for key, value in w.items():
            bad += key not in g or g[key] != value
    return bad


class Checker:
    """Compares what a candidate produced with the reference: the program,
    or the control (``control.Control``) in its place through the same
    interface, each mode one path for both."""

    def __init__(self, program: Program) -> None:
        self.program, self.device = program, program.device
        self.mode = program.cell.config["check"]
        self.nums = {k: 0 for k in limits(program.cell)}

    def ref_cfg(self, s: int = 0):
        return ref.Config.from_fields(self.program.lane_fields(s))

    def trajectory(self, study: Study) -> None:
        """Rerun the study through the candidate's own entry a chunk at a
        time (``run_until_converged`` up to each chunk's end) beside the
        reference's run of every lane from its own initial state, and
        compare every lane's state at each chunk's end, the first
        converged rounds (the window's and the rerun's) and the sampled
        series (the window's and the rerun's)."""
        p, nums = self.program, self.nums
        sampled = p.stride is not None
        lanes = range(len(study.seeds))
        refs = [ref.Run(self.ref_cfg(s), seed, self.device) for s, seed in zip(lanes, study.seeds)]
        ref_first, ref_series = [None for _ in lanes], []
        sim = p.build(study.seeds)
        t = 0
        while t < p.cap:
            t = min(t + p.chunk, p.cap)
            res = sim.run_until_converged(max_rounds=t)
            got_first = res if isinstance(res, list) else [res]
            while refs[0].state.tick < t:
                for s, run in zip(lanes, refs):
                    run.step()
                    if ref_first[s] is None and ref.converged(run.state):
                        ref_first[s] = run.state.tick
                if sampled:
                    ref_series.append({"tick": refs[0].state.tick, **ref.metrics_sample(refs[0].state)})
            states = [lane_of(sim.states, s) for s in lanes] if p.kind == "sweep" else [sim.state]
            for s in lanes:
                diff_state(states[s], refs[s].state, nums)
            ref_done = all(f is not None for f in ref_first)
            if all(f is not None for f in got_first) or (ref_done and t >= max(ref_first) + p.chunk):
                break
        for s in lanes:
            w_first = study.first[s] if s < len(study.first) else None
            nums["rounds_off"] = max(nums["rounds_off"], off(w_first, ref_first[s], p.cap),
                                     off(got_first[s], ref_first[s], p.cap))
        if sampled:
            nums["series_diff"] += (diff_series(study.series, ref_series)
                                    + diff_series(sim.flush_metrics(), ref_series))
        del refs, states, sim
        gc.collect()

    def stepwise(self, study: Study, rng: random.Random) -> None:
        """For a state too large for the reference to follow a whole
        study within a run: rerun the study through the candidate's own
        entry, stopping it at a few rounds, and hold it there against the
        reference: the initial state and the first chunk against the
        reference's own, one round drawn from the seed and the converging
        round from the candidate's own state there."""
        p, nums = self.program, self.nums
        seed, t_w = study.seeds[0], study.first[0]
        if t_w is None or t_w < 2:
            nums["rounds_off"] += p.cap + 1
            return
        cfg = self.ref_cfg()
        sim = p.build(study.seeds)

        def stop(tick: int) -> None:
            early = sim.run_until_converged(max_rounds=tick)
            if early is not None:
                nums["rounds_off"] = max(nums["rounds_off"], t_w - early)

        def from_candidate() -> ref.Run:
            st = sim.state
            return ref.Run(cfg, seed, self.device, state=ref.State(
                tick=int(st.tick), max_version=st.max_version.clone(),
                heartbeat=st.heartbeat.clone(), w=st.w.clone(), hb_known=st.hb_known.clone(),
                last_change=st.last_change.clone(), imean=st.imean.clone(),
                icount=st.icount.clone(), live_view=st.live_view.clone()))

        # The start: the initial state, then the first chunk.
        run = ref.Run(cfg, seed, self.device)
        diff_state(sim.state, run.state, nums)
        a = min(p.chunk, t_w - 1)
        stop(a)
        run.run_to(a)
        diff_state(sim.state, run.state, nums)
        del run
        gc.collect()
        # One round drawn from the seed, from the candidate's state.
        r = rng.randrange(a, t_w - 1) if t_w - 1 > a else None
        if r is not None:
            stop(r)
            run = from_candidate()
            run.step()
            stop(r + 1)
            diff_state(sim.state, run.state, nums)
            del run
            gc.collect()
        # The converging round, from the candidate's state just before it.
        stop(t_w - 1)
        log(f"stepwise: start and round {r} checked, converging round {t_w} next")
        run = from_candidate()
        before = ref.converged(run.state)
        got_first = sim.run_until_converged(max_rounds=t_w)
        run.step()
        first_ref = t_w - 1 if before else (t_w if ref.converged(run.state) else None)
        nums["rounds_off"] = max(nums["rounds_off"], off(t_w, got_first, p.cap),
                                 off(got_first, first_ref, p.cap), off(t_w, first_ref, p.cap))
        diff_state(sim.state, run.state, nums)
        del run, sim
        gc.collect()

    def compared(self, sample: int) -> int:
        """How many studies a check compares: the longest and ``sample``
        more (the stepwise mode: the longest alone)."""
        return 1 + sample if self.mode == "trajectory" else 1

    def check(self, studies: list[Study], run_seed: int, sample: int) -> dict:
        """Check the longest study and ``sample`` more drawn from the seed
        (the stepwise mode checks the longest alone); returns each number
        compared."""
        rng = random.Random(derive_seed(run_seed, "check"))
        done = [s for s in studies if not s.failed]
        if not done:
            return self.nums
        longest = max(done, key=lambda s: (s.ticks, -s.index))
        rest = [s for s in done if s is not longest]
        picked = [longest] + rng.sample(rest, min(self.compared(sample) - 1, len(rest)))
        for st in picked:
            if self.mode == "trajectory":
                self.trajectory(st)
            else:
                self.stepwise(st, rng)
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return self.nums


# -- a run ---------------------------------------------------------------------------


@dataclasses.dataclass
class Window:
    """What the end-to-end readers read: the window's studies and length,
    the set-up time, the peak of device memory and the cell's nodes."""

    studies: list[Study]
    window_s: float
    setup_s: float
    peak_bytes: int
    nodes: int


def read_e2e(cell: Cell, window: Window) -> dict:
    out = {}
    for m in cell.end_to_end:
        value = load_module(cell.bench / "e2e" / f"{m['name']}.py").value(window)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def read_per_layer(cell: Cell, trace) -> dict:
    out = {}
    for m in cell.per_layer:
        value = load_module(cell.bench / "metrics" / f"{m['name']}.py").read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def trace_info(program: Program, studies: list[Study]) -> dict:
    return {
        "rounds": sum(s.ticks for s in studies),
        "lane_rounds": sum(s.ticks * s.lanes for s in studies),
        "studies": len(studies),
        "lanes": program.lanes,
        "init_ms": [s.init_s * 1e3 for s in studies if s.error is None],
        "fields": program.cell.fields,
    }


def limits(cell: Cell) -> dict:
    """The numbers a cell compares, each with its limit: the sampled
    series only where the traffic samples."""
    sampled = cell.traffic.get("metrics_stride") is not None
    return {k: v for k, v in LIMITS.items() if sampled or k != "series_diff"}


def judge(cell: Cell, studies: list[Study], nums: dict) -> bool:
    """``correct``: no study failed, and every number compared lies within
    its limit."""
    return not any(s.failed for s in studies) and all(
        nums[k] <= limit for k, limit in limits(cell).items())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float | None = None, trace_path: Path | None = None) -> dict:
    """One run of ``cell``: set-up, the window (or the traced slice), the
    check; returns the result line's object."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    cuda = device.type == "cuda"
    program = Program(cell, device)
    program.warm_up(seed)
    sync(device)
    gc.collect()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    log(f"{cell.name}: set-up {setup_s:.3f} s")
    result_trace = None
    if trace:
        path = trace_path or ROOT / "build" / "gossipbench" / f"{cell.name}.trace.json"
        studies, path = run_slice(program, seed, path)
        from .trace import Trace

        result_trace = Trace.load(path, trace_info(program, studies))
        window = Window(studies, result_trace.window_s, setup_s, 0, cell.fields["n_nodes"])
    else:
        studies, window_s = run_window(program, seed, seconds)
        window = Window(studies, window_s, setup_s, 0, cell.fields["n_nodes"])
    if cuda:
        window.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    log(f"{cell.name}: {len(studies)} studies, {sum(s.ticks for s in studies)} rounds in "
        f"{window.window_s:.3f} s, first rounds {[s.first for s in studies[:8]]}")
    gc.collect()
    t_check = time.perf_counter()
    checker = Checker(program)
    nums = checker.check(studies, seed, int(cell.traffic["check_sample"]))
    log(f"{cell.name}: check {time.perf_counter() - t_check:.3f} s")
    failed = sum(s.failed for s in studies)
    correct = judge(cell, studies, nums)
    metrics = read_per_layer(cell, result_trace) if trace else read_e2e(cell, window)
    dev = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": cell.chips,
        "memory_peak_bytes": window.peak_bytes,
    }
    out = {"correct": bool(correct), "attempted": len(studies), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = result_trace.busy_s()
        dev["window_s"] = result_trace.window_s
        out["breakdown"] = {"device_ops": result_trace.device_ops(),
                            "idle_gaps": result_trace.idle_gaps()}
    errors = [s.error for s in studies if s.error]
    if errors:
        out["error"] = errors[0][:500]
    out["checks"] = {k: {"value": nums[k], "limit": lim} for k, lim in limits(cell).items()}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(args, t0: float) -> int:
    """The command line's run: refuses without the cards the cell asks
    for, then prints the result as the last line of standard output and
    each number compared, beside its limit, as the last lines of
    standard error."""
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gossipbench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"found {have}", file=sys.stderr)
        return 2
    try:
        import aiocluster_torch
    except ImportError as exc:
        print(f"gossipbench: the port is not in this checkout: {exc}", file=sys.stderr)
        return 2
    if not Path(aiocluster_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"gossipbench: aiocluster_torch loaded from {aiocluster_torch.__file__}, "
              f"not from this checkout ({ROOT})", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0=t0)
    bad = forbidden_modules()
    if bad:
        print(f"gossipbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0
