"""The control of the benchmark's comparison: the configuration's plain
reference with the budget's share computed in bfloat16, the nearest
precision below the float32 the configuration's round states, put in the
program's place through the program's own interface, so it goes through
the same window of studies and the same check. A cell's comparison has
to find it not correct on every seed:

    python3 gossipbench/control.py --workload <name> --seeds 1 2 3

prints, for each seed, every number compared and whether the control
came out correct (it must not), and exits 1 if it ever did.
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gossipbench import harness  # noqa: E402

PRECISION = "bfloat16"


class ControlSim:
    """One study of the control with the interface of the simulators the
    harness drives: every lane a run of the cell's reference in
    ``PRECISION``, stepped a chunk at a time, its convergence checked
    after every round (``run_until_converged``; ``run`` does not check)
    and, where the traffic samples, its metrics sampled after every
    round."""

    def __init__(self, program: harness.Program, seeds: list[int]) -> None:
        self.ref = ref = program.cell.reference
        self.runs = [ref.Run(ref.Config.from_fields(program.lane_fields(s)), seed,
                             program.device, precision=PRECISION)
                     for s, seed in enumerate(seeds)]
        self.chunk, self.sweep = program.chunk, program.kind == "sweep"
        self.first: list[int | None] = [None for _ in seeds]
        self.samples = None if program.stride is None else []

    @property
    def tick(self) -> int:
        return self.runs[0].state.tick

    @property
    def state(self):
        return self.runs[0].state

    @property
    def states(self) -> types.SimpleNamespace:
        """The lanes' compared fields, field by field, indexed by lane."""
        return types.SimpleNamespace(**{f: [getattr(r.state, f) for r in self.runs]
                                        for f in self.ref.COMPARED})

    def _round(self, tracked: bool = True) -> None:
        for s, run in enumerate(self.runs):
            run.step()
            if tracked and self.first[s] is None and self.ref.converged(run.state):
                self.first[s] = run.state.tick
        if self.samples is not None:
            self.samples.append({"tick": self.tick, **self.ref.metrics_sample(self.state)})

    def run(self, rounds: int) -> None:
        """``rounds`` more rounds, convergence unchecked."""
        for _ in range(rounds):
            self._round(tracked=False)

    def metrics(self) -> dict[str, float]:
        """The metrics bundle of the first lane's state."""
        return self.ref.metrics_sample(self.state)

    def run_until_converged(self, max_rounds: int):
        """Whole chunks until every lane has converged or ``max_rounds``
        have run; each lane's first converged round (a simulator's: the
        first lane's)."""
        while self.tick < max_rounds and None in self.first:
            end = min(self.tick + self.chunk, max_rounds)
            while self.tick < end:
                self._round()
        return list(self.first) if self.sweep else self.first[0]

    def flush_metrics(self) -> list[dict]:
        """The sampled series, closed at the current tick."""
        if not self.samples or self.samples[-1]["tick"] != self.tick:
            self.samples.append({"tick": self.tick, **self.ref.metrics_sample(self.state)})
        out, self.samples = self.samples, []
        return out


class Control(harness.Program):
    """The cell's traffic driven through the control instead of the
    program."""

    def build(self, seeds: list[int]) -> ControlSim:
        return ControlSim(self, seeds)


def control_run(cell: harness.Cell, seed: int, device) -> dict:
    """One run's check with the control in the program's place: as many
    of the cell's studies as a check compares, driven through the control
    as the window drives the program, then the check and the verdict."""
    control = Control(cell, device)
    checker = harness.Checker(control)
    sample = int(cell.traffic["check_sample"])
    studies = [control.study(k, control.seeds(seed, k)) for k in range(checker.compared(sample))]
    nums = checker.check(studies, seed, sample)
    return {"correct": harness.judge(cell, studies, nums),
            "failed": sum(s.failed for s in studies), "numbers": nums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    passed = 0
    for seed in args.seeds:
        out = control_run(cell, seed, args.device)
        passed += out["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
