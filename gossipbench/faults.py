"""Faults planted in the timed path underneath a run, each of which the
check has to find (``correct`` false): a round that returns its state
unchanged, half of the rows (or of a sweep's lanes) left out of the
round, and the round's answer altered where it is produced (convergence
reported one round late).

    python3 gossipbench/faults.py --workload <name> --fault <fault> --seeds 1 2 3 [--seconds 5]

runs the cell with the fault planted, prints each run's numbers, and
exits 1 if any run came out correct.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gossipbench import harness  # noqa: E402


def state_unchanged(real):
    def step(blocks, *args, return_converged=False, **kw):
        if not return_converged:
            return list(blocks)
        lanes = blocks[0].w.shape[:-2]
        return list(blocks), torch.zeros(lanes, dtype=torch.bool, device=blocks[0].w.device)
    return step


def half_the_rows(real):
    def step(blocks, *args, **kw):
        n = blocks[0].w.shape[-2]
        kept = [b.w[..., n // 2:, :].clone() for b in blocks]
        out = real(blocks, *args, **kw)
        for b, k in zip(out[0] if isinstance(out, tuple) else out, kept):
            b.w[..., n // 2:, :] = k
        return out
    return step


def half_the_lanes(real):
    def step(blocks, *args, **kw):
        s = blocks[0].w.shape[0]
        kept = [b.w[s // 2:].clone() for b in blocks]
        out = real(blocks, *args, **kw)
        for b, k in zip(out[0] if isinstance(out, tuple) else out, kept):
            b.w[s // 2:] = k
        return out
    return step


def answer_late(real):
    seen = {}

    def step(blocks, *args, return_converged=False, tick=None, **kw):
        out = real(blocks, *args, return_converged=return_converged, tick=tick, **kw)
        if tick == 0:
            seen.clear()
        if not return_converged:
            return out
        new, flag = out
        prev = seen.get("flag")
        seen["flag"] = flag.clone()
        fresh = flag if prev is None else flag & ~prev
        return new, flag & ~fresh
    return step


FAULTS = {
    "state_unchanged": state_unchanged,
    "half_the_rows": half_the_rows,
    "half_the_lanes": half_the_lanes,
    "answer_late": answer_late,
}


def applies(fault: str, cell: harness.Cell) -> bool:
    """A sweep's lanes exist only in a sweep."""
    return fault != "half_the_lanes" or cell.traffic["kind"] == "sweep"


@contextlib.contextmanager
def planted(fault: str, cell: harness.Cell):
    """The round entry the cell's traffic drives (``step_blocks``, or a
    sweep's ``sweep_blocks``) replaced by its faulty form."""
    import aiocluster_torch.ops.gossip as gossip

    name = "sweep_blocks" if cell.traffic["kind"] == "sweep" else "step_blocks"
    real = getattr(gossip, name)
    setattr(gossip, name, FAULTS[fault](real))
    try:
        yield
    finally:
        setattr(gossip, name, real)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    passed = 0
    for seed in args.seeds:
        with planted(args.fault, cell):
            out = harness.run_cell(cell, seed, args.seconds, False, args.device)
        passed += out["correct"]
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": out["correct"], "failed": out["failed"],
                          "attempted": out["attempted"], "checks": out["checks"]}), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
