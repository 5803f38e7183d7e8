"""Time the unsharded sweep of aiocluster_torch on the card, tree against
tree: the headline phi ladder (8 lanes, seeds 0-7, phi 7.0 + 0.25 i) at
10,240 nodes in untracked chunks of 16, timed as chip_smoke.py's phase 11
times it (8 rounds of warm-up, then 48 rounds on the host clock between
two synchronizations), ``--repeats`` times.

    python3 tools/torch_sweep_rate.py ROOT [ROOT ...]

Each ROOT is a checkout holding ``aiocluster_torch/``; each runs in a
subprocess of its own that imports that checkout's package (and builds
its kernels into that checkout's ``build/``), one after the other in the
order given, so ``A B B A`` compares two trees on one card. Prints the
card's name and power limit, then one JSON line a run: its ms a sweep
round for each repeat and its lane-rounds/s over all of them. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

LANES = 8
ROUNDS, WARMUP = 48, 8


def child(root: str, repeats: int) -> None:
    sys.path.insert(0, root)
    import torch

    from aiocluster_torch import SweepSimulator
    from aiocluster_torch.sim.config import headline_config

    seeds = list(range(LANES))
    phis = [7.0 + 0.25 * i for i in range(LANES)]
    sweep = SweepSimulator(headline_config(), seeds, phi_threshold=phis, device="cuda",
                           chunk=16)
    sweep.run(WARMUP)
    torch.cuda.synchronize()
    ms = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        sweep.run(ROUNDS)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / ROUNDS * 1e3)
    print(json.dumps({"root": root, "round_ms": ms,
                      "lane_rounds_per_s": LANES * 1e3 * len(ms) / sum(ms)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.roots[0], args.repeats)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for root in args.roots:
        root = str(Path(root).resolve())
        done = subprocess.run([sys.executable, __file__, "--child", root,
                               "--repeats", str(args.repeats)], timeout=900)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
