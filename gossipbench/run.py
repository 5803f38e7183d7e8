"""Runs one cell of the port's benchmark on the cards of this machine:

    python3 gossipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line with the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics read from a
``torch.profiler`` trace (``--trace 1``), whether the outputs were
correct, and the device; exits non-zero without a result where the cell's
CUDA devices are missing.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from gossipbench import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
