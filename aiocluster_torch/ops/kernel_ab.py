"""Time the pull kernels of one checkout of this repository on one CUDA
card, for an A/B of two checkouts in one machine.

Run it as a file, with the checkout under test first on the import path:

    PYTHONSAFEPATH=1 PYTHONPATH=<checkout> python <this file> --label <name> [--out FILE]

It builds that checkout's kernels (``ops/_build.py``) and times, with
CUDA events (mean of ``--iters`` launches after two warm-up launches), the
launches of the main paths at their widths on random operands drawn on
the card from fixed seeds, so that two checkouts time the same work:

- the pairs pull: the headline's first, middle and last (check + fused FD)
  sub-exchanges at 10,240 (int16/int16/bfloat16, one CTA a pair), and the
  north star's at 100,352 (lean int16, on 4-CTA clusters);
- the totals pass: int16, int8 and (m8) int8 at 100,352, packed u4r at
  262,144, each summing and with the refresh;
- the m8 pull: the headline's modes at 10,240 (int16 with hb), and the
  north star's at 100,352 (lean int16) and the int8 north star's, fed the
  totals and, where the checkout's wrapper takes them, staged on the
  clusters of its rule.

A mode the checkout's wrappers refuse (a ValueError: an older checkout's
m8 wrapper stages no int16 row of 100,352) is recorded as refused. Prints one
JSON object a mode and writes them all to ``--out``. To compare two
checkouts, run them in one call in turns (A, B, B, A) and compare only
within that call.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time

import torch

from aiocluster_torch.ops import _build, m8_pull, m8_totals, pairs_pull, pairs_totals, prng
from aiocluster_torch.ops.fd import FdParams

HEADLINE_N, NORTH_STAR_N, WIDEST_U4R_N = 10_240, 100_352, 262_144
BUDGET, SALT, RUN_SALT = 2618, 3, 0x9E3779B9


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches, by CUDA
    events, after two warm-up launches."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def draw(gen, lo, hi, shape, dtype, dev):
    return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=dtype)


def matching(n, dev, gen):
    """A grouped matching of n rows and every row valid but a seeded
    tenth: (gm, c, valid, alive)."""
    gm, c, p = prng.grouped_matching(prng.key(9), n)
    alive = torch.rand(n, generator=gen, device=dev) < 0.9
    return gm.to(dev, torch.int32), c.to(dev, torch.int32), alive & alive[p.to(dev)], alive


def modes(dev):
    """The sections of timed launches: each a function that makes its
    operands on the card and returns {mode name: launch thunk} (the
    operands go with the thunks)."""
    takes_cluster = "cluster" in inspect.signature(m8_pull.m8_pull).parameters

    def headline_pairs():
        n = HEADLINE_N
        gen = torch.Generator(device=dev).manual_seed(1)
        gm, c, valid, alive = matching(n, dev, gen)
        w = draw(gen, 0, 17, (n, n), torch.int16, dev)
        hb = draw(gen, 0, 40, (n, n), torch.int16, dev)
        mv = draw(gen, 16, 20, (n,), torch.int32, dev)
        hbv = draw(gen, 38, 41, (n,), torch.int32, dev)
        fd = pairs_pull.FdOperands(
            40, draw(gen, 0, 40, (n, n), torch.int16, dev),
            (torch.rand((n, n), generator=gen, device=dev) * 6).to(torch.bfloat16),
            draw(gen, 0, 12, (n, n), torch.int16, dev),
            torch.zeros((n, n), dtype=torch.bool, device=dev),
            draw(gen, 0, 40, (n, n), torch.int16, dev), FdParams(10.0, 1000, 5.0, 16.5, 7.5),
        )
        args = (gm, c, valid, SALT, RUN_SALT, BUDGET)
        check = (mv, alive, alive)
        return {
            "pairs_pull[diag] headline": lambda: pairs_pull.pairs_pull(
                w, hb, *args, mv=mv, hbv=hbv),
            "pairs_pull[pull] headline": lambda: pairs_pull.pairs_pull(w, hb, *args),
            "pairs_pull[check+fd] headline": lambda: pairs_pull.pairs_pull(
                w, hb, *args, check=check, hbv=hbv, fd=fd),
        }

    def north_star_pairs():
        n = NORTH_STAR_N
        gen = torch.Generator(device=dev).manual_seed(2)
        gm, c, valid, alive = matching(n, dev, gen)
        w = draw(gen, 0, 17, (n, n), torch.int16, dev)
        mv = draw(gen, 16, 20, (n,), torch.int32, dev)
        args = (gm, c, valid, SALT, RUN_SALT, BUDGET)
        return {
            "pairs_pull[cluster+diag] north_star": lambda: pairs_pull.pairs_pull(
                w, None, *args, mv=mv, cluster=4),
            "pairs_pull[cluster] north_star": lambda: pairs_pull.pairs_pull(
                w, None, *args, cluster=4),
            "pairs_pull[cluster+check] north_star": lambda: pairs_pull.pairs_pull(
                w, None, *args, check=(mv, alive, alive), cluster=4),
            "pairs_totals[diag] int16 north_star": lambda: pairs_totals.pairs_totals(
                w, gm, c, valid, mv=mv),
            "pairs_totals[sum] int16 north_star": lambda: pairs_totals.pairs_totals(
                w, gm, c, valid),
        }

    def m8_north_star(wdt, k):
        def make():
            n = NORTH_STAR_N
            gen = torch.Generator(device=dev).manual_seed(3)
            gm, c, valid, _ = matching(n, dev, gen)
            w = draw(gen, 0, 17, (n, n), wdt, dev)
            mv = draw(gen, 16, 20, (n,), torch.int32, dev)
            out = torch.empty_like(w)
            args = (gm, c, valid, SALT, RUN_SALT, BUDGET)
            tot = m8_totals.m8_totals(w, gm, c, valid, mv=mv)
            rung = "int16" if wdt == torch.int16 else "int8"
            found = {
                f"m8_totals[diag] {rung} north_star": lambda: m8_totals.m8_totals(
                    w, gm, c, valid, mv=mv),
                f"m8_totals[sum] {rung} north_star": lambda: m8_totals.m8_totals(w, gm, c, valid),
                f"m8_pull[totals+diag] {rung} north_star": lambda: m8_pull.m8_pull(
                    w, None, *args, mv=mv, totals=tot, out=(out, None)),
                f"m8_pull[totals] {rung} north_star": lambda: m8_pull.m8_pull(
                    w, None, *args, totals=tot, out=(out, None)),
            }
            if wdt == torch.int8:
                found |= {
                    "pairs_totals[diag] int8 north_star": lambda: pairs_totals.pairs_totals(
                        w, gm, c, valid, mv=mv),
                    "pairs_totals[sum] int8 north_star": lambda: pairs_totals.pairs_totals(
                        w, gm, c, valid),
                }
            kw = {"cluster": k} if takes_cluster else {}
            found |= {
                f"m8_pull[staged+diag] {rung} north_star": lambda: m8_pull.m8_pull(
                    w, None, *args, mv=mv, out=(out, None), **kw),
                f"m8_pull[staged] {rung} north_star": lambda: m8_pull.m8_pull(
                    w, None, *args, out=(out, None), **kw),
            }
            return found
        return make

    def headline_m8():
        n = HEADLINE_N
        gen = torch.Generator(device=dev).manual_seed(4)
        gm, c, valid, _ = matching(n, dev, gen)
        w = draw(gen, 0, 17, (n, n), torch.int16, dev)
        hb = draw(gen, 0, 40, (n, n), torch.int16, dev)
        mv = draw(gen, 16, 20, (n,), torch.int32, dev)
        hbv = draw(gen, 38, 41, (n,), torch.int32, dev)
        out = (torch.empty_like(w), torch.empty_like(hb))
        args = (gm, c, valid, SALT, RUN_SALT, BUDGET)
        return {
            "m8_pull[diag] headline": lambda: m8_pull.m8_pull(
                w, hb, *args, mv=mv, hbv=hbv, out=out),
            "m8_pull[pull] headline": lambda: m8_pull.m8_pull(w, hb, *args, out=out),
        }

    def widest_u4r():
        n = WIDEST_U4R_N
        gen = torch.Generator(device=dev).manual_seed(5)
        gm, c, valid, _ = matching(n, dev, gen)
        w = draw(gen, 0, 256, (n, n // 2), torch.uint8, dev)
        bump = draw(gen, 0, 2, (n,), torch.int32, dev)
        return {
            "pairs_totals[packed+diag] u4r widest": lambda: pairs_totals.pairs_totals(
                w, gm, c, valid, mv=bump),
            "pairs_totals[packed+sum] u4r widest": lambda: pairs_totals.pairs_totals(
                w, gm, c, valid),
        }

    return (headline_pairs, headline_m8, north_star_pairs, m8_north_star(torch.int16, 4),
            m8_north_star(torch.int8, 2), widest_u4r)


def time_section(make, label, iters):
    """Make one section's operands, time each of its launches, and drop
    the operands on return. Returns the rows."""
    rows = []
    for name, fn in make().items():
        try:
            ms = cuda_ms(fn, iters)
        except ValueError as err:
            row = {"label": label, "mode": name, "refused": str(err)[:200]}
        else:
            row = {"label": label, "mode": name, "ms": ms}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--out")
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all()
    rows = []
    for make in modes(dev):
        rows += time_section(make, a.label, a.iters)
        torch.cuda.empty_cache()
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"label": a.label, "card": torch.cuda.get_device_name(0),
                       "seconds": time.perf_counter() - t0, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
