"""Which implementation served each phase of the port's rounds: the
counterpart of the reference's ``pallas_fallbacks`` ledger.

- ``launches``: kernel launches, keyed ``"pairs_pull[<mode>]"`` (the mode
  flags set, e.g. ``diag``, ``pull``, ``check+fd``, ``totals+diag``; a
  sweep's lane launches lead with ``lanes``, e.g. ``lanes+diag``),
  ``"pairs_totals[diag]"`` / ``"pairs_totals[sum]"`` (``[lanes+sum]``
  ...) or ``"fd"``. Each wrapper adds one where it launches its kernel,
  and nowhere else: a lane launch counts once for all its lanes.
- ``plain_calls``: phases served by plain PyTorch ops, keyed by phase:
  ``"pull"`` counts sub-exchanges, ``"totals"`` their totals passes,
  ``"fd"`` standalone FD phases (a wrapper given CPU tensors counts here
  too; a sweep's plain round counts each lane's).
- ``fallbacks``: rounds whose phase a config asked the kernels for but
  plain PyTorch ops served, because the reference serves that route with
  XLA for want of a kernel too; keyed by the reference's reason name
  (``"fault_plan"``: an effective fault plan, whose link, crash and
  byzantine masks no kernel carries; ``"packed_dtype"``: the u4r rung
  with heartbeats or pinned to m8;
  ``"fd_packed_bookkeeping"``: int8 sample counters or the live bitmap
  off the pairs path; ``"fanout"``: a fanout-0 round, whose pull has no
  sub-exchange to carry the refresh and the FD epilogue;
  ``"sweep_needs_pairs"``: a sweep pinned to m8, which has no lane lift).
- ``refusals``: routes refused with ``NotImplementedError``, keyed by the
  message (which names the ``ROADMAP.md`` item that ports them: sweeps
  over a mesh).
"""

from __future__ import annotations

import collections

launches: collections.Counter = collections.Counter()
plain_calls: collections.Counter = collections.Counter()
fallbacks: collections.Counter = collections.Counter()
refusals: collections.Counter = collections.Counter()


def reset() -> None:
    """Zero every counter."""
    launches.clear()
    plain_calls.clear()
    fallbacks.clear()
    refusals.clear()


def kernel_launches(kernel: str) -> int:
    """Launches of one kernel (``"pairs_pull"``, ``"pairs_totals"``),
    over all its modes."""
    return sum(v for k, v in launches.items() if k.startswith(kernel + "["))


def refuse(reason: str):
    """Count a refusal and raise it."""
    refusals[reason] += 1
    raise NotImplementedError(reason)
