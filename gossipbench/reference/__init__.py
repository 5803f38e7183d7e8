"""The plain references of the gossip simulator, one module a semantics.

A configuration names its reference by ``"reference": "<module>"``, a
module of this package (without the key: ``sim``); the harness loads it
from its file, per cell, as a module of this package, so it may import
its neighbours relatively (``from . import prng``, ``from .sim import
...``). A reference module provides:

- ``Config.from_fields(fields)``: the configuration of a benchmark file's
  simulator fields; it raises ``NotImplementedError`` for any field or
  value whose semantics the module does not model;
- ``Run(cfg, seed, device, state=None, precision="float32")``: one seeded
  run from its own initial state (or from ``state``), with ``.step()``
  (one round), ``.run_to(tick)`` and ``.state``; ``precision`` names the
  lower precision the control computes in;
- ``converged(state)``: whether every node holds every owner's versions;
- ``metrics_sample(state)``: the metrics bundle of a state, a dict of
  floats under the program's keys;
- ``COMPARED``: the names of the state fields the check compares, each a
  tensor of the program's state and of the reference's ``State``;
- ``state_of(program_state)``: the program's state copied into the
  reference's ``State`` (the stepwise check follows the program from it).

No reference imports ``jax`` or any module of ``aiocluster_tpu`` or
``aiocluster_torch``: the benchmark hands it the configuration's fields
and a seed, and it works out the initial state and every round again
from those alone.
"""
