"""The benchmark of ``aiocluster_torch``, the PyTorch and CUDA port of the
gossip simulator (``python3 gossipbench/run.py --workload <name> ...``).

The manifest is ``BENCHMARK.json`` at the root of the checkout. A
configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, a per-layer metric's reader ``metrics/<name>.py``
and an end-to-end metric's ``e2e/<name>.py``: the harness
(``harness.py``) finds each by the name the manifest gives it. The plain
reference that decides ``correct`` is the module of ``reference/`` that
the configuration names (``sim`` by default); none imports JAX or any
module of the port.
"""
