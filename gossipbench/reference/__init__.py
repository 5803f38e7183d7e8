"""The plain reference of the gossip simulator: plain PyTorch ops, frozen
from the port's plain round (its threefry draws, the budgeted pull, the
phi-accrual failure detector, the convergence flag and the metrics
sample) and the port's fused-model byte count.

It imports neither ``jax`` nor any module of ``aiocluster_tpu`` or
``aiocluster_torch``: the benchmark hands it the configuration's fields
and a seed, and it works out the initial state and every round again
from those alone.
"""
