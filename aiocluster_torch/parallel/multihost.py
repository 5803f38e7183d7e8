"""A mesh across processes over ``torch.distributed`` (the port of the
reference's ``parallel/multihost.py``).

Every process holds its own column blocks of the owners and runs the
same rounds on them; the collectives of a round (the deficit totals,
the flag, the greedy offsets, the view draw's best, the metrics) gather
every process's partials and reduce them in global block order, so a
run over processes equals the single-process mesh bit for bit, whatever
order a backend's ``all_reduce`` would sum in.

Usage, on every participating process:

    from aiocluster_torch.parallel import multihost
    multihost.initialize("127.0.0.1:29500", num_processes=2, process_id=rank)
    sim = Simulator(cfg, mesh=multihost.global_mesh(), seed=0)
    sim.run_until_converged()        # every process steps together

CUDA processes join over NCCL, CPU ones (``device="cpu"``) over gloo.
NCCL takes one card a rank, so one card runs a world of one rank (its
blocks may still be many: ``global_mesh(["cuda:0"] * 8)``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    *,
    device: str = "cuda",
) -> None:
    """Join the process group. Call once, before any device use.

    ``coordinator_address`` is "host:port" of rank 0's rendezvous (a
    ``tcp://`` init method). ``device`` "cuda" joins over NCCL, rank r on
    card ``r % device_count`` (made the current device); "cpu" joins over
    gloo."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.initialize(device='cuda'): no CUDA device")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"multihost runs on 'cuda' or 'cpu', not {device!r}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id,
    )


def global_mesh(devices=None) -> Mesh:
    """The mesh over every process's blocks: this process's ``devices``
    (one block each, repeats allowed; by default one block on the
    process's device: its card under NCCL, the CPU under gloo), every
    process holding as many blocks."""
    if not dist.is_initialized():
        raise RuntimeError("multihost.global_mesh(): call multihost.initialize first")
    if devices is None:
        nccl = dist.get_backend() == "nccl"
        devices = [torch.device("cuda", torch.cuda.current_device()) if nccl else "cpu"]
    local = make_mesh(devices).devices
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise ValueError(f"every process must hold as many blocks: {counts}")
    return Mesh(local, span=ProcessSpan(dist.get_rank() * len(local), dist.get_world_size()))


def is_primary() -> bool:
    """True on the process that should do host-side reporting."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    """How many processes the job spans (the ``hosts=`` argument of
    ``sim.memory.plan`` / ``fits_verdict``)."""
    return dist.get_world_size() if dist.is_initialized() else 1


class ProcessSpan:
    """The collectives of a mesh across processes (``gossip.process_span``):
    ``gather`` returns every process's partials of one reduction in
    global block order; ``first_block`` is this process's first block,
    ``processes`` the world's size."""

    def __init__(self, first_block: int, processes: int) -> None:
        self.first_block = first_block
        self.processes = processes

    def gather(self, parts) -> list[torch.Tensor]:
        """One ``all_gather`` of this process's stacked partials (on its
        first block's device, bool as uint8): the world's, block by
        block, rank after rank."""
        dev = parts[0].device
        stack = torch.stack([p.to(dev) for p in parts])
        wire = stack.to(torch.uint8) if stack.dtype == torch.bool else stack
        out = [torch.empty_like(wire) for _ in range(dist.get_world_size())]
        dist.all_gather(out, wire.contiguous())
        flat = torch.cat(out).to(stack.dtype)
        return list(flat.unbind(0))
