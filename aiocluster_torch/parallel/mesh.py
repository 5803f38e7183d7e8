"""Owner-axis sharding of the simulator in one process (the port of the
reference's ``parallel/mesh.py``).

One 1-D mesh axis, "owners", splits every (N, N) knowledge matrix into
column blocks: block k holds the owners ``k * n_local .. (k + 1) *
n_local - 1`` of all N rows, on the mesh's k-th device. Rows stay whole,
so a pair's two rows lie in every block and each block's sub-exchange is
local; the (N,) vectors and the tick are replicated. A round
(``ops.gossip.step_blocks``) runs each phase block after block between
its collectives: the deficit totals are summed over the blocks (in block
order, float32) before any block's pull, the FD phase runs per block at
its owner offset, and the convergence flag is the min over the blocks.
The result is the unsharded trajectory, bit for bit.

Where the reference's shard_map runs one program per device, the port
has one process: a device may appear more than once in a mesh, so
``make_mesh(["cuda:0"] * 8)`` is the reference's 8-shard computation on
one card and ``make_mesh(["cpu"] * 8)`` the tests' form; with distinct
devices the collectives copy each block's partials to the first block's
device and the result back. A mesh across processes
(parallel/multihost.py ``global_mesh``) lists this process's blocks:
each process holds its own, and ``collectives(mesh)`` makes every
reduction gather all processes' partials first.

Sweeps (sim/sweep.py) hold their lanes as the same column blocks with a
leading lane axis: (S, N, n_local) matrices, (S, N) vectors
(``shard_sweep_state``, ``sharded_sweep_chunk_fn``,
``sharded_sweep_metrics_fn``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import TYPE_CHECKING

import torch

from ..obs.profiling import span
from ..ops import gossip
from ..sim.config import SimConfig
from ..sim.state import STATE_FIELDS, SimState, init_lanes, init_state, lane, state_n_local

if TYPE_CHECKING:
    from .multihost import ProcessSpan

AXIS = "owners"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices along the "owners" axis, in block order: this
    process's blocks. A mesh of ``torch.distributed``
    (``parallel.multihost.global_mesh``) carries its ``span``, the
    processes its collectives reduce over (a world of one included);
    its blocks are then blocks ``span.first_block ..`` of
    ``span.processes`` processes'."""

    devices: tuple[torch.device, ...]
    span: ProcessSpan | None = None

    @property
    def processes(self) -> int:
        """The processes holding the mesh's blocks."""
        return 1 if self.span is None else self.span.processes

    @property
    def size(self) -> int:
        """The blocks of the whole mesh, over every process."""
        return len(self.devices) * self.processes

    @property
    def first_block(self) -> int:
        """The global index of this process's first block."""
        return 0 if self.span is None else self.span.first_block

    def n_local(self, cfg: SimConfig) -> int:
        """The owners a block holds (``gossip.block_width``: refused by
        name off the widths a mesh may take)."""
        return gossip.block_width(cfg, self.size)

    def offsets(self, cfg: SimConfig) -> tuple[int, ...]:
        """Each of this process's blocks' first global owner."""
        n_local = self.n_local(cfg)
        return tuple((self.first_block + k) * n_local for k in range(len(self.devices)))


def collectives(mesh: Mesh | None):
    """The context in which rounds and reductions of ``mesh``'s blocks
    run (``gossip.process_span``): over every process's blocks on a mesh
    across processes; this process alone on any other mesh or none."""
    return gossip.process_span(None if mesh is None else mesh.span)


def make_mesh(devices=None) -> Mesh:
    """A mesh over ``devices`` (names or ``torch.device``; repeats allowed:
    each entry is one block). By default every visible CUDA device."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh(): no CUDA device; list the devices")
        devices = [f"cuda:{i}" for i in range(count)]
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs))


# -- rule-based partition specs ------------------------------------------------
#
# One first-match-wins regex table over the SimState field names assigns
# every field its layout: the (N, N)-class matrices are split along their
# owner columns, the vectors and the tick replicated. There is no
# catch-all: a new field must be classified here, or the spec raises
# naming it (a silently replicated (N, N) matrix is 20 GB at 100k).

COLUMNS = (None, AXIS)  # rows whole, owner columns split
REPLICATED = ()

PARTITION_RULES: tuple[tuple[str, tuple], ...] = (
    (r"^(w|hb_known|last_change|imean|icount|live_view|dead_since)$", COLUMNS),
    (r"^(tick|max_version|heartbeat|alive)$", REPLICATED),
)


def match_partition_rules(rules, names) -> dict[str, tuple]:
    """First-match-wins regex table over field names -> spec. Unmatched
    names raise, naming both the field and the table."""
    out: dict[str, tuple] = {}
    for name in names:
        for pattern, spec in rules:
            if re.fullmatch(pattern, name):
                out[name] = spec
                break
        else:
            raise ValueError(
                f"SimState field {name!r} matches no partition rule; add it to "
                "parallel.mesh.PARTITION_RULES (the single place fields are "
                "classified for sharding)"
            )
    return out


def state_partition_spec() -> dict[str, tuple]:
    """Each SimState field's spec: ``COLUMNS`` or ``REPLICATED``."""
    return match_partition_rules(PARTITION_RULES, list(STATE_FIELDS))


def shard_state(state: SimState, mesh: Mesh) -> list[SimState]:
    """Split a whole state into this process's column blocks of the mesh,
    each copied to its device (a disabled (0, 0) matrix stays (0, 0)).
    The packed rungs split along their stored columns: a block of a
    packed w or live bitmap is a block of owners. A lane-batched state
    (a sweep's) splits the same last axis."""
    blocks = []
    for k, dev in enumerate(mesh.devices):
        g = mesh.first_block + k
        fields = {}
        for name, spec in state_partition_spec().items():
            t = getattr(state, name)
            if spec == COLUMNS and t.numel():
                width = t.shape[-1] // mesh.size
                t = t[..., g * width : (g + 1) * width].contiguous()
            fields[name] = t.to(dev)
        blocks.append(SimState(**fields))
    return blocks


def init_blocks(cfg: SimConfig, mesh: Mesh, initial_versions=None) -> list[SimState]:
    """``init_state`` made block by block on the mesh's devices: the whole
    state never exists at once."""
    n_local = mesh.n_local(cfg)
    return [
        init_state(cfg, initial_versions, device=dev, owner_offset=off, n_local=n_local)
        for dev, off in zip(mesh.devices, mesh.offsets(cfg))
    ]


def gather_state(blocks: list[SimState]) -> SimState:
    """The whole state of a mesh's blocks (lane-batched or not), on the
    first block's device (a copy of every matrix: use it at the widths
    that fit twice). One process's blocks only."""
    head = blocks[0]
    dev = head.w.device
    fields = {}
    for name, spec in state_partition_spec().items():
        t = getattr(head, name)
        if spec == COLUMNS and t.numel():
            t = torch.cat([getattr(b, name).to(dev) for b in blocks], dim=-1)
        fields[name] = t
    return SimState(**fields)


# -- chunks of rounds ------------------------------------------------------------


def sharded_chunk_fn(cfg: SimConfig, mesh: Mesh):
    """(blocks, key, m, tick) -> blocks: ``m`` rounds of a sharded state
    from host tick ``tick`` (the reference's ``sharded_chunk_fn``)."""
    offsets = mesh.offsets(cfg)

    def chunk(blocks, key, m, tick):
        with collectives(mesh):
            return gossip.run_rounds(blocks, key, cfg, offsets=offsets, m=m, tick=tick,
                                     tracked=False)[0]

    return chunk


def sharded_tracked_chunk_fn(cfg: SimConfig, mesh: Mesh):
    """(blocks, key, m, tick) -> (blocks, first): like
    ``sharded_chunk_fn``, also returning the exact tick at which full
    convergence was first observed in the chunk (0 if not), from the
    min over the blocks' flags each round."""
    offsets = mesh.offsets(cfg)

    def chunk(blocks, key, m, tick):
        with collectives(mesh):
            return gossip.run_rounds(blocks, key, cfg, offsets=offsets, m=m, tick=tick,
                                     tracked=True)

    return chunk


def sharded_metrics_fn(mesh: Mesh):
    """blocks -> the reference's sharded metrics bundle: the convergence
    metrics, the version spread and the staleness percentiles, each
    block's partials reduced over the blocks."""

    def metrics(blocks):
        offsets = block_offsets(blocks, mesh)
        with collectives(mesh):
            return gossip.metrics_sample_blocks(blocks, offsets)

    return metrics


def block_offsets(blocks, mesh: Mesh) -> tuple[int, ...]:
    """The first global owner of each of this process's ``blocks``."""
    n_local = state_n_local(blocks[0])
    return tuple((mesh.first_block + k) * n_local for k in range(len(blocks)))


# -- sweep lanes (sim/sweep.py): a leading lane axis --------------------------------
#
# A sweep's state is the SimState with a leading lane axis: its (S, N,
# n_local) matrices are column blocks of the owners exactly as above,
# lanes and rows whole, its (S, N) vectors replicated. A round of the
# blocks (``gossip.sweep_blocks``) reduces each collective per lane: one
# (S, N) or (S,) reduction over the blocks, not S of them.


def sweep_state_partition_spec() -> dict[str, tuple]:
    """Each lane-batched SimState field's spec: the same table with the
    lane axis prepended, (S, N, n_local) matrices split on the owners,
    everything else replicated."""
    return {name: (None, *spec) if spec else spec for name, spec in state_partition_spec().items()}


def shard_sweep_state(states: SimState, mesh: Mesh) -> list[SimState]:
    """Split a lane-batched state into this process's column blocks of
    the mesh (``shard_state`` on the last axis)."""
    return shard_state(states, mesh)


def init_sweep_blocks(cfg: SimConfig, mesh: Mesh, lanes: int, initial_versions=None):
    """``init_lanes`` made block by block on the mesh's devices."""
    n_local = mesh.n_local(cfg)
    return [
        init_lanes(cfg, lanes, initial_versions, device=dev, owner_offset=off, n_local=n_local)
        for dev, off in zip(mesh.devices, mesh.offsets(cfg))
    ]


def sharded_sweep_chunk_fn(cfg: SimConfig, mesh: Mesh, *, tracked: bool = False):
    """The lane-batched chunk over the mesh's blocks (the reference's
    ``sharded_sweep_chunk_fn``). Untracked: ``(blocks, keys, sweep, m,
    tick, draws, salts, run_salts, active) -> blocks``; tracked: the same
    and ``first`` -> ``(blocks, first)``, ``first`` the (S,) int32
    first-converged tick of each lane (0: not yet), carried on the device
    across chunks. ``draws`` are the chunk's ``prng.chunk_draws`` of the
    lanes' keys, ``salts`` its ``gossip.lane_salt_table``, ``tick`` the
    host tick before the chunk (``gossip.run_sweep_rounds``)."""
    offsets = mesh.offsets(cfg)

    def chunk(blocks, keys, sweep, m, tick, draws, salts, run_salts, active, first=None):
        if tracked and first is None:
            raise ValueError("a tracked chunk carries first")
        with collectives(mesh):
            blocks, first = gossip.run_sweep_rounds(
                blocks, keys, cfg, sweep, offsets=offsets, m=m, tick=tick, draws=draws,
                salts=salts, run_salts=run_salts, active=active,
                first=first if tracked else None,
            )
        return (blocks, first) if tracked else blocks

    return chunk


def sharded_sweep_metrics_fn(mesh: Mesh):
    """blocks -> the reference's per-lane sharded metrics: each lane's
    ``convergence_metrics`` and version spread (no staleness
    percentiles, as the reference's sharded sweep bundle), as (S,)
    device tensors, each reduced over the blocks, inside one
    ``aiocluster_torch.metrics_sample`` range."""

    def metrics(blocks):
        lanes = blocks[0].w.shape[0]
        offsets = block_offsets(blocks, mesh)
        per_lane = []
        with span("aiocluster_torch.metrics_sample"):
            with collectives(mesh):
                for s in range(lanes):
                    views = [lane(b, s) for b in blocks]
                    out = gossip.convergence_metrics_blocks(views, offsets)
                    out["version_spread"] = gossip.staleness_tensor_blocks(views, offsets).max()
                    per_lane.append(out)
            return {k: torch.stack([m[k] for m in per_lane]) for k in per_lane[0]}

    return metrics
