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
device and the result back.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from ..ops import gossip
from ..sim.config import SimConfig
from ..sim.state import STATE_FIELDS, SimState, init_state, state_n_local

AXIS = "owners"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices along the "owners" axis, in block order."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def n_local(self, cfg: SimConfig) -> int:
        """The owners a block holds (``gossip.block_width``: refused by
        name off the widths a mesh may take)."""
        return gossip.block_width(cfg, self.size)

    def offsets(self, cfg: SimConfig) -> tuple[int, ...]:
        """Each block's first global owner."""
        n_local = self.n_local(cfg)
        return tuple(k * n_local for k in range(self.size))


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
    """Split a whole state into the mesh's column blocks, each copied to
    its device (a disabled (0, 0) matrix stays (0, 0)). The packed rungs
    split along their stored columns: a block of a packed w or live
    bitmap is a block of owners."""
    blocks = []
    for k, dev in enumerate(mesh.devices):
        fields = {}
        for name, spec in state_partition_spec().items():
            t = getattr(state, name)
            if spec == COLUMNS and t.numel():
                width = t.shape[1] // mesh.size
                t = t[:, k * width : (k + 1) * width].contiguous()
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
    """The whole state of a mesh's blocks, on the first block's device
    (a copy of every matrix: use it at the widths that fit twice)."""
    head = blocks[0]
    dev = head.w.device
    fields = {}
    for name, spec in state_partition_spec().items():
        t = getattr(head, name)
        if spec == COLUMNS and t.numel():
            t = torch.cat([getattr(b, name).to(dev) for b in blocks], dim=1)
        fields[name] = t
    return SimState(**fields)


# -- chunks of rounds ------------------------------------------------------------


def sharded_chunk_fn(cfg: SimConfig, mesh: Mesh):
    """(blocks, key, m, tick) -> blocks: ``m`` rounds of a sharded state
    from host tick ``tick`` (the reference's ``sharded_chunk_fn``)."""
    offsets = mesh.offsets(cfg)

    def chunk(blocks, key, m, tick):
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
        return gossip.run_rounds(blocks, key, cfg, offsets=offsets, m=m, tick=tick,
                                 tracked=True)

    return chunk


def sharded_metrics_fn(mesh: Mesh):
    """blocks -> the reference's sharded metrics bundle: the convergence
    metrics, the version spread and the staleness percentiles, each
    block's partials reduced over the blocks."""

    def metrics(blocks):
        n_local = state_n_local(blocks[0])
        offsets = [k * n_local for k in range(mesh.size)]
        return gossip.metrics_sample_blocks(blocks, offsets)

    return metrics
