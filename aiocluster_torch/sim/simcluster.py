"""SimCluster: the Cluster-shaped API over the tensor simulator (the port
of the reference's ``sim/simcluster.py``).

Named nodes, owner-side set/delete, replica views, liveness and
snapshots, while each round runs on the device for the whole cluster.

Values stay host-side. Each node keeps an append-only **write log**;
entry ``v-1`` is the write that created version ``v``. Because deltas
ship in increasing version order, replica ``i``'s view of owner ``j`` is
exactly the first ``w[i, j]`` log entries with last-writer-wins per key,
so materialising a replica is a host-side prefix fold and needs no
per-key device state. The device state is read one watermark, one live
row or one column minimum per block at a time, never as a gathered
(N, N) copy; writes, kills and revivals replace the state out of place
(``Simulator.state``'s setter), so a state handed out earlier does not
change under its holder.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.values import KeyStatus
from .config import SimConfig
from .simulator import Simulator


@dataclass(frozen=True, slots=True)
class _LogEntry:
    key: str
    value: str
    status: KeyStatus


class SimCluster:
    """A whole simulated cluster with per-node KV API parity, on
    ``device`` (the card unless asked) or a mesh's column blocks.

    Long-running clusters compact their write logs with :meth:`compact`:
    entries every replica has already absorbed fold into a per-node base
    view, so host memory tracks the live keyspace instead of the full
    write history.
    """

    def __init__(
        self,
        cfg: SimConfig,
        *,
        names: list[str] | None = None,
        initial_key_values: dict[str, dict[str, str]] | None = None,
        seed: int = 0,
        mesh=None,
        topology=None,
        trace: bool = False,
        device: str | torch.device | None = None,
    ) -> None:
        n = cfg.n_nodes
        if cfg.version_dtype == "u4r":
            # The write flush bumps max_version by direct state surgery,
            # which on the packed residual rung would need a matching
            # residual shift outside the round.
            raise ValueError(
                "SimCluster does not support version_dtype='u4r' "
                "(host-side write flush bypasses the residual encoding); "
                "use an unpacked rung"
            )
        self.cfg = cfg
        self.names = names or [f"node-{i}" for i in range(n)]
        if len(self.names) != n:
            raise ValueError("names length != n_nodes")
        self._index = {name: i for i, name in enumerate(self.names)}
        self._logs: list[list[_LogEntry]] = [[] for _ in range(n)]
        # Compaction state: log_base[j] versions of owner j live in
        # base_views[j] (a folded prefix); self._logs[j][k] is version
        # log_base[j] + k + 1.
        self._log_base = np.zeros(n, np.int64)
        # base view entry: key -> (value, status, version at fold time).
        # The version keeps replica_view right for observers whose
        # watermark sits BELOW the compaction base (the dead-node
        # lifecycle forgot the owner and a revival re-replicates it).
        self._base_views: list[dict[str, tuple[str, KeyStatus, int]]] = [{} for _ in range(n)]
        self._pending_writes = np.zeros(n, np.int32)

        initial_key_values = initial_key_values or {}
        for name, kvs in initial_key_values.items():
            i = self._index[name]
            for key, value in kvs.items():
                self._logs[i].append(_LogEntry(key, value, KeyStatus.SET))
        # Synthetic keyspace for nodes without explicit initial values,
        # so benchmark configs ("16 KV per node") need no per-key setup.
        if not initial_key_values and cfg.keys_per_node > 0:
            for i in range(n):
                self._logs[i] = [
                    _LogEntry(f"key-{k:04d}", f"{self.names[i]}:{k}", KeyStatus.SET)
                    for k in range(cfg.keys_per_node)
                ]
        versions = np.array([len(log) for log in self._logs], np.int32)
        # Current owner-side view per node, maintained incrementally so
        # writes stay O(1) (replica_view still folds the log prefix).
        self._views: list[dict[str, tuple[str, KeyStatus]]] = [
            self._materialize(log, None) for log in self._logs
        ]

        self.sim = Simulator(
            cfg, seed=seed, mesh=mesh, topology=topology, initial_versions=versions,
            trace=trace, device=device,
        )

    # -- owner-side writes (host log + deferred device bump) ------------------

    def _log_write(self, node: str, entry: _LogEntry) -> None:
        i = self._index[node]
        self._logs[i].append(entry)
        self._views[i][entry.key] = (entry.value, entry.status)
        self._pending_writes[i] += 1

    def set(self, node: str, key: str, value: str) -> None:
        current = self._views[self._index[node]].get(key)
        if current is not None and current[1] is KeyStatus.SET and current[0] == value:
            return  # idempotent set
        self._log_write(node, _LogEntry(key, value, KeyStatus.SET))

    def delete(self, node: str, key: str) -> None:
        if key not in self._views[self._index[node]]:
            return
        self._log_write(node, _LogEntry(key, "", KeyStatus.DELETED))

    def set_with_ttl(self, node: str, key: str, value: str) -> None:
        current = self._views[self._index[node]].get(key)
        if (
            current is not None
            and current[1] is KeyStatus.DELETE_AFTER_TTL
            and current[0] == value
        ):
            return  # idempotent TTL set
        self._log_write(node, _LogEntry(key, value, KeyStatus.DELETE_AFTER_TTL))

    def get(self, node: str, key: str) -> str | None:
        entry = self._views[self._index[node]].get(key)
        if entry is None or entry[1] in (KeyStatus.DELETED, KeyStatus.DELETE_AFTER_TTL):
            return None
        return entry[0]

    # -- stepping -------------------------------------------------------------

    def _flush_writes(self) -> None:
        if self._pending_writes.any():
            st = self.sim.state
            bump = torch.from_numpy(self._pending_writes).to(st.max_version.device)
            self.sim.state = st.replace(max_version=st.max_version + bump)
            # Keep the narrow rungs' horizon guard sound: the largest
            # per-node bump bounds how much the global max can have grown.
            self.sim.note_max_version_increase(int(self._pending_writes.max()))
            self._pending_writes[:] = 0

    def step(self, rounds: int = 1) -> None:
        """Advance gossip; owner writes issued since the last step become
        visible to the cluster this round (the owner's digest advertises
        the new max_version and peers pull the delta)."""
        self._flush_writes()
        self.sim.run(rounds)

    def run_until_converged(self, max_rounds: int = 100_000) -> int | None:
        self._flush_writes()
        return self.sim.run_until_converged(max_rounds)

    # -- replica observation --------------------------------------------------

    @staticmethod
    def _materialize(
        log: list[_LogEntry], prefix: int | None
    ) -> dict[str, tuple[str, KeyStatus]]:
        entries = log if prefix is None else log[:prefix]
        view: dict[str, tuple[str, KeyStatus]] = {}
        for e in entries:
            view[e.key] = (e.value, e.status)
        return view

    def replica_view(self, observer: str, owner: str) -> dict[str, str]:
        """What ``observer`` currently knows of ``owner``'s live keys.

        A watermark below the compaction base happens when the dead-node
        lifecycle has forgotten the owner (w = 0 -> empty view) or while
        a revived owner is being re-replicated from scratch; folded
        entries then apply only once the watermark reaches their fold
        version."""
        i, j = self._index[observer], self._index[owner]
        watermark = self.sim.watermark(i, j)
        view: dict[str, tuple[str, KeyStatus]] = {
            k: (v, status)
            for k, (v, status, ver) in self._base_views[j].items()
            if ver <= watermark
        }
        prefix = max(0, watermark - int(self._log_base[j]))
        for e in self._logs[j][:prefix]:
            view[e.key] = (e.value, e.status)
        return {k: v for k, (v, status) in view.items() if status is KeyStatus.SET}

    # -- log compaction (the GC analogue) -------------------------------------

    def compact(self) -> int:
        """Fold every write-log prefix that ALL replicas (alive or dead,
        any of whom may revive and resume pulling) have already absorbed
        into the per-node base view, dropping tombstoned/TTL keys
        outright: absence and tombstone are indistinguishable below the
        floor. Returns the number of log entries folded away. The floors
        are the column minima of w, read block by block."""
        self._flush_writes()
        floors = self.sim.column_minima()  # includes the owner diagonal
        folded = 0
        for j in range(len(self._logs)):
            k = int(floors[j] - self._log_base[j])
            if k <= 0:
                continue
            k = min(k, len(self._logs[j]))
            base = self._base_views[j]
            for idx, e in enumerate(self._logs[j][:k]):
                if e.status is KeyStatus.SET:
                    base[e.key] = (e.value, e.status, int(self._log_base[j]) + idx + 1)
                else:
                    base.pop(e.key, None)
            self._logs[j] = self._logs[j][k:]
            self._log_base[j] += k
            folded += k
        return folded

    def live_view(self, observer: str) -> list[str]:
        """Node names ``observer`` currently believes are alive (requires
        track_failure_detector)."""
        if not self.cfg.track_failure_detector:
            raise ValueError("failure detector disabled for this sim")
        row = self.sim.live_row(self._index[observer])
        return [self.names[j] for j in np.flatnonzero(row)]

    def alive_nodes(self) -> list[str]:
        mask = self.sim.blocks[0].alive.cpu().numpy()
        return [self.names[i] for i in np.flatnonzero(mask)]

    def _set_alive(self, node: str, alive: bool) -> None:
        st = self.sim.state
        mask = st.alive.clone()
        mask[self._index[node]] = alive
        self.sim.state = st.replace(alive=mask)

    def kill(self, node: str) -> None:
        """Crash ``node``: it stops heartbeating and exchanging. Peers'
        failure detectors notice over the following rounds; with
        SimConfig.dead_grace_ticks set, its state is eventually excluded
        from digests and then forgotten."""
        self._set_alive(node, False)

    def revive(self, node: str) -> None:
        """Restart a killed ``node`` with its state intact. It resumes
        heartbeating and must re-earn liveness at each observer with
        fresh heartbeat samples."""
        self._set_alive(node, True)

    @property
    def tick(self) -> int:
        return self.sim.tick

    def metrics(self) -> dict[str, np.ndarray]:
        return self.sim.metrics()
