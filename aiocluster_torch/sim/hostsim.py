"""Native host simulator for the matching domain (the port of the
reference's ``sim/hostsim.py``).

``HostSimulator`` walks the EXACT trajectory of the port's ``Simulator``
(and so of the reference's) for configs on its domain, on the host CPU:
the (N, N) arithmetic runs in ``_hostsim.cpp`` (one thread, AVX2 where
the host has it), built by g++ at first use (utils/cbuild.py). It
measures exact rounds-to-convergence where no card is at hand, and a
card run's state can be handed to it and back (``from_state`` /
``state()``).

Bit-exactness, by construction:

- The per-round randomness comes from the port's own draws
  (``ops.prng.chunk_draws`` for one round at the round's tick: the
  grouped matchings, or the choice pairing's uniform peers) with the key
  schedule ``sim_step`` uses: ``fold_in(key, tick)``, ``split``, then
  ``fold_in(peer_key, c)`` per sub-exchange; the dither salts are
  ``sub_salt`` of the round mixed with ``prng.run_salt(key)``.
- ``_hostsim.cpp`` mirrors each elementwise op of the budgeted advance
  and the dither hash at f32/int16 precision (the f32 row totals are
  integers < 2^24, so the summation order is immaterial), and the FD
  pass rounds its liveness bound's multiply-add once, as ``ops/fd.py``
  does (ROADMAP C3).
- The watermarks live as int8 (lossless on the domain: every value is
  at most keys_per_node <= 127); comparisons with a ``Simulator`` are by
  value. bfloat16 interval means travel as their uint16 bits.

Domain: the matching pairing, or the lean profile's alive-mode choice;
proportional budget; ``n % 128 == 0``; int16 or int8 watermarks; int16
heartbeats and sample counters, bool liveness; no churn, writes,
lifecycle, effective fault plan, cadence or zone bias, or quarantine.
``SUPPORT_DOMAIN`` holds it as data; ``supported()`` is the gate.

The loop simulated is jettify/aiocluster server.py:378-495; convergence
semantics state.py:310-322.
"""

from __future__ import annotations

import ctypes
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..faults import sim as _faults_sim
from ..obs.registry import MetricsRegistry
from ..obs.sim import SimMetrics
from ..obs.trace import TraceWriter
from ..ops import prng
from ..utils.cbuild import NativeBuildError, build_and_load
from .config import SimConfig

_SRC = Path(__file__).with_name("_hostsim.cpp")
# -march=native and the unrolling change instruction selection, not IEEE
# f32 results. -ffp-contract=off keeps every other multiply and add
# rounded on its own (the FD bound's one fused multiply-add is an
# explicit std::fmaf in the source).
FLAGS = ("-O3", "-march=native", "-funroll-loops", "-ffp-contract=off")
_LIB: ctypes.CDLL | None = None

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {
    "acg_hostsim_subexchange": (ctypes.c_long, [
        _P, _P, _I64, _P, _P, _I64, _I32, ctypes.c_uint32, _I32, _I32, _P]),
    "acg_hostsim_diag": (None, [_P, _I64, _P]),
    "acg_hostsim_choice_subexchange": (None, [
        _P, _P, _I64, _P, _I32, _I32, ctypes.c_uint32, _I32]),
    "acg_hostsim_rowmin": (None, [_P, _I64, _P]),
    "acg_hostsim_diag_hb": (None, [_P, _I64, _P]),
    "acg_hostsim_fd": (None, [
        _P, _P, _P, _P, _I32, _P, _P, _I64, _I32, _I32, _I32,
        ctypes.c_float, ctypes.c_float, ctypes.c_float]),
}


def load() -> ctypes.CDLL:
    """The native library, built with ``FLAGS`` on first use (cached
    under ``build/aiocluster_torch/host/``). Raises
    ``utils.cbuild.NativeBuildError`` with g++'s message when it cannot
    be built."""
    global _LIB
    if _LIB is None:
        lib = build_and_load(_SRC, flags=FLAGS)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the native library builds and loads on this host."""
    try:
        load()
    except NativeBuildError:
        return False
    return True


# -- the support domain, AS DATA ----------------------------------------------
#
# The exact domain on which HostSimulator's trajectory equals
# Simulator's, one row per FEATURE (the reference's rows, reasons and
# admissible values): each row classifies the config into a value and
# names the admissible values. ``supported()`` is the conjunction;
# ``unsupported_features()`` names the offending rows.
#
# - profiles: lean (no hb/FD matrices) and full (heartbeats + phi-accrual
#   FD) at int16 hb ticks and int16 sample counters with bool liveness:
#   the FD block is then purely elementwise (acg_hostsim_fd).
# - "choice" pairing is native for the lean profile only: the responder
#   side's heartbeat absorb would need a scatter the hb kernel does not
#   model, and "view" sampling reads live_view.
# - int16 and int8 watermarks qualify (the kernel stores int8 either
#   way, lossless while they fit, which the keys_per_node row ensures on
#   this no-writes domain); the packed u4r rung does not.
# - deficit-total exactness: the round's f32 deficit sums equal the
#   kernel's int32 ones below 2^24; the largest row total is K * (n - 1).
# - fault plans lower to per-round link/crash masks the native kernel
#   does not model; a plan with no effective behaviour stays native.


@dataclass(frozen=True)
class DomainRow:
    """One feature of the native fast path's support domain."""

    feature: str
    allowed: tuple
    value: "Callable[[SimConfig], object]"
    note: str = ""


SUPPORT_DOMAIN: tuple[DomainRow, ...] = (
    DomainRow(
        "heartbeat_dtype",
        ("int16", None),
        lambda c: c.heartbeat_dtype if c.track_heartbeats else None,
        "the C FD/hb kernels stamp int16 ticks",
    ),
    DomainRow(
        "icount_dtype",
        ("int16", None),
        lambda c: c.icount_dtype if c.track_failure_detector else None,
        "the C FD kernel's sample counters are int16",
    ),
    DomainRow(
        "live_bits",
        (False,),
        lambda c: c.live_bits,
        "the C FD kernel writes bool liveness, not the bitmap rung",
    ),
    DomainRow(
        "dead_grace",
        (None,),
        lambda c: c.dead_grace_ticks,
        "no dead-node lifecycle (column masks / forgets)",
    ),
    DomainRow(
        "pairing",
        ("matching", "choice-lean"),
        lambda c: (
            "matching"
            if c.pairing == "matching"
            else (
                "choice-lean"
                if (
                    c.pairing == "choice"
                    and c.peer_mode == "alive"
                    and not c.track_heartbeats
                )
                else c.pairing
            )
        ),
        "matching, or lean-profile alive-mode choice",
    ),
    DomainRow(
        "budget_policy",
        ("proportional",),
        lambda c: c.budget_policy,
        "greedy's owner-order cumsum is not mirrored",
    ),
    DomainRow(
        "shape_mod_128",
        (True,),
        lambda c: c.n_nodes % 128 == 0,
        "the grouped-matching family's domain",
    ),
    DomainRow(
        "version_dtype",
        ("int16", "int8"),
        lambda c: c.version_dtype,
        "unpacked narrow rungs; kernel storage is int8 either way",
    ),
    DomainRow(
        "keys_fit_int8",
        (True,),
        lambda c: c.keys_per_node <= 127,
        "watermarks never exceed keys_per_node here (no writes)",
    ),
    DomainRow(
        "deficit_total_f32_exact",
        (True,),
        lambda c: c.keys_per_node * (c.n_nodes - 1) < 2**24,
        "f32 vs int32 deficit-sum agreement bound",
    ),
    DomainRow(
        "churn_free",
        (True,),
        lambda c: c.death_rate == 0.0 and c.revival_rate == 0.0,
        "peer validity masks must be all-true",
    ),
    DomainRow(
        "writes_free",
        (True,),
        lambda c: c.writes_per_round == 0,
        "owner-side writes are not mirrored",
    ),
    DomainRow(
        "fault_plan_inert",
        (True,),
        lambda c: not (
            _faults_sim.plan_affects_links(
                _faults_sim.effective_fault_plan(c.fault_plan, c.heterogeneity)
            )
            or _faults_sim.plan_affects_nodes(c.fault_plan)
            or _faults_sim.plan_affects_byzantine(c.fault_plan)
        ),
        "link/crash/byzantine masks (incl. derived WAN faults) run on "
        "the XLA engine",
    ),
    DomainRow(
        "heterogeneity_inert",
        (True,),
        lambda c: c.heterogeneity is None or not (
            c.heterogeneity.cadence_effective()
            or c.heterogeneity.zone_bias > 0
        ),
        "cadence masks / zone-biased draws are not mirrored in the C "
        "kernels (WAN classes already fail the fault row)",
    ),
    DomainRow(
        "quarantine",
        (False,),
        lambda c: c.quarantine,
        "breaker-quarantine peer masks run on the XLA engine (the C "
        "matching draw carries no per-peer mask)",
    ),
)


def supported(cfg: SimConfig) -> bool:
    """Whether ``cfg`` is inside the native fast path's domain — the
    conjunction of SUPPORT_DOMAIN's rows (see the table above)."""
    return all(row.value(cfg) in row.allowed for row in SUPPORT_DOMAIN)


def unsupported_features(cfg: SimConfig) -> list[str]:
    """The SUPPORT_DOMAIN feature names ``cfg`` violates (empty when
    supported) — for error messages and the domain-matrix test."""
    return [
        row.feature
        for row in SUPPORT_DOMAIN
        if row.value(cfg) not in row.allowed
    ]


def _host(arr) -> np.ndarray:
    """A host numpy array of ``arr`` (numpy, or a tensor on any device;
    a bfloat16 tensor as its uint16 bits)."""
    if torch.is_tensor(arr):
        t = arr.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(arr)


class HostSimulator:
    """Convergence runner on the host for configs inside
    ``SUPPORT_DOMAIN``: run / run_until_converged / flush_metrics / save /
    resume, with the ``Simulator``'s trajectory.

    ``state_w`` (int8 or int16, numpy or a tensor) and ``state_extra``
    (``hb``, ``heartbeat``, ``last_change``, ``imean``, ``icount``,
    ``live_view``) at ``tick`` resume a run; ``from_state`` takes a port
    ``Simulator``'s ``SimState`` and ``state()`` hands one back."""

    _EXTRA_FIELDS = ("hb", "heartbeat", "last_change", "imean", "icount",
                     "live_view")

    def __init__(
        self,
        cfg: SimConfig,
        *,
        seed: int = 0,
        state_w=None,
        tick: int = 0,
        state_extra: dict | None = None,
        metrics: MetricsRegistry | None = None,
        metrics_stride: int = 64,
        trace_writer: TraceWriter | None = None,
    ) -> None:
        if not supported(cfg):
            raise ValueError(
                "config outside the host fast-path domain — offending "
                f"features: {unsupported_features(cfg)} "
                "(see hostsim.SUPPORT_DOMAIN)"
            )
        self._lib = load()
        self.cfg = cfg
        self.seed = seed
        n = cfg.n_nodes
        self.max_version = np.full((n,), cfg.keys_per_node, dtype=np.int32)
        if state_w is None:
            # init_state: each node knows only its own keyspace.
            self.w = np.zeros((n, n), dtype=np.int8)
            np.fill_diagonal(self.w, cfg.keys_per_node)
        else:
            state_w = _host(state_w)
            if state_w.shape != (n, n) or state_w.dtype not in (np.int8, np.int16):
                raise ValueError(
                    f"state_w: {state_w.dtype}{state_w.shape} is not int8/int16 {(n, n)}"
                )
            if state_w.dtype == np.int16:
                if int(state_w.max(initial=0)) > 127 or int(state_w.min(initial=0)) < 0:
                    raise ValueError("state_w holds a watermark outside [0, 127]")
                state_w = state_w.astype(np.int8)
            self.w = np.ascontiguousarray(state_w)
        self.tick = int(tick)
        self._row_min = np.zeros((n,), dtype=np.int32)
        # The simulator's stride sampler, engine-labelled "host-native".
        # Each sample costs one pass over w, so the stride bounds the
        # overhead exactly.
        self._obs: SimMetrics | None = None
        if metrics is not None or trace_writer is not None:
            self._obs = SimMetrics(
                metrics, trace_writer, stride=metrics_stride,
                engine="host-native", start_tick=self.tick,
            )
        self._track_hb = cfg.track_heartbeats
        self._track_fd = cfg.track_failure_detector
        extra = state_extra or {}

        def take(name, default):
            arr = extra.get(name)
            if arr is None:
                return default
            arr = _host(arr)
            # Hard errors: a wrong array would flow straight into the
            # raw-pointer C kernels.
            if arr.shape != default.shape or arr.dtype != default.dtype:
                raise ValueError(
                    f"checkpoint {name}: {arr.dtype}{arr.shape} != "
                    f"expected {default.dtype}{default.shape}"
                )
            return np.ascontiguousarray(arr)

        if self._track_hb:
            hb0 = np.zeros((n, n), np.int16)
            np.fill_diagonal(hb0, 1)
            self.hb = take("hb", hb0)
            self.heartbeat = take("heartbeat", np.ones((n,), np.int32))
        if self._track_fd:
            self._fd_bf16 = cfg.fd_dtype == "bfloat16"
            # bfloat16 means travel as their uint16 bits.
            imean_dtype = np.uint16 if self._fd_bf16 else np.float32
            self.last_change = take("last_change", np.zeros((n, n), np.int16))
            self.imean = take("imean", np.zeros((n, n), imean_dtype))
            self.icount = take("icount", np.zeros((n, n), np.int16))
            self.live_view = take("live_view", np.eye(n, dtype=bool))
        # The simulator's key schedule: the run key from the seed, the
        # per-run dither salt its bits.
        self._key = prng.key(seed)
        self._run_salt = prng.run_salt(self._key)

    @classmethod
    def from_state(cls, cfg: SimConfig, state, *, seed: int = 0, **kwargs) -> "HostSimulator":
        """Continue a port ``Simulator``'s run on the host: ``state`` is its
        ``SimState`` (on any device), at its tick, under the same config
        and seed."""
        extra = None
        if cfg.track_heartbeats:
            extra = {"hb": state.hb_known, "heartbeat": state.heartbeat}
            if cfg.track_failure_detector:
                extra.update(last_change=state.last_change, imean=state.imean,
                             icount=state.icount, live_view=state.live_view)
        return cls(cfg, seed=seed, state_w=state.w, tick=int(state.tick),
                   state_extra=extra, **kwargs)

    def state(self, device="cpu"):
        """The run's state as a port ``SimState`` on ``device`` (a
        ``Simulator(cfg, seed=, state=)`` continues it there)."""
        from .state import DTYPES, SimState

        def put(arr, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(arr))
            return (t if dtype is None else t.to(dtype)).to(device)

        n, hdt = self.cfg.n_nodes, DTYPES[self.cfg.heartbeat_dtype]
        empty = torch.zeros((0, 0), dtype=hdt, device=device)
        hb = self.heartbeat if self._track_hb else np.full((n,), 1 + self.tick, np.int32)
        fd = {}
        if self._track_fd:
            imean = put(self.imean)
            fd = dict(
                last_change=put(self.last_change),
                imean=imean.view(torch.bfloat16) if self._fd_bf16 else imean,
                icount=put(self.icount), live_view=put(self.live_view),
            )
        return SimState(
            tick=torch.tensor(self.tick, dtype=torch.int32, device=device),
            max_version=put(self.max_version),
            heartbeat=put(hb),
            alive=torch.ones((n,), dtype=torch.bool, device=device),
            w=put(self.w, DTYPES[self.cfg.version_dtype]),
            hb_known=put(self.hb) if self._track_hb else empty,
            last_change=fd.get("last_change", empty),
            imean=fd.get("imean", torch.zeros((0, 0), dtype=DTYPES[self.cfg.fd_dtype],
                                              device=device)),
            icount=fd.get("icount", torch.zeros((0, 0), dtype=torch.int16, device=device)),
            live_view=fd.get("live_view", torch.zeros((0, 0), dtype=torch.bool, device=device)),
            dead_since=empty,
        )

    # -- round advancement ----------------------------------------------------

    def _draws(self, tick: int):
        """One round's draws at ``tick``, on the host, from the
        simulator's own key schedule (``prng.chunk_draws``)."""
        return prng.chunk_draws(self._key, tick, 1, self.cfg).round(0)

    def _round_pairs(self, tick: int) -> list[tuple[np.ndarray, np.ndarray]]:
        """The fanout matchings of one round as (A, B) pair arrays."""
        p_all = self._draws(tick).p.to(torch.int32).numpy()
        idx = np.arange(self.cfg.n_nodes, dtype=np.int32)
        out = []
        for p in p_all:
            a = idx[idx < p]  # self-pairs (p[i] == i) are no-op exchanges
            out.append((np.ascontiguousarray(a), np.ascontiguousarray(p[a])))
        return out

    def _round_peers(self, tick: int) -> np.ndarray:
        """(n, fanout) int32 independent peer draws of the choice
        pairing."""
        return self._draws(tick).peers.to(torch.int32).numpy()

    def _step(self, track: bool) -> bool:
        """One full gossip round in place; returns the post-round
        all-converged flag when ``track`` (else False)."""
        tick = self.tick + 1
        n = self.cfg.n_nodes
        if self.cfg.pairing == "choice":
            return self._step_choice(tick, track)
        hb_ptr = None
        hb0 = None
        if self._track_hb:
            # heartbeat = tick + 1 (starts at 1), so the last safe tick
            # is 32766: at 32767 the owner's self-heartbeat would wrap
            # to int16 minimum on the diagonal refresh.
            if tick + 1 >= 2**15:
                raise RuntimeError(
                    "tick horizon exceeds the int16 heartbeat matrices"
                )
            # Owner-side activity: every node is alive on this domain.
            self.heartbeat += 1
            self._lib.acg_hostsim_diag_hb(
                self.hb.ctypes.data, n, self.heartbeat.ctypes.data
            )
            hb_ptr = self.hb.ctypes.data
        self._lib.acg_hostsim_diag(
            self.w.ctypes.data, n, self.max_version.ctypes.data
        )
        if self._track_fd:
            # The FD compares against the round-start matrix (post
            # diagonal refresh, pre exchanges); one preallocated buffer,
            # not a fresh (n, n) copy a round.
            if not hasattr(self, "_hb0"):
                self._hb0 = np.empty_like(self.hb)
            hb0 = self._hb0
            np.copyto(hb0, self.hb)
        pairs = self._round_pairs(tick)
        fan = self.cfg.fanout
        for c, (a, b) in enumerate(pairs):
            last = c == fan - 1
            salt = tick * (2 * fan) + 2 * c  # gossip's sub_salt(c, 0)
            self._lib.acg_hostsim_subexchange(
                self.w.ctypes.data, hb_ptr, n,
                a.ctypes.data, b.ctypes.data, len(a),
                np.int32(salt), np.uint32(self._run_salt),
                self.cfg.budget,
                1 if (track and last) else 0,
                self._row_min.ctypes.data,
            )
        if self._track_fd:
            cfg = self.cfg
            self._lib.acg_hostsim_fd(
                self.hb.ctypes.data, hb0.ctypes.data,
                self.last_change.ctypes.data,
                self.imean.ctypes.data, 1 if self._fd_bf16 else 0,
                self.icount.ctypes.data, self.live_view.ctypes.data,
                n, np.int32(tick),
                np.int32(cfg.max_interval_ticks),
                np.int32(cfg.window_ticks),
                # The f32 scalars as the simulator's FD sees them: pw and
                # phi are f32 casts of the config doubles; pw * pm
                # multiplies in doubles first and casts the product.
                float(np.float32(cfg.prior_weight)),
                float(np.float32(cfg.prior_weight * cfg.prior_mean_ticks)),
                float(np.float32(cfg.phi_threshold)),
            )
        self.tick = tick
        if not track:
            return False
        # Every row's watermark has reached every owner's max_version
        # (all alive on this domain). Rows untouched this round
        # (self-pairs) keep a stale _row_min; with n % 128 == 0 the
        # grouped matchings have no self-pairs, but guard anyway.
        touched = np.zeros((n,), dtype=bool)
        a, b = pairs[-1]
        touched[a] = True
        touched[b] = True
        if not touched.all():
            untouched = ~touched
            self._row_min[untouched] = self.w[untouched].min(axis=1)
        return bool((self._row_min >= self.max_version).all())

    def _step_choice(self, tick: int, track: bool) -> bool:
        """One 'choice'-pairing round: fanout independent sub-exchanges,
        each reading a pre-sub-exchange snapshot."""
        n = self.cfg.n_nodes
        fan = self.cfg.fanout
        self._lib.acg_hostsim_diag(
            self.w.ctypes.data, n, self.max_version.ctypes.data
        )
        peers = self._round_peers(tick)
        if not hasattr(self, "_w_pre"):
            self._w_pre = np.empty_like(self.w)
        for c in range(fan):
            np.copyto(self._w_pre, self.w)
            p = np.ascontiguousarray(peers[:, c])
            base = tick * (2 * fan) + 2 * c  # sub_salt(0, d) + 2c
            self._lib.acg_hostsim_choice_subexchange(
                self.w.ctypes.data, self._w_pre.ctypes.data, n,
                p.ctypes.data, np.int32(base), np.int32(base + 1),
                np.uint32(self._run_salt), self.cfg.budget,
            )
        self.tick = tick
        if not track:
            return False
        # The scatter pass can touch any row after its min was last
        # known; one dedicated min pass gives the exact flag.
        self._lib.acg_hostsim_rowmin(
            self.w.ctypes.data, n, self._row_min.ctypes.data
        )
        return bool((self._row_min >= self.max_version).all())

    def run(self, rounds: int) -> None:
        for _ in range(rounds):
            self._step(track=False)
            self._maybe_sample()

    def run_until_converged(
        self,
        max_rounds: int = 100_000,
        on_round=None,
    ) -> int | None:
        """Exact first round at which full convergence holds (checked
        every round, like Simulator's tracker). ``on_round`` is an
        optional callback(tick) between rounds (checkpoint hooks)."""
        if self.tick == 0:
            pass  # fresh cluster: trivially unconverged (w off-diag 0)
        elif bool((self.w.min(axis=1) >= self.max_version).all()):
            return self.tick
        while self.tick < max_rounds:
            converged = self._step(track=True)
            self._maybe_sample()
            if converged:
                return self.tick
            if on_round is not None:
                on_round(self.tick)
        return None

    # -- telemetry ------------------------------------------------------------

    def _maybe_sample(self) -> None:
        if self._obs is None or not self._obs.due(self.tick):
            return
        self._sample_now()

    def _sample_now(self) -> None:
        k = self.cfg.keys_per_node
        col_min = self.w.min(axis=0)
        w_min = int(self.w.min())
        self._obs.record(
            self.tick,
            {
                "converged_owners": int((col_min >= k).sum()),
                "min_fraction": w_min / k,
                "mean_fraction": float(self.w.mean(dtype=np.float64)) / k,
                "alive_count": self.cfg.n_nodes,
                # max_version is uniform on this domain (no writes), so
                # the worst pair lag collapses to max - global min, and
                # w <= k everywhere makes the plain sum the capped one.
                "version_spread": int(self.max_version.max()) - w_min,
                "kv_known": float(self.w.sum(dtype=np.int64)),
            },
        )

    def flush_metrics(self) -> list[dict]:
        """Push buffered samples into the registry/trace; returns the
        series (empty when telemetry is off). The series is closed at the
        run's current tick."""
        if self._obs is None:
            return []
        if self._obs.last_tick != self.tick:
            self._sample_now()
        return self._obs.flush()

    # -- checkpointing --------------------------------------------------------

    def save(self, path: str) -> None:
        """The reference's raw checkpoint: ``<path>.w.npy`` (the int8
        matrix), one ``<path>.<field>.npy`` a full-profile matrix
        (bfloat16 as its uint16 bits, bool as uint8) and a JSON sidecar
        ``<path>.json``, each written to a temporary name and renamed."""
        tmp = f"{path}.w.tmp.npy"
        np.save(tmp, self.w)
        os.replace(tmp, f"{path}.w.npy")
        extras = [f for f in self._EXTRA_FIELDS if hasattr(self, f)]
        for name in extras:
            arr = getattr(self, name)
            if arr.dtype == bool:
                arr = arr.view(np.uint8)
            np.save(f"{path}.{name}.tmp.npy", arr)
            os.replace(f"{path}.{name}.tmp.npy", f"{path}.{name}.npy")
        meta = {
            "tick": self.tick,
            "seed": self.seed,
            "n_nodes": self.cfg.n_nodes,
            "keys_per_node": self.cfg.keys_per_node,
            "fanout": self.cfg.fanout,
            "budget": self.cfg.budget,
            "extras": extras,
            "fd_dtype": self.cfg.fd_dtype if self._track_fd else None,
            # Rung provenance: a resume must not silently reinterpret a
            # checkpoint across rungs.
            "version_dtype": self.cfg.version_dtype,
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }
        with open(f"{path}.json.tmp", "w") as f:
            json.dump(meta, f)
        os.replace(f"{path}.json.tmp", f"{path}.json")

    @classmethod
    def resume(cls, path: str, cfg: SimConfig) -> "HostSimulator":
        """Continue a run from ``save``'s files (either package's)."""
        with open(f"{path}.json") as f:
            meta = json.load(f)
        for field in ("n_nodes", "keys_per_node", "fanout", "budget"):
            if meta[field] != getattr(cfg, field):
                raise ValueError(
                    f"checkpoint {field}={meta[field]} != cfg "
                    f"{getattr(cfg, field)}"
                )
        # Loud cross-rung rejection (files without a rung field were
        # int16-only).
        saved_rung = meta.get("version_dtype", "int16")
        if saved_rung != cfg.version_dtype:
            raise ValueError(
                f"checkpoint version_dtype={saved_rung!r} != cfg "
                f"{cfg.version_dtype!r} (cross-rung resume refused; load "
                "under the rung that wrote it)"
            )
        saved = set(meta.get("extras", []))
        wanted = {
            f
            for f in cls._EXTRA_FIELDS
            if (cfg.track_heartbeats and f in ("hb", "heartbeat"))
            or (
                cfg.track_failure_detector
                and f in ("last_change", "imean", "icount", "live_view")
            )
        }
        if saved != wanted:
            raise ValueError(
                f"checkpoint profile {sorted(saved)} != cfg profile "
                f"{sorted(wanted)}"
            )
        if wanted and meta.get("fd_dtype") not in (None, cfg.fd_dtype):
            raise ValueError(
                f"checkpoint fd_dtype={meta['fd_dtype']} != cfg {cfg.fd_dtype}"
            )
        extra = {}
        for name in saved:
            arr = np.load(f"{path}.{name}.npy")
            if name == "live_view":
                arr = arr.view(bool)
            extra[name] = arr
        w = np.load(f"{path}.w.npy")
        return cls(
            cfg, seed=meta["seed"], state_w=w, tick=meta["tick"],
            state_extra=extra or None,
        )
