"""Every rung of the memory ladder runs in the port bit for bit as in the
reference: lean int8 and u4r, full shrunk and deep, whole trajectories
against the reference ``Simulator`` (its XLA path on the CPU), through
the port's plain round and through its kernel wrappers (staged and
two-pass forms, on CPU tensors their plain versions); the named rung
tables; the loud fallback counters; packed states carried across; the
horizon guards. Mirrors tests/test_memory_ladder.py. Tolerance 0."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from aiocluster_tpu.sim import SimConfig as RefConfig
from aiocluster_tpu.sim import Simulator as RefSimulator
from aiocluster_tpu.sim.memory import full_config as ref_full_config
from aiocluster_tpu.sim.memory import lean_config as ref_lean_config
from aiocluster_tpu.sim.state import init_state as ref_init
from aiocluster_torch import Simulator, SimConfig, full_config, lean_config
from aiocluster_torch.ops import counters, gossip, pairs_pull, prng
from aiocluster_torch.sim.carry import state_from_numpy, state_to_numpy
from aiocluster_torch.sim.packed import watermarks_i32
from aiocluster_torch.sim.state import STATE_FIELDS, init_state, state_n_local
from test_torch_sim import _assert_states_equal

torch.set_num_threads(1)

LEAN = dict(
    n_nodes=256, keys_per_node=8, fanout=3, budget=24,
    track_failure_detector=False, track_heartbeats=False,
)
FULL = dict(
    n_nodes=256, keys_per_node=8, fanout=2, budget=24,
    version_dtype="int16", heartbeat_dtype="int16", fd_dtype="bfloat16",
    window_ticks=100,
)
SHRUNK = dict(icount_dtype="int8", live_bits=True)
DEEP = dict(version_dtype="int8", heartbeat_dtype="int8", **SHRUNK)

# The port's routes: its plain round, its kernel wrappers with the rows
# staged by one CTA, by a cluster of CTAs (a block limit too small for one
# CTA's rows), and the two-pass form (no row staged).
ROUTES = ["plain", "kernels", "cluster", "two_pass"]


def _port_sim(kw, route, seed, monkeypatch, chunk=4):
    if route == "two_pass":
        monkeypatch.setattr(pairs_pull, "SMEM_LIMIT", pairs_pull.STATIC_SMEM)
    if route == "cluster":
        monkeypatch.setattr(pairs_pull, "SMEM_LIMIT", pairs_pull.STATIC_SMEM + 200)
    cfg = SimConfig(**kw, use_pallas=route != "plain")
    want = {"plain": "plain", "kernels": "pairs", "cluster": "pairs_cluster",
            "two_pass": "pairs_two_pass"}[route]
    assert gossip.pull_phase_engaged(cfg, "cpu") == want
    return Simulator(cfg, seed=seed, chunk=chunk, device="cpu")


def _ref_sim(kw, seed, chunk=4):
    return RefSimulator(RefConfig(**kw), seed=seed, chunk=chunk)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize(
    "rung, over",
    [("int8", {}), ("u4r", {}), ("u4r", dict(keys_per_node=4, writes_per_round=1, fanout=2,
                                             budget=16))],
    ids=["int8", "u4r", "u4r_writes"],
)
def test_lean_rung_trajectory_equals_reference(rung, over, route, monkeypatch):
    """Every state field after every round for 10 rounds (u4r with
    writes: 4 + 10 versions stay inside the rung's 15)."""
    kw = {**LEAN, "version_dtype": rung, **over}
    ref, port = _ref_sim(kw, 3), _port_sim(kw, route, 3, monkeypatch)
    for r in range(10):
        ref.run(1)
        port.run(1)
        _assert_states_equal(jax.device_get(ref.state), port.state, f"{rung} round {r + 1}")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("rung", ["int8", "u4r"])
def test_lean_rung_converged_round_equals_int32(rung, route, monkeypatch):
    """The reference's contract: a rung's exact converged round is the
    int32 reference's (u4r at keys 8 stays inside its 15 versions)."""
    want = _ref_sim(dict(LEAN, version_dtype="int32"), 0).run_until_converged(200)
    got = _port_sim(dict(LEAN, version_dtype=rung), route, 0, monkeypatch).run_until_converged(200)
    assert want == got is not None


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize(
    "rung, over", [("shrunk", SHRUNK), ("deep", DEEP), ("deep_fanout1", dict(DEEP, fanout=1))],
)
def test_full_rung_trajectory_equals_reference(rung, over, route, monkeypatch):
    """The shrunk FD bookkeeping (int8 counters, the live bitmap) and the
    deep rung, every field for 12 rounds; the kernel routes carry the FD
    in the pull's epilogue."""
    kw = {**FULL, **over}
    ref, port = _ref_sim(kw, 5), _port_sim(kw, route, 5, monkeypatch)
    if route != "plain":
        assert gossip.fd_phase_engaged(port.cfg, "cpu") == "fused"
    for r in range(12):
        ref.run(1)
        port.run(1)
        _assert_states_equal(jax.device_get(ref.state), port.state, f"{rung} round {r + 1}")


def test_deep_rung_equals_int16_profile():
    """The reference's field-for-field contract on the port alone: the
    deep rung's state, widened, equals the int16/bool full profile's."""
    a = Simulator(SimConfig(**FULL), seed=5, chunk=4, device="cpu")
    b = Simulator(SimConfig(**{**FULL, **DEEP}), seed=5, chunk=4, device="cpu")
    a.run(12)
    b.run(12)
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    for f in ("w", "hb_known", "last_change", "icount"):
        assert np.array_equal(sa[f].astype(np.int32), sb[f].astype(np.int32)), f
    assert np.array_equal(sa["imean"].view(np.uint16), sb["imean"].view(np.uint16))
    live = np.unpackbits(sb["live_view"], axis=1, bitorder="little").astype(bool)
    assert np.array_equal(sa["live_view"], live)


def test_u4r_residuals_equal_int16_run():
    """At keys 15 the u4r rung's residuals are clip(max_version - w, 0,
    15) of the int16 run's watermarks, round for round."""
    kw = dict(LEAN, keys_per_node=15)
    a = Simulator(SimConfig(**kw, version_dtype="int16"), seed=2, device="cpu")
    b = Simulator(SimConfig(**kw, version_dtype="u4r"), seed=2, device="cpu")
    for _ in range(6):
        a.run(1)
        b.run(1)
        want = torch.clamp(a.state.max_version[None, :] - a.state.w.to(torch.int32), 0, 15)
        assert torch.equal(b.state.max_version[None, :] - watermarks_i32(b.state), want)


# -- configs and state ---------------------------------------------------------------


@pytest.mark.parametrize("rung", ["int32", "int16", "int8", "u4r"])
def test_lean_config_rungs_match_reference(rung):
    assert dataclasses.asdict(lean_config(1_024, rung, budget=2618)) == dataclasses.asdict(
        ref_lean_config(1_024, rung, budget=2618))


@pytest.mark.parametrize("rung", ["int32", "int16", "shrunk", "deep"])
def test_full_config_rungs_match_reference(rung):
    assert dataclasses.asdict(full_config(49_152, rung, budget=2618)) == dataclasses.asdict(
        ref_full_config(49_152, rung, budget=2618))


@pytest.mark.parametrize(
    "kw",
    [dict(LEAN, version_dtype="u4r"), dict(LEAN, version_dtype="int8"),
     {**FULL, **SHRUNK}, {**FULL, **DEEP}],
    ids=["u4r", "int8", "shrunk", "deep"],
)
def test_init_state_equals_reference(kw):
    state = init_state(SimConfig(**kw), device="cpu")
    _assert_states_equal(ref_init(RefConfig(**kw)), state, "init")
    assert state_n_local(state) == kw["n_nodes"]  # the packed width decoded


@pytest.mark.parametrize(
    "kw", [dict(LEAN, version_dtype="u4r"), {**FULL, **DEEP}], ids=["u4r", "deep"],
)
def test_packed_state_carries_across(kw, monkeypatch):
    """Reference arrays in, port tensors out and back: a packed state
    carried in after 4 reference rounds continues as the reference does,
    and its arrays come back unchanged in layout."""
    ref = _ref_sim(kw, 7, chunk=1)
    ref.run(4)
    arrays = {f: np.asarray(getattr(jax.device_get(ref.state), f)) for f in STATE_FIELDS}
    state = state_from_numpy(arrays, SimConfig(**kw), device="cpu")
    back = state_to_numpy(state)
    for f in STATE_FIELDS:
        a, b = arrays[f], back[f]
        if a.dtype.name == "bfloat16":
            a, b = a.view(np.uint16), b.view(np.uint16)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    port = Simulator(SimConfig(**kw), seed=7, chunk=1, state=state, device="cpu")
    ref.run(4)
    port.run(4)
    _assert_states_equal(jax.device_get(ref.state), port.state, "carried")
    # The packed field at its unpacked width is refused.
    field = "w" if kw["version_dtype"] == "u4r" else "live_view"
    wrong = dict(arrays, **{field: np.zeros((256, 256), np.uint8)})
    with pytest.raises(ValueError, match=f"{field} shape"):
        state_from_numpy(wrong, SimConfig(**kw), device="cpu")


# -- the loud fallbacks -----------------------------------------------------------------


def test_u4r_off_the_kernel_domain_falls_back_loudly():
    """The reference's "packed_dtype" routes: u4r with heartbeats, and
    u4r pinned to m8 (no m8 kernel carries the codec), run the plain
    round, counted once a round; the lean u4r rung on the pairs
    kernels counts nothing."""
    hb = SimConfig(n_nodes=256, keys_per_node=8, budget=24, version_dtype="u4r",
                   track_failure_detector=False, track_heartbeats=True, use_pallas=True)
    m8 = SimConfig(n_nodes=256, keys_per_node=8, budget=24, version_dtype="u4r",
                   track_failure_detector=False, track_heartbeats=False, use_pallas=True,
                   pallas_variant="m8")
    for cfg in (hb, m8):
        assert gossip.pull_fallback_reason(cfg, "cpu") == "packed_dtype"
        assert gossip.pull_phase_engaged(cfg, "cpu") == "plain"
    counters.reset()
    Simulator(hb, seed=0, chunk=2, device="cpu").run(2)
    Simulator(m8, seed=0, chunk=2, device="cpu").run(2)
    assert counters.fallbacks == {"packed_dtype": 4}
    lean = dataclasses.replace(m8, pallas_variant="auto")
    assert gossip.pull_fallback_reason(lean, "cpu") is None
    counters.reset()
    a = Simulator(lean, seed=1, chunk=2, device="cpu")
    b = Simulator(dataclasses.replace(lean, use_pallas=False), seed=1, chunk=2, device="cpu")
    a.run(4)
    b.run(4)
    assert not counters.fallbacks and torch.equal(a.state.w, b.state.w)
    # The reference counts the same routes (once a trace).
    ref = RefConfig(**{f.name: getattr(hb, f.name) for f in dataclasses.fields(RefConfig)})
    from aiocluster_tpu.ops.gossip import pallas_fallback_reason

    assert pallas_fallback_reason(ref) == "packed_dtype"


def test_shrunk_fd_rides_the_fused_epilogue_and_falls_back_off_it():
    """The shrunk bookkeeping fuses into the pairs epilogue (nothing
    counted); pinned to m8 the standalone FD kernel does not take it, so
    the FD phase runs plain, counted "fd_packed_bookkeeping" a round."""
    cfg = SimConfig(**{**FULL, **SHRUNK}, use_pallas=True)
    assert gossip.fd_phase_engaged(cfg, "cpu") == "fused"
    counters.reset()
    Simulator(cfg, seed=0, chunk=2, device="cpu").run(2)
    assert not counters.fallbacks
    off = dataclasses.replace(cfg, pallas_variant="m8")
    assert gossip.fd_phase_engaged(off, "cpu") == "plain"
    assert gossip.fd_fallback_reason(off, "cpu") == "fd_packed_bookkeeping"
    counters.reset()
    Simulator(off, seed=0, chunk=2, device="cpu").run(2)
    assert counters.fallbacks == {"fd_packed_bookkeeping": 2}
    assert counters.plain_calls["fd"] == 2 and counters.plain_calls["m8_pull"] == 4
    # Without the kernels asked for, nothing falls back.
    assert gossip.fd_fallback_reason(dataclasses.replace(off, use_pallas=False), "cpu") is None


# -- the horizon guards ------------------------------------------------------------------


def test_int8_heartbeat_horizon_guard():
    sim = Simulator(SimConfig(**{**FULL, **DEEP}), seed=0, chunk=8, device="cpu")
    with pytest.raises(ValueError, match="int8 heartbeats"):
        sim.run(128)


def test_u4r_version_horizon_guard():
    cfg = SimConfig(**dict(LEAN, version_dtype="u4r", keys_per_node=12, writes_per_round=1))
    sim = Simulator(cfg, seed=0, chunk=1, device="cpu")
    sim.run(3)  # versions reach 15
    with pytest.raises(ValueError, match="u4r"):
        sim.run(1)
    with pytest.raises(ValueError, match="overflow"):
        init_state(dataclasses.replace(cfg, keys_per_node=16), device="cpu")


# -- the kernel's one-advance body on the packed rung ----------------------------


def _packed_operands(n, seed, saturated):
    """A packed u4r row matrix with every nibble value (``saturated``: a
    third of the bytes 0xFF, both residuals 15), the write bumps (some
    15, which saturate), a grouped matching and a valid mask flipped on
    a fifth of the rows (a row valid where its partner is not)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 256, (n, n // 2)).astype(np.uint8)
    if saturated:
        w[rng.random(w.shape) < 1 / 3] = 0xFF
    gm, c, p = prng.grouped_matching(prng.key(seed), n)
    alive = torch.from_numpy(rng.random(n) < 0.85)
    valid = (alive & alive[p]) ^ torch.from_numpy(rng.random(n) < 0.2)
    bump = torch.from_numpy(rng.choice([0, 1, 3, 15], n).astype(np.int32))
    return torch.from_numpy(w), gm.to(torch.int32), c.to(torch.int32), valid, bump


@pytest.mark.parametrize("col0", [0, 64], ids=["whole", "block"])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("saturated", [False, True], ids=["mixed", "saturated"])
def test_packed_one_advance_body_equals_plain_pull(saturated, diag, col0):
    """The kernel's one-advance body on packed rows (the larger residual
    shrinks) equals the plain packed pull: saturated nibbles, the write
    bumps' saturating refresh and the diagonal zero, a column block."""
    from test_torch_pairs_pull import _one_advance_round

    n = 128
    w, gm, c, valid, bump = _packed_operands(n, 5 + diag + 2 * saturated, saturated)
    w, bump = w[:, col0 // 2:].contiguous(), bump[col0:].contiguous()
    mv = bump if diag else None
    for budget in (10, 4096):
        got = _one_advance_round(w, gm, c, valid, 0x5A5A ^ 77, budget, mv=mv, col0=col0)
        want = w.clone()
        pairs_pull.pairs_pull_plain(want, None, gm, c, valid, 0x5A5A, 77, budget, mv=mv,
                                    owner_offset=col0)
        assert torch.equal(got, want), budget


def test_packed_one_advance_body_equals_reference_halves():
    """On the whole width, the one-advance body equals the reference's
    two-direction ``_packed_adv_halves`` of every row toward its partner."""
    import jax.numpy as jnp

    from aiocluster_tpu.ops import gossip as ref_gossip
    from test_torch_pairs_pull import _one_advance_round

    n = 128
    w, gm, c, valid, _ = _packed_operands(n, 3, saturated=True)
    p = prng.rows_of_groups(gm.long(), c.long())
    a_lo, a_hi = ref_gossip._packed_adv_halves(
        jnp.asarray(w.numpy()), jnp.asarray(w[p].numpy()), 10, jnp.asarray(valid.numpy()),
        None, jnp.asarray(0x5A5A, jnp.int32), jnp.arange(n, dtype=jnp.int32),
        jnp.asarray(77, jnp.uint32),
    )
    lo, hi = gossip.nibbles(w)
    want = gossip.pack_halves(lo - torch.from_numpy(np.array(a_lo)),
                              hi - torch.from_numpy(np.array(a_hi)))
    got = _one_advance_round(w, gm, c, valid, 0x5A5A ^ 77, 10)
    assert torch.equal(got, want)
