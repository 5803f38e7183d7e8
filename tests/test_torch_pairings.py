"""The other pairings (ROADMAP.md A7) in the port equal the reference bit
for bit: the topology generators' arrays, the draws (randint with a span
per element, the masked categorical without a logarithm, the
permutation's inverse) against ``jax.random``, the view draw against the
reference's ``_view_peer_choice`` with the float32 log of XLA's CPU
backend, and every state field of the permutation, unrestricted
matching, choice (uniform, categorical, view) and adjacency rounds
against the reference's XLA ``sim_step`` on JAX CPU, tolerance 0 —
unsharded, over a 4-block mesh and as 3 sweep lanes where the reference
sweeps the config; BASELINE config 2 (``ring(64, 1)``) converges at the
reference's round, and each plain route counts the reference's reason."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from aiocluster_tpu.models import topology as ref_topology
from aiocluster_tpu.ops.gossip import _view_peer_choice
from aiocluster_tpu.sim import Simulator as RefSimulator
from aiocluster_torch import SimConfig, Simulator
from aiocluster_torch.models import topology
from aiocluster_torch.ops import counters, gossip, prng
from test_torch_churn import (
    BASE,
    CHURN,
    ref_config,
    run_against_reference,
    run_mesh_against_reference,
    sweep_against_reference,
)
from test_torch_sim import NARROW

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)

GENERATORS = [
    ("ring", (64, 1), {}),
    ("ring", (100, 3), {}),
    ("scale_free", (300, 3), dict(seed=0)),
    ("scale_free", (200, 2), dict(max_degree=5, seed=4)),
    ("small_world", (120, 2), dict(rewire_p=0.3, seed=1)),
    ("small_world", (64, 1), dict(rewire_p=1.0, seed=2)),
    ("hierarchical", (96, 16, 2), dict(seed=3)),
    ("hierarchical", (50, 8, 0), {}),
]


@pytest.mark.parametrize("name, args, kw", GENERATORS)
def test_topology_generators_equal_reference(name, args, kw):
    """Each generator builds the reference's arrays for the same
    arguments (dtype, shape and values)."""
    want = getattr(ref_topology, name)(*args, **kw)
    got = getattr(topology, name)(*args, **kw)
    for field in ("adjacency", "degrees"):
        a, b = getattr(want, field), getattr(got, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got.n_nodes == want.n_nodes


def test_randint_with_a_span_per_element_equals_jax():
    """The adjacency draw's ``randint(key, (n, fanout), 0,
    degrees[:, None])``: a span per row, spans of 1 included."""
    for seed in range(4):
        deg = np.random.default_rng(seed).integers(1, 60, 300).astype(np.int32)
        want = random.randint(random.key(seed), (300, 3), 0, jnp.asarray(deg)[:, None])
        got = prng.randint(prng.key(seed), (300, 3), 0, torch.from_numpy(deg)[:, None])
        assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("n", [64, 200, 257])
def test_categorical_without_logarithm_equals_jax(n):
    """The masked categorical over the alive nodes is the argmax of the
    uniform mantissas over the alive columns (ties to the lowest, 0 when
    none is alive): equal to ``jax.random.categorical`` of ``where(alive,
    0, -1e30)`` over 60 keys at densities from none to all alive."""
    rng = np.random.default_rng(n)
    for k in range(60):
        alive = rng.random(n) < [0.0, 0.01, 0.3, 0.8, 1.0][k % 5]
        want = random.categorical(random.key(k), jnp.where(jnp.asarray(alive), 0.0, -1e30),
                                  shape=(n, 3))
        got = prng.categorical(prng.key(k), torch.from_numpy(alive), 3)
        assert np.array_equal(np.asarray(want), got.numpy()), k


def test_categorical_row_blocks_are_one_draw(monkeypatch):
    """Drawn a block of rows at a time (each block's counters offset by
    its first row), the categorical equals the one-block draw."""
    alive = torch.from_numpy(np.random.default_rng(0).random(96) < 0.5)
    whole = prng.categorical(prng.key(3), alive, 2)
    monkeypatch.setattr(prng, "CATEGORICAL_BLOCK_ELEMS", 2 * 96 * 5)
    assert torch.equal(prng.categorical(prng.key(3), alive, 2), whole)


def test_permutation_draws_and_inverse():
    """A permutation sub-exchange draws ``permutation(fold_in(peer_key,
    c), n)`` and its inverse (the reference's argsort)."""
    cfg = SimConfig(**dict(BASE, pairing="permutation"))
    key = random.key(9)
    draws = prng.chunk_draws(prng.key(9), 5, 2, cfg)
    for r, tick in enumerate((5, 6)):
        _, peer_key = random.split(random.fold_in(key, tick))
        for c in range(cfg.fanout):
            p = np.asarray(random.permutation(random.fold_in(peer_key, c), 256))
            assert np.array_equal(p, draws.p[r, c].numpy())
            assert np.array_equal(np.argsort(p), draws.inv[r, c].numpy())


def test_xla_log_equals_the_reference_log():
    """``gossip.xla_log`` equals the float32 ``jnp.log`` of JAX's CPU
    backend on 2^21 inputs spread over the view draw's two domains (the
    clipped uniforms, and their negated logarithms)."""
    f = jax.jit(jnp.log)
    for lo, hi in ((1e-12, 1.0 - 2.0**-24), (5.9e-8, 27.7)):
        a, b = (int(np.float32(v).view(np.uint32)) for v in (lo, hi))
        x = np.linspace(a, b, 1 << 20).astype(np.uint32).view(np.float32)
        assert np.array_equal(np.asarray(f(x)), gossip.xla_log(torch.from_numpy(x)).numpy())


def test_fma32_rounds_once():
    """``fma32`` is a correctly rounded float32 a * b + c: on exact cases,
    and where the float64 sum lands on a float32 halfway point that the
    exact sum misses (24,929 * 673 = 2^24 + 1, so a * b = 1 + 2^-24,
    halfway between 1 and 1 + 2^-23, and c = +-2^-80 decides)."""
    a = torch.tensor([1 + 2.0**-12, 3.0, 24929 * 2.0**-15, 24929 * 2.0**-15])
    b = torch.tensor([1 + 2.0**-12, 5.0, 673 * 2.0**-9, 673 * 2.0**-9])
    c = torch.tensor([-1.0, 2.0**-30, 2.0**-80, -(2.0**-80)])
    got = gossip.fma32(a, b, c)
    exact = a.double() * b.double() + c.double()
    assert torch.equal(got[:2], exact[:2].float())
    assert got[2].item() == 1 + 2.0**-23 and got[3].item() == 1.0


@pytest.mark.parametrize("density", [0.0, 0.002, 0.05, 0.6])
def test_view_draw_equals_reference(density):
    """The view draw's peer of every row equals the reference's
    ``_view_peer_choice`` on 4,096 rows of 192 owner columns under 8 salts
    per case (131,072 rows over the four cases), from a cold start to
    dense views; and split into 4 column blocks (each block's best, then
    the best over the blocks in block order) a square view gives the
    whole view's draw."""
    rows, cols = 4096, 192
    rng = np.random.default_rng(int(density * 1000))
    for k in range(8):
        live = rng.random((rows, cols)) < density
        salt = int(rng.integers(-(2**31), 2**31))
        run_salt = int(rng.integers(0, 2**32))
        want = _view_peer_choice(
            jnp.asarray(live), jnp.asarray(salt, jnp.int32), jnp.arange(cols, dtype=jnp.int32),
            None, jnp.asarray(run_salt, jnp.uint32),
        )
        _, got = gossip.view_block_best(torch.from_numpy(live), salt, run_salt)
        assert np.array_equal(np.asarray(want), got.numpy()), k
    n = 256
    live = torch.from_numpy(rng.random((n, n)) < density)
    cfg = SimConfig(n_nodes=n, fanout=2, pairing="choice", peer_mode="view")

    def block(view):
        return type("Block", (), {"w": torch.empty(0), "live_view": view})

    split = gossip.view_peers(cfg, [block(live[:, o:o + 64]) for o in range(0, n, 64)],
                              [0, 64, 128, 192], salt, run_salt)
    assert torch.equal(split, gossip.view_peers(cfg, [block(live)], [0], salt, run_salt))


# name: (config, port switches, topology)
ROUTES = {
    "permutation": (dict(BASE, pairing="permutation", **NARROW), dict(use_pallas=True), None),
    "permutation_u4r": (dict(BASE, pairing="permutation", version_dtype="u4r", keys_per_node=8,
                             writes_per_round=0, track_failure_detector=False,
                             track_heartbeats=False), dict(use_pallas=True), None),
    "matching_off_domain": (dict(BASE, n_nodes=320), dict(use_pallas=True), None),
    "matching_off_domain_lean": (dict(BASE, n_nodes=200, version_dtype="int8",
                                      track_failure_detector=False, track_heartbeats=False),
                                 {}, None),
    "choice_uniform": (dict(BASE, pairing="choice", **NARROW), dict(use_pallas=True), None),
    "choice_categorical": (dict(BASE, pairing="choice", **CHURN), {}, None),
    "choice_view": (dict(BASE, pairing="choice", peer_mode="view", **CHURN), {}, None),
    "ring": (dict(BASE, n_nodes=64), dict(use_pallas=True), ("ring", (64, 1), {})),
    "scale_free": (dict(BASE, pairing="choice", **NARROW), {},
                   ("scale_free", (256, 3), dict(seed=0))),
    "small_world_churn": (dict(BASE, **CHURN), {},
                          ("small_world", (256, 2), dict(rewire_p=0.2, seed=1))),
    "hierarchical": (dict(BASE, n_nodes=128, track_failure_detector=False,
                          track_heartbeats=False), {}, ("hierarchical", (128, 16, 1), {})),
}
REASONS = {
    "permutation": "pairing", "permutation_u4r": "pairing", "matching_off_domain": "shape",
    "choice_uniform": "pairing", "ring": "topology",
}


def _topology(spec):
    return None if spec is None else getattr(topology, spec[0])(*spec[1], **spec[2])


@pytest.mark.parametrize("route", list(ROUTES))
def test_rounds_equal_reference(route):
    """Five rounds of every pairing route equal the reference's field for
    field; a config that asks for the kernels runs the plain pull and
    counts the reference's reason, its FD phase the standalone kernel's
    plain version."""
    kw, over, spec = ROUTES[route]
    counters.reset()
    run_against_reference(kw, rounds=5, over=over, topology=_topology(spec))
    if route in REASONS:
        assert counters.fallbacks == {REASONS[route]: 5}
        assert not counters.launches
    assert counters.plain_calls["pull"] == 5 * kw["fanout"]
    assert not counters.refusals


MESH_ROUTES = ["permutation", "matching_off_domain", "choice_uniform", "choice_categorical",
               "choice_view", "scale_free"]


@pytest.mark.parametrize("route", MESH_ROUTES)
def test_mesh_rounds_equal_reference(route):
    """The same routes over 4 column blocks (the view draw's best taken
    across the blocks, the responder's scatter-max per block on whole
    rows) equal the reference's unsharded rounds."""
    kw, over, spec = ROUTES[route]
    run_mesh_against_reference(kw, over=over, topology=_topology(spec))


@pytest.mark.parametrize(
    "route", ["permutation", "matching_off_domain", "choice_uniform", "choice_categorical",
              "choice_view"],
)
def test_sweep_lanes_equal_reference(route):
    """3 sweep lanes of the routes the reference sweeps (no topology) equal
    its lanes; a permutation sweep also sweeps fanout."""
    kw, over, _ = ROUTES[route]
    lanes = dict(writes_per_round=[0, 1, 2])
    if route == "permutation":
        lanes["fanout"] = [1, 2, 3]
    sweep_against_reference(kw, over=over, **lanes)


def test_baseline_config_2_converges_at_reference_round():
    """BASELINE config 2: 64 nodes on ``ring(64, 1)``, 16 keys each,
    fanout 3, the headline budget: the port converges at the reference's
    round."""
    kw = dict(n_nodes=64, keys_per_node=16, fanout=3, budget=2618)
    ref = RefSimulator(ref_config(kw), seed=0, topology=ref_topology.ring(64, 1), chunk=8)
    want = ref.run_until_converged(max_rounds=256)
    sim = Simulator(SimConfig(**kw), seed=0, topology=topology.ring(64, 1), chunk=8,
                    device="cpu")
    assert want is not None and sim.run_until_converged(max_rounds=256) == want


def test_topology_simulator_validation():
    """``Simulator(topology=)`` keeps the reference's errors: a size
    mismatch and the packed u4r rung; and a churn-free choice config
    refuses a carried state with dead nodes."""
    with pytest.raises(ValueError, match="topology size"):
        Simulator(SimConfig(n_nodes=128), topology=topology.ring(64), device="cpu")
    u4r = SimConfig(n_nodes=128, version_dtype="u4r", keys_per_node=8,
                    track_failure_detector=False, track_heartbeats=False)
    with pytest.raises(ValueError, match="u4r"):
        Simulator(u4r, topology=topology.ring(128), device="cpu")
    cfg = SimConfig(n_nodes=128, pairing="choice")
    state = Simulator(cfg, device="cpu").state
    state = state.replace(alive=torch.arange(128) % 2 == 0)
    with pytest.raises(ValueError, match="churn-free 'choice'"):
        Simulator(cfg, state=state, device="cpu")
