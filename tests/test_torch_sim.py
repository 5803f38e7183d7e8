"""The port's round equals the reference's bit for bit: every state tensor
at every round up to convergence (the reference's XLA path on the CPU
against the port's plain path), the same converged round through
``Simulator.run_until_converged`` over several seeds, a state carried in
mid-run continuing identically, and the dispatch resolution."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from jax import random

from aiocluster_tpu.ops.gossip import sim_step as ref_step
from aiocluster_tpu.sim import SimConfig as RefConfig
from aiocluster_tpu.sim import Simulator as RefSimulator
from aiocluster_tpu.sim.state import init_state as ref_init
from aiocluster_torch import Simulator, SimConfig, full_config, lean_config
from aiocluster_torch.faults import split_brain
from aiocluster_torch.models import ring
from aiocluster_torch.ops import counters, gossip, pairs_pull, prng
from aiocluster_torch.parallel import make_mesh
from aiocluster_torch.sim.carry import state_from_numpy, state_to_numpy
from aiocluster_torch.sim.state import DTYPES, STATE_FIELDS, init_state

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)

NARROW = dict(version_dtype="int16", heartbeat_dtype="int16", fd_dtype="bfloat16")


def _assert_states_equal(ref, port, where):
    got = state_to_numpy(port)
    for f in STATE_FIELDS:
        a, b = np.asarray(getattr(ref, f)), got[f]
        if a.dtype.name == "bfloat16":
            a, b = a.view(np.uint16), b.view(np.uint16)
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{where}: {f}"


@pytest.mark.parametrize(
    "n, rung, fanout, wpr, over",
    [
        (256, "wide", 3, 0, {}),
        (256, "narrow", 3, 1, {}),
        (512, "narrow", 1, 0, {}),
        (512, "wide", 1, 1, {}),
        # use_pallas=True on CPU tensors: the pairs wrappers' plain
        # versions with the fused FD epilogue.
        (256, "narrow", 2, 0, dict(use_pallas=True)),
        # The A/B seam: plain pull, the standalone FD wrapper.
        (256, "wide", 3, 1, dict(use_pallas=False, use_pallas_fd=True)),
        (256, "narrow", 3, 0, dict(track_failure_detector=False, track_heartbeats=False)),
    ],
)
def test_round_by_round_equals_reference(n, rung, fanout, wpr, over):
    kw = dict(n_nodes=n, keys_per_node=4, fanout=fanout, budget=64,
              writes_per_round=wpr, **(NARROW if rung == "narrow" else {}), **over)
    # The reference runs its XLA path (its own tests pin it bit-equal to
    # its kernels); the port runs whichever path ``over`` selects.
    rcfg = RefConfig(**dict(kw, use_pallas=False, use_pallas_fd=False))
    pcfg = SimConfig(**kw)
    rs, ps = ref_init(rcfg), init_state(pcfg, device="cpu")
    key, pkey = random.key(n + fanout), prng.key(n + fanout)
    converged = False
    for r in range(40):
        rs, rflag = ref_step(rs, key, rcfg, return_converged=True)
        ps, pflag = gossip.sim_step(ps, pkey, pcfg, return_converged=True)
        _assert_states_equal(rs, ps, f"round {r + 1}")
        assert bool(rflag) == bool(pflag)
        converged = bool(rflag)
        if converged and wpr == 0:
            break
    assert converged or wpr > 0 or fanout == 1


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_run_until_converged_same_round(seed):
    kw = dict(n_nodes=256, keys_per_node=6, fanout=2, budget=48, **NARROW)
    want = RefSimulator(RefConfig(**kw), seed=seed, chunk=4).run_until_converged(200)
    sim = Simulator(SimConfig(**kw), seed=seed, chunk=4, device="cpu")
    got = sim.run_until_converged(200)
    assert got is not None and got == want
    m = sim.metrics()
    assert bool(m["all_converged"]) and float(m["min_fraction"]) == 1.0


def test_metrics_match_reference():
    from aiocluster_tpu.ops.gossip import convergence_metrics as ref_metrics

    kw = dict(n_nodes=256, keys_per_node=6, fanout=2, budget=20, **NARROW)
    rcfg, pcfg = RefConfig(**kw), SimConfig(**kw)
    rs, ps = ref_init(rcfg), init_state(pcfg, device="cpu")
    key, pkey = random.key(3), prng.key(3)
    for _ in range(4):
        rs, ps = ref_step(rs, key, rcfg), gossip.sim_step(ps, pkey, pcfg)
    want = {k: np.asarray(v) for k, v in ref_metrics(rs).items()}
    got = {k: v.numpy() for k, v in gossip.convergence_metrics(ps).items()}
    assert set(got) == set(want)
    for k in ("converged_owners", "all_converged", "alive_count", "fd_false_positives"):
        assert np.array_equal(got[k], want[k]), k
    # Float sums: the same values summed in another order (rtol is one
    # float32 rounding per addition over 65k terms at most).
    for k in ("min_fraction", "mean_fraction", "kv_known", "fd_false_positive_fraction"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_carried_state_continues_identically():
    kw = dict(n_nodes=256, keys_per_node=8, fanout=3, budget=24, writes_per_round=1, **NARROW)
    rcfg, pcfg = RefConfig(**kw), SimConfig(**kw)
    key = random.key(9)
    rs = ref_init(rcfg)
    for _ in range(5):
        rs = ref_step(rs, key, rcfg)
    arrays = {f: np.asarray(getattr(rs, f)) for f in STATE_FIELDS}
    sim = Simulator(pcfg, seed=9, state=state_from_numpy(arrays, pcfg, "cpu"), device="cpu")
    assert sim.tick == 5
    for _ in range(6):
        rs = ref_step(rs, key, rcfg)
    sim.run(6)
    _assert_states_equal(rs, sim.state, "after carry")


# The configurations the port runs on one card, with the form of their
# sub-exchanges and the CTAs that stage a row pair (pairs_pull.pull_form,
# through gossip.kernel_pull_form).
FORM_CASES = {
    "headline": (SimConfig(n_nodes=10_240, keys_per_node=16, fanout=3, budget=2618, **NARROW),
                 None, ("pairs", 1)),
    "north_star": (lean_config(100_352, budget=2618), None, ("pairs_cluster", 4)),
    "north_star_int8": (lean_config(100_352, "int8", budget=2618), None, ("pairs_two_pass", 1)),
    "north_star_u4r": (lean_config(100_352, "u4r", budget=2618), None, ("pairs_two_pass", 1)),
    "widest_u4r": (lean_config(262_144, "u4r", budget=2618), None, ("pairs_two_pass", 1)),
    "full_65536": (full_config(65_536), None, ("pairs_cluster", 4)),
    "full_deep_49152": (full_config(49_152, "deep"), None, ("pairs_two_pass", 1)),
    "full_shrunk_49152": (full_config(49_152, "shrunk"), None, ("pairs_cluster", 2)),
    "headline_int8": (lean_config(10_240, "int8"), None, ("pairs", 1)),
    "headline_u4r": (lean_config(10_240, "u4r"), None, ("pairs", 1)),
    "north_star_mesh": (lean_config(100_352, budget=2618), 12_544, ("pairs_two_pass", 1)),
    "headline_mesh": (SimConfig(n_nodes=10_240, keys_per_node=16, fanout=3, budget=2618,
                                **NARROW), 1_280, ("pairs_two_pass", 1)),
}


@pytest.mark.parametrize("name", list(FORM_CASES))
def test_kernel_pull_form_rule(name):
    """Each configuration's form and cluster size, the same for a sweep's
    lanes (the north-star pair, S = 2, stages as the north star does):
    staged on the smallest cluster that lets two CTAs share an SM, except
    rows of 1-byte elements past NARROW_STAGED_BYTES (two-pass, as
    measured faster); 8 column blocks keep the two-pass form."""
    cfg, n_local, want = FORM_CASES[name]
    assert gossip.kernel_pull_form(cfg, n_local) == want
    cuda = torch.device("cuda")
    assert gossip.resolve_phases(cfg, cuda, n_local=n_local).pull == want[0]
    if n_local is None:
        assert gossip.resolve_phases(cfg, cuda, sweep=True).pull == want[0]
        n = cfg.n_nodes
        row_len, itemsize = (n // 2, 1) if cfg.version_dtype == "u4r" else (
            n, DTYPES[cfg.version_dtype].itemsize)
        k = pairs_pull.cluster_size(row_len, itemsize)
        assert pairs_pull.cluster_fits(row_len, itemsize, k, ctas=2)
        assert k == 1 or not pairs_pull.cluster_fits(row_len, itemsize, k // 2, ctas=2)
        narrow = itemsize == 1 and row_len > pairs_pull.NARROW_STAGED_BYTES
        assert want == (("pairs_two_pass", 1) if narrow else
                        ("pairs" if k == 1 else "pairs_cluster", k))


M8_FORM_NAMES = {"pairs": "m8", "pairs_cluster": "m8_cluster", "pairs_two_pass": "m8_two_pass"}


@pytest.mark.parametrize("name", list(FORM_CASES))
def test_kernel_pull_form_rule_m8(name):
    """Pinned to m8, each configuration takes the pairs pull's form and
    cluster size under the m8 name (the m8 pull runs the same frame out
    of place): the headline staged by one CTA, the north star on 4-CTA
    clusters, the int8 and u4r rows past NARROW_STAGED_BYTES and the
    column blocks two-pass. The u4r rung pinned to m8 still runs the
    reference's plain route ("packed_dtype"): no m8 kernel carries the
    codec."""
    cfg, n_local, (form, k) = FORM_CASES[name]
    m8 = dataclasses.replace(cfg, pallas_variant="m8")
    want = (M8_FORM_NAMES[form], k)
    assert gossip.kernel_pull_form(m8, n_local) == want
    assert want[0] in gossip.M8_FORMS
    phases = gossip.resolve_phases(m8, torch.device("cuda"), n_local=n_local)
    if cfg.version_dtype == "u4r":
        assert (phases.pull, phases.pull_fallback) == ("plain", "packed_dtype")
    else:
        assert phases.pull == want[0] and phases.pull_fallback is None


def test_dispatch_resolution():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    head = SimConfig(n_nodes=10_240, keys_per_node=16, fanout=3, budget=2618, **NARROW)
    assert gossip.pull_phase_engaged(head, cuda) == "pairs"
    assert gossip.fd_phase_engaged(head, cuda) == "fused"
    seam = dataclasses.replace(head, use_pallas=False, use_pallas_fd=True)
    assert gossip.pull_phase_engaged(seam, cuda) == "plain"
    assert gossip.fd_phase_engaged(seam, cuda) == "kernel"
    both_off = dataclasses.replace(head, use_pallas=False, use_pallas_fd=False)
    assert gossip.pull_phase_engaged(both_off, cuda) == "plain"
    assert gossip.fd_phase_engaged(both_off, cuda) == "plain"
    fd_pinned = dataclasses.replace(head, use_pallas_fd=False)
    assert gossip.pull_phase_engaged(fd_pinned, cuda) == "pairs"
    assert gossip.fd_phase_engaged(fd_pinned, cuda) == "plain"
    # On the CPU "auto" resolves to the plain round.
    assert gossip.pull_phase_engaged(head, cpu) == "plain"
    assert gossip.fd_phase_engaged(head, cpu) == "plain"
    lean = dataclasses.replace(head, track_failure_detector=False, track_heartbeats=False)
    assert gossip.fd_phase_engaged(lean, cuda) == "off"
    # A pinned m8 takes the single-pass pull, its FD phase the standalone
    # kernel (as in the reference).
    m8 = dataclasses.replace(head, pallas_variant="m8")
    assert gossip.pull_phase_engaged(m8, cuda) == "m8"
    assert gossip.fd_phase_engaged(m8, cuda) == "kernel"
    assert gossip.pull_phase_engaged(m8, cpu) == "plain"
    assert gossip.pull_phase_engaged(dataclasses.replace(head, pallas_variant="pairs"), cuda) == "pairs"
    # Fanout 0 (no sub-exchange to carry the refresh and the FD
    # epilogue): the pull runs plain with the reference's fallback
    # "fanout", the FD phase the standalone kernel (plain on the shrunk
    # bookkeeping), as in the reference. Nothing is refused.
    counters.reset()
    zero = gossip.Phases("plain", "fanout", "kernel", None)
    assert gossip.resolve_phases(dataclasses.replace(head, fanout=0), cuda) == zero
    assert gossip.fd_phase_engaged(dataclasses.replace(head, fanout=0), cuda) == "kernel"
    assert gossip.resolve_phases(dataclasses.replace(m8, fanout=0), cuda) == zero
    shrunk = dataclasses.replace(head, fanout=0, icount_dtype="int8", live_bits=True,
                                 window_ticks=100)
    assert gossip.resolve_phases(shrunk, cuda) == gossip.Phases(
        "plain", "fanout", "plain", "fd_packed_bookkeeping")
    # Rows too wide for two CTAs of one SM to stage take a cluster of
    # CTAs a pair (one launch a sub-exchange), FD still fused.
    assert gossip.pull_phase_engaged(SimConfig(n_nodes=65_536), cuda) == "pairs_cluster"
    assert gossip.fd_phase_engaged(SimConfig(n_nodes=65_536), cuda) == "fused"
    north_star = lean_config(100_352, budget=2618)
    assert gossip.pull_phase_engaged(north_star, cuda) == "pairs_cluster"
    assert gossip.fd_phase_engaged(north_star, cuda) == "off"
    # The width bound counts the kernel's static shared memory and the
    # runtime's 1 KB a CTA: two CTAs of 28,800 int16 owners share an SM,
    # two of 28,928 do not.
    assert gossip.pull_phase_engaged(dataclasses.replace(head, n_nodes=28_800), cuda) == "pairs"
    assert gossip.pull_phase_engaged(dataclasses.replace(head, n_nodes=28_928), cuda) == "pairs_cluster"
    # A pinned "pairs" takes the same rule (the reference takes m8 past
    # its staged width: the same bits).
    pinned = dataclasses.replace(head, n_nodes=58_112, pallas_variant="pairs")
    assert gossip.pull_phase_engaged(pinned, cuda) == "pairs_cluster"
    # A pinned m8 stages its rows by the same rule on the same clusters
    # (it runs the pairs pull's frame out of place), else it takes the m8
    # two-pass form (the m8 totals, then the pull fed them).
    assert gossip.pull_phase_engaged(dataclasses.replace(m8, n_nodes=28_800), cuda) == "m8"
    assert gossip.pull_phase_engaged(dataclasses.replace(m8, n_nodes=57_984), cuda) == "m8_cluster"
    wide_m8 = dataclasses.replace(m8, n_nodes=58_112)
    assert gossip.pull_phase_engaged(wide_m8, cuda) == "m8_cluster"
    assert gossip.fd_phase_engaged(wide_m8, cuda) == "kernel"
    north_star_m8 = lean_config(100_352, budget=2618, pallas_variant="m8")
    assert gossip.pull_phase_engaged(north_star_m8, cuda) == "m8_cluster"
    assert gossip.fd_phase_engaged(north_star_m8, cuda) == "off"
    int8_m8 = lean_config(100_352, "int8", budget=2618, pallas_variant="m8")
    assert gossip.pull_phase_engaged(int8_m8, cuda) == "m8_two_pass"
    assert not counters.refusals
    # use_pallas=True asks for the kernels on the CPU too: the same route,
    # and the reference's gates name it so.
    wanted_zero = dataclasses.replace(head, fanout=0, use_pallas=True)
    assert gossip.resolve_phases(wanted_zero, cpu) == zero
    from aiocluster_tpu.ops import gossip as ref_gossip
    ref_zero = RefConfig(**dataclasses.asdict(wanted_zero))
    assert ref_gossip.pallas_fallback_reason(ref_zero) == "fanout"
    assert ref_gossip.fd_phase_engaged(ref_zero) == "kernel"
    assert gossip.pull_phase_engaged(dataclasses.replace(head, fanout=0), cpu) == "plain"


def test_fanout_zero_round_equals_reference():
    """A fanout-0 headline-shaped config at n = 256 that asks for the
    kernels: each round (diagonal refresh, no exchange, the FD phase
    through the standalone FD wrapper) equals the reference's, with the
    fallback "fanout" counted once a round."""
    kw = dict(n_nodes=256, keys_per_node=16, fanout=0, budget=2618, writes_per_round=1,
              **NARROW)
    rcfg = RefConfig(**dict(kw, use_pallas=False, use_pallas_fd=False))
    pcfg = SimConfig(**dict(kw, use_pallas=True))
    rs, ps = ref_init(rcfg), init_state(pcfg, device="cpu")
    key, pkey = random.key(0), prng.key(0)
    counters.reset()
    for r in range(1, 7):
        rs, rflag = ref_step(rs, key, rcfg, return_converged=True)
        ps, pflag = gossip.sim_step(ps, pkey, pcfg, return_converged=True)
        _assert_states_equal(rs, ps, f"round {r}")
        assert bool(rflag) == bool(pflag) is False
    assert counters.fallbacks == {"fanout": 6}
    assert counters.plain_calls == {"fd": 6} and not counters.launches


# -- the pinned m8 path ---------------------------------------------------------

M8_PROFILES = {
    "headline_shaped": SimConfig(n_nodes=256, keys_per_node=4, fanout=3, budget=64,
                                 use_pallas=True, pallas_variant="m8", **NARROW),
    "lean": lean_config(256, budget=300, use_pallas=True, pallas_variant="m8"),
    # The headline config (bench.py's keys, fanout, budget and dtypes),
    # its width cut to 256 owners.
    "headline": SimConfig(n_nodes=256, keys_per_node=16, fanout=3, budget=2618,
                          use_pallas=True, pallas_variant="m8", **NARROW),
}
M8_ROUNDS = 8


@functools.lru_cache(maxsize=None)
def _reference_m8_states(profile: str):
    """The reference Simulator's states after each of the first
    ``M8_ROUNDS`` rounds of a pinned-m8 profile, on its kernel path (the
    m8 kernel and, with the FD, the standalone FD kernel, interpreted)."""
    ref = RefSimulator(RefConfig(**dataclasses.asdict(M8_PROFILES[profile])), seed=4, chunk=1)
    states = []
    for _ in range(M8_ROUNDS):
        ref.run(1)
        states.append(jax.tree_util.tree_map(np.asarray, ref.state))
    return states


@pytest.mark.parametrize("form", ["m8", "m8_cluster", "m8_two_pass"])
@pytest.mark.parametrize("profile", sorted(M8_PROFILES))
def test_m8_simulator_equals_reference_and_pairs_path(profile, form, monkeypatch):
    """The pinned-m8 Simulator (its kernels' plain versions here) equals
    the reference's pinned-m8 Simulator round by round, in each form: the
    single-pass form staged by one CTA, on a cluster (forced: a block
    limit one CTA cannot stage a pair of 256 owners in) and the two-pass
    form (forced: no row may stage), and equals the port's own pairs path
    on every state tensor."""
    if form == "m8_two_pass":
        monkeypatch.setattr(pairs_pull, "SMEM_LIMIT", pairs_pull.STATIC_SMEM)
    elif form == "m8_cluster":
        monkeypatch.setattr(pairs_pull, "SMEM_LIMIT", pairs_pull.STATIC_SMEM + 200)
    cfg = M8_PROFILES[profile]
    assert gossip.pull_phase_engaged(cfg, "cpu") == form
    counters.reset()
    port = Simulator(cfg, seed=4, chunk=1, device="cpu")
    pairs = Simulator(dataclasses.replace(cfg, pallas_variant="pairs"), seed=4, chunk=1,
                      device="cpu")
    for r, want in enumerate(_reference_m8_states(profile), start=1):
        port.run(1)
        pairs.run(1)
        _assert_states_equal(want, port.state, f"round {r}")
        _assert_states_equal(want, pairs.state, f"pairs path, round {r}")
    # Both simulators' plain calls: the m8 path's (its FD phase the
    # standalone FD wrapper's) and the pairs path's (FD fused).
    per_round = {"m8_pull": cfg.fanout, "pull": cfg.fanout}
    if form == "m8_two_pass":
        per_round.update(m8_totals=cfg.fanout, totals=cfg.fanout)
    if cfg.track_failure_detector:
        per_round["fd"] = 1
    assert dict(counters.plain_calls) == {k: v * M8_ROUNDS for k, v in per_round.items()}
    assert not counters.launches and not counters.refusals
    again = Simulator(cfg, seed=4, chunk=4, device="cpu")
    assert again.run_until_converged(200) == Simulator(
        dataclasses.replace(cfg, pallas_variant="pairs"), seed=4, device="cpu"
    ).run_until_converged(200)


def test_m8_round_ping_pongs_two_buffers():
    """Each m8 sub-exchange reads its input and writes another buffer, and
    the buffer it consumed takes the next one's output: at fanout 2 the
    round's w ends in the input state's buffer. The round-start hb the
    FD phase reads is never written: hb then takes two new buffers."""
    base = dataclasses.replace(M8_PROFILES["headline_shaped"], fanout=2)
    for fd in (True, False):
        cfg = dataclasses.replace(base, track_failure_detector=fd)
        state = init_state(cfg, device="cpu")
        state = gossip.sim_step(state, prng.key(1), cfg)
        w_ptr, hb_ptr = state.w.data_ptr(), state.hb_known.data_ptr()
        hb0 = state.hb_known.clone()
        new = gossip.sim_step(state, prng.key(1), cfg)
        assert new.w.data_ptr() == w_ptr
        if fd:
            assert new.hb_known.data_ptr() != hb_ptr
            assert torch.equal(state.hb_known, hb0)
        else:
            assert new.hb_known.data_ptr() == hb_ptr


def test_counters_on_the_cpu_path():
    counters.reset()
    cfg = SimConfig(n_nodes=128, fanout=2, use_pallas=True, **NARROW)
    sim = Simulator(cfg, seed=1, device="cpu")
    sim.run(3)
    # The pairs wrappers' plain versions (FD fused into the last call).
    assert counters.plain_calls == {"pull": 6} and not counters.launches
    counters.reset()
    Simulator(dataclasses.replace(cfg, use_pallas=False), seed=1, device="cpu").run(2)
    assert counters.plain_calls == {"pull": 4, "fd": 2}
    counters.reset()
    Simulator(dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=True), seed=1, device="cpu").run(2)
    assert counters.plain_calls == {"pull": 4, "fd": 2} and counters.kernel_launches("pairs_pull") == 0
    counters.reset()
    assert not counters.plain_calls and not counters.launches and not counters.refusals


def test_sim_step_refuses_out_of_slice_configs():
    """sim_step refuses no config by roadmap ID any more: a fault plan
    (A10, once refused here), also one set past __post_init__, runs and
    masks the round; churn (A6) runs and writes the flipped alive mask,
    and topologies (A7) run through ``Simulator(topology=)``."""
    cfg = SimConfig(n_nodes=128)
    object.__setattr__(cfg, "fault_plan", split_brain(2, heal=4))  # past __post_init__
    state = init_state(SimConfig(n_nodes=128), device="cpu")
    counters.reset()
    new = gossip.sim_step(state, prng.key(0), cfg)
    assert not counters.refusals and int(new.tick) == 1
    # The partition held: neither island learned of the other.
    assert int(new.w[:64, 64:].max()) == 0 and int(new.w[64:, :64].max()) == 0
    assert int(new.w[:64, :64].sum()) > int(torch.diagonal(new.w)[:64].sum())
    churn = SimConfig(n_nodes=128, death_rate=0.5)
    new = gossip.sim_step(init_state(churn, device="cpu"), prng.key(0), churn)
    assert 0 < int(new.alive.sum()) < 128
    assert torch.equal(new.heartbeat, 1 + new.alive.to(torch.int32))
    Simulator(SimConfig(n_nodes=128), mesh=make_mesh(["cpu"] * 2))
    sim = Simulator(SimConfig(n_nodes=128), topology=ring(128, 1), device="cpu")
    sim.run(2)
    assert sim.tick == 2
    with pytest.raises(ValueError, match="topology size"):
        Simulator(SimConfig(n_nodes=64), topology=ring(128, 1), device="cpu")
    assert not counters.refusals


def test_horizon_guard():
    cfg = SimConfig(n_nodes=128, **NARROW)
    state = init_state(cfg, device="cpu")
    state = state.replace(tick=torch.tensor(2**15 - 4, dtype=torch.int32))
    sim = Simulator(cfg, state=state, device="cpu")
    with pytest.raises(ValueError, match="overflows int16 heartbeats"):
        sim.run(8)
    wcfg = SimConfig(n_nodes=128, version_dtype="int16", keys_per_node=30_000, writes_per_round=400)
    with pytest.raises(ValueError, match="version_dtype='int16'"):
        Simulator(wcfg, device="cpu").run(8)
