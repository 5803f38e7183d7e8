"""The plain pair-fused sub-exchange (the CPU side of the CUDA kernel's
wrapper) equals the reference's Pallas kernel run in interpret mode, in
every mode on the simulator's path, and equals the reference's XLA
pieces (hash, dither, budgeted advance). Tolerance 0 throughout: every
quantity is an integer or the same float32 ops in the same order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aiocluster_tpu.ops import gossip as ref_gossip
from aiocluster_tpu.ops.pallas_pull import fused_pull_pairs
from aiocluster_torch.ops import counters, gossip, pairs_pull, prng
from aiocluster_torch.ops.fd import FdParams

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)

SALT, RUN_SALT, TICK = 7, 0x9E3779B9, 31
# prior_mean 3.3: prior_weight * prior_mean is folded in f64 and rounded
# to f32 once, on both sides.
FD_CONSTS = dict(max_interval=10.0, window=1000, prior_weight=5.0, prior_mean=3.3, phi=7.5)


def _case(n, seed, wdt, hdt, imdt, self_match=False):
    rng = np.random.default_rng(seed)
    gm, c, _ = prng.grouped_matching(prng.key(seed), n)
    gm, c = gm.numpy().astype(np.int32), c.numpy().astype(np.int32)
    if self_match:
        # Groups 0 and 1 self-matched (rotations 0 and 4), their old
        # partners matched to each other: gm stays an involution.
        a, b = gm[0], gm[1]
        if a != 1:  # 0 and 1 had other partners: match those together
            gm[a], gm[b] = b, a
            c[min(a, b)], c[max(a, b)] = 3, 5
        gm[0], gm[1] = 0, 1
        c[0], c[1] = 0, 4
    p = prng.rows_of_groups(torch.from_numpy(gm).long(), torch.from_numpy(c).long()).numpy()
    assert np.array_equal(p[p], np.arange(n))
    alive = rng.random(n) < 0.85
    return dict(
        w=rng.integers(0, 50, (n, n)).astype(wdt),
        hb=rng.integers(0, TICK, (n, n)).astype(hdt),
        gm=gm, c=c, valid=alive & alive[p], alive=alive,
        owner_alive=rng.random(n) < 0.9,
        mv=rng.integers(40, 90, n).astype(np.int32),
        hbv=rng.integers(TICK - 2, TICK + 1, n).astype(np.int32),
        lc=rng.integers(0, TICK, (n, n)).astype(hdt),
        im=(rng.random((n, n)) * 6).astype(np.float32),
        ic=rng.integers(0, 12, (n, n)).astype(np.int16),
        hb0=rng.integers(0, TICK, (n, n)).astype(hdt),
        imdt=imdt,
    )


def _reference(case, *, diag, check, fd, hb0, budget, totals=None, lean=False):
    """The reference kernel, interpreted; ``lean`` drops hb (w only) and
    ``totals`` feeds the rows' deficit totals."""
    j = {k: jnp.asarray(v) for k, v in case.items() if k != "imdt"}
    kw = {}
    if diag:
        kw["mv"] = j["mv"]
        if not lean:
            kw["hbv"] = j["hbv"]
    if totals is not None:
        kw["totals"] = jnp.asarray(totals)
    if check:
        kw["check"] = (j["mv"], j["alive"], j["owner_alive"])
    if fd:
        kw["hbv"] = j["hbv"]
        im = jnp.asarray(case["im"], case["imdt"])
        kw["fd"] = (jnp.asarray(TICK, jnp.int32), j["lc"], im, j["ic"],
                    j["hb0"] if hb0 else None, FD_CONSTS["phi"])
        kw["fd_params"] = (FD_CONSTS["max_interval"], FD_CONSTS["window"],
                           FD_CONSTS["prior_weight"], FD_CONSTS["prior_mean"])
    out = fused_pull_pairs(
        j["w"], None if lean else j["hb"], j["gm"], j["c"], j["valid"],
        jnp.asarray(SALT, jnp.int32), jnp.asarray(RUN_SALT, jnp.uint32), budget,
        interpret=True, **kw,
    )
    flag = None
    if check:
        out, flag = out
    if lean:
        out = (out,)
    return [np.asarray(x) for x in out], flag


def _port(case, *, diag, check, fd, hb0, budget, totals=None, lean=False):
    t = {k: torch.from_numpy(np.array(v)) for k, v in case.items() if k != "imdt"}
    kw = {}
    if diag:
        kw["mv"] = t["mv"]
        if not lean:
            kw["hbv"] = t["hbv"]
    if totals is not None:
        kw["totals"] = torch.from_numpy(np.array(totals))
    if check:
        kw["check"] = (t["mv"], t["alive"], t["owner_alive"])
    if fd:
        kw["hbv"] = t["hbv"]
        imdt = torch.bfloat16 if case["imdt"] == "bfloat16" else torch.float32
        pw, pm = FD_CONSTS["prior_weight"], FD_CONSTS["prior_mean"]
        kw["fd"] = pairs_pull.FdOperands(
            TICK, t["lc"], t["im"].to(imdt), t["ic"],
            torch.zeros(t["w"].shape, dtype=torch.bool), t["hb0"] if hb0 else None,
            FdParams(FD_CONSTS["max_interval"], FD_CONSTS["window"], pw, pw * pm,
                     FD_CONSTS["phi"]),
        )
    before = counters.plain_calls["pull"]
    flag = pairs_pull.pairs_pull(
        t["w"], None if lean else t["hb"], t["gm"], t["c"], t["valid"], SALT,
        RUN_SALT, budget, **kw,
    )
    # CPU tensors: the plain version
    assert counters.plain_calls["pull"] == before + 1
    outs = [t["w"]] if lean else [t["w"], t["hb"]]
    if fd:
        f = kw["fd"]
        outs += [f.lc, f.im, f.ic, f.live]
    return outs, flag


def _np(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


# Every mode runs the pull itself; the FD rungs not covered here are
# covered against the standalone FD kernel (test_torch_fd.py).
MODES = {
    "diag": dict(diag=True, check=False, fd=False, hb0=False),
    "check": dict(diag=False, check=True, fd=False, hb0=False),
    "last_fd_hb0": dict(diag=False, check=True, fd=True, hb0=True),
    "only_fd_no_hb0": dict(diag=True, check=True, fd=True, hb0=False),
}


@pytest.mark.parametrize(
    "mode, rung",
    [
        ("diag", ("int32", "int32", "float32")),
        ("check", ("int16", "int16", "bfloat16")),
        ("last_fd_hb0", ("int16", "int16", "bfloat16")),
        ("only_fd_no_hb0", ("int16", "int32", "float32")),
    ],
)
def test_plain_pairs_equals_interpret_kernel(mode, rung):
    m = MODES[mode]
    case = _case(128, seed=len(mode) + len(rung[0]), wdt=rung[0], hdt=rung[1], imdt=rung[2])
    want, want_flag = _reference(case, budget=40, **m)
    got, got_flag = _port(case, budget=40, **m)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        assert np.array_equal(a, _np(b))
    if m["check"]:
        assert int(want_flag) == int(got_flag[0])


def test_plain_pairs_self_matched_groups():
    """Self-matched groups (hand-made gm: one with rotation 0, whose rows
    map to themselves, one with rotation 4) still get the refresh, the FD
    epilogue and the check; their exchange is a no-op or within-group."""
    case = _case(128, seed=5, wdt="int16", hdt="int16", imdt="bfloat16", self_match=True)
    m = MODES["only_fd_no_hb0"]
    want, want_flag = _reference(case, budget=32, **m)
    got, got_flag = _port(case, budget=32, **m)
    for a, b in zip(want, got):
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        assert np.array_equal(a, _np(b))
    assert int(want_flag) == int(got_flag[0])


def test_check_flag_passes_when_converged():
    case = _case(128, seed=3, wdt="int16", hdt="int16", imdt="bfloat16")
    case["mv"] = np.zeros_like(case["mv"])
    m = MODES["check"]
    _, want_flag = _reference(case, budget=40, **m)
    _, got_flag = _port(case, budget=40, **m)
    assert int(want_flag) == int(got_flag[0]) == 1


def test_hash_mix_matches_reference():
    rng = np.random.default_rng(0)
    i, j, s = (rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32) for _ in range(3))
    want = np.asarray(ref_gossip.hash_mix_u32(jnp.asarray(i), jnp.asarray(j), jnp.asarray(s)))
    got = gossip.hash_mix_u32(
        torch.from_numpy(i.astype(np.int64)), torch.from_numpy(j.astype(np.int64)),
        torch.from_numpy(s.astype(np.int64)),
    )
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("salt, run_salt", [(0, 0), (7, 0x12345678), (2**31 - 1, 2**32 - 1)])
def test_hash_uniform_matches_reference(salt, run_salt):
    n = 256
    want = ref_gossip._hash_uniform(
        jnp.asarray(salt, jnp.int32), n, jnp.arange(n, dtype=jnp.int32),
        jnp.asarray(run_salt, jnp.uint32),
    )
    got = gossip.hash_uniform(salt, n, torch.arange(n), run_salt)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["int16", "int32"])
@pytest.mark.parametrize("budget", [1, 17, 300, 4096])
def test_budgeted_advance_matches_reference(dtype, budget):
    n = 256
    rng = np.random.default_rng(budget)
    w_recv = rng.integers(0, 40, (n, n)).astype(dtype)
    w_send = rng.integers(0, 40, (n, n)).astype(dtype)
    valid = rng.random(n) < 0.8
    want = ref_gossip._budgeted_advance(
        jnp.asarray(w_recv), jnp.asarray(w_send), budget, jnp.asarray(valid), None,
        "proportional", jnp.asarray(SALT, jnp.int32), jnp.arange(n, dtype=jnp.int32),
        jnp.asarray(RUN_SALT, jnp.uint32),
    )
    got = gossip.budgeted_advance(
        torch.from_numpy(w_recv), torch.from_numpy(w_send), budget,
        torch.from_numpy(valid), SALT, torch.arange(n), RUN_SALT,
    )
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    checks its operands and raises — no silent plain fallback."""
    n = 128
    w = torch.zeros((n, n), dtype=torch.int16, device="meta")
    gm = torch.zeros(n // 8, dtype=torch.int32, device="meta")
    valid = torch.zeros(n, dtype=torch.bool, device="meta")
    before = counters.plain_calls["pull"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        pairs_pull.pairs_pull(w, None, gm, gm, valid, 0, 0, 8)
    assert counters.plain_calls["pull"] == before


# -- the kernel's one-advance body (exchange_once) ------------------------------


def _one_advance_round(w, gm, c, valid, salt_mix, budget, *, mv=None, col0=0):
    """A lean sub-exchange through ``exchange_once``, as the kernel runs
    it: every leader pair's refreshed rows (packed: shifted by the write
    bumps ``mv``), one advance per column pair, both rows written back
    (a self-matched row once)."""
    packed = w.dtype == torch.uint8
    p = prng.rows_of_groups(gm.long(), c.long())
    rows = torch.arange(w.shape[0])
    lead = rows[rows <= p]
    part = p[lead]
    if packed:
        x = gossip.refreshed_packed_rows(w, lead, mv, col0)
        y = gossip.refreshed_packed_rows(w, part, mv, col0)
    else:
        x = gossip.refreshed_rows(w, lead, mv, col0=col0)
        y = gossip.refreshed_rows(w, part, mv, col0=col0)
    owners = col0 + torch.arange(pairs_pull.owner_columns(w))
    nx, ny = pairs_pull.exchange_once(
        x, y, valid[lead], valid[part], lead, part, owners, salt_mix, budget, packed=packed,
    )
    out = w.clone()
    out[part] = ny
    out[lead] = nx
    return out


def _salt_mix(salt, run_salt):
    return (salt & prng.M32) ^ (run_salt & prng.M32)


ONE_ADVANCE_CASES = ["random", "equal_rows", "asymmetric_valid", "self_matched", "diag",
                     "column_block"]


def _one_advance_operands(name, n=128, seed=0):
    """Operands of a lean int16 sub-exchange for one named case."""
    case = _case(n, seed, "int16", "int16", "bfloat16", self_match=name == "self_matched")
    t = {k: torch.from_numpy(np.array(v)) for k, v in case.items() if k != "imdt"}
    p = prng.rows_of_groups(t["gm"].long(), t["c"].long())
    w, valid, mv, col0 = t["w"], t["valid"], None, 0
    if name == "equal_rows":
        # Half the pairs hold equal rows (every deficit 0 both ways), and
        # a third of every other pair's columns agree.
        lead = torch.arange(n)[torch.arange(n) < p]
        w[p[lead[::2]]] = w[lead[::2]]
        cols = torch.arange(n) % 3 == 0
        w[p[lead[1::2]].unsqueeze(1), cols] = w[lead[1::2].unsqueeze(1), cols]
    if name == "asymmetric_valid":
        rng = np.random.default_rng(seed + 100)
        valid = valid ^ torch.from_numpy(rng.random(n) < 0.25)
        assert (valid != valid[p]).any()
    if name == "diag":
        mv = t["mv"]
    if name == "column_block":
        col0 = n // 2
        w, mv = w[:, col0:].contiguous(), t["mv"][col0:].contiguous()
    return w, t["gm"], t["c"], valid, mv, col0


@pytest.mark.parametrize("budget", [12, 4096])
@pytest.mark.parametrize("name", ONE_ADVANCE_CASES)
def test_one_advance_body_equals_plain_pull(name, budget):
    """The kernel's one-advance body equals the plain version (both
    directions' advances) on every row pair: equal columns, a row invalid
    where its partner is valid, self-matched rows, the owner diagonal,
    a column block of the owners."""
    w, gm, c, valid, mv, col0 = _one_advance_operands(name, seed=len(name))
    got = _one_advance_round(w, gm, c, valid, _salt_mix(SALT, RUN_SALT), budget, mv=mv,
                             col0=col0)
    want = w.clone()
    pairs_pull.pairs_pull_plain(want, None, gm, c, valid, SALT, RUN_SALT, budget, mv=mv,
                                owner_offset=col0)
    assert torch.equal(got, want)
    assert not torch.equal(got, w)  # the sub-exchange moved something


def test_one_advance_body_equals_reference_advance():
    """On the whole width, rows i and p advanced once per column pair
    equal the reference's two-direction ``_budgeted_advance`` of every
    row toward its partner."""
    w, gm, c, valid, _, _ = _one_advance_operands("asymmetric_valid", seed=9)
    p = prng.rows_of_groups(gm.long(), c.long())
    n = w.shape[0]
    adv = ref_gossip._budgeted_advance(
        jnp.asarray(w.numpy()), jnp.asarray(w[p].numpy()), 12, jnp.asarray(valid.numpy()),
        None, "proportional", jnp.asarray(SALT, jnp.int32), jnp.arange(n, dtype=jnp.int32),
        jnp.asarray(RUN_SALT, jnp.uint32),
    )
    want = w.numpy() + np.asarray(adv)
    got = _one_advance_round(w, gm, c, valid, _salt_mix(SALT, RUN_SALT), 12)
    assert np.array_equal(got.numpy(), want)


def test_one_advance_body_equals_plain_lanes():
    """Three lanes, each with its own salt and matching (lane 1 voided):
    the one-advance body lane by lane equals the plain lane version."""
    lanes = [_one_advance_operands("random", seed=20 + s) for s in range(3)]
    w = torch.stack([x[0] for x in lanes])
    gm, c = torch.stack([x[1] for x in lanes]), torch.stack([x[2] for x in lanes])
    valid = torch.stack([x[3] for x in lanes])
    valid[1] = False
    salt_mix = prng.salt_mix(torch.tensor([7, 2**31 + 5, 123]),
                             torch.tensor([0x12345678, 0, 0xFFFFFFFF]))
    want = w.clone()
    pairs_pull.pairs_pull_lanes_plain(want, None, gm, c, valid, salt_mix, 12)
    for s in range(3):
        got = _one_advance_round(w[s], gm[s], c[s], valid[s], int(salt_mix[s]) & prng.M32, 12)
        assert torch.equal(got, want[s]), s
    assert torch.equal(want[1], w[1])
