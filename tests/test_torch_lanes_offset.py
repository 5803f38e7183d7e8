"""The lane launches at an owner offset (a sweep over a mesh): the plain
``pairs_pull_lanes`` and ``pairs_totals_lanes`` on a column block of the
owners equal the reference's ``fused_pull_pairs_lanes`` and
``fused_pull_pairs_totals_lanes`` run in interpret mode at the same
``owner_offset``, every lane with its own matching, salt, run salt and
FD phi, one lane voided (its alive-pair mask all 0). N = 256 in two
blocks of 128 (the packed rung N = 512 in two of 256, the reference's
packed block), 2 or 3 lanes. The pull is fed each lane's global totals
(the blocks' shares summed), as the sharded sweep feeds it. Tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aiocluster_tpu.ops.pallas_pull import fused_pull_pairs_lanes, fused_pull_pairs_totals_lanes
from aiocluster_torch.ops import pairs_pull, pairs_totals, prng
from aiocluster_torch.ops.fd import FdParams

torch.set_num_threads(1)

TICK, BUDGET = 31, 40
SALTS = np.array([7, 2**31 - 5, 123], dtype=np.int32)
RUN_SALTS = np.array([0x9E3779B9, 0, 0x1234567], dtype=np.uint32)
PHIS = np.array([7.0, 8.25, 9.5], dtype=np.float32)
FD_CONSTS = (10.0, 100, 5.0, 3.3)

# (w, hb, imean dtype) per rung; hb None is lean.
RUNGS = {
    "int16": ("int16", "int16", "bfloat16"),
    "int8": ("int8", None, None),
    "u4r": ("u4", None, None),
}


def _lanes(rung, lanes, seed):
    """``lanes`` lanes of whole-width operands (numpy); lane 1's
    alive-pair mask is all 0."""
    wdt, hdt, _ = RUNGS[rung]
    packed = wdt == "u4"
    n = 512 if packed else 256
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("gm", "c", "valid", "alive", "owner_alive", "mv", "hbv", "w",
                           "hb", "lc", "hb0", "im", "ic")}
    for s in range(lanes):
        gm, c, p = prng.grouped_matching(prng.key(seed + s), n)
        alive = rng.random(n) < 0.85
        valid = alive & alive[p.numpy()]
        if s == 1:
            valid[:] = False
        out["gm"].append(gm.numpy().astype(np.int32))
        out["c"].append(c.numpy().astype(np.int32))
        out["valid"].append(valid)
        out["alive"].append(alive)
        out["owner_alive"].append(rng.random(n) < 0.9)
        out["mv"].append((rng.integers(0, 3, n) if packed else rng.integers(40, 90, n))
                         .astype(np.int32))
        out["hbv"].append(rng.integers(TICK - 2, TICK + 1, n).astype(np.int32))
        if packed:
            out["w"].append(rng.integers(0, 256, (n, n // 2)).astype(np.uint8))
        else:
            out["w"].append(rng.integers(0, 50, (n, n)).astype(wdt))
        if hdt is not None:
            out["hb"].append(rng.integers(0, TICK, (n, n)).astype(hdt))
            out["lc"].append(rng.integers(0, TICK, (n, n)).astype(hdt))
            out["hb0"].append(rng.integers(0, TICK, (n, n)).astype(hdt))
            out["im"].append((rng.random((n, n)) * 6).astype(np.float32))
            out["ic"].append(rng.integers(0, 101, (n, n)).astype(np.int16))
    case = {k: np.stack(v) for k, v in out.items() if v}
    case["n"] = n
    return case


def _block(case, k):
    """Block k of two: each matrix's columns, each owner vector's slice."""
    n = case["n"]
    width = n // 2
    cols = slice(k * width, (k + 1) * width)
    out = dict(case, off=k * width, width=width)
    packed = case["w"].dtype == np.uint8
    out["w"] = np.ascontiguousarray(
        case["w"][..., k * width // 2 : (k + 1) * width // 2] if packed else case["w"][..., cols]
    )
    for name in ("hb", "lc", "hb0", "im", "ic", "mv", "hbv", "owner_alive"):
        if name in case:
            out[name] = np.ascontiguousarray(case[name][..., cols])
    return out


def _salt_mix(lanes) -> torch.Tensor:
    return prng.salt_mix(torch.from_numpy(SALTS[:lanes].astype(np.int64)),
                         torch.from_numpy(RUN_SALTS[:lanes].astype(np.int64)))


def _np(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _ref(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _totals(case, k, diag):
    b = _block(case, k)
    mv = b["mv"] if diag else None
    got = pairs_totals.pairs_totals_lanes(
        torch.from_numpy(b["w"].copy()), torch.from_numpy(b["gm"]), torch.from_numpy(b["c"]),
        torch.from_numpy(b["valid"]), mv=None if mv is None else torch.from_numpy(mv),
        owner_offset=b["off"],
    )
    return b, mv, got.numpy()


@pytest.mark.parametrize("diag", [True, False], ids=["diag", "sum"])
@pytest.mark.parametrize("rung", list(RUNGS))
def test_lane_block_totals_equal_interpret_kernel(rung, diag):
    """Each block's lane totals equal the reference's at its offset, and
    the blocks' shares summed per lane equal the whole width's."""
    case = _lanes(rung, 2, seed=5 + diag)
    whole = pairs_totals.pairs_totals_lanes(
        torch.from_numpy(case["w"]), torch.from_numpy(case["gm"]), torch.from_numpy(case["c"]),
        torch.from_numpy(case["valid"]), mv=torch.from_numpy(case["mv"]) if diag else None,
    ).numpy()
    acc = np.zeros_like(whole)
    for k in range(2):
        b, mv, got = _totals(case, k, diag)
        want = fused_pull_pairs_totals_lanes(
            jnp.asarray(b["w"]), jnp.asarray(b["gm"]), jnp.asarray(b["c"]),
            jnp.asarray(b["valid"]), interpret=True,
            mv=None if mv is None else jnp.asarray(mv), owner_offset=b["off"],
        )
        assert np.array_equal(got, np.asarray(want)), f"block {k}"
        assert not got[1].any()  # the voided lane lacks nothing
        acc = acc + got
    assert np.array_equal(acc, whole)


# (rung, mode, lanes): first (diag), middle, last (check; FD where the
# rung has heartbeats).
CASES = [
    ("int16", "first", 2), ("int16", "middle", 3), ("int16", "last", 2),
    ("int8", "first", 3), ("int8", "last", 2),
    ("u4r", "first", 2), ("u4r", "last", 2),
]


@pytest.mark.parametrize("rung, mode, lanes", CASES, ids=[f"{r}-{m}" for r, m, _ in CASES])
def test_lane_block_pull_equals_interpret_kernel(rung, mode, lanes):
    """Block 1's lane pull (at owner offset n / 2, fed each lane's global
    totals) equals the reference's interpreted lane kernel at that
    offset: every output and each lane's block flag."""
    _, hdt, imdt = RUNGS[rung]
    lean = hdt is None
    diag, check = mode == "first", mode == "last"
    case = _lanes(rung, lanes, seed=11 + len(mode) + lanes)
    totals = _totals(case, 0, diag)[2] + _totals(case, 1, diag)[2]
    b = _block(case, 1)
    j = {k: jnp.asarray(v) for k, v in b.items() if isinstance(v, np.ndarray)}
    t = {k: torch.from_numpy(v.copy()) for k, v in b.items() if isinstance(v, np.ndarray)}
    rkw = dict(owner_offset=b["off"], totals=jnp.asarray(totals))
    pkw = dict(owner_offset=b["off"], totals=torch.from_numpy(totals.copy()))
    if diag:
        rkw["mv"], pkw["mv"] = j["mv"], t["mv"]
        if not lean:
            rkw["hbv"], pkw["hbv"] = j["hbv"], t["hbv"]
    fd = None
    if check:
        rkw["check"] = (j["mv"], j["alive"], j["owner_alive"])
        pkw["check"] = (t["mv"], t["alive"], t["owner_alive"])
        if not lean:
            phis = PHIS[:lanes]
            rkw["hbv"], pkw["hbv"] = j["hbv"], t["hbv"]
            rkw["fd"] = (jnp.asarray(TICK, jnp.int32), j["lc"], jnp.asarray(b["im"], imdt),
                         j["ic"], j["hb0"], jnp.asarray(phis))
            rkw["fd_params"] = FD_CONSTS
            pw, pm = FD_CONSTS[2], FD_CONSTS[3]
            fd = pkw["fd"] = pairs_pull.FdOperands(
                TICK, t["lc"], t["im"].to(getattr(torch, imdt)), t["ic"],
                torch.zeros(t["lc"].shape, dtype=torch.bool), t["hb0"],
                FdParams(FD_CONSTS[0], FD_CONSTS[1], pw, pw * pm, 99.0),
                phi=torch.from_numpy(phis),
            )
    out = fused_pull_pairs_lanes(
        j["w"], None if lean else j["hb"], j["gm"], j["c"], j["valid"],
        jnp.asarray(SALTS[:lanes]), jnp.asarray(RUN_SALTS[:lanes]), BUDGET, interpret=True,
        **rkw,
    )
    flags = pairs_pull.pairs_pull_lanes(
        t["w"], None if lean else t["hb"], t["gm"], t["c"], t["valid"], _salt_mix(lanes),
        BUDGET, **pkw,
    )
    if check:
        out, want_flag = out
        assert np.array_equal(flags.numpy(), np.asarray(want_flag))
    want = (out,) if lean else tuple(out)
    got = [t["w"]] if lean else [t["w"], t["hb"]]
    if fd is not None:
        got += [fd.lc, fd.im, fd.ic, fd.live]
    assert len(got) == len(want)
    for name, a, g in zip(("w", "hb", "lc", "im", "ic", "live"), want, got):
        assert np.array_equal(_ref(a), _np(g)), name
