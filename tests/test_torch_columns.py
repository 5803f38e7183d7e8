"""Column blocks of the owners (the owner-sharded form): the plain pairs
pull, pairs totals and FD versions at an ``owner_offset`` equal the
reference's Pallas kernels run in interpret mode at the same offset, in
every mode a sharded round reaches. N = 256 in two blocks of 128 (the
packed rung N = 512 in two of 256: the reference's packed kernel takes
256-owner blocks); each block is run, and each holds the owner diagonal
of half the rows while the other half's refresh falls outside it. The
pull is fed the rows' global totals (the blocks' shares summed), as the
sharded round feeds it; the blocks' shares sum to the whole width's.
Tolerance 0: every quantity is an integer or the same float32 ops in the
same order, and the shares are exact integer sums below 2^24."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aiocluster_tpu.ops.pallas_fd import fused_fd as ref_fused_fd
from aiocluster_tpu.ops.pallas_pull import fused_pull_pairs, fused_pull_pairs_totals
from aiocluster_torch.ops import fd as fd_mod
from aiocluster_torch.ops import pairs_pull, pairs_totals, prng
from aiocluster_torch.ops.fd import FdParams

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)

SALT, RUN_SALT, TICK, BUDGET = 13, 0x9E3779B9, 31, 40
FD_CONSTS = (10.0, 100, 5.0, 3.3)  # max_interval, window, prior_weight, prior_mean
PHI = 7.5
PARAMS = FdParams(10.0, 100, 5.0, 5.0 * 3.3, PHI)

# (w, hb, imean, icount dtypes, live bitmap) per rung; hb None is lean.
RUNGS = {
    "int16": ("int16", "int16", "bfloat16", "int16", False),
    "lean_int16": ("int16", None, None, None, False),
    "lean_int8": ("int8", None, None, None, False),
    "u4r": ("u4", None, None, None, False),
    "shrunk": ("int16", "int16", "bfloat16", "int8", True),
}
MODES = {
    "first": dict(diag=True, check=False, fd=False),
    "middle": dict(diag=False, check=False, fd=False),
    "last": dict(diag=False, check=True, fd=False),
    "last_fd": dict(diag=False, check=True, fd=True),
}
CASES = [
    ("int16", "first"), ("int16", "middle"), ("int16", "last_fd"),
    ("lean_int16", "first"), ("lean_int16", "middle"), ("lean_int16", "last"),
    ("lean_int8", "first"), ("lean_int8", "middle"), ("lean_int8", "last"),
    ("u4r", "first"), ("u4r", "middle"), ("u4r", "last"),
    ("shrunk", "last_fd"),
]


def _case(rung, seed):
    """Whole-width operands (numpy) of one sub-exchange on ``rung``."""
    wdt, hdt, imdt, icdt, _ = RUNGS[rung]
    packed = wdt == "u4"
    n = 512 if packed else 256
    rng = np.random.default_rng(seed)
    gm, c, p = prng.grouped_matching(prng.key(seed), n)
    alive = rng.random(n) < 0.85
    case = dict(
        n=n, gm=gm.numpy().astype(np.int32), c=c.numpy().astype(np.int32),
        valid=alive & alive[p.numpy()], alive=alive,
        owner_alive=rng.random(n) < 0.9,
        mv=(rng.integers(0, 3, n) if packed else rng.integers(40, 90, n)).astype(np.int32),
        hbv=rng.integers(TICK - 2, TICK + 1, n).astype(np.int32),
    )
    if packed:
        case["w"] = rng.integers(0, 256, (n, n // 2)).astype(np.uint8)
    else:
        case["w"] = rng.integers(0, 50, (n, n)).astype(wdt)
    if hdt is not None:
        case["hb"] = rng.integers(0, TICK, (n, n)).astype(hdt)
        case["lc"] = rng.integers(0, TICK, (n, n)).astype(hdt)
        case["hb0"] = rng.integers(0, TICK, (n, n)).astype(hdt)
        case["im"] = (rng.random((n, n)) * 6).astype(np.float32)
        case["ic"] = rng.integers(0, 101, (n, n)).astype(icdt)  # up to the window
    return case


def _block(case, k):
    """Block k of the case: each matrix's columns, each owner vector's
    slice (a packed w stores two owners a byte)."""
    n = case["n"]
    width = n // 2
    cols = slice(k * width, (k + 1) * width)
    out = dict(case, off=k * width, width=width)
    packed = case["w"].dtype == np.uint8
    out["w"] = np.ascontiguousarray(
        case["w"][:, k * width // 2 : (k + 1) * width // 2] if packed else case["w"][:, cols]
    )
    for name in ("hb", "lc", "hb0", "im", "ic"):
        if name in case:
            out[name] = np.ascontiguousarray(case[name][:, cols])
    for name in ("mv", "hbv", "owner_alive"):
        out[name] = np.ascontiguousarray(case[name][cols])
    return out


def _totals(case, mv, k=None, ref=True):
    """The reference's (None unless ``ref``) and the port's totals of
    block k (or the whole width), as numpy."""
    b = case if k is None else _block(case, k)
    off = 0 if k is None else b["off"]
    bmv = None if mv is None else b["mv"]
    want = None
    if ref:
        want = np.asarray(fused_pull_pairs_totals(
            jnp.asarray(b["w"]), jnp.asarray(b["gm"]), jnp.asarray(b["c"]),
            jnp.asarray(b["valid"]), interpret=True,
            mv=None if bmv is None else jnp.asarray(bmv), owner_offset=off,
        ))
    got = pairs_totals.pairs_totals(
        torch.from_numpy(b["w"].copy()), torch.from_numpy(b["gm"]), torch.from_numpy(b["c"]),
        torch.from_numpy(b["valid"]), mv=None if bmv is None else torch.from_numpy(bmv),
        owner_offset=off,
    )
    return want, got.numpy()


@pytest.mark.parametrize("diag", [True, False], ids=["diag", "sum"])
@pytest.mark.parametrize("rung", ["lean_int16", "lean_int8", "u4r"])
def test_block_totals_equal_interpret_kernel(rung, diag):
    """Each block's totals equal the reference's at its offset, and the
    blocks' shares summed in float32 equal the whole width's."""
    case = _case(rung, 3 + diag)
    mv = case["mv"] if diag else None
    whole_ref, whole = _totals(case, mv)
    assert np.array_equal(whole, whole_ref)
    acc = np.zeros_like(whole)
    for k in range(2):
        want, got = _totals(case, mv, k)
        assert np.array_equal(got, want), f"block {k}"
        acc = acc + got
    assert np.array_equal(acc, whole)


def _ref_np(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _np(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


@pytest.mark.parametrize("k", [0, 1], ids=["block0", "block1"])
@pytest.mark.parametrize("rung, mode", CASES, ids=[f"{r}-{m}" for r, m in CASES])
def test_block_pull_equals_interpret_kernel(rung, mode, k):
    """Block k's pull (fed the rows' global totals) equals the
    reference's interpreted kernel at the block's owner offset: every
    output and the block's convergence flag."""
    m = MODES[mode]
    _, hdt, imdt, _, bits = RUNGS[rung]
    case = _case(rung, 11 + 2 * list(MODES).index(mode))
    lean = hdt is None
    mv = case["mv"] if m["diag"] else None
    totals = _totals(case, mv, 0, ref=False)[1] + _totals(case, mv, 1, ref=False)[1]
    b = _block(case, k)
    j = {key: jnp.asarray(v) for key, v in b.items() if isinstance(v, np.ndarray)}
    t = {key: torch.from_numpy(v.copy()) for key, v in b.items() if isinstance(v, np.ndarray)}
    rkw = dict(owner_offset=b["off"], totals=jnp.asarray(totals))
    pkw = dict(owner_offset=b["off"], totals=torch.from_numpy(totals.copy()))
    if m["diag"]:
        rkw["mv"], pkw["mv"] = j["mv"], t["mv"]
        if not lean:
            rkw["hbv"], pkw["hbv"] = j["hbv"], t["hbv"]
    if m["check"]:
        rkw["check"] = (j["mv"], j["alive"], j["owner_alive"])
        pkw["check"] = (t["mv"], t["alive"], t["owner_alive"])
    fd = None
    if m["fd"]:
        rkw["hbv"], pkw["hbv"] = j["hbv"], t["hbv"]
        rkw["fd"] = (jnp.asarray(TICK, jnp.int32), j["lc"], jnp.asarray(b["im"], imdt), j["ic"],
                     j["hb0"], PHI)
        rkw["fd_params"] = FD_CONSTS + ((True,) if bits else ())
        width = b["width"]
        live = torch.zeros((b["n"], width // 8 if bits else width),
                           dtype=torch.uint8 if bits else torch.bool)
        fd = pkw["fd"] = pairs_pull.FdOperands(
            TICK, t["lc"], t["im"].to(getattr(torch, imdt)), t["ic"], live, t["hb0"], PARAMS,
        )
    out = fused_pull_pairs(
        j["w"], None if lean else j["hb"], j["gm"], j["c"], j["valid"],
        jnp.asarray(SALT, jnp.int32), jnp.asarray(RUN_SALT, jnp.uint32), BUDGET,
        interpret=True, **rkw,
    )
    flag = pairs_pull.pairs_pull(
        t["w"], None if lean else t["hb"], t["gm"], t["c"], t["valid"], SALT, RUN_SALT,
        BUDGET, **pkw,
    )
    if m["check"]:
        out, want_flag = out
        assert int(flag[0]) == int(want_flag)
    want = (out,) if lean else out
    got = [t["w"]] if lean else [t["w"], t["hb"]]
    if fd is not None:
        got += [fd.lc, fd.im, fd.ic, fd.live]
    assert len(got) == len(want)
    for name, a, g in zip(("w", "hb", "lc", "im", "ic", "live"), want, got):
        assert np.array_equal(_ref_np(a), _np(g)), name


def test_block_check_passes_where_the_block_caught_up():
    """A block whose owners every alive row has reached passes the check
    while the other block fails it: the round's flag is their min."""
    case = _case("lean_int16", 21)
    case["w"][:, :128] = 90  # every row caught up on block 0's owners
    flags = []
    for k in range(2):
        b = _block(case, k)
        t = {key: torch.from_numpy(v.copy()) for key, v in b.items() if isinstance(v, np.ndarray)}
        flags.append(int(pairs_pull.pairs_pull(
            t["w"], None, t["gm"], t["c"], t["valid"], SALT, RUN_SALT, BUDGET,
            totals=torch.zeros(b["n"]), owner_offset=b["off"],
            check=(t["mv"], t["alive"], t["owner_alive"]),
        )[0]))
    assert flags == [1, 0]


@pytest.mark.parametrize("k", [0, 1], ids=["block0", "block1"])
@pytest.mark.parametrize("hdt, imdt", [("int16", "bfloat16"), ("int32", "float32")])
def test_block_fd_equals_interpret_kernel(hdt, imdt, k):
    """The standalone FD pass on block k (its self diagonal and hb0's
    refresh at global owner offset + j) equals the reference's kernel
    with the same owner_offset, and the blocks side by side equal the
    whole width's pass."""
    n, width = 256, 128
    rng = np.random.default_rng(5)
    hb = rng.integers(0, TICK, (n, n)).astype(hdt)
    hb0 = np.minimum(hb, rng.integers(0, TICK, (n, n)).astype(hdt))
    hbv = rng.integers(TICK - 2, TICK + 1, n).astype(np.int32)
    lc = rng.integers(0, TICK, (n, n)).astype(hdt)
    im = (rng.random((n, n)) * 6).astype(np.float32)
    ic = rng.integers(0, 12, (n, n)).astype(np.int16)
    cols = slice(k * width, (k + 1) * width)

    def blk(a):
        return np.ascontiguousarray(a[:, cols] if a.ndim == 2 else a[cols])

    want = [_ref_np(a) for a in ref_fused_fd(
        jnp.asarray(TICK, jnp.int32), jnp.asarray(blk(hb)), jnp.asarray(blk(hb0)),
        jnp.asarray(blk(hbv)), jnp.asarray(blk(lc)), jnp.asarray(blk(im), imdt),
        jnp.asarray(blk(ic)), max_interval=10.0, window=100, prior_weight=5.0,
        prior_mean=3.3, phi_threshold=PHI, interpret=True, owner_offset=k * width,
    )]
    lc_t, ic_t = torch.tensor(blk(lc)), torch.tensor(blk(ic))
    im_t = torch.tensor(blk(im)).to(getattr(torch, imdt))
    live = torch.zeros((n, width), dtype=torch.bool)
    fd_mod.fused_fd(TICK, torch.tensor(blk(hb)), torch.tensor(blk(hb0)), torch.tensor(blk(hbv)),
                    lc_t, im_t, ic_t, live, PARAMS, owner_offset=k * width)
    for a, g in zip(want, (lc_t, im_t, ic_t, live)):
        assert np.array_equal(a, _np(g))
    whole = [torch.tensor(lc), torch.tensor(im).to(getattr(torch, imdt)), torch.tensor(ic),
             torch.zeros((n, n), dtype=torch.bool)]
    fd_mod.fused_fd(TICK, torch.tensor(hb), torch.tensor(hb0), torch.tensor(hbv), *whole, PARAMS)
    for a, g in zip(whole, (lc_t, im_t, ic_t, live)):
        assert torch.equal(a[:, cols], g)
    # The block holds the self diagonal of rows k * width .. only.
    rows = torch.arange(k * width, (k + 1) * width)
    assert bool(live[rows, rows - k * width].all())


def test_block_operands_are_checked():
    """A block that is not rows of 8-element vectors (16 owners packed),
    or an offset that does not place it among the owners (a packed block
    starts on a byte), is refused by the kernels' operand check."""
    with pytest.raises(ValueError, match="owner_offset"):
        pairs_pull.check_block(256, 128, 192, packed=False)
    with pytest.raises(ValueError, match="8-element"):
        pairs_pull.check_block(256, 12, 0, packed=False)
    with pytest.raises(ValueError, match="16 owners"):
        pairs_pull.check_block(512, 24, 0, packed=True)
    with pytest.raises(ValueError, match="owner_offset"):
        pairs_pull.check_block(512, 256, 129, packed=True)
    pairs_pull.check_block(256, 128, 128, packed=False)
