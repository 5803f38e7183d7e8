"""The two-pass single-pass pull: the m8 deficit-totals pass (the CPU
side of its CUDA kernel's wrapper) equals the reference's m8 totals
Pallas kernel run in interpret mode, over the whole width and over
column blocks whose totals sum to the whole width's, also where a row's
valid differs from its partner's (the kernel visits each pair once and
masks each direction by its own row); and pass A's totals fed to the m8
pull give the single pass's bits, block by block too. Tolerance 0
throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aiocluster_tpu.ops.pallas_pull import fused_pull_m8, fused_pull_totals_m8
from aiocluster_torch.ops import counters, m8_pull, m8_totals, pairs_totals, prng
from test_torch_m8_pull import BUDGET, _block, _t
from test_torch_pairs_pull import RUN_SALT, SALT, _case

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)


def _ref_totals(ops, diag, col0=0):
    return np.asarray(fused_pull_totals_m8(
        jnp.asarray(ops["w"]), jnp.asarray(ops["gm"]), jnp.asarray(ops["c"]),
        jnp.asarray(ops["valid"]), interpret=True,
        mv=jnp.asarray(ops["mv"]) if diag else None, owner_offset=col0,
    ))


WHOLE_WIDTH_CASES = [
    ("int16", True, False),
    ("int16", False, True),
    ("int32", True, True),
    ("int32", False, False),
]


def _asymmetric(case, seed):
    """The case with a tenth of its rows' valid flipped, so that some rows
    are valid where their partner is not (the reference's kernel masks
    each row by its own valid)."""
    n = case["valid"].shape[0]
    flip = np.random.default_rng(seed).random(n) < 0.1
    valid = case["valid"] ^ flip
    p = prng.rows_of_groups(torch.from_numpy(case["gm"]).long(),
                            torch.from_numpy(case["c"]).long()).numpy()
    assert (valid != valid[p]).any()
    return dict(case, valid=valid)


def _port_totals(ops, diag, col0=0, fn=m8_totals.m8_totals):
    return fn(
        _t(ops["w"]), _t(ops["gm"]), _t(ops["c"]), _t(ops["valid"]),
        mv=_t(ops["mv"]) if diag else None, owner_offset=col0,
    )


@pytest.mark.parametrize("wdt, diag, self_match", WHOLE_WIDTH_CASES)
def test_plain_totals_equals_interpret_kernel(wdt, diag, self_match):
    case = _case(128, seed=70 + diag + 2 * self_match, wdt=wdt, hdt="int16",
                 imdt="bfloat16", self_match=self_match)
    _check_whole_width(case, diag)


@pytest.mark.parametrize("wdt, diag, self_match", WHOLE_WIDTH_CASES)
def test_plain_totals_asymmetric_valid_equals_interpret_kernel(wdt, diag, self_match):
    case = _case(128, seed=74 + diag + 2 * self_match, wdt=wdt, hdt="int16",
                 imdt="bfloat16", self_match=self_match)
    _check_whole_width(_asymmetric(case, 170 + diag), diag)


def _check_whole_width(case, diag):
    ops = _block(case, True, 0, None)
    want = _ref_totals(ops, diag)
    before = counters.plain_calls["m8_totals"]
    got = _port_totals(ops, diag)
    assert counters.plain_calls["m8_totals"] == before + 1  # CPU: the plain version
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    # The same function as the pair-fused pass A.
    assert torch.equal(got, pairs_totals.pairs_totals_plain(
        _t(ops["w"]), _t(ops["gm"]), _t(ops["c"]), _t(ops["valid"]),
        mv=_t(ops["mv"]) if diag else None))


@pytest.mark.parametrize("diag", [True, False])
def test_column_blocks_sum_to_the_whole_width(diag):
    """n = 256 in two blocks of 128 owners: each block's totals equal the
    reference's at its owner offset, and the blocks' totals sum to the
    whole width's (the reference's sharded psum)."""
    case = _case(256, seed=80 + diag, wdt="int16", hdt="int16", imdt="bfloat16",
                 self_match=True)
    _check_column_blocks(case, diag)


@pytest.mark.parametrize("self_match", [True, False])
@pytest.mark.parametrize("diag", [True, False])
def test_column_blocks_asymmetric_valid_sum_to_the_whole_width(diag, self_match):
    case = _case(256, seed=84 + diag + 2 * self_match, wdt="int32", hdt="int32",
                 imdt="bfloat16", self_match=self_match)
    _check_column_blocks(_asymmetric(case, 180 + diag), diag)


def _check_column_blocks(case, diag):
    whole = _port_totals(_block(case, True, 0, None), diag)
    summed = torch.zeros(256, dtype=torch.float32)
    for col0 in (0, 128):
        ops = _block(case, True, col0, 128)
        got = _port_totals(ops, diag, col0)
        assert np.array_equal(got.numpy(), _ref_totals(ops, diag, col0))
        summed += got
    assert torch.equal(summed, whole)


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "hb"])
@pytest.mark.parametrize("diag", [True, False])
def test_two_pass_equals_single_pass(diag, lean):
    """m8_pull(totals=m8_totals(...)) gives the single pass's bits (the
    reference's two-pass kernels too); so do two column blocks pulled with
    the whole width's totals, side by side."""
    case = _case(256, seed=90 + diag + 2 * lean, wdt="int16", hdt="int16",
                 imdt="bfloat16", self_match=True)
    ops = _block(case, lean, 0, None)
    t = {k: _t(v) for k, v in ops.items()}
    args = (t["gm"], t["c"], t["valid"], SALT, RUN_SALT, BUDGET)
    kw = {}
    if diag:
        kw["mv"] = t["mv"]
        if not lean:
            kw["hbv"] = t["hbv"]
    single = m8_pull.m8_pull(t["w"], t["hb"], *args, **kw)
    totals = m8_totals.m8_totals(t["w"], t["gm"], t["c"], t["valid"], mv=kw.get("mv"))
    two_pass = m8_pull.m8_pull(t["w"], t["hb"], *args, totals=totals, **kw)
    single, two_pass = ((x,) if lean else x for x in (single, two_pass))
    for a, b in zip(single, two_pass, strict=True):
        assert torch.equal(a, b)
    ref_totals = _ref_totals(ops, diag)
    assert np.array_equal(totals.numpy(), ref_totals)
    ref = fused_pull_m8(
        jnp.asarray(ops["w"]), None if lean else jnp.asarray(ops["hb"]),
        jnp.asarray(ops["gm"]), jnp.asarray(ops["c"]), jnp.asarray(ops["valid"]),
        jnp.asarray(SALT, jnp.int32), jnp.asarray(RUN_SALT, jnp.uint32), BUDGET,
        interpret=True, mv=jnp.asarray(ops["mv"]) if diag else None,
        hbv=jnp.asarray(ops["hbv"]) if diag and not lean else None,
        totals=jnp.asarray(ref_totals),
    )
    ref = (ref,) if lean else ref
    for a, b in zip(ref, two_pass, strict=True):
        assert np.array_equal(np.asarray(a), b.numpy())
    blocks = []
    for col0 in (0, 128):
        bops = _block(case, lean, col0, 128)
        bt = {k: _t(v) for k, v in bops.items()}
        bkw = {k: bt[k] for k in kw}
        out = m8_pull.m8_pull(bt["w"], bt["hb"], *args, owner_offset=col0,
                              totals=totals, **bkw)
        blocks.append((out,) if lean else out)
    for k, whole in enumerate(two_pass):
        assert torch.equal(torch.cat([b[k] for b in blocks], dim=1), whole)


def test_counter_keys():
    assert m8_totals.counter_key(True) == "m8_totals[diag]"
    assert m8_totals.counter_key(False) == "m8_totals[sum]"
