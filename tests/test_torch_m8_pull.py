"""The plain single-pass sub-exchange (the CPU side of the m8 CUDA
kernel's wrapper) equals the reference's m8 Pallas kernel run in
interpret mode in every mode on the m8 path: int16 and int32, the lean
and the heartbeat profiles, the diagonal refresh on and off, the totals
given, a dead mask, self-matched groups and a column block of the owners
(``owner_offset``). Tolerance 0 throughout: every quantity is an integer
or the same float32 ops in the same order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aiocluster_tpu.ops.pallas_pull import fused_pull_m8
from aiocluster_torch.ops import counters, m8_pull, pairs_pull
from test_torch_pairs_pull import RUN_SALT, SALT, _case

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)

BUDGET = 40


def _block(case, lean, col0, n_local):
    """The case's operands for the owners col0 .. col0 + n_local - 1 (the
    whole width when n_local is None)."""
    cols = slice(col0, None if n_local is None else col0 + n_local)
    return dict(
        w=np.ascontiguousarray(case["w"][:, cols]),
        hb=None if lean else np.ascontiguousarray(case["hb"][:, cols]),
        gm=case["gm"], c=case["c"], valid=case["valid"],
        mv=case["mv"][cols], hbv=case["hbv"][cols],
    )


def _reference(ops, *, diag, totals=None, col0=0):
    j = {k: None if v is None else jnp.asarray(v) for k, v in ops.items()}
    out = fused_pull_m8(
        j["w"], j["hb"], j["gm"], j["c"], j["valid"], jnp.asarray(SALT, jnp.int32),
        jnp.asarray(RUN_SALT, jnp.uint32), BUDGET, interpret=True,
        mv=j["mv"] if diag else None,
        hbv=j["hbv"] if diag and ops["hb"] is not None else None,
        owner_offset=col0,
        totals=None if totals is None else jnp.asarray(totals),
    )
    out = (out,) if ops["hb"] is None else out
    return [np.asarray(x) for x in out]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _port(ops, *, diag, totals=None, col0=0, fn=m8_pull.m8_pull, **kw):
    t = {k: _t(v) for k, v in ops.items()}
    before = {k: v.clone() for k, v in t.items() if v is not None}
    out = fn(
        t["w"], t["hb"], t["gm"], t["c"], t["valid"], SALT, RUN_SALT, BUDGET,
        mv=t["mv"] if diag else None,
        hbv=t["hbv"] if diag and t["hb"] is not None else None,
        owner_offset=col0, totals=_t(totals), **kw,
    )
    for k, v in before.items():  # out of place: the inputs are untouched
        assert torch.equal(t[k], v), k
    out = (out,) if t["hb"] is None else out
    return [x.numpy() for x in out]


CASES = {
    # name: (w dtype, hb dtype, lean, diag, totals, self_match, block)
    "i16 hb diag": ("int16", "int16", False, True, False, False, False),
    "i16 hb": ("int16", "int16", False, False, False, False, False),
    "i32 hb diag": ("int32", "int32", False, True, False, False, False),
    "i32 hb totals": ("int32", "int32", False, False, True, False, False),
    "i16 lean diag": ("int16", "int16", True, True, False, False, False),
    "i16 lean totals diag": ("int16", "int16", True, True, True, False, False),
    "i32 lean": ("int32", "int32", True, False, False, False, False),
    "i16 hb diag self-matched": ("int16", "int16", False, True, False, True, False),
    "i32 lean totals self-matched": ("int32", "int32", True, False, True, True, False),
    "i16 hb diag block": ("int16", "int16", False, True, True, False, True),
    "i16 lean diag block": ("int16", "int16", True, True, True, True, True),
    "i32 hb block": ("int32", "int16", False, False, True, False, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_m8_pull_equals_interpret_kernel(name):
    """n = 128, or 256 with n_local = 128 at owner_offset 128 for a
    column block; an 85%-alive dead mask; the totals arbitrary (some
    zero, most binding at budget 40): each row's scale must come from its
    own total."""
    wdt, hdt, lean, diag, given, self_match, block = CASES[name]
    n = 256 if block else 128
    case = _case(n, seed=60 + len(name), wdt=wdt, hdt=hdt, imdt="bfloat16",
                 self_match=self_match)
    col0, n_local = (128, 128) if block else (0, None)
    ops = _block(case, lean, col0, n_local)
    totals = None
    if given:
        rng = np.random.default_rng(len(name))
        totals = rng.integers(0, 3000, n).astype(np.float32)
        totals[::7] = 0.0
    want = _reference(ops, diag=diag, totals=totals, col0=col0)
    before = counters.plain_calls["m8_pull"]
    got = _port(ops, diag=diag, totals=totals, col0=col0)
    assert counters.plain_calls["m8_pull"] == before + 1  # CPU: the plain version
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("arith", ["i16", "i16_f32"])
def test_int16_variants_on_the_experiments_inputs(arith):
    """The experiment's variants compute the reference kernel's function:
    on its input ranges (w in [0, 2000), hb in [0, 500), everyone alive)
    their plain version is the reference's output."""
    n = 128
    rng = np.random.default_rng(3)
    case = _case(n, seed=3, wdt="int16", hdt="int16", imdt="bfloat16")
    ops = _block(case, False, 0, None)
    ops["w"] = rng.integers(0, 2000, (n, n)).astype(np.int16)
    ops["hb"] = rng.integers(0, 500, (n, n)).astype(np.int16)
    ops["valid"] = np.ones(n, bool)
    want = _reference(ops, diag=False)
    got = _port(ops, diag=False, arith=arith)
    for a, b in zip(want, got, strict=True):
        assert np.array_equal(a, b)


def test_m8_equals_the_pairs_pull():
    """The single-pass and the pair-fused sub-exchange are the same
    function (the reference pins its two kernels bit-identical): the
    port's plain versions agree in the refresh mode with hb."""
    case = _case(256, seed=5, wdt="int16", hdt="int16", imdt="bfloat16", self_match=True)
    ops = _block(case, False, 0, None)
    got = _port(ops, diag=True)
    t = {k: _t(v) for k, v in ops.items()}
    pairs_pull.pairs_pull_plain(
        t["w"], t["hb"], t["gm"], t["c"], t["valid"], SALT, RUN_SALT, BUDGET,
        mv=t["mv"], hbv=t["hbv"],
    )
    assert np.array_equal(got[0], t["w"].numpy()) and np.array_equal(got[1], t["hb"].numpy())


def test_out_buffers_and_operand_rules():
    case = _case(128, seed=8, wdt="int16", hdt="int16", imdt="bfloat16")
    ops = _block(case, False, 0, None)
    want = _port(ops, diag=True)
    t = {k: _t(v) for k, v in ops.items()}
    w_out, hb_out = torch.full_like(t["w"], -1), torch.full_like(t["hb"], -1)
    args = (t["w"], t["hb"], t["gm"], t["c"], t["valid"], SALT, RUN_SALT, BUDGET)
    got = m8_pull.m8_pull(*args, mv=t["mv"], hbv=t["hbv"], out=(w_out, hb_out))
    assert got[0] is w_out and got[1] is hb_out
    assert np.array_equal(w_out.numpy(), want[0]) and np.array_equal(hb_out.numpy(), want[1])
    with pytest.raises(ValueError, match="must not alias"):
        m8_pull.m8_pull(*args, out=(t["w"], None))
    with pytest.raises(ValueError, match="hbv required"):
        m8_pull.m8_pull(*args, mv=t["mv"])
    with pytest.raises(ValueError, match="lean mode"):
        m8_pull.m8_pull(t["w"], None, *args[2:], hbv=t["hbv"], mv=t["mv"])
    with pytest.raises(ValueError, match="only with hb"):
        m8_pull.m8_pull(*args, mv=t["mv"], hbv=t["hbv"], arith="i16")
    with pytest.raises(ValueError, match="unknown arith"):
        m8_pull.m8_pull(*args, arith="i8")


def test_counter_keys():
    assert m8_pull.counter_key(True) == "m8_pull[diag]"
    assert m8_pull.counter_key(False) == "m8_pull[pull]"
    assert m8_pull.counter_key(True, totals=True) == "m8_pull[totals+diag]"
    assert m8_pull.counter_key(False, totals=True) == "m8_pull[totals]"
    assert m8_pull.counter_key(False, arith="i16_f32") == "m8_pull[i16_f32]"
