"""The lane lift of the pair-fused kernels (the CPU side of the CUDA
kernels' lane launches): ``pairs_pull_lanes_plain`` and
``pairs_totals_lanes_plain`` equal the reference's
``fused_pull_pairs_lanes`` and ``fused_pull_pairs_totals_lanes`` run in
interpret mode, S = 3 lanes each with its own matching, salt, run salt
and FD phi, in the diag, check+FD, totals-fed and packed modes; one lane
whose alive-pair mask is all 0 (a swept fanout below the static bound)
still gets the refresh, the check and the FD epilogue. Lane s also
equals the single-lane plain version on lane s's operands. Tolerance 0
throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aiocluster_tpu.ops.pallas_pull import fused_pull_pairs_lanes, fused_pull_pairs_totals_lanes
from aiocluster_torch.ops import counters, pairs_pull, pairs_totals, prng
from aiocluster_torch.ops.fd import FdParams

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)

S, TICK, BUDGET = 3, 31, 40
SALTS = np.array([7, 2**31 - 5, 123], dtype=np.int32)
RUN_SALTS = np.array([0x9E3779B9, 0, 0x1234567], dtype=np.uint32)
PHIS = np.array([7.0, 8.25, 9.5], dtype=np.float32)
FD_CONSTS = (10.0, 1000, 5.0, 3.3)


def _lanes(n, seed, *, wdt, hdt, packed=False):
    """S lanes of random operands; lane 1's alive-pair mask is all 0."""
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("w", "hb", "gm", "c", "valid", "alive", "owner_alive", "mv", "hbv",
                           "bump", "lc", "im", "ic", "hb0")}
    for s in range(S):
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
        if packed:
            out["w"].append(rng.integers(0, 256, (n, n // 2)).astype(np.uint8))
            out["mv"].append(rng.integers(8, 16, n).astype(np.int32))
        else:
            out["w"].append(rng.integers(0, 50, (n, n)).astype(wdt))
            out["mv"].append(rng.integers(40, 90, n).astype(np.int32))
        out["bump"].append(rng.integers(0, 4, n).astype(np.int32))
        out["hb"].append(rng.integers(0, TICK, (n, n)).astype(hdt))
        out["hbv"].append(rng.integers(TICK - 2, TICK + 1, n).astype(np.int32))
        out["lc"].append(rng.integers(0, TICK, (n, n)).astype(hdt))
        out["im"].append((rng.random((n, n)) * 6).astype(np.float32))
        out["ic"].append(rng.integers(0, 12, (n, n)).astype(np.int16))
        out["hb0"].append(rng.integers(0, TICK, (n, n)).astype(hdt))
    return {k: np.stack(v) for k, v in out.items()}


def _np(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _ref(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _salt_mix() -> torch.Tensor:
    return prng.salt_mix(torch.from_numpy(SALTS.astype(np.int64)),
                         torch.from_numpy(RUN_SALTS.astype(np.int64)))


# mode: (diag, check, fd, hb0, lean, totals, packed, w dtype, hb dtype, imean dtype)
MODES = {
    "diag": dict(diag=True, check=False, fd=False, hb0=False, lean=False, totals=False,
                 packed=False, wdt="int32", hdt="int32", imdt="float32"),
    "check_fd": dict(diag=False, check=True, fd=True, hb0=True, lean=False, totals=False,
                     packed=False, wdt="int16", hdt="int16", imdt="bfloat16"),
    "only_fd": dict(diag=True, check=True, fd=True, hb0=False, lean=False, totals=False,
                    packed=False, wdt="int16", hdt="int16", imdt="float32"),
    "totals_lean": dict(diag=True, check=True, fd=False, hb0=False, lean=True, totals=True,
                        packed=False, wdt="int16", hdt="int16", imdt="float32"),
    "totals_fd": dict(diag=False, check=True, fd=True, hb0=True, lean=False, totals=True,
                      packed=False, wdt="int8", hdt="int16", imdt="bfloat16"),
    "packed": dict(diag=True, check=True, fd=False, hb0=False, lean=True, totals=False,
                   packed=True, wdt="uint8", hdt="int16", imdt="float32"),
    "packed_totals": dict(diag=False, check=False, fd=False, hb0=False, lean=True, totals=True,
                          packed=True, wdt="uint8", hdt="int16", imdt="float32"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_lanes_equal_interpret_kernel(mode):
    m = MODES[mode]
    n = 256 if m["packed"] else 128  # the reference's packed kernel needs 256-multiples
    case = _lanes(n, seed=len(mode), wdt=m["wdt"], hdt=m["hdt"], packed=m["packed"])
    j = {k: jnp.asarray(v) for k, v in case.items()}
    t = {k: torch.from_numpy(np.array(v)) for k, v in case.items()}
    refresh = "bump" if m["packed"] else "mv"
    rkw, pkw = {}, {}
    if m["diag"]:
        rkw["mv"], pkw["mv"] = j[refresh], t[refresh]
        if not m["lean"]:
            rkw["hbv"], pkw["hbv"] = j["hbv"], t["hbv"]
    if m["totals"]:
        want_tot = fused_pull_pairs_totals_lanes(
            j["w"], j["gm"], j["c"], j["valid"], interpret=True, mv=rkw.get("mv"))
        got_tot = pairs_totals.pairs_totals_lanes(
            t["w"], t["gm"], t["c"], t["valid"], mv=pkw.get("mv"))
        assert np.array_equal(got_tot.numpy(), np.asarray(want_tot))
        assert not got_tot[1].any()  # the voided lane lacks nothing
        rkw["totals"], pkw["totals"] = want_tot, got_tot
    if m["check"]:
        rkw["check"] = (j["mv"], j["alive"], j["owner_alive"])
        pkw["check"] = (t["mv"], t["alive"], t["owner_alive"])
    fd = None
    if m["fd"]:
        imdt = torch.bfloat16 if m["imdt"] == "bfloat16" else torch.float32
        rkw["hbv"], pkw["hbv"] = j["hbv"], t["hbv"]
        rkw["fd"] = (jnp.asarray(TICK, jnp.int32), j["lc"], jnp.asarray(case["im"], m["imdt"]),
                     j["ic"], j["hb0"] if m["hb0"] else None, jnp.asarray(PHIS))
        rkw["fd_params"] = FD_CONSTS
        pw, pm = FD_CONSTS[2], FD_CONSTS[3]
        fd = pairs_pull.FdOperands(
            TICK, t["lc"], t["im"].to(imdt), t["ic"], torch.zeros(t["lc"].shape, dtype=torch.bool),
            t["hb0"] if m["hb0"] else None,
            FdParams(FD_CONSTS[0], FD_CONSTS[1], pw, pw * pm, 99.0), phi=torch.from_numpy(PHIS),
        )
        pkw["fd"] = fd
    lean = m["lean"]
    out = fused_pull_pairs_lanes(
        j["w"], None if lean else j["hb"], j["gm"], j["c"], j["valid"], jnp.asarray(SALTS),
        jnp.asarray(RUN_SALTS), BUDGET, interpret=True, **rkw,
    )
    # The single-lane plain version on each lane's operands, for lane parity.
    single = {k: v.clone() for k, v in t.items()}
    counters.reset()
    flags = pairs_pull.pairs_pull_lanes(
        t["w"], None if lean else t["hb"], t["gm"], t["c"], t["valid"], _salt_mix(), BUDGET,
        **pkw,
    )
    assert counters.plain_calls == {"pull": 1} and not counters.launches
    want_flag = None
    if m["check"]:
        out, want_flag = out
        assert np.array_equal(flags.numpy(), np.asarray(want_flag))
    want = [out] if lean else list(out)
    got = [t["w"]] + ([] if lean else [t["hb"]])
    if fd is not None:
        got += [fd.lc, fd.im, fd.ic, fd.live]
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert np.array_equal(_ref(a), _np(b))

    for s in range(S):
        lane_fd = None
        if fd is not None:
            lane_fd = pairs_pull.FdOperands(
                TICK, single["lc"][s], single["im"][s].to(fd.im.dtype), single["ic"][s],
                torch.zeros_like(fd.live[s]), single["hb0"][s] if m["hb0"] else None,
                FdParams(FD_CONSTS[0], FD_CONSTS[1], FD_CONSTS[2], FD_CONSTS[2] * FD_CONSTS[3],
                         float(PHIS[s])),
            )
        kw = {k: v[s] for k, v in pkw.items() if k in ("mv", "hbv", "totals")}
        if m["check"]:
            kw["check"] = tuple(x[s] for x in pkw["check"])
        w_s, hb_s = single["w"][s], None if lean else single["hb"][s]
        flag = pairs_pull.pairs_pull_plain(
            w_s, hb_s, single["gm"][s], single["c"][s], single["valid"][s], int(SALTS[s]),
            int(RUN_SALTS[s]), BUDGET, fd=lane_fd, **kw,
        )
        assert torch.equal(w_s, t["w"][s])
        if not lean:
            assert torch.equal(hb_s, t["hb"][s])
        if lane_fd is not None:
            for a, b in zip((lane_fd.lc, lane_fd.im, lane_fd.ic, lane_fd.live),
                            (fd.lc[s], fd.im[s], fd.ic[s], fd.live[s])):
                assert torch.equal(a, b)
        if m["check"]:
            assert int(flag[0]) == int(flags[s])


def test_voided_lane_still_refreshes_and_runs_the_fd():
    """A lane whose valid mask is all 0 exchanges nothing, but its
    diagonal reads the refresh and its FD epilogue runs (the fanout-mask
    contract of a sweep)."""
    n = 128
    case = _lanes(n, seed=40, wdt="int16", hdt="int16")
    t = {k: torch.from_numpy(np.array(v)) for k, v in case.items()}
    w0, hb0 = t["w"].clone(), t["hb"].clone()
    fd = pairs_pull.FdOperands(
        TICK, t["lc"], t["im"], t["ic"], torch.zeros((S, n, n), dtype=torch.bool), None,
        FdParams(10.0, 1000, 5.0, 16.5, 8.0),
    )
    pairs_pull.pairs_pull_lanes(
        t["w"], t["hb"], t["gm"], t["c"], t["valid"], _salt_mix(), BUDGET, mv=t["mv"],
        hbv=t["hbv"], fd=fd,
    )
    ids = torch.arange(n)
    w1 = w0[1].clone()
    w1[ids, ids] = t["mv"][1].to(w1.dtype)
    assert torch.equal(t["w"][1], w1)  # refreshed, otherwise unchanged
    h1 = hb0[1].clone()
    h1[ids, ids] = t["hbv"][1].to(h1.dtype)
    assert torch.equal(t["hb"][1], h1)
    assert bool(fd.live[1].diagonal().all())  # the epilogue ran: self is live
    assert not torch.equal(t["w"][0], w0[0])  # a valid lane exchanged


def test_lane_wrappers_never_fall_back_off_the_cpu():
    """Tensors that are not on the CPU go to the kernel path, which checks
    its operands and raises: no silent plain fallback."""
    n = 128
    w = torch.zeros((S, n, n), dtype=torch.int16, device="meta")
    gm = torch.zeros((S, n // 8), dtype=torch.int32, device="meta")
    valid = torch.zeros((S, n), dtype=torch.bool, device="meta")
    salt = torch.zeros(S, dtype=torch.int32, device="meta")
    counters.reset()
    with pytest.raises(ValueError, match="CUDA tensor"):
        pairs_pull.pairs_pull_lanes(w, None, gm, gm, valid, salt, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pairs_totals.pairs_totals_lanes(w, gm, gm, valid)
    assert not counters.plain_calls and not counters.launches


def test_lane_counter_keys():
    assert pairs_pull.counter_key(True, False, False, lanes=True) == "pairs_pull[lanes+diag]"
    assert pairs_pull.counter_key(False, True, True, totals=True, lanes=True) == (
        "pairs_pull[lanes+totals+check+fd]")
    assert pairs_pull.counter_key(False, False, False, packed=True, lanes=True) == (
        "pairs_pull[lanes+packed]")
    assert pairs_totals.counter_key(False, lanes=True) == "pairs_totals[lanes+sum]"
    assert pairs_totals.counter_key(True, packed=True, lanes=True) == (
        "pairs_totals[lanes+packed+diag]")
    assert pairs_totals.counter_key(True) == "pairs_totals[diag]"
