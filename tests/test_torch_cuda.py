"""The CUDA kernels against their plain versions at small sizes, and the
kernel path of the simulator against its plain path. These need an
NVIDIA GPU with nvcc (Hopper, sm_90a): on a machine without one they
skip. On a GPU machine without JAX, skip the suite's conftest (it sets
JAX up): ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from aiocluster_torch import Simulator, SimConfig
from aiocluster_torch.ops import counters, pairs_pull, prng
from aiocluster_torch.ops import fd as fd_mod
from aiocluster_torch.ops.fd import FdParams
from aiocluster_torch.sim.state import STATE_FIELDS

pytestmark = pytest.mark.cuda

NARROW = dict(version_dtype="int16", heartbeat_dtype="int16", fd_dtype="bfloat16")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _operands(n, seed, wdt, hdt, imdt, dev, *, diag, check, fd, hb0):
    rng = np.random.default_rng(seed)
    to = lambda a, dt: torch.from_numpy(np.array(a)).to(dev, dt)  # noqa: E731
    gm, c, p = prng.grouped_matching(prng.key(seed), n)
    alive = rng.random(n) < 0.85
    valid = torch.from_numpy(alive) & torch.from_numpy(alive)[p]
    ops = dict(
        w=to(rng.integers(0, 50, (n, n)), wdt), hb=to(rng.integers(0, 30, (n, n)), hdt),
        gm=gm.to(dev, torch.int32), c=c.to(dev, torch.int32), valid=valid.to(dev),
    )
    kw = {}
    mv = to(rng.integers(40, 90, n), torch.int32)
    hbv = to(rng.integers(28, 31, n), torch.int32)
    if diag:
        kw.update(mv=mv, hbv=hbv)
    if check:
        kw["check"] = (mv, to(alive, torch.bool), to(rng.random(n) < 0.9, torch.bool))
    if fd:
        kw["hbv"] = hbv
        kw["fd"] = pairs_pull.FdOperands(
            31, to(rng.integers(0, 31, (n, n)), hdt), to(rng.random((n, n)) * 6, imdt),
            to(rng.integers(0, 12, (n, n)), torch.int16),
            torch.zeros((n, n), dtype=torch.bool, device=dev),
            to(rng.integers(0, 31, (n, n)), hdt) if hb0 else None,
            FdParams(10.0, 1000, 5.0, 16.5, 7.5),
        )
    return ops, kw


def _clone(ops, kw):
    ops = {k: v.clone() for k, v in ops.items()}
    kw = dict(kw)
    if "fd" in kw:
        f = kw["fd"]
        kw["fd"] = dataclasses.replace(
            f, lc=f.lc.clone(), im=f.im.clone(), ic=f.ic.clone(), live=f.live.clone(),
        )
    return ops, kw


def _run(fn, ops, kw):
    flag = fn(ops["w"], ops["hb"], ops["gm"], ops["c"], ops["valid"], 7, 0x12345678, 40, **kw)
    outs = [ops["w"], ops["hb"]]
    if "fd" in kw:
        f = kw["fd"]
        outs += [f.lc, f.im, f.ic, f.live]
    return outs + ([flag] if flag is not None else [])


@pytest.mark.parametrize(
    "mode", [
        dict(diag=False, check=False, fd=False, hb0=False),
        dict(diag=True, check=False, fd=False, hb0=False),
        dict(diag=False, check=True, fd=True, hb0=True),
        dict(diag=True, check=True, fd=True, hb0=False),
    ],
)
@pytest.mark.parametrize(
    "rung", [(torch.int16, torch.int16, torch.bfloat16), (torch.int32, torch.int32, torch.float32)]
)
def test_pairs_kernel_equals_plain(dev, mode, rung):
    ops, kw = _operands(256, 3, *rung, dev, **mode)
    before = counters.pull_launches()
    got = _run(pairs_pull.pairs_pull, *_clone(ops, kw))
    assert counters.pull_launches() == before + 1
    want = _run(pairs_pull.pairs_pull_plain, ops, kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def test_fd_kernel_equals_plain(dev):
    n = 256
    rng = np.random.default_rng(4)
    to = lambda a, dt: torch.from_numpy(np.array(a)).to(dev, dt)  # noqa: E731

    def fresh():
        r = np.random.default_rng(5)
        return [to(r.integers(0, 31, (n, n)), torch.int16), to(r.random((n, n)) * 6, torch.bfloat16),
                to(r.integers(0, 12, (n, n)), torch.int16), torch.zeros((n, n), dtype=torch.bool, device=dev)]

    hb = to(rng.integers(0, 31, (n, n)), torch.int16)
    hb0 = to(rng.integers(0, 31, (n, n)), torch.int16)
    hbv = to(rng.integers(28, 31, n), torch.int32)
    params = FdParams(10.0, 1000, 5.0, 25.0, 8.0)
    a, b = fresh(), fresh()
    fd_mod.fused_fd(31, hb, hb0, hbv, *a, params)
    fd_mod.fused_fd_plain(31, hb, hb0, hbv, *b, params)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_simulator_kernel_path_equals_plain_path(dev):
    cfg = SimConfig(n_nodes=512, keys_per_node=4, fanout=3, budget=64, **NARROW)
    counters.reset()
    kern = Simulator(cfg, seed=2, device=dev)
    kern.run(5)
    assert counters.pull_launches() == 15 and not counters.plain_calls
    plain = Simulator(dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=False), seed=2, device=dev)
    plain.run(5)
    seam = Simulator(dataclasses.replace(cfg, use_pallas=False, use_pallas_fd=True), seed=2, device=dev)
    seam.run(5)
    torch.cuda.synchronize()
    for f in STATE_FIELDS:
        assert torch.equal(getattr(kern.state, f), getattr(plain.state, f)), f
        assert torch.equal(getattr(seam.state, f), getattr(plain.state, f)), f
    assert counters.launches["fd"] == 5
    cpu = Simulator(cfg, seed=2, device="cpu")
    assert cpu.run_until_converged(100) == Simulator(cfg, seed=2, device=dev).run_until_converged(100)


def test_draws_on_the_device_equal_the_host(dev):
    key = prng.key(7)
    on_dev = prng.round_draws(key.to(dev), 3, 4, 1024, 3)
    on_cpu = prng.round_draws(key, 3, 4, 1024, 3)
    for a, b in zip(on_dev, on_cpu, strict=True):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
