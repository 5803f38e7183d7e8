"""The plain FD phase (the CPU side of the standalone CUDA kernel's
wrapper) equals the reference's streaming Pallas FD kernel in interpret
mode, and the shared ``fd_update`` arithmetic equals the reference's
(the XLA block's ops in the same order). Tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aiocluster_tpu.ops import pallas_pull
from aiocluster_tpu.ops.pallas_fd import fused_fd as ref_fused_fd
from aiocluster_torch.ops import _build, counters
from aiocluster_torch.ops import fd as fd_mod
from aiocluster_torch.ops.fd import FdParams

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)

CONSTS = dict(max_interval=10.0, window=1000, prior_weight=5.0, prior_mean=3.3)
PHI = 7.5
PARAMS = FdParams(10.0, 1000, 5.0, 5.0 * 3.3, PHI)


def _np(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _ref_np(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("hdt, imdt", [("int16", "bfloat16"), ("int32", "float32")])
def test_plain_fd_equals_interpret_kernel(hdt, imdt):
    n, tick = 128, 40
    rng = np.random.default_rng(1)
    hb = rng.integers(0, tick, (n, n)).astype(hdt)
    hb0 = np.minimum(hb, rng.integers(0, tick, (n, n)).astype(hdt))
    hbv = rng.integers(tick - 2, tick + 1, n).astype(np.int32)
    lc = rng.integers(0, tick, (n, n)).astype(hdt)
    lc[rng.random((n, n)) < 0.1] = 0  # never seen
    im = (rng.random((n, n)) * 6).astype(np.float32)
    ic = rng.integers(0, 12, (n, n)).astype(np.int16)
    ic[rng.random((n, n)) < 0.05] = 1000  # at the window cap
    # Host copies of the reference's results before the port runs: the
    # port updates its inputs in place, which must not race JAX reading
    # numpy memory it may share.
    want = [_ref_np(a) for a in ref_fused_fd(
        jnp.asarray(tick, jnp.int32), jnp.asarray(hb), jnp.asarray(hb0),
        jnp.asarray(hbv), jnp.asarray(lc), jnp.asarray(im, imdt), jnp.asarray(ic),
        phi_threshold=PHI, interpret=True, **CONSTS,
    )]
    lc_t, ic_t = torch.tensor(lc), torch.tensor(ic)
    im_t = torch.tensor(im).to(getattr(torch, imdt))
    live = torch.zeros((n, n), dtype=torch.bool)
    before = counters.plain_calls["fd"]
    fd_mod.fused_fd(
        tick, torch.tensor(hb), torch.tensor(hb0), torch.tensor(hbv),
        lc_t, im_t, ic_t, live, PARAMS,
    )
    assert counters.plain_calls["fd"] == before + 1
    for a, b in zip(want, (lc_t, im_t, ic_t, live)):
        assert np.array_equal(a, _np(b))
    assert 0 < int(live.sum()) < n * n  # both outcomes exercised


def test_fd_update_equals_reference_arithmetic():
    n, tick = 4096, 57
    rng = np.random.default_rng(2)
    hb = rng.integers(0, tick, n).astype(np.int32)
    hb0 = rng.integers(0, tick, n).astype(np.int32)
    lc = rng.integers(0, tick, n).astype(np.int32)
    im = (rng.random(n) * 12).astype(np.float32)
    ic = rng.integers(0, 1001, n).astype(np.int32)
    want = pallas_pull.fd_update(
        jnp.asarray(tick, jnp.int32), jnp.asarray(hb), jnp.asarray(hb0),
        jnp.asarray(lc), jnp.asarray(im), jnp.asarray(ic),
        max_interval=CONSTS["max_interval"], window=CONSTS["window"],
        prior_weight=CONSTS["prior_weight"], prior_mean=CONSTS["prior_mean"], phi=PHI,
    )
    got = fd_mod.fd_update(
        tick, torch.from_numpy(hb), torch.from_numpy(hb0), torch.from_numpy(lc),
        torch.from_numpy(im), torch.from_numpy(ic), PARAMS,
    )
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_fd_params_fold_the_prior_on_the_host():
    from aiocluster_torch.sim.config import SimConfig

    p = FdParams.from_config(SimConfig(n_nodes=128, prior_weight=5.0, prior_mean_ticks=3.3))
    assert p.prior_wm == 5.0 * 3.3 and p.window == 1000 and p.phi == 8.0


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
