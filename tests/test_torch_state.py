"""init_state equals the reference's on each ported rung, the dtype
contract matches, and states carry across in both directions."""

import numpy as np
import pytest
import torch

from aiocluster_tpu.sim import SimConfig as RefConfig
from aiocluster_tpu.sim import state as ref_state
from aiocluster_torch.sim import state as port_state
from aiocluster_torch.sim.carry import state_from_numpy, state_to_numpy
from aiocluster_torch.sim.config import SimConfig

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)

RUNGS = [
    dict(),
    dict(version_dtype="int16", heartbeat_dtype="int16", fd_dtype="bfloat16"),
    dict(version_dtype="int16", heartbeat_dtype="int32", fd_dtype="float32"),
    dict(track_failure_detector=False),
    dict(track_failure_detector=False, track_heartbeats=False),
]


def _ref_arrays(rs) -> dict[str, np.ndarray]:
    return {f: np.asarray(getattr(rs, f)) for f in port_state.STATE_FIELDS}


def _assert_same(ref: dict, port: dict):
    assert set(ref) == set(port)
    for f in ref:
        a, b = ref[f], port[f]
        assert a.shape == b.shape, f
        assert a.dtype.name == b.dtype.name, (f, a.dtype, b.dtype)
        assert np.array_equal(a.view(np.uint16) if a.dtype.name == "bfloat16" else a,
                              b.view(np.uint16) if b.dtype.name == "bfloat16" else b), f


@pytest.mark.parametrize("rung", RUNGS)
def test_init_state_matches_reference(rung):
    kw = dict(n_nodes=128, keys_per_node=5, **rung)
    ref = ref_state.init_state(RefConfig(**kw))
    port = port_state.init_state(SimConfig(**kw), device="cpu")
    _assert_same(_ref_arrays(ref), state_to_numpy(port))


def test_init_state_initial_versions_and_overflow():
    kw = dict(n_nodes=128, version_dtype="int16")
    iv = np.arange(128, dtype=np.int32) % 7 + 1
    ref = ref_state.init_state(RefConfig(**kw), iv)
    port = port_state.init_state(SimConfig(**kw), torch.from_numpy(iv), device="cpu")
    _assert_same(_ref_arrays(ref), state_to_numpy(port))
    with pytest.raises(ValueError, match="overflow"):
        port_state.init_state(SimConfig(**kw), np.full(128, 2**15), device="cpu")


@pytest.mark.parametrize("rung", RUNGS)
def test_expected_dtypes_and_limits_match_reference(rung):
    kw = dict(n_nodes=128, **rung)
    assert port_state.expected_dtypes(SimConfig(**kw)) == ref_state.expected_dtypes(
        RefConfig(**kw)
    )
    assert port_state.VERSION_LIMITS == ref_state.VERSION_LIMITS
    assert port_state.HEARTBEAT_LIMITS == ref_state.HEARTBEAT_LIMITS


@pytest.mark.parametrize("rung", RUNGS[:3])
def test_carry_round_trips(rung):
    kw = dict(n_nodes=128, keys_per_node=3, **rung)
    ref = _ref_arrays(ref_state.init_state(RefConfig(**kw)))
    ref["imean"] = ref["imean"] + np.asarray(1.375, ref["imean"].dtype)  # non-zero floats
    port = state_from_numpy(ref, SimConfig(**kw), device="cpu")
    assert port_state.state_n_local(port) == 128
    _assert_same(ref, state_to_numpy(port))
    again = state_from_numpy(state_to_numpy(port), SimConfig(**kw), device="cpu")
    _assert_same(ref, state_to_numpy(again))


def test_carry_rejects_a_mismatched_rung():
    kw = dict(n_nodes=128)
    arrays = _ref_arrays(ref_state.init_state(RefConfig(**kw)))
    narrow = SimConfig(n_nodes=128, version_dtype="int16")
    with pytest.raises(ValueError, match="w: dtype int32"):
        state_from_numpy(arrays, narrow, device="cpu")
    del arrays["icount"]
    with pytest.raises(ValueError, match="missing"):
        state_from_numpy(arrays, SimConfig(**kw), device="cpu")
