"""On the card (marker ``cuda``; skipped without one): the control at a
cell's own size comes out not correct, and a short run of the cell comes
out correct."""

import pytest

from gossipbench import control, harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["headline.converge", "headline.sampled"])
def test_control_fails_at_full_size(cuda_device, workload):
    out = control.control_run(harness.load_cell(workload), 6_000_000_001, cuda_device)
    assert out["correct"] is False and out["failed"] == 0, out


@pytest.mark.cuda
def test_short_run_is_correct(cuda_device):
    out = harness.run_cell(harness.load_cell("headline.converge"), 6_000_000_003, 2.0, False,
                           cuda_device)
    assert out["correct"] and out["device"]["platform"] == "gpu"
