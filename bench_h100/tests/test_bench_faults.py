"""The comparison that decides ``correct`` fails a run whose timed path is
broken underneath, for each fault the cell can have; the harness's look
for a chip is skipped (the kinds run on the CPU) and the rest of a run is
driven as the benchmark drives it, with the cell's own limits. A cell
that serves one keyframe a request has no half batch to leave out."""

import pytest

from tiny import run_tiny, tiny_cell


@pytest.mark.parametrize("name, fault", [
    ("kitti-b8-infer", "answer_altered"), ("kitti-b8-infer", "half_batch"),
    ("tmvo-b1-infer", "answer_altered"),
])
def test_inference_faults(name, fault):
    cell = tiny_cell(name, batch=1) if name == "tmvo-b1-infer" else tiny_cell(name)
    _, run = run_tiny(cell, faults=[fault])
    assert not run.correct, run.compared


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_training_faults(fault):
    _, run = run_tiny(tiny_cell("kitti-b8-stage4"), faults=[fault])
    assert not run.correct, run.compared


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "no_exchange"])
def test_data_parallel_faults(fault):
    _, run = run_tiny(tiny_cell("kitti-b32-stage1-dp4"), faults=[fault])
    assert not run.correct, run.compared
