"""The control of each cell's comparison, at a size a test run holds: the
plain reference computed one precision step below the configuration's
(convolutions on TF32 operands, emulated by rounding on the CPU) has to
fail at least one of the cell's numbers against the exact reference, with
the cell's own limits. On the card the same control runs at the cell's
size (``calibrate.py``; PERF.md gives its readings)."""

import time

import pytest
import torch

from bench_h100 import harness
from bench_h100.kinds import _training
from bench_h100.kinds import infer_closed_loop as ic
from tiny import tiny_cell

SEEDS = (2**31 + 5, 2**33 + 6, 7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["kitti-b8-infer", "tmvo-b1-infer"])
def test_inference_control_fails(name, seed):
    cell = tiny_cell(name)
    ctx = harness.Context(cell, seed, 0.0, False, torch.device("cpu"), time.perf_counter())
    order, points = ic.plan(seed, cell.traffic)
    exact = ic.reference_answers(ctx, order, range(len(points)))
    control = ic.reference_answers(ctx, order, range(len(points)), exact=False)
    readings = ic.gaps(control, exact)
    assert any(readings[k] > cell.limits[k] for k in cell.limits), readings


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["kitti-b8-stage4", "kitti-b32-stage1-dp4"])
def test_training_control_fails(name, seed):
    cell = tiny_cell(name)
    ref = _training.reference_steps(cell, seed, torch.device("cpu"))
    control = _training.reference_steps(cell, seed, torch.device("cpu"), exact=False)
    readings = _training.gaps(control, ref)
    assert any(readings[k] > cell.limits[k] for k in cell.limits), readings


def test_tf32_rounding():
    from bench_h100.reference.monorec import round_tf32

    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 1.0 + 3 * 2**-11, -3.14159])
    got = round_tf32(x)
    # 10 mantissa bits: ties go to the even neighbour.
    assert got[:4].tolist() == [1.0, 1.0, 1.0 + 2**-10, 1.0 + 2**-9]
    assert abs(got[4].item() + 3.14159) < 2**-9
