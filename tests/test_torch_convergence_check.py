"""The port's convergence check (``monorec_tpu_torch/tools/convergence_check.py``)
at a tiny size on the CPU: both policies at 32x64, D=4, batch 2, 2 steps
each. Its record has the JAX tool's keys, its numbers are finite, its curves
hold the logged steps, and two exact runs with the same seeds agree bit for
bit. The step's parity with flax is held by ``tests/test_torch_train.py``.

The runs use one intra-op thread: with several, the CPU's reductions may
split differently from run to run under load, and the last bits move.
"""

import ast
import math
from pathlib import Path

import pytest
import torch

from monorec_tpu_torch import precision
from monorec_tpu_torch.tools import convergence_check as cc

STEPS, BATCH = 2, 2
JAX_TOOL = Path(__file__).resolve().parents[1] / "tools" / "convergence_check.py"


def _run(policy):
    return cc.run_policy(policy, STEPS, BATCH, 25, device="cpu", image_size=(32, 64),
                         depth_steps=4)


@pytest.fixture(scope="module")
def runs():
    saved, threads = (precision._current, precision._consumed), torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {"exact": _run("exact"), "serving": _run("serving"), "exact_again": _run("exact")}
    finally:
        precision._current, precision._consumed = saved
        torch.set_num_threads(threads)


def _jax_tool_keys():
    """The keys of the dict literal that the JAX tool prints."""
    for node in ast.walk(ast.parse(JAX_TOOL.read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets if isinstance(t, ast.Name)] == ["out"]):
            return [k.value for k in node.value.keys]
    raise AssertionError("the JAX tool's output record was not found")


def test_record_has_the_jax_tools_keys(runs):
    record = cc.summarize(1, STEPS, BATCH, runs["exact"], runs["serving"])
    assert list(record) == _jax_tool_keys()
    assert (record["stage"], record["steps"], record["batch"]) == (1, STEPS, BATCH)


def test_numbers_are_finite(runs):
    record = cc.summarize(1, STEPS, BATCH, runs["exact"], runs["serving"])
    numbers = [v for k, v in record.items() if not k.startswith("curve_")]
    numbers += [loss for k in ("curve_exact", "curve_serving") for _, loss in record[k]]
    assert all(math.isfinite(v) for v in numbers)


@pytest.mark.parametrize("policy", ["exact", "serving"])
def test_curve_holds_the_logged_steps(runs, policy):
    # log every 25 steps and the last: steps 0 and 1 of 2
    curve = runs[policy]["curve"]
    assert [step for step, _ in curve] == [0, STEPS - 1]
    assert runs[policy]["final_loss"] == curve[-1][1]


def test_exact_runs_repeat_bit_for_bit(runs):
    assert runs["exact_again"] == runs["exact"]
    assert runs["serving"]["curve"] != runs["exact"]["curve"]  # the policy took effect


def test_stage_4_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
        cc.main(["--stage", "4", "--device", "cpu"])
