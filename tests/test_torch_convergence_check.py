"""The port's convergence check (``monorec_tpu_torch/tools/convergence_check.py``)
at a tiny size on the CPU: both policies at 32x64, D=4, batch 2, 2 steps
each. Its record has the JAX tool's keys, its numbers are finite, its curves
hold the logged steps, and two exact runs with the same seeds agree bit for
bit; ``--stage 4`` (through ``MonoRecTrainer``) prints its record with the
same keys. The steps' parity with the JAX package is held by
``tests/test_torch_train.py`` and ``tests/test_torch_refinement_feed.py``.

The runs use one intra-op thread: with several, the CPU's reductions may
split differently from run to run under load, and the last bits move.
"""

import ast
import json
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


def test_stage_4_prints_its_record(monkeypatch, capsys):
    """``main(["--stage", "4"])`` at the tiny size: stage 4's two policies
    through ``MonoRecTrainer``, their record on stdout with the JAX tool's
    keys, finite abs_rel and the logged steps. (Its losses are NaN here: the
    seed-0 MaskModule puts every pixel above 0.5, a ratio of 1, where
    ``depth_refinement_loss`` means over no static pixel.)"""
    run_policy = cc.run_policy

    def tiny(*args, **kwargs):
        return run_policy(*args, **kwargs, image_size=(32, 64), depth_steps=4)

    monkeypatch.setattr(cc, "run_policy", tiny)
    saved, threads = (precision._current, precision._consumed), torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cc.main(["--stage", "4", "--device", "cpu", "--steps", str(STEPS),
                        "--batch", str(BATCH)]) == 0
    finally:
        precision._current, precision._consumed = saved
        torch.set_num_threads(threads)
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(record) == _jax_tool_keys()
    assert (record["stage"], record["steps"], record["batch"]) == (4, STEPS, BATCH)
    assert math.isfinite(record["abs_rel_exact"]) and math.isfinite(record["abs_rel_serving"])
    for key in ("curve_exact", "curve_serving"):
        assert [step for step, _ in record[key]] == [0, STEPS - 1]
    assert record["abs_rel_serving"] != record["abs_rel_exact"]  # the policy took effect
