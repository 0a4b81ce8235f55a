"""Each traffic kind drives a tiny cell on the CPU through the program's
plain kernels, and its run is correct against the reference."""

import json

import pytest

from bench_h100 import harness
from tiny import run_tiny, tiny_cell


@pytest.mark.parametrize("name", ["kitti-b8-infer", "tmvo-b1-infer"])
def test_inference_cell(name):
    ctx, run = run_tiny(tiny_cell(name), trace=True)
    assert run.correct, run.compared
    assert set(run.metrics) == {"infer_keyframes_per_s", "infer_p95_ms", "setup_s"}
    line = harness.result_line(ctx, run, "cpu")
    assert list(line)[-1] == "checks"
    assert {"cost_volume_ms.infer", "unet_ms.infer", "mfu_pct.infer"} <= set(line["metrics"])
    json.dumps(line)


def test_compared_requests_spread_over_the_window():
    """The compared requests start after points of the window drawn from the
    seed, not among its first requests."""
    from bench_h100.kinds import infer_closed_loop as ic

    cell = tiny_cell("kitti-b8-infer", compared_requests=3)
    order, points = ic.plan(2**31 + 77, cell.traffic)
    assert len(points) == 3 and points == sorted(points) and 0 <= points[0] and points[-1] < 1
    assert ic.plan(2**31 + 78, cell.traffic)[1] != points
    _, run = run_tiny(cell)
    kept = run.record["compared_positions"]
    assert len(kept) == 3 and len(set(kept)) == 3 and kept[-1] < run.attempted
    assert len(run.compared) == 2 and run.correct


def test_training_cell():
    ctx, run = run_tiny(tiny_cell("kitti-b8-stage4"), trace=True)
    assert run.correct, run.compared
    assert set(run.metrics) == {"train_keyframes_per_s", "setup_s"}
    assert {"loss_ms.train", "backward_ms.train", "mfu_pct.train"} <= set(
        harness.per_layer(run.record))


def test_data_parallel_cell():
    """Two gloo ranks in place of the four cards."""
    cell = tiny_cell("kitti-b32-stage1-dp4")
    assert cell.chips == 2
    _, run = run_tiny(cell)
    assert run.correct, run.compared
    assert run.device_count == 2


def test_result_line_without_trace():
    ctx, run = run_tiny(tiny_cell("tmvo-b1-infer"))
    line = harness.result_line(ctx, run, "cpu")
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert set(line["metrics"]) == set(run.metrics)
    assert line["device"]["platform"] == "gpu" and "busy_s" not in line["device"]


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "monorec_tpu_torch_extra", types.ModuleType("x"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "monorec_tpu.models", types.ModuleType("y"))
    assert harness.forbidden_loaded() == ["monorec_tpu"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(harness.parse_args(["--workload", "kitti-b8-infer", "--seed", "1",
                                          "--seconds", "1"]), 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


def test_leaf_quantile_sees_a_few_leaves():
    """A fault confined to a tenth of the leaves leaves the median leaf's gap
    at 0 and moves the 90th percentile."""
    import torch

    from bench_h100.kinds import _training

    ref = {"grad_norms": {f"l{i}": 1.0 + i % 3 for i in range(70)},
           "update_norms": {f"l{i}": 0.1 * (1 + i % 3) for i in range(70)},
           "losses": [1.0], "first_result": torch.zeros(1, 1, 2, 2)}
    got = {k: (dict(v) if isinstance(v, dict) else v) for k, v in ref.items()}
    for i in range(0, 70, 8):  # 9 leaves
        got["grad_norms"][f"l{i}"] *= 2
        got["update_norms"][f"l{i}"] = 0.0
    g = _training.gaps(got, ref)
    assert g["grad_gap"] == 0 and g["update_gap"] == 0
    assert g["grad_gap_p90"] > 0.4 and g["update_gap_p90"] > 0.4


@pytest.mark.parametrize("kind", ["infer", "train"])
def test_device_idle_reads_busy_against_the_untraced_window(kind):
    """0.1 s busy a traced step against 0.125 s a step in the window: 20% idle,
    however long the profiler made the traced steps."""
    reader = harness.metric_readers()[f"device_idle_pct.{kind}"]
    rec = {"kind": kind, "steps": 160, "window_s": 20.0,
           "trace": {"busy_s": 0.8, "items": 8, "window_s": 5.0}}
    assert reader.read(rec) == pytest.approx(20.0)
    assert harness.metric_readers()[f"device_idle_pct.{'train' if kind == 'infer' else 'infer'}"
                                    ].read(rec) is None
