"""The span recorder (``monorec_tpu_torch/tracing.py``) on the CPU: off, it
hands out one shared null context and keeps nothing; on, its spans nest by
parent and item, subtract their children, show as host ranges to the
profiler, and leave the forward's and the training step's results as they
are. Every test leaves the recorder off (the suite shares its worker
processes)."""

import contextlib
import time

import numpy as np
import pytest
import torch

from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch import tracing
from monorec_tpu_torch.cli.inference_example import serve
from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from monorec_tpu_torch.train import MonoRecTrainer
from monorec_tpu_torch.train.loggers import read_scalars

B, H, W, F, D = 2, 32, 64, 2, 8
FORWARD_SPANS = {"cost_volume", "features", "mask", "depth"}
# The stage-4 step's spans: each one's parent and its calls a step (two
# cost volumes and two depth decodes: mono and stereo, separate passes).
STAGE4_TREE = {"train_step": ([], 1), "feed": (["train_step"], 1),
               "cost_volume": (["feed"], 2), "features": (["feed"], 1), "mask": (["feed"], 1),
               "depth": (["feed"], 2), "loss": (["feed"], 1),
               "backward": (["train_step"], 1), "grad_reduce": (["train_step"], 1),
               "optimizer": (["train_step"], 1), "sync.guard": (["optimizer"], 1),
               "sync.losses": (["train_step"], 1), "sync.metrics": (["train_step"], 1)}


def _off():
    return tracing.span("a") is tracing.span("b")


@pytest.fixture(autouse=True)
def _recorder_left_off():
    assert _off()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    assert _off()


def _tree(recorder, item=0):
    """{span name: (the names of its parents, its calls)} in ``item``."""
    tree = {}
    for s in recorder.spans:
        if s.item == item:
            parents, calls = tree.get(s.name, (set(), 0))
            if s.parent >= 0:
                parents.add(recorder.spans[s.parent].name)
            tree[s.name] = (parents, calls + 1)
    return {name: (sorted(parents), calls) for name, (parents, calls) in tree.items()}


def _model(seed=0):
    return MonoRec(MonoRecConfig(cv_depth_steps=D),
                   generator=torch.Generator().manual_seed(seed)).eval()


def _batch(seed=1, stereo=False):
    return batch_to_torch(make_batch(B, H, W, F, stereo=stereo, mask=stereo, seed=seed, tz=0.5),
                          "cpu")


class _Loader:
    batch_size = B

    def __len__(self):
        return 100

    def __iter__(self):
        return iter([_batch(stereo=True)])


def _stage4_trainer(tmp_path, **trainer_options):
    config = {"loss": "depth_refinement_loss",
              "metrics": ["a1_sparse_metric", "abs_rel_sparse_metric"],
              "optimizer": {"type": "Adam", "args": {"lr": 1e-5, "amsgrad": True}},
              "trainer": {"compute_mask": True, "compute_stereo_pred": True,
                          "mult_mask_on_cv": True, "alpha": 0.5, "max_distance": 80,
                          "skip_nonfinite_updates": True, "tensorboard": False,
                          **trainer_options}}
    model = MonoRec(MonoRecConfig(cv_depth_steps=D, augmentation="depth",
                                  freeze_module=("att",)),
                    generator=torch.Generator().manual_seed(0))
    params = [p for p in model.parameters() if p.requires_grad]
    return MonoRecTrainer(model, config_mod.build_loss(config), config_mod.build_metrics(config),
                          config_mod.build_optimizer(config, params, 100), config, _Loader(),
                          run_dir=tmp_path, options=("stereo", "stereo_repr"),
                          generator=torch.Generator().manual_seed(3))




def test_off_hands_out_one_shared_null_context():
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a"):
        pass

    @tracing.traced("f")
    def f(x):
        return x + 1

    assert f(1) == 2
    with tracing.capture(False) as recorder:
        pass
    with tracing.span("a"):  # after the block: off again, nothing kept
        f(1)
    assert recorder.spans == [] and recorder.collect() == {"items": 0, "spans": {}}


def test_spans_nest_by_parent_and_item_and_subtract_children():
    @tracing.traced("outer")
    def outer():
        time.sleep(0.002)
        with tracing.span("inner"):
            time.sleep(0.003)
        with tracing.span("inner"):
            time.sleep(0.003)

    with tracing.capture(False) as recorder:
        outer()
        with tracing.span("inner"):  # a root of its own: the next item
            pass
    assert _tree(recorder, 0) == {"outer": ([], 1), "inner": (["outer"], 2)}
    assert _tree(recorder, 1) == {"inner": ([], 1)}
    got = recorder.collect()
    assert got["items"] == 2
    o, i = got["spans"]["outer"], got["spans"]["inner"]
    assert o["calls"] == [1, 0] and i["calls"] == [2, 1]
    assert i["host_ms"][0] >= 6.0 and o["host_ms"][0] >= i["host_ms"][0] + 2.0
    assert o["device_ms"] == o["host_ms"]  # no card: the host does the work
    assert o["self_device_ms"][0] == pytest.approx(o["device_ms"][0] - i["device_ms"][0])
    assert i["self_device_ms"] == i["device_ms"]


def test_collect_keeps_the_first_items():
    with tracing.capture(False) as recorder:
        for _ in range(3):
            with tracing.span("req"):
                with tracing.span("part"):
                    pass
        assert recorder.collect(items=2)["spans"]["part"]["calls"] == [1, 1]
    assert recorder.collect(items=5)["items"] == 3
    with tracing.capture(False) as recorder:
        with tracing.span("req"):
            pass
    assert recorder.collect()["spans"]["req"]["calls"] == [1]


def test_forward_gives_one_item_of_its_four_layers():
    model = _model()
    with torch.inference_mode(), tracing.capture(False) as recorder:
        model(_batch())
        model(_batch(2))
    spans = recorder.collect()
    assert spans["items"] == 2 and set(spans["spans"]) == FORWARD_SPANS | {"forward"}
    for item in (0, 1):
        assert _tree(recorder, item) == {"forward": ([], 1),
                                         **{name: (["forward"], 1) for name in FORWARD_SPANS}}
    assert _off()


@pytest.mark.parametrize("layers", [18, 50])
def test_simple_mask_forward_opens_depth_prepass_around_its_first_depth(layers):
    """Under ``simple_mask`` the first, no-gradient depth pass is the span
    ``depth_prepass`` with one ``depth`` inside it; the second ``depth`` is
    the forward's own. The full MaskModule's forward opens none."""
    model = MonoRec(MonoRecConfig(cv_depth_steps=D, resnet_layers=layers, simple_mask=True),
                    generator=torch.Generator().manual_seed(0)).eval()
    with torch.inference_mode(), tracing.capture(False) as recorder:
        model(_batch())
    spans = recorder.collect()["spans"]
    assert spans["depth_prepass"]["calls"] == [1] and spans["depth"]["calls"] == [2]
    assert _tree(recorder) == {"forward": ([], 1),
                               **{name: (["forward"], 1) for name in FORWARD_SPANS - {"depth"}},
                               "depth_prepass": (["forward"], 1),
                               "depth": (["depth_prepass", "forward"], 2)}
    assert 0 <= spans["depth_prepass"]["self_device_ms"][0] < spans["depth_prepass"][
        "device_ms"][0]
    with torch.inference_mode(), tracing.capture(False) as recorder:
        _model()(_batch())
    assert "depth_prepass" not in recorder.collect()["spans"]


def test_stage4_train_step_gives_the_tree(tmp_path):
    trainer = _stage4_trainer(tmp_path)
    with tracing.capture(False) as recorder:
        trainer.train_step(_batch(stereo=True), 0.5)
    assert recorder.collect()["items"] == 1
    assert _tree(recorder) == STAGE4_TREE


def test_spans_are_host_ranges_of_the_profiler():
    """Under ``torch.profiler`` each span is a host range of its name that
    holds its operators, nested in its parent's."""
    from torch.profiler import ProfilerActivity, profile

    model = _model()
    batch = _batch()
    with torch.inference_mode(), tracing.capture(False), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        model(batch)
    events = prof.events()
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in events
              if e.name in FORWARD_SPANS | {"forward"}}
    assert set(ranges) == FORWARD_SPANS | {"forward"}
    f0, f1 = ranges["forward"]
    for name in FORWARD_SPANS:
        s0, s1 = ranges[name]
        assert f0 <= s0 < s1 <= f1, name
        assert any(e.name.startswith("aten::") and s0 <= e.time_range.start
                   and e.time_range.end <= s1 for e in events), name


def test_results_equal_with_the_recorder_on_or_off(tmp_path):
    model, batch = _model(), _batch()
    with torch.inference_mode():
        off = model(batch)
        with tracing.capture(False):
            on = model(batch)
    for key in ("result", "cv_mask", "cost_volume"):
        assert torch.equal(off[key], on[key]), key

    batch = _batch(stereo=True)
    plain, traced = _stage4_trainer(tmp_path / "a"), _stage4_trainer(tmp_path / "b")
    floats_off, metrics_off, _ = plain.train_step(batch, 0.5)
    with tracing.capture(False):
        floats_on, metrics_on, _ = traced.train_step(batch, 0.5)
    assert list(floats_off) == list(floats_on) and floats_on["skipped_nonfinite"] == 0.0
    # The random mask marks no pixel moving, so the dynamic terms are NaN
    # on both sides (equal here); the step applies, its gradients finite.
    np.testing.assert_array_equal(list(floats_off.values()), list(floats_on.values()))
    np.testing.assert_array_equal(metrics_off, metrics_on)
    for (k, a), (_, b) in zip(plain.model.state_dict().items(),
                              traced.model.state_dict().items()):
        assert torch.equal(a, b), k


def test_capture_restores_the_recorder_around_it():
    with tracing.capture(False) as outer:
        with tracing.span("outside"):
            with tracing.capture(False) as inner:
                with tracing.span("inside"):
                    pass
            with tracing.span("after"):
                pass
    assert set(inner.collect()["spans"]) == {"inside"}
    assert _tree(outer) == {"outside": ([], 1), "after": (["outside"], 1)}


def test_cpu_log_step_times_the_host_with_a_card_present(tmp_path, monkeypatch):
    """A model on the CPU is timed on the host's clock, with no CUDA event,
    even where a card is present (the device follows the model's
    parameters, not ``torch.cuda.is_available``)."""
    recorders = []
    capture = tracing.capture

    @contextlib.contextmanager
    def spy(cuda):
        with capture(cuda) as recorder:
            recorders.append(recorder)
            yield recorder

    monkeypatch.setattr(tracing, "capture", spy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    trainer = _stage4_trainer(tmp_path, module_timing=True, log_step=1, len_epoch=1)
    trainer._train_epoch(1)
    assert len(recorders) == 1 and not recorders[0].cuda
    spans = recorders[0].collect()["spans"]
    times = read_scalars(tmp_path / "tb" / "metrics.jsonl")[0]
    assert set(k for k in times if k.endswith("_module_time")) == {
        "cv_module_time", "resnet_module_time", "mask_module_time", "depth_module_time"}
    for name, key in (("cost_volume", "cv_module_time"), ("features", "resnet_module_time"),
                      ("mask", "mask_module_time"), ("depth", "depth_module_time")):
        assert times[key] == pytest.approx(sum(spans[name]["host_ms"])) and times[key] > 0


def test_serve_gives_no_latency_for_no_request():
    assert serve(_model(), []) == ([], [])
