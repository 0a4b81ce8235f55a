"""The program's own spans (``monorec_tpu_torch/tracing.py``) against the
harness's wrappers (``harness.Spans``) on the CPU, at the tiny size: per
item, the program's ``cost_volume``, ``mask`` + ``depth``, ``loss`` and
``backward`` + ``grad_reduce`` + ``optimizer`` host times read what the
wrappers around the same calls read, within 10% + 0.5 ms."""

import torch

from bench_h100 import harness, scenes
from bench_h100.kinds import _training
from bench_h100.kinds import infer_closed_loop as ic
from bench_h100.reference.monorec import seeded_state_dict
from tiny import tiny_cell

SEED = 2**31 + 77
ITEMS = 3


def _agree(program, wrapped):
    assert len(program) == len(wrapped) == ITEMS
    for p, w in zip(program, wrapped):
        assert abs(p - w) <= 0.1 * w + 0.5, (program, wrapped)


def _program(recorder, *names):
    spans = recorder.collect()["spans"]
    return [sum(v) for v in zip(*(spans[n]["host_ms"] for n in names))]


def test_inference_spans_read_what_the_wrappers_read():
    from monorec_tpu_torch import tracing

    cell = tiny_cell("kitti-b8-infer")
    cfg, tr, dev = cell.config, cell.traffic, torch.device("cpu")
    s = cfg["shape"]
    model = ic._program_model(cfg, seeded_state_dict(s["depth_steps"], scenes.sub_seed(SEED, 0),
                                                     dev), dev)
    batches = scenes.make_batches(cfg["scene"], ITEMS, tr["batch"], s["height"], s["width"],
                                  s["frames"], False, SEED, dev)
    spans = harness.Spans(False)
    for attr in ("cost_volume", "mask", "depth"):
        spans.wrap(model, attr, attr)
    with torch.inference_mode(), tracing.capture(False) as recorder:
        for i, batch in enumerate(batches):
            spans.item = i
            model({k: batch[k] for k in ic.INPUT_KEYS})
    wrapped = spans.per_item()
    _agree(_program(recorder, "cost_volume"), wrapped["cost_volume"])
    _agree(_program(recorder, "mask", "depth"),
           [m + d for m, d in zip(wrapped["mask"], wrapped["depth"])])


def test_training_spans_read_what_the_wrappers_read(tmp_path):
    from monorec_tpu_torch import config as config_mod
    from monorec_tpu_torch import tracing
    from monorec_tpu_torch.models import MonoRec
    from monorec_tpu_torch.train import MonoRecTrainer

    cell = tiny_cell("kitti-b8-stage4")
    cfg, tr, dev = cell.config, cell.traffic, torch.device("cpu")
    stage = _training.stage_config(cfg, tr)
    model = MonoRec(config_mod.build_model_config(stage["arch"]["args"]),
                    generator=torch.Generator().manual_seed(0))
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = config_mod.build_optimizer(stage, params, _training.STEPS_PER_EPOCH)
    trainer = MonoRecTrainer(model, config_mod.build_loss(stage), config_mod.build_metrics(stage),
                             optimizer, stage, _training.Loader(tr["global_batch"], False),
                             run_dir=tmp_path, options=tr["options"],
                             generator=torch.Generator().manual_seed(3))
    batches = _training.global_batches(cfg, tr, SEED, dev, ITEMS)
    # The wrappers as the training kind puts them: around the loss, and from
    # after ``zero_grad`` to after ``step``.
    spans = harness.Spans(False)
    spans.wrap(trainer, "loss_fn", "loss")
    zero_grad, step = optimizer.zero_grad, optimizer.step

    def zero_grad_marked(*a, **k):
        zero_grad(*a, **k)
        spans.mark("backward")

    def step_marked(*a, **k):
        out = step(*a, **k)
        spans.close("backward")
        return out

    optimizer.zero_grad, optimizer.step = zero_grad_marked, step_marked
    with tracing.capture(False) as recorder:
        for i, batch in enumerate(batches):
            spans.item = i
            trainer.train_step(batch, 0.5)
    wrapped = spans.per_item()
    _agree(_program(recorder, "loss"), wrapped["loss"])
    _agree(_program(recorder, "backward", "grad_reduce", "optimizer"), wrapped["backward"])
