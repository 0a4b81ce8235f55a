"""The kind ``infer_closed_loop_arch``, its plain reference of ResNet-50 +
SimpleMaskModule, its frozen operation counts (``flops_arch.py``) and the
readers of the program's spans, on the CPU at the tiny size."""

import json
import math
import time

import pytest
import torch

from bench_h100 import flops, flops_arch, harness
from bench_h100.kinds import infer_closed_loop as ic
from bench_h100.kinds import infer_closed_loop_arch as ica
from bench_h100.reference.monorec import Refine
from bench_h100.reference.monorec_r50_simple import MonoRecR50SimpleReference
from tiny import run_tiny, tiny_cell

CELL = "kitti-r50simple-b8-infer"
KITTI = dict(height=256, width=512, depth_steps=32, frames=2)
R50_SIMPLE = {"resnet_layers": 50, "simple_mask": True}


def test_cell_runs_traced_and_correct():
    ctx, run = run_tiny(tiny_cell(CELL), trace=True)
    assert run.correct, run.compared
    assert set(run.metrics) == {"infer_keyframes_per_s", "infer_p95_ms", "setup_s"}
    line = harness.result_line(ctx, run, "cpu")
    # ``device_idle_pct.infer`` reads the card's activity: nothing on the CPU.
    assert {"features_ms.infer", "depth_prepass_ms.infer", "unet_ms.infer",
            "mfu_pct.infer"} <= set(line["metrics"])
    program = run.record["program"]
    assert program["items"] == run.attempted
    assert set(program["spans"]) == {"forward", "cost_volume", "features", "depth_prepass",
                                     "depth", "mask"}
    # Two depth passes a request, the first inside ``depth_prepass``.
    assert all(c == 2 for c in program["spans"]["depth"]["calls"])
    assert run.record["flops_per_item"] == flops_arch.infer_flops(
        dict(run.record["shape"]), R50_SIMPLE)
    json.dumps(line)


def test_untraced_run_records_no_program_spans():
    _, run = run_tiny(tiny_cell(CELL))
    assert run.correct, run.compared
    assert "program" not in run.record and "trace" not in run.record


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_faults_make_it_incorrect(fault):
    _, run = run_tiny(tiny_cell(CELL), faults=[fault])
    assert not run.correct, run.compared


@pytest.mark.parametrize("seed", (2**31 + 5, 2**33 + 6, 7))
def test_control_fails(seed):
    cell = tiny_cell(CELL)
    ctx = harness.Context(cell, seed, 0.0, False, torch.device("cpu"), time.perf_counter())
    order, points = ica.plan(seed, cell.traffic)
    exact = ica.reference_answers(ctx, order, range(len(points)))
    control = ica.reference_answers(ctx, order, range(len(points)), exact=False)
    readings = ica.gaps(control, exact)
    assert any(readings[k] > cell.limits[k] for k in cell.limits), readings


def test_reference_for_follows_the_arch():
    from bench_h100.reference import monorec

    assert ica.reference_for({"resnet_layers": 18})[0] is monorec.MonoRecReference
    network, _ = ica.reference_for(R50_SIMPLE)
    with torch.device("meta"):
        assert isinstance(network(8, (0.33, 0.0025)), MonoRecR50SimpleReference)
    with pytest.raises(ValueError, match="resnet_layers=34"):
        ica.reference_for({"resnet_layers": 34})


def test_r50_simple_gflop():
    m = {k: flops.gflop(v) for k, v in flops_arch.module_flops(KITTI, R50_SIMPLE).items()}
    assert m == {"resnet": 21.4, "mask": 56.5, "depth": 60.9, "k1": 1.6}
    assert flops.gflop(flops_arch.infer_flops(KITTI, R50_SIMPLE)) == 201.1


def test_resnet50_stem_and_a_bottleneck_by_hand():
    convs = flops_arch.resnet_convs(50, 256, 512)
    assert len(convs) == 53
    # The stem: 7x7x3 -> 64 at 128x256, then the max pool to 64x128.
    assert convs[0] == (3, 64, 7, 7, 128 * 256, False)
    # layer2.0: 1x1 256 -> 128 at 64x128, the 3x3 with the stride at 32x64,
    # 1x1 128 -> 512, and the strided 1x1 shortcut 256 -> 512.
    layer2 = 1 + 3 * 3 + 1  # the stem, layer1's three blocks, layer1.0's shortcut
    assert convs[layer2:layer2 + 4] == [(256, 128, 1, 1, 64 * 128, False),
                                        (128, 128, 3, 3, 32 * 64, False),
                                        (128, 512, 1, 1, 32 * 64, False),
                                        (256, 512, 1, 1, 32 * 64, False)]
    ops = 2 * (256 * 128 * 64 * 128 + 128 * 128 * 9 * 32 * 64 + 128 * 512 * 32 * 64
               + 256 * 512 * 32 * 64)
    assert flops.conv_flops(convs[layer2:layer2 + 4]) == ops


def test_resnet18_and_the_mask_module_as_flops_py_counts_them():
    assert flops_arch.module_flops(KITTI, {"resnet_layers": 18}) == flops.module_flops(KITTI)
    assert flops_arch.infer_flops(KITTI, {}) == flops.step_flops(KITTI, "infer")


def test_counts_match_the_reference_modules():
    """2 x the multiply-adds that the reference's convolutions perform, read
    from their shapes by hooks, at a small size: the ResNet-50, the simple
    mask once, each depth pass."""
    h, w, d, f = 64, 128, 8, 2
    model = MonoRecR50SimpleReference(d)
    total = {}

    def hook(name):
        def count(mod, inp, out):
            x = inp[0]
            if isinstance(mod, Refine):
                t = mod.conv2d_t
                n = t.in_channels * t.out_channels * 16 * x.shape[-2] * x.shape[-1]
            else:
                n = (mod.in_channels * mod.out_channels * math.prod(mod.kernel_size)
                     * out.shape[-2] * out.shape[-1])
            total[name] = total.get(name, 0) + 2 * n * x.shape[0]
        return count

    for name, sub in (("mask", model.att_module), ("depth", model.depth_module)):
        for mod in sub.modules():
            if isinstance(mod, (torch.nn.Conv2d, Refine)):
                mod.register_forward_hook(hook(name))
    # The encoder's convolutions run through ``conv2d`` on their weights, not
    # their modules' forward: count them from each convolution's weight and
    # the size of the feature map it writes.
    enc = model._feature_extractor.encoder
    sizes = {}
    with torch.no_grad():
        feats = model._feature_extractor(torch.rand(1, 3, h, w))
        assert [t.shape[1] for t in feats] == list(flops_arch.feature_channels(50))
        hh, ww = feats[1].shape[-2:]
        sizes[enc.conv1] = feats[0].shape[-2] * feats[0].shape[-1]
        for block in (b for layer in (enc.layer1, enc.layer2, enc.layer3, enc.layer4)
                      for b in layer):
            s = block.conv2.stride[0]
            h2, w2 = math.ceil(hh / s), math.ceil(ww / s)
            sizes.update({block.conv1: hh * ww, block.conv2: h2 * w2, block.conv3: h2 * w2})
            if block.downsample is not None:
                sizes[block.downsample[0]] = h2 * w2
            hh, ww = h2, w2
        total["resnet"] = sum(2 * c.weight.numel() * px for c, px in sizes.items())
        model.att_module(torch.rand(1, f, d, h, w), torch.rand(1, 3, h, w),
                         torch.rand(1, 1, h, w), feats)
        model.depth_module(torch.rand(1, d, h, w), torch.rand(1, 3, h, w), feats)
    got = flops_arch.module_flops(dict(height=h, width=w, depth_steps=d, frames=f), R50_SIMPLE)
    assert {k: got[k] for k in total} == total


@pytest.fixture(scope="module")
def existing_records():
    """Traced records of the existing kinds, tiny: an inference and a
    training cell."""
    return [run_tiny(tiny_cell(name), trace=True)[1].record
            for name in ("kitti-b8-infer", "kitti-b8-stage4")]


@pytest.mark.parametrize("name", ["features_ms.infer", "depth_prepass_ms.infer"])
def test_new_readers_read_nothing_in_the_existing_kinds(name, existing_records):
    reader = harness.metric_readers()[name]
    assert [reader.read(rec) for rec in existing_records] == [None, None]


def test_new_readers_read_the_program_spans():
    rec = {"kind": "infer", "program": {"items": 2, "spans": {
        "features": {"device_ms": [8.0, 9.0]}, "depth_prepass": {"device_ms": [20.0, 22.0]}}}}
    readers = harness.metric_readers()
    assert readers["features_ms.infer"].read(rec) == pytest.approx(8.5)
    assert readers["depth_prepass_ms.infer"].read(rec) == pytest.approx(21.0)
    # A program without the span (a model with the full MaskModule).
    del rec["program"]["spans"]["depth_prepass"]
    assert readers["depth_prepass_ms.infer"].read(rec) is None


def test_arch_kind_on_the_kitti_config_reads_what_the_old_kind_reads():
    """On ResNet-18 with the MaskModule the new kind's model, weights,
    reference and operations are the old kind's."""
    cell = tiny_cell("kitti-b8-infer")
    cell.traffic["kind"] = "infer_closed_loop_arch"
    ctx, run = run_tiny(cell)
    assert run.correct, run.compared
    assert run.record["flops_per_item"] == flops.step_flops(cell.config["shape"], "infer")
    _, old = run_tiny(tiny_cell("kitti-b8-infer"))
    assert [c["value"] for c in run.compared] == [c["value"] for c in old.compared]
    assert ic.plan(ctx.seed, cell.traffic) == ica.plan(ctx.seed, cell.traffic)
