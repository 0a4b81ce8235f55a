"""The frozen operation and byte counts against hand counts and against
the reference's own modules."""

import math

import pytest
import torch

from bench_h100 import flops
from bench_h100.reference.monorec import MonoRecReference, Refine

KITTI = dict(height=256, width=512, depth_steps=32, frames=2)
TMVO = dict(height=480, width=640, depth_steps=32, frames=4)


@pytest.mark.parametrize("shape, want", [
    (KITTI, {"resnet": 9.5, "mask": 58.2, "depth": 54.4, "k1": 1.6}),
    (TMVO, {"resnet": 22.2, "mask": 178.2, "depth": 127.6, "k1": 7.3}),
], ids=["kitti", "tmvo"])
def test_module_gflop(shape, want):
    got = {k: flops.gflop(v) for k, v in flops.module_flops(shape).items()}
    assert got == want


def test_resnet_stem_by_hand():
    # 7x7x3 -> 64 at 128x256, then the max pool.
    assert flops.resnet18_convs(256, 512)[0] == (3, 64, 7, 7, 128 * 256, False)


def test_step_flops_rules():
    m = flops.module_flops(KITTI)
    k1_stereo = flops.k1_flops(1, (1,), 32, 256, 512)
    assert flops.step_flops(KITTI, "infer") == sum(m.values())
    assert flops.step_flops(KITTI, "stage1") == m["resnet"] + m["k1"] + 3 * m["depth"]
    assert flops.step_flops(KITTI, "stage4") == pytest.approx(
        m["resnet"] + m["k1"] + k1_stereo + m["mask"] + 4 * m["depth"])


def test_k1_by_hand():
    # B=8, F=2, D=32, 256x512: sources 8*2*3*HW f32, keyframes 8*3*HW f32,
    # homographies 16*32*9 f64 in; per-frame CVs 16*32*HW and fused 8*32*HW out.
    hw = 256 * 512
    n_bytes = 16 * 3 * hw * 4 + 8 * 3 * hw * 4 + 16 * 32 * 9 * 8 + (16 + 8) * 32 * hw * 4
    ops = flops.K1_CV_FLOPS * 16 * 32 * hw + (2 * 2 + 3) * 8 * 32 * hw
    assert flops.K1_CV_FLOPS == 173 + 9
    assert flops.k1_flops(8, (2,), 32, 256, 512) == ops
    assert flops.k1_bound_s(8, (2,), 32, 256, 512) == max(n_bytes / 3.35e12, ops / 67e12)
    # Bound by operations: 0.186 ms, as PERF.md's kernel table has it.
    assert round(flops.k1_bound_s(8, (2,), 32, 256, 512) * 1e3, 3) == 0.186


def test_k3_by_hand():
    # Forward at M=64, 3x256x512: x, y in, the map out; bound by bytes.
    elems, px = 64 * 3 * 256 * 512, 64 * 256 * 512
    assert flops.k3_bound_s("fwd", 64, 256, 512) == max((2 * elems + px) * 4 / 3.35e12,
                                                        (81 * elems + px) / 67e12)
    assert round(flops.k3_bound_s("fwd", 64, 256, 512) * 1e3, 3) == 0.070
    assert round(flops.k3_bound_s("bwd", 64, 256, 512) * 1e3, 3) == 0.100


def test_counts_match_the_modules():
    """2 x the multiply-adds that the reference's convolutions perform, read
    from their shapes by hooks, at a small size."""
    h, w, d, f = 64, 128, 8, 2
    model = MonoRecReference(d)
    total = {}

    def hook(name):
        def count(mod, inp, out):
            x = inp[0]
            if isinstance(mod, Refine):  # its transposed convolution, counted whole
                t = mod.conv2d_t
                n = t.in_channels * t.out_channels * 16 * x.shape[-2] * x.shape[-1]
            else:
                n = (mod.in_channels * mod.out_channels * math.prod(mod.kernel_size)
                     * out.shape[-2] * out.shape[-1])
            total[name] = total.get(name, 0) + 2 * n * x.shape[0]
        return count

    for name, sub in (("resnet", model._feature_extractor), ("mask", model.att_module),
                      ("depth", model.depth_module)):
        for mod in sub.modules():
            if isinstance(mod, (torch.nn.Conv2d, Refine)):
                mod.register_forward_hook(hook(name))
    with torch.no_grad():
        feats = model.features(torch.rand(1, 3, h, w) - 0.5)
        model.att_module(torch.rand(1, f, d, h, w), feats)
        model.depth_module(torch.rand(1, d, h, w), torch.rand(1, 3, h, w), feats)
    got = flops.module_flops(dict(height=h, width=w, depth_steps=d, frames=f))
    assert {k: got[k] for k in total} == total
