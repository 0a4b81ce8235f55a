"""The U-Nets' stride-1 convolution kernel's Python side, on the CPU: the
routing rule's decision for every stride-1 layer of the benchmarked
configurations, the plain version against ``F.conv2d`` + bias +
``leaky_relu`` under asymmetric same pads, the autograd Function's
gradients against the layer's own, the tile plan, and the layers' counts
with the kernel's route rehearsed by the plain version. The kernel itself
is held on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
phase 33."""

import types

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from monorec_tpu_torch.models import layers
from monorec_tpu_torch.models.depth_module import DepthModule
from monorec_tpu_torch.models.mask_module import MaskModule, SimpleMaskModule
from monorec_tpu_torch.models.resnet import encoder_channels
from monorec_tpu_torch.ops import same_conv as sc

# (C_in, C_out, kh, kw) of every stride-1 SamePadConv of the three
# benchmarked configurations, and whether the kernel takes it (PERF.md's
# per-shape table on the H100).
DECISIONS = {
    (24, 1, 3, 3): True, (32, 24, 3, 3): True, (32, 32, 1, 3): True, (32, 32, 3, 3): True,
    (32, 48, 3, 3): True, (35, 48, 7, 1): True, (36, 36, 3, 3): True, (36, 48, 3, 3): True,
    (48, 1, 1, 1): False, (48, 48, 1, 3): True, (48, 48, 1, 7): True, (48, 48, 3, 1): True,
    (48, 48, 3, 3): True, (48, 64, 3, 3): True, (64, 1, 3, 3): True, (64, 64, 1, 3): False,
    (64, 64, 2, 2): True, (64, 64, 3, 1): False, (64, 64, 3, 3): False, (64, 96, 3, 3): False,
    (96, 32, 3, 1): True, (96, 48, 3, 3): True, (96, 96, 2, 2): True, (96, 96, 3, 3): False,
    (100, 48, 3, 3): True, (128, 1, 3, 3): True, (128, 128, 1, 3): False,
    (128, 128, 3, 1): False, (192, 192, 1, 3): False, (192, 192, 3, 1): False,
    (208, 64, 3, 3): False, (224, 96, 3, 3): False, (256, 1, 3, 3): False,
    (256, 256, 1, 3): False, (256, 256, 3, 1): False, (320, 96, 3, 3): False,
    (352, 96, 2, 2): False, (416, 96, 3, 3): False, (704, 96, 3, 3): False,
    (1120, 96, 2, 2): False,
}
# Stride-1 calls of one forward the kernel takes, of all stride-1 calls.
ROUTED = {"monorec-kitti": (20, 46), "monorec-r50-simple": (30, 69), "monorec-tmvo": (20, 46)}
KERNELS = [(2, 2), (3, 3), (7, 1), (1, 7), (5, 1), (1, 5), (3, 1), (1, 3)]


@pytest.mark.parametrize("key", sorted(DECISIONS), ids=str)
def test_routing_rule_decides_each_stride1_layer(key):
    c_in, c_out, kh, kw = key
    assert sc.admits(torch.float32, (1, 1), (kh, kw), c_in, c_out) == DECISIONS[key]
    # The serving policy's bf16 and any stride 2 stay on cuDNN.
    assert not sc.admits(torch.bfloat16, (1, 1), (kh, kw), c_in, c_out)
    assert not sc.admits(torch.float32, (2, 1), (kh, kw), c_in, c_out)


@pytest.mark.parametrize("config", sorted(ROUTED))
def test_every_stride1_layer_of_the_configurations_is_decided(config):
    _, *args = next(c for c in chip_smoke.SAME_CONV_CONFIGS if c[0] == config)
    calls = chip_smoke.unet_conv_shapes(*args)
    keys = {(k[1], k[4], k[5], k[6]): c for k, c in calls.items()}
    assert set(keys) <= set(DECISIONS)
    routed = sum(c for k, c in calls.items() if DECISIONS[(k[1], k[4], k[5], k[6])])
    assert (routed, sum(calls.values())) == ROUTED[config]


def test_takes_counts_the_stride1_float32_calls_it_leaves_to_cudnn():
    card = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    before = sc.same_conv.routed_library
    assert sc.takes(card, layers.SamePadConv(32, 48, 3))
    assert not sc.takes(card, layers.SamePadConv(64, 64, 3))
    assert not sc.takes(card, layers.SamePadConv(48, 1, 1))
    assert not sc.takes(card, layers.SamePadConv(32, 48, (7, 1), (2, 1)))  # stride 2: not counted
    assert not sc.takes(types.SimpleNamespace(is_cuda=True, dtype=torch.bfloat16),
                        layers.SamePadConv(32, 48, 3))  # bf16: not counted
    assert not sc.takes(torch.empty(1, 32, 4, 4), layers.SamePadConv(32, 48, 3))  # the CPU
    assert sc.same_conv.routed_library == before + 2


@pytest.mark.parametrize("size", [(9, 11), (8, 12)], ids=["odd", "even"])
@pytest.mark.parametrize("slope", [0.1, 1.0])
@pytest.mark.parametrize("kernel", KERNELS, ids=str)
def test_plain_version_matches_conv2d_bias_and_leaky_relu(kernel, slope, size):
    g = torch.Generator().manual_seed(0)
    kh, kw = kernel
    x = torch.randn(2, 5, *size, generator=g, dtype=torch.float64)
    w = torch.randn(16, 5, kh, kw, generator=g, dtype=torch.float64)
    b = torch.randn(16, generator=g, dtype=torch.float64)
    top, left = sc.same_pads(kh, kw)
    got = sc.same_conv_fwd(x, w, b, slope, (top, left))
    # TF-"same": floor half of k - 1 before, the rest (one more for even k) after.
    y = F.conv2d(F.pad(x, (left, kw - 1 - left, top, kh - 1 - top)), w, b)
    want = y if slope == 1.0 else F.leaky_relu(y, slope)
    assert got.shape == want.shape == (2, 16, *size)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("slope", [0.1, 1.0])
@pytest.mark.parametrize("kernel", KERNELS, ids=str)
def test_function_gradients_match_the_layers(kernel, slope):
    torch.manual_seed(0)
    conv = layers.SamePadConv(5, 16, kernel, 1, slope).double()
    x = torch.randn(2, 5, 9, 11, dtype=torch.float64, requires_grad=True)
    params = (x, conv.weight, conv.bias)
    got = sc._SameConv.apply(x, conv.weight, conv.bias, slope, sc.same_pads(*kernel))
    want = conv(x)  # the CPU layer: the convolution with its bias, then leaky_relu
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    cot = torch.randn_like(want)
    for a, b in zip(torch.autograd.grad(got, params, cot), torch.autograd.grad(want, params, cot)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)


def test_function_leaves_out_gradients_nobody_asks_for():
    torch.manual_seed(0)
    conv = layers.SamePadConv(4, 8, 2).double()
    x = torch.randn(1, 4, 6, 7, dtype=torch.float64)
    out = sc.same_conv(x, conv.weight, conv.bias, 1.0, (0, 0))
    assert type(out.grad_fn).__name__ == "_SameConvBackward"
    gw, gb = torch.autograd.grad(out.sum(), (conv.weight, conv.bias))
    assert gw.shape == conv.weight.shape and torch.allclose(gb, torch.full_like(gb, 42.0))
    with torch.no_grad():
        assert sc.same_conv(x, conv.weight, conv.bias, 1.0, (0, 0)).grad_fn is None


@pytest.mark.parametrize("shape,kernel,config", [
    ((16, 256, 512, 32), (3, 3), 2),  # 32 channels: a whole block of 32, or four of 8
    ((8, 256, 512, 48), (3, 3), 1),  # 48: two blocks of 24
    ((8, 256, 512, 24), (3, 3), 1),
    ((8, 256, 512, 36), (3, 3), 2),  # 36: five blocks of 8 idle least
    ((8, 256, 512, 48), (1, 7), 1),
    ((8, 256, 512, 64), (2, 2), 0),  # a short strip costs most where taps are few
    ((1, 480, 640, 32), (1, 3), 0),
])
def test_plan_fills_the_channel_blocks(shape, kernel, config):
    n, h, w, c_out = shape
    assert sc.plan(n, h, w, c_out, kernel, 132, (2, 2, 3)) == config


@pytest.mark.parametrize("kernel,config,count", [
    ((3, 3), 0, 8 * 2 * 16 * 16),  # 48 channels in 2 blocks, 512 / 32 x 256 / 16 tiles
    ((3, 3), 1, 8 * 2 * 16 * 16),
    ((3, 3), 2, 8 * 6 * 16 * 16),
    ((1, 7), 1, 8 * 2 * 8 * 32),  # the strip along x: 256 / 32 x 512 / 16
])
def test_tiles_follow_the_strip(kernel, config, count):
    assert sc.tiles(8, 256, 512, 48, kernel, config) == count


@pytest.mark.parametrize("resnet_layers,simple", [(18, False), (50, True)],
                         ids=["r18", "r50simple"])
def test_layers_route_the_kernel_s_layers_and_count_their_pads(resnet_layers, simple,
                                                                monkeypatch):
    # The card's route rehearsed on the CPU: the rule decides as on a CUDA
    # float32 input and the plain version stands in for the kernel.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _rehearse_the_route(resnet_layers, simple, monkeypatch)
    finally:
        torch.set_num_threads(threads)


def _rehearse_the_route(resnet_layers, simple, monkeypatch):
    calls = {"same_conv": 0, "conv_bias_act": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    def forward(b=1, f=2, d=32, h=32, w=64):
        g = torch.Generator().manual_seed(1)
        feat = encoder_channels(resnet_layers)
        torch.manual_seed(0)
        depth = DepthModule(d, False, feat)
        mask = SimpleMaskModule(d, feat) if simple else MaskModule(d, feature_channels=feat)
        feats = [torch.randn(b, c, h // s, w // s, generator=g)
                 for c, s in zip(feat, (2, 4, 8, 16, 32))]
        cv, key = torch.rand(b, d, h, w, generator=g), torch.rand(b, 3, h, w, generator=g)
        sfcv = torch.rand(b, f, d, h, w, generator=g)
        layers.pad_counts.clear()
        with torch.no_grad():
            m = (mask(sfcv, key, depth(cv, key, feats)[0], feats) if simple
                 else mask(sfcv, feats))
            return m, depth(cv, key, feats), dict(layers.pad_counts)

    plain_mask, plain_depth, plain_pads = forward()
    monkeypatch.setattr(layers, "takes", lambda x, conv: sc.admits(
        x.dtype, conv.stride, conv.kernel_size, conv.in_channels, conv.out_channels))
    monkeypatch.setattr(layers, "same_conv", counted("same_conv", layers.same_conv))
    monkeypatch.setattr(layers, "conv_bias_act", counted("conv_bias_act", layers.conv_bias_act))
    mask, depth, pads = forward()
    routed, stride1 = ROUTED["monorec-r50-simple" if simple else "monorec-kitti"]
    unet_layers = 93 if simple else 58  # every SamePadConv and Refine, once a decode
    assert calls == {"same_conv": routed, "conv_bias_act": unet_layers - routed}
    # The kernel's pad counts as implicit: the counts do not move.
    assert pads == plain_pads == {"implicit": stride1, "explicit": 16 if simple else 8}
    torch.testing.assert_close(mask, plain_mask, rtol=1e-4, atol=1e-5)
    for a, b in zip(depth, plain_depth):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
