"""The U-Nets' convolutions without their glue, on the CPU: implicit same
padding against an explicit pad, the same pads' counts of a Mask + Depth
forward (on meta tensors), and the bias + LeakyReLU epilogue's plain path
against the ATen operations it replaces. The kernel itself is held on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 32."""

import pytest
import torch
import torch.nn.functional as F

from monorec_tpu_torch.models import layers
from monorec_tpu_torch.models.depth_module import DepthModule
from monorec_tpu_torch.models.mask_module import MaskModule
from monorec_tpu_torch.ops import bias_act as ba

KERNELS = [1, 2, 3, 5, 7, (3, 1), (1, 3), (7, 1), (1, 7)]


def _explicit(conv, x, slope):
    """The same conv as an explicit pad, a VALID conv with its bias and a
    LeakyReLU, as the layers computed it before."""
    y = F.conv2d(layers.pad_same(x, conv.kernel_size, conv.stride), conv.weight, conv.bias,
                 conv.stride)
    return y if slope == 1.0 else F.leaky_relu(y, slope)


@pytest.mark.parametrize("size", [(16, 20), (15, 21)], ids=["even", "odd"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", KERNELS, ids=str)
def test_implicit_same_pad_conv_matches_explicit_pad(kernel, stride, size):
    torch.manual_seed(0)
    conv = layers.SamePadConv(3, 4, kernel, stride, layers.LEAKY_SLOPE).double()
    x = torch.randn(2, 3, *size, dtype=torch.float64, requires_grad=True)
    got, want = conv(x), _explicit(conv, x, layers.LEAKY_SLOPE)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    cot = torch.randn_like(want)
    params = (x, conv.weight, conv.bias)
    for g, w in zip(torch.autograd.grad(got, params, cot), torch.autograd.grad(want, params, cot)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("layer", ["k3", "upconv_k2", "k7x1_s2", "refine"])
def test_cpu_layers_keep_a_plain_layers_numbers(layer):
    # Off the card the convolution keeps its bias (the CPU fuses it): the
    # float32 numbers the JAX parity tests were set against, bit for bit.
    torch.manual_seed(0)
    x = torch.randn(2, 16, 24, 40)
    if layer == "refine":
        m = layers.Refine(16, 8)
        t = m.conv2d_t
        want = F.leaky_relu(F.conv_transpose2d(x, t.weight, t.bias, t.stride), 0.1)[:, :, 1:-1,
                                                                                   1:-1]
    else:
        kernel, stride, slope = {"k3": (3, 1, 0.1), "upconv_k2": (2, 1, 1.0),
                                 "k7x1_s2": ((7, 1), (2, 1), 0.1)}[layer]
        m = layers.SamePadConv(16, 8, kernel, stride, slope)
        want = _explicit(m, x, slope)
    with torch.no_grad():
        got = m(x)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("h,w,b,f", [(256, 512, 8, 2), (480, 640, 1, 4)])
def test_pad_counts_of_one_mask_and_depth_forward(h, w, b, f, monkeypatch):
    calls = []
    plain = layers.conv_bias_act
    monkeypatch.setattr(layers, "conv_bias_act", lambda *a, **k: calls.append(1) or plain(*a, **k))
    with torch.device("meta"):
        mask, depth = MaskModule(32), DepthModule(32)
        feats = [torch.empty(b, c, h // s, w // s) for c, s in zip((64, 64, 128, 256),
                                                                   (2, 4, 8, 16))]
        layers.pad_counts.clear()
        with torch.inference_mode():
            mask(torch.empty(b, f, 32, h, w), feats)
            preds = depth(torch.empty(b, 32, h, w), torch.empty(b, 3, h, w), feats)
    assert dict(layers.pad_counts) == {"implicit": 46, "explicit": 8}
    assert len(calls) == 58
    assert [tuple(p.shape) for p in preds] == [(b, 1, h // s, w // s) for s in (1, 2, 4, 8)]


WINDOWS = [None, (1, 1, 6, 9)]  # whole planes; a 1-pixel crop of (8, 11) planes


def _operands(dtype, window, seed=0):
    """y, bias and a cotangent; an eighth of the kept pre-activations exactly 0."""
    g = torch.Generator().manual_seed(seed)
    shape = (2, 3, 8, 11) if window else (2, 3, 6, 9)
    y = torch.randn(shape, generator=g).to(dtype)
    bias = torch.randn(3, generator=g).to(dtype)
    kept = ba._view(y, window)
    zero = torch.rand(kept.shape, generator=g) < 1 / 8
    kept.copy_(torch.where(zero, -bias.view(1, -1, 1, 1).expand_as(kept), kept))
    return y, bias, torch.randn((2, 3, 6, 9), generator=g).to(dtype)


def _atens(y, bias, slope, window):
    """The ATen operations the epilogue replaces: ``add_`` of the bias to
    the convolution's output, ``leaky_relu``, the crop."""
    v = y.clone()
    v.add_(bias.view(1, -1, 1, 1))
    v = v if slope == 1.0 else F.leaky_relu(v, slope)
    return ba._view(v, window)


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("window", WINDOWS, ids=["whole", "window"])
@pytest.mark.parametrize("slope", [0.1, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_bias_act_plain_forward_is_bit_equal_to_add_and_leaky_relu(dtype, slope, window):
    y, bias, _ = _operands(dtype, window)
    out = ba.bias_act(y, bias, slope, window)
    want = _atens(y, bias, slope, window)
    assert out.is_contiguous() and out.shape == want.shape
    assert torch.equal(_bits(out), _bits(want))


@pytest.mark.parametrize("window", WINDOWS, ids=["whole", "window"])
@pytest.mark.parametrize("slope", [0.1, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_bias_act_backward_matches_autograd_of_the_plain_ops(dtype, slope, window):
    y, bias, cot = _operands(dtype, window)
    assert (ba._view(y, window) + bias.view(1, -1, 1, 1) == 0).any()
    yk, bk = y.clone().requires_grad_(), bias.clone().requires_grad_()
    yr, br = y.clone().requires_grad_(), bias.clone().requires_grad_()
    out = ba.bias_act(yk, bk, slope, window)
    assert type(out.grad_fn).__name__ == "_BiasActBackward"
    gy, gb = torch.autograd.grad(out, (yk, bk), cot)
    ry, rb = torch.autograd.grad(_atens(yr, br, slope, window), (yr, br), cot)
    # At a pre-activation of exactly 0 both take the slope.
    assert torch.equal(_bits(gy), _bits(ry))
    assert gb.dtype == rb.dtype == dtype
    torch.testing.assert_close(gb, rb, rtol=1e-6 if dtype == torch.float32 else 2**-7,
                               atol=1e-6)


@pytest.mark.parametrize("window,kept", [
    (None, None),
    ((0, 0, 6, 9), None),  # the whole plane: the kernel's whole-plane paths
    ((1, 1, 5, 8), (1, 1, 5, 8)),
    ((0, 0, 5, 9), (0, 0, 5, 9)),
])
def test_a_window_of_the_whole_plane_is_no_window(window, kept):
    assert ba._kept((2, 3, 6, 9), window) == kept


def test_depth_module_ends_in_one_activated_conv():
    # dec[4]'s last conv carries the LeakyReLU; its parameters keep their keys.
    m = DepthModule(8)
    last = m.dec[4]
    assert isinstance(last[2], layers.SamePadConv) and last[2].slope == layers.LEAKY_SLOPE
    assert len(last) == 3
    assert {"dec.4.2.weight", "dec.4.2.bias"} <= set(m.state_dict())
