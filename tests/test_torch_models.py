"""Port network modules (monorec_tpu_torch.models) against the flax modules of
the JAX package on the same numpy inputs, float32 on the CPU.

Layers: the port layer is initialised from a seed and its weights carried to
flax with the JAX package's own layout rules (utils/torch_compat.py).
Networks: flax is initialised and its variables carried to the port with
``state_dict_from_flax``. Tolerances are those of tests/test_convert.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorec_tpu.models import layers as jl
from monorec_tpu.models.depth_module import DepthModule as JDepth
from monorec_tpu.models.mask_module import MaskModule as JMask
from monorec_tpu.models.resnet import ResNetEncoder as JResNet
from monorec_tpu.utils.torch_compat import conv_kernel_from_torch, conv_transpose_kernel_from_torch
from monorec_tpu_torch.convert import state_dict_from_flax
from monorec_tpu_torch.models import layers as tl
from monorec_tpu_torch.models.depth_module import DepthModule
from monorec_tpu_torch.models.mask_module import MaskModule
from monorec_tpu_torch.models.monorec import init_weights
from monorec_tpu_torch.models.resnet import ResNetEncoder

H, W, D, F = 32, 64, 8, 2
FEAT_SHAPES = [(64, H // 2, W // 2), (64, H // 4, W // 4), (128, H // 8, W // 8),
               (256, H // 16, W // 16), (512, H // 32, W // 32)]


def _nchw(x):
    return torch.from_numpy(np.moveaxis(np.asarray(x), -1, 1).copy())


def _nhwc(t):
    return jnp.asarray(np.moveaxis(t.detach().numpy(), 1, -1))


def _close(port, ref, rtol, atol):
    np.testing.assert_allclose(port.detach().numpy(), np.moveaxis(np.asarray(ref), -1, 1),
                               rtol=rtol, atol=atol)


def _seeded(module):
    init_weights(module, torch.Generator().manual_seed(0))
    return module.eval()


def _conv(m):
    return {"kernel": jnp.asarray(conv_kernel_from_torch(m.weight.detach().numpy())),
            "bias": jnp.asarray(m.bias.detach().numpy())}


@pytest.mark.parametrize("kernel,stride,h,w", [(7, 2, 33, 47), (5, 2, 32, 48), (3, 1, 10, 10), (2, 1, 8, 8)])
def test_pad_same_matches_jax(kernel, stride, h, w):
    x = np.random.default_rng(0).standard_normal((1, h, w, 2)).astype(np.float32)
    _close(tl.pad_same(_nchw(x), kernel, stride), jl.pad_same(jnp.asarray(x), kernel, stride),
           0, 0)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (7, 2), ((5, 1), (2, 1)), (2, 1)])
def test_same_pad_conv_matches_flax(kernel, stride):
    x = np.random.default_rng(1).standard_normal((2, 17, 23, 4)).astype(np.float32)
    port = _seeded(tl.SamePadConv(4, 6, kernel, stride))
    ref = jl.SamePadConv(6, kernel, stride).apply({"params": {"Conv_0": _conv(port)}},
                                                 jnp.asarray(x))
    _close(port(_nchw(x)), ref, 1e-5, 1e-5)


def test_separable_conv_lrelu_matches_flax():
    x = np.random.default_rng(2).standard_normal((1, 16, 20, 5)).astype(np.float32)
    port = _seeded(tl.SeparableConvLReLU(5, 7, 5, 2))
    params = {"SamePadConv_0": {"Conv_0": _conv(port.conv_y)},
              "SamePadConv_1": {"Conv_0": _conv(port.conv_x)}}
    ref = jl.SeparableConvLReLU(7, 5, 2).apply({"params": params}, jnp.asarray(x))
    _close(port(_nchw(x)), ref, 1e-5, 1e-5)


def test_upconv_matches_flax():
    x = np.random.default_rng(3).standard_normal((1, 5, 7, 4)).astype(np.float32)
    port = _seeded(tl.Upconv(4, 3))
    ref = jl.Upconv(3).apply({"params": {"SamePadConv_0": {"Conv_0": _conv(port.conv)}}},
                             jnp.asarray(x))
    _close(port(_nchw(x)), ref, 1e-5, 1e-5)


def test_refine_matches_flax():
    x = np.random.default_rng(4).standard_normal((1, 5, 7, 4)).astype(np.float32)
    port = _seeded(tl.Refine(4, 3))
    t = port.conv2d_t
    params = {"ConvTranspose_0": {
        "kernel": jnp.asarray(conv_transpose_kernel_from_torch(t.weight.detach().numpy())),
        "bias": jnp.asarray(t.bias.detach().numpy())}}
    ref = jl.Refine(3).apply({"params": params}, jnp.asarray(x))
    assert port(_nchw(x)).shape == (1, 3, 10, 14)
    _close(port(_nchw(x)), ref, 1e-5, 1e-5)


def _flax_vars(module, *args, seed=0):
    v = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v.get("batch_stats", {}))
    # Non-trivial running statistics, so their conversion is exercised.
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.min() > 0.5
                   else rng.normal(0, 0.05, a.shape)).astype(np.float32), stats)
    return params, stats


def _load(port, top, params, stats, prefix):
    sd = state_dict_from_flax({top: params}, {top: stats} if stats else {})
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return port.eval()


def _features(seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (1, h, w, c)).astype(np.float32) for c, h, w in FEAT_SHAPES]


def test_resnet18_matches_flax():
    x = np.random.default_rng(5).uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    module = JResNet(18)
    params, stats = _flax_vars(module, jnp.asarray(x))
    port = _load(ResNetEncoder(18), "encoder", params, stats, "_feature_extractor.")
    ref = jax.jit(module.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        out = port(_nchw(x))
    for i, (p, r) in enumerate(zip(out, ref)):
        assert p.shape[1:] == FEAT_SHAPES[i]
        _close(p, r, 1e-3, 2e-3)


def test_mask_module_matches_flax():
    rng = np.random.default_rng(6)
    sfcv = rng.uniform(-1, 1, (1, F, H, W, D)).astype(np.float32)
    feats = _features(7)
    module = JMask(D)
    args = (jnp.asarray(sfcv), [jnp.asarray(f) for f in feats])
    params, _ = _flax_vars(module, *args)
    port = _load(MaskModule(D), "att", params, None, "att_module.")
    ref = jax.jit(module.apply)({"params": params}, *args)
    with torch.no_grad():
        out = port(torch.from_numpy(np.moveaxis(sfcv, -1, 2).copy()), [_nchw(f) for f in feats])
    assert out.shape == (1, 1, H, W)
    _close(out, ref, 1e-3, 2e-3)


@pytest.mark.parametrize("large_model", [False, True])
def test_depth_module_matches_flax(large_model):
    rng = np.random.default_rng(8)
    cv = rng.uniform(-1, 1, (1, H, W, D)).astype(np.float32)
    key = rng.uniform(-0.5, 0.5, (1, H, W, 3)).astype(np.float32)
    feats = _features(9)
    module = JDepth(D, large_model)
    args = (jnp.asarray(cv), jnp.asarray(key), [jnp.asarray(f) for f in feats])
    params, _ = _flax_vars(module, *args)
    port = _load(DepthModule(D, large_model), "depth_net", params, None, "depth_module.")
    ref = jax.jit(module.apply)({"params": params}, *args)
    with torch.no_grad():
        out = port(_nchw(cv), _nchw(key), [_nchw(f) for f in feats])
    lo, hi = 0.0025, 0.33  # the model's affine map, as tests/test_convert.py compares
    for i, (p, r) in enumerate(zip(out, ref)):
        assert p.shape == (1, 1, H >> i, W >> i)
        _close((1 - p) * lo + p * hi, (1 - r) * lo + r * hi, 1e-3, 2e-4)
