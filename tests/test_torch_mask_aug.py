"""The port's mask augmentation (``monorec_tpu_torch/models/augmentation.py``)
against the JAX package's (``monorec_tpu/models/augmentation.py``) on the
CPU, where the JAX side runs its XLA path: the same ``MaskAugParams``, given
as numpy, flip and crop the same numpy tensors at B=2, 32x64, for C = 1, 3
and D = 8 and for (B, F, C, H, W) frame stacks.

Tolerances: values atol 1e-5 (both are float32 bilinear samples of the same
grid; the port samples through K2's plain version on the CPU). The crop of
a binary mask thresholded at 0.5 must be equal except at pixels whose JAX
value lies within 1e-5 of 0.5. The sampler's draws: inside their ranges,
and the same from the same seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorec_tpu.models import augmentation as j_aug
from monorec_tpu_torch.models import augmentation as t_aug

B, H, W, F = 2, 32, 64, 2


def _params(seed: int, b: int = B, full_first: bool = False):
    """Crop rectangles drawn as the sampler draws them, with both flips; the
    first sample may take the whole image."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.8, 1.0, b).astype(np.float32)
    ratio = rng.uniform(1.9, 2.1, b).astype(np.float32)
    area = scale * H * W
    crop_w = np.clip(np.sqrt(area * ratio), 1.0, W).astype(np.float32)
    crop_h = np.clip(np.sqrt(area / ratio), 1.0, H).astype(np.float32)
    u = rng.uniform(0, 1, (b, 2)).astype(np.float32)
    y0, x0 = u[:, 0] * (H - crop_h), u[:, 1] * (W - crop_w)
    flip = np.arange(b) % 2 == 0
    if full_first:
        y0[0], x0[0], crop_h[0], crop_w[0] = 0.0, 0.0, H, W
    return flip, y0.astype(np.float32), x0.astype(np.float32), crop_h, crop_w


def _both(params):
    return (j_aug.MaskAugParams(*(jnp.asarray(p) for p in params)),
            t_aug.MaskAugParams(*(torch.from_numpy(np.asarray(p)) for p in params)))


@pytest.mark.parametrize("c", [1, 3, 8])
@pytest.mark.parametrize("seed,full_first", [(0, False), (1, True)])
def test_apply_mask_aug_matches_jax(c, seed, full_first):
    x = np.random.default_rng(10 + c).uniform(-0.5, 0.5, (B, H, W, c)).astype(np.float32)
    jp, tp = _both(_params(seed, full_first=full_first))
    ref = np.asarray(j_aug.apply_mask_aug(jnp.asarray(x), jp))
    got = t_aug.apply_mask_aug(torch.from_numpy(np.moveaxis(x, -1, 1)), tp)
    assert got.shape == (B, c, H, W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.moveaxis(ref, -1, 1), rtol=0, atol=1e-5)


@pytest.mark.parametrize("c", [3, 8])
def test_apply_mask_aug_frames_matches_jax(c):
    x = np.random.default_rng(20 + c).uniform(-0.5, 0.5, (B, F, H, W, c)).astype(np.float32)
    jp, tp = _both(_params(2))
    ref = np.asarray(j_aug.apply_mask_aug_frames(jnp.asarray(x), jp))
    xt = torch.from_numpy(np.moveaxis(x, -1, 2))
    got = t_aug.apply_mask_aug_frames(xt, tp)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(ref, -1, 2), rtol=0, atol=1e-5)
    # The fold repeats each sample's parameters for its F frames.
    for i in range(F):
        np.testing.assert_array_equal(got[:, i].numpy(), t_aug.apply_mask_aug(xt[:, i], tp).numpy())


def test_thresholded_mask_crop_matches_jax():
    rng = np.random.default_rng(3)
    mask = (rng.uniform(0, 1, (B, H, W, 1)) > 0.7).astype(np.float32)
    mask[:, H // 4 : H // 2, W // 4 : W // 2] = 1.0
    for seed in range(4):
        jp, tp = _both(_params(seed))
        ref = np.moveaxis(np.asarray(j_aug.apply_mask_aug(jnp.asarray(mask), jp)), -1, 1)
        got = t_aug.apply_mask_aug(torch.from_numpy(np.moveaxis(mask, -1, 1)), tp).numpy()
        near = np.abs(ref - 0.5) <= 1e-5
        assert ((got > 0.5) == (ref > 0.5))[~near].all()
        assert 0 < (ref > 0.5).sum() < ref.size


def test_sampled_params_are_in_range_and_repeat():
    draw = lambda seed: t_aug.sample_mask_aug_params(  # noqa: E731
        torch.Generator().manual_seed(seed), 256, H, W)
    p = draw(5)
    assert p.flip.dtype == torch.bool and 0.3 < p.flip.float().mean() < 0.7
    area = p.crop_h * p.crop_w / (H * W)
    assert (area >= 0.8 - 1e-5).all() and (area <= 1.0 + 1e-5).all()
    ratio = p.crop_w / p.crop_h
    assert (ratio > 1.9 - 1e-4).all() and (ratio < 2.1 + 1e-4).all()
    assert (p.y0 >= 0).all() and (p.y0 + p.crop_h <= H + 1e-4).all()
    assert (p.x0 >= 0).all() and (p.x0 + p.crop_w <= W + 1e-4).all()
    for a, b in zip(p, draw(5)):
        assert torch.equal(a, b)
    assert not torch.equal(p.x0, draw(6).x0)


def test_apply_mask_aug_refuses_a_tensor_that_requires_a_gradient():
    """K2 gives the sampled tensor no gradient: cropping a tensor that needs
    one would silently zero it."""
    _, tp = _both(_params(0))
    x = torch.zeros(B, 3, H, W, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        t_aug.apply_mask_aug(x, tp)
    with torch.no_grad():
        assert t_aug.apply_mask_aug(x, tp).shape == x.shape
