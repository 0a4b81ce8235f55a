"""The port's colour jitter (``monorec_tpu_torch/models/augmentation.py``)
against the JAX package's (``monorec_tpu/models/augmentation.py``:
``apply_color_jitter_batch``, ``jitter_image_keys``) on the same numpy
images and the same injected parameters, on the CPU.

The cases: each of four samples takes its own order of the four operations;
gray pixels (r = g = b, a hue delta of 0), black pixels (v = 0), hue shifts
that wrap below 0 and above 1 (JAX's ``%`` is a floor modulo); (B, H, W, 3)
and (B, F, H, W, 3) images; one parameter set shared by the frames of a
sample and by every image key.

Tolerance: atol 2e-6, rtol 0. Both sides compute the same float32 formulas;
only the luma (a dot product in JAX) and the per-image mean of the contrast
sum in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monorec_tpu.models.augmentation as j_aug
import monorec_tpu_torch.models.augmentation as t_aug

B, H, W, F = 4, 12, 16, 2
ATOL = 2e-6
ORDERS = np.array([[0, 1, 2, 3], [3, 2, 1, 0], [1, 3, 0, 2], [2, 0, 3, 1]])


def _params(seed=0, hue=(0.08, -0.09, 0.1, -0.1)):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, B).astype(np.float32)  # noqa: E731
    return [u(0.8, 1.2), u(0.8, 1.2), u(0.8, 1.2), np.asarray(hue, np.float32), ORDERS]


def _images(shape, seed=1):
    """Images in [-0.5, 0.5] with gray and black pixels, and near-red pixels
    whose hue sits just above 0 and just below 1."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    x[..., 0, :4, :] = x[..., 0, :4, :1]  # gray: r = g = b
    x[..., 1, :4, :] = -0.5  # black
    x[..., 2, :2, :] = np.array([0.5, -0.48, -0.5], np.float32)  # hue just above 0
    x[..., 2, 2:4, :] = np.array([0.5, -0.5, -0.48], np.float32)  # hue just below 1
    return x


def _jax(params):
    return j_aug.ColorJitterBatch(*(jnp.asarray(p) for p in params))


def _port(params):
    return t_aug.ColorJitterBatch(*(torch.from_numpy(np.asarray(p)) for p in params))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


@pytest.mark.parametrize("frames", [0, F])
def test_color_jitter_matches_jax(frames):
    shape = (B, frames, H, W, 3) if frames else (B, H, W, 3)
    x, params = _images(shape), _params()
    want = np.asarray(j_aug.apply_color_jitter_batch(jnp.asarray(x), _jax(params)))
    got = t_aug.apply_color_jitter_batch(_nchw(x), _port(params))
    assert got.shape == _nchw(x).shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, -3), rtol=0, atol=ATOL)
    # The jitter moved every sample, and kept the images in [-0.5, 0.5].
    assert all((got[i] != _nchw(x)[i]).any() for i in range(B))
    assert got.min() >= -0.5 and got.max() <= 0.5


def test_each_sample_keeps_its_own_order():
    """The same parameters under another order give another image: the order
    is per sample, not one for the batch."""
    x, params = _images((B, H, W, 3), seed=2), _params(seed=3)
    base = t_aug.apply_color_jitter_batch(_nchw(x), _port(params))
    for i in range(B):
        swapped = list(params)
        swapped[4] = ORDERS.copy()
        swapped[4][i] = ORDERS[(i + 1) % B]
        out = t_aug.apply_color_jitter_batch(_nchw(x), _port(swapped))
        want = np.asarray(j_aug.apply_color_jitter_batch(jnp.asarray(x), _jax(swapped)))
        np.testing.assert_allclose(out.numpy(), np.moveaxis(want, -1, -3), rtol=0, atol=ATOL)
        others = [j for j in range(B) if j != i]
        assert torch.equal(out[others], base[others])
        assert (out[i] - base[i]).abs().max() > 1e-4


def test_hue_wraps_with_a_floor_modulo():
    """Only the hue, shifted by -0.1 on a hue just above 0 and by +0.1 on one
    just below 1: both wrap, as JAX's ``%`` does (``fmod`` would not)."""
    x = _images((B, H, W, 3), seed=4)
    params = _params(seed=5, hue=(-0.1, 0.1, -0.1, 0.1))
    params[0] = params[1] = params[2] = np.ones(B, np.float32)
    want = np.asarray(j_aug.apply_color_jitter_batch(jnp.asarray(x), _jax(params)))
    got = t_aug.apply_color_jitter_batch(_nchw(x), _port(params)).numpy()
    np.testing.assert_allclose(got, np.moveaxis(want, -1, -3), rtol=0, atol=ATOL)
    # A red hue shifted by -0.1 turns towards magenta: blue rises above green.
    px = got[0, :, 2, 0] + 0.5
    assert px[2] > px[1] + 0.1


def test_jitter_image_keys_shares_one_draw_across_frames_and_keys(monkeypatch):
    params = _params(seed=6)
    monkeypatch.setattr(j_aug, "sample_color_jitter_batch", lambda rng, b: _jax(params))
    monkeypatch.setattr(t_aug, "sample_color_jitter_batch", lambda gen, b: _port(params))
    batch = {"keyframe": _images((B, H, W, 3), 7), "frames": _images((B, F, H, W, 3), 8),
             "stereoframe": _images((B, H, W, 3), 9), "poses": np.eye(4, dtype=np.float32)}
    want = j_aug.jitter_image_keys({k: jnp.asarray(v) for k, v in batch.items()}, None)
    t_batch = {k: (_nchw(v) if v.ndim >= 4 else torch.from_numpy(v)) for k, v in batch.items()}
    got = t_aug.jitter_image_keys(t_batch, torch.Generator())
    assert set(got) == set(want)
    assert got["poses"] is t_batch["poses"]
    for key in ("keyframe", "frames", "stereoframe"):
        np.testing.assert_allclose(got[key].numpy(), np.moveaxis(np.asarray(want[key]), -1, -3),
                                   rtol=0, atol=ATOL, err_msg=key)
    # Frame f of a sample is that frame jittered alone with the sample's draw.
    for f in range(F):
        alone = t_aug.apply_color_jitter_batch(t_batch["frames"][:, f], _port(params))
        assert torch.equal(got["frames"][:, f], alone)


def test_sample_color_jitter_batch_ranges_and_repeats():
    p = t_aug.sample_color_jitter_batch(torch.Generator().manual_seed(0), 64)
    for factor in p[:3]:
        assert factor.shape == (64,) and 0.8 <= factor.min() and factor.max() <= 1.2
    assert -0.1 <= p.hue.min() and p.hue.max() <= 0.1
    assert all(sorted(row.tolist()) == [0, 1, 2, 3] for row in p.order)
    assert len({tuple(row.tolist()) for row in p.order}) > 4
    q = t_aug.sample_color_jitter_batch(torch.Generator().manual_seed(0), 64)
    assert all(torch.equal(a, b) for a, b in zip(p, q))
