"""The port's ``ops/residual_image.py`` and ``losses/perceptual.py`` against
the JAX package's on the same seeded numpy inputs, on the CPU.

* ``residual_image``: mono frames, and mono with the stereo frame, at B=2,
  24x32 (``tests/test_torch_losses.py``'s geometry, so border pixels warp
  out of view and some are seen by no frame); the zero pixels must agree
  exactly.
* ``PerceptualError``: a torchvision-keyed VGG16 prefix with random weights
  (the real ones are not in the repository), converted by each package's
  ``convert_torchvision_vgg16``, with and without a mask, small and full
  features. The full features' mask is resized by an antialiased bilinear
  filter, as ``jax.image.resize`` does when it downsamples; the masks must
  agree exactly, at the mask's edges too, and a plain bilinear resize must
  not.

Tolerances: the residual image rtol 1e-5 / atol 1e-6 (the same SSIM
formula on warps that differ by float32 rounding); the perceptual error
rtol 1e-4 / atol 1e-5 (``tests/test_perceptual.py``: convolutions that sum
in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorec_tpu.losses.perceptual import PerceptualError as JPerceptualError
from monorec_tpu.losses.perceptual import convert_torchvision_vgg16 as j_convert
from monorec_tpu.ops.residual_image import residual_image as j_residual_image
from monorec_tpu_torch.data.synthetic import batch_to_torch
from monorec_tpu_torch.losses import perceptual
from monorec_tpu_torch.ops.residual_image import residual_image

B, H, W, FR = 2, 24, 32, 2


def _data(seed=0):
    rng = np.random.default_rng(seed)
    k = np.zeros((4, 4), np.float32)
    k[0, 0] = k[1, 1] = 30.0
    k[0, 2], k[1, 2] = W / 2 - 0.5, H / 2 - 0.5
    k[2, 2] = k[3, 3] = 1
    kb = np.tile(k, (B, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (B, FR, 1, 1))
    poses[:, 0, 0, 3] = 0.25
    poses[:, 1, 0, 3] = -0.25
    poses[:, 1, 2, 3] = 0.3
    stereo_pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    stereo_pose[:, 0, 3] = 0.54
    inv = rng.uniform(0.05, 0.3, (B, H, W, 1)).astype(np.float32)
    inv[:, : H // 2, W // 3 :] = 0.9  # a near object: wide disparities, pixels no frame sees
    return {
        "keyframe": rng.uniform(-0.5, 0.5, (B, H, W, 3)).astype(np.float32),
        "keyframe_pose": np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)),
        "keyframe_intrinsics": kb,
        "frames": rng.uniform(-0.5, 0.5, (B, FR, H, W, 3)).astype(np.float32),
        "poses": poses,
        "intrinsics": np.tile(kb[:, None], (1, FR, 1, 1)),
        "stereoframe": rng.uniform(-0.5, 0.5, (B, H, W, 3)).astype(np.float32),
        "stereoframe_pose": stereo_pose,
        "stereoframe_intrinsics": kb,
    }, inv


@pytest.mark.parametrize("use_stereo", [False, True])
def test_residual_image_matches_jax(use_stereo):
    data, inv = _data()
    want = np.asarray(j_residual_image({k: jnp.asarray(v) for k, v in data.items()},
                                       jnp.asarray(inv), use_stereo=use_stereo))[..., 0]
    got = residual_image(batch_to_torch(data, "cpu"),
                         torch.from_numpy(np.moveaxis(inv, -1, 1).copy()), use_stereo=use_stereo)
    assert got.shape == (B, 1, H, W)
    got = got[:, 0].numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert 0 < (want == 0).sum() < want.size  # some pixels no frame sees, not all
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _vgg_prefix(seed=0):
    """A torchvision ``vgg16().features``-keyed state_dict of the four
    convolutions, random (``features.<i>`` keys)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for idx, (cin, cout) in zip((0, 2, 5, 7), ((3, 64), (64, 64), (64, 128), (128, 128))):
        sd[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=gen) * (2 / (9 * cin)) ** 0.5
        sd[f"features.{idx}.bias"] = torch.randn(cout, generator=gen) * 0.05
    return sd


@pytest.mark.parametrize("small", [True, False])
def test_perceptual_error_matches_jax(small, tmp_path):
    sd = _vgg_prefix()
    path = tmp_path / "vgg16.pth"
    torch.save({k.removeprefix("features."): v for k, v in sd.items()}, path)  # .features keys
    model = perceptual.PerceptualError(small_features=small).load_torchvision(path)
    assert model.weights_loaded
    params = j_convert(sd)
    jm = JPerceptualError(small_features=small)
    rng = np.random.default_rng(1)
    img0 = rng.uniform(0, 1, (B, 16, 32, 3)).astype(np.float32)
    img1 = rng.uniform(0, 1, (B, 16, 32, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, 16, 32)) > 0.8
    mask[:, 3:10, 5:14] = True  # a blob with odd edges: fractional resize weights there
    t0, t1 = (torch.from_numpy(np.moveaxis(x, -1, 1).copy()) for x in (img0, img1))
    with torch.no_grad():
        got = model(t0, t1)
        got_m, got_mask = model(t0, t1, torch.from_numpy(mask))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(img0), jnp.asarray(img1)))
    want_m, want_mask = jm.apply({"params": params}, jnp.asarray(img0), jnp.asarray(img1),
                                 jnp.asarray(mask))
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), **tol)
    assert got_mask.dtype == torch.bool and got_mask.shape == got_m.shape
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    if not small:
        plain = torch.nn.functional.interpolate(torch.from_numpy(mask)[:, None].float(),
                                                size=got_m.shape[-2:], mode="bilinear")[:, 0] > 0
        assert not np.array_equal(plain.numpy(), np.asarray(want_mask))


def test_perceptual_error_warns_once_on_random_weights(caplog):
    model = perceptual.PerceptualError(small_features=True)
    x = torch.rand(1, 3, 8, 8)
    with caplog.at_level("WARNING"):
        model(x, x)
        model(x, x)
    assert sum("RANDOM VGG16 weights" in r.message for r in caplog.records) == 1
    with pytest.raises(KeyError, match="features.2"):
        perceptual.convert_torchvision_vgg16({"features.0.weight": x, "features.0.bias": x})
