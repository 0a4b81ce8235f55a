"""The port's losses (``losses/common.py``, ``losses/monorec_losses.py``),
sparse metrics, ``utils`` helpers and synthetic data against the JAX package
on the same seeded numpy inputs, on the CPU (where both sides run their
plain versions: the JAX XLA sampler and jnp SSIM, the port's K2 and K3
plain versions).

Tolerance: rtol 5e-4 / atol 1e-5 for losses and their gradients
(``tests/test_reprojection_parity.py:120``, the full-chain reprojection
budget of PARITY.md row 9); rtol 1e-5 for the metrics and helpers, whose
only differences are float32 sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorec_tpu.data.loader import DataLoader as JDataLoader
from monorec_tpu.data.synthetic import SyntheticSweepDataset as JSyntheticSweepDataset
from monorec_tpu.losses import common as jc
from monorec_tpu.losses.monorec_losses import depth_loss as j_depth_loss
from monorec_tpu.metrics import get_metric as j_get_metric
from monorec_tpu.utils import mask_mean as j_mask_mean
from monorec_tpu_torch.data.loader import DataLoader
from monorec_tpu_torch.data.synthetic import SyntheticSweepDataset, batch_to_torch
from monorec_tpu_torch.losses import common as tc
from monorec_tpu_torch.losses.monorec_losses import depth_loss
from monorec_tpu_torch.metrics import METRICS, get_metric
from monorec_tpu_torch.utils import mask_mean

B, H, W, FR = 2, 24, 32, 2
TOL = dict(rtol=5e-4, atol=1e-5)


def _data(seed=0):
    """A numpy NHWC batch: two frames 0.25 m to either side (one moving
    forward), a stereo frame, intrinsics with fx = 30: disparities of
    1-2 px, so border pixels warp out of view."""
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
    target = rng.uniform(0.02, 0.3, (B, H, W, 1)).astype(np.float32)
    target[rng.uniform(size=target.shape) < 0.3] = 0.0  # sparse GT
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
        "target": target,
    }


def _inv_depth(seed=1, h=H, w=W):
    rng = np.random.default_rng(seed)
    inv = rng.uniform(0.05, 0.3, (B, h, w, 1)).astype(np.float32)
    inv[:, : h // 2, w // 3 :] = 0.6  # a near object: a depth edge
    return inv


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return batch_to_torch(d, "cpu")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach() if torch.is_tensor(port) else port),
                               np.asarray(ref), **(tol or TOL))


REPROJECTION_CASES = [
    # automasking, combine_frames, mono_auto, border, use_stereo
    (False, "min", False, 0, False),
    (True, "min", False, 0, False),
    (True, "avg", False, 0, True),
    (False, "avg", True, 0, True),
    (False, "min", False, 3, True),
    (True, "min", True, 3, False),
]


@pytest.mark.parametrize("automasking,combine,mono_auto,border,use_stereo", REPROJECTION_CASES)
def test_reprojection_loss_matches_jax(automasking, combine, mono_auto, border, use_stereo):
    data, inv = _data(), _inv_depth()
    kw = dict(automasking=automasking, combine_frames=combine, mono_auto=mono_auto,
              border=border, use_stereo=use_stereo)
    jd = _j(data)
    j_map = np.asarray(jc.reprojection_loss(jnp.asarray(inv), jd, reduce=False, **kw))
    j_val, j_grad = jax.value_and_grad(lambda d: jc.reprojection_loss(d, jd, **kw))(
        jnp.asarray(inv))

    td = _t(data)
    t_map = tc.reprojection_loss(_nchw(inv), td, reduce=False, **kw)
    ti = _nchw(inv).requires_grad_()
    t_val = tc.reprojection_loss(ti, td, **kw)
    t_val.backward()

    np.testing.assert_array_equal(torch.isinf(t_map).numpy(), np.isinf(j_map))
    assert 0 < np.isinf(j_map).sum() < j_map.size  # some pixels out of view, not all
    fin = np.isfinite(j_map)
    _close(t_map.numpy()[fin], j_map[fin])
    _close(t_val, j_val)
    _close(ti.grad.numpy()[:, 0], np.asarray(j_grad)[..., 0])


def test_reprojection_loss_rnd_draws_from_the_generator(monkeypatch):
    data, inv = _data(seed=2), _inv_depth(seed=3)
    gen = torch.Generator().manual_seed(5)
    idx = torch.randint(0, FR, (B,), generator=torch.Generator().manual_seed(5))
    # The JAX side draws from a PRNG key; feed it the port's draw.
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(idx.numpy()))
    j_map = np.asarray(jc.reprojection_loss(jnp.asarray(inv), _j(data), reduce=False,
                                            combine_frames="rnd", rng=jax.random.PRNGKey(0)))
    t_map = tc.reprojection_loss(_nchw(inv), _t(data), reduce=False, combine_frames="rnd",
                                 generator=gen).numpy()
    np.testing.assert_array_equal(np.isinf(t_map), np.isinf(j_map))
    fin = np.isfinite(j_map)
    _close(t_map[fin], j_map[fin])
    with pytest.raises(ValueError):
        tc.reprojection_loss(_nchw(inv), _t(data), combine_frames="rnd")


@pytest.mark.parametrize("options", [(), ("stereo",)])
def test_depth_loss_values_and_gradient_match_jax(options):
    data = _data(seed=4)
    preds = [_inv_depth(seed=10 + i, h=H // 2**i, w=W // 2**i) for i in range(4)]
    jd = _j(data)

    def j_loss(ps):
        return j_depth_loss({**jd, "predicted_inverse_depths": ps}, 0.5, None, options)

    j_dict = j_loss([jnp.asarray(p) for p in preds])
    j_grads = jax.grad(lambda ps: j_loss(ps)["loss"])([jnp.asarray(p) for p in preds])

    tp = [_nchw(p).requires_grad_() for p in preds]
    t_dict = depth_loss({**_t(data), "predicted_inverse_depths": tp}, 0.5, None, options)
    t_dict["loss"].backward()
    assert set(t_dict) == set(j_dict)
    for key in j_dict:
        _close(t_dict[key], j_dict[key])
    assert float(t_dict["warp_uncovered"]) == 0.0
    for p, g in zip(tp, j_grads):
        _close(p.grad.numpy()[:, 0], np.asarray(g)[..., 0])


def test_helpers_of_the_loss_match_jax():
    data, inv = _data(seed=6), _inv_depth(seed=7)
    jd, td = _j(data), _t(data)
    for use_stereo in (False, True):
        _close(tc.identity_reprojection_errors(td, True, use_stereo),
               jc.identity_reprojection_errors(jd, True, use_stereo), rtol=1e-5, atol=1e-6)
    tiled = tc.tile_batch_for_scales(td, 3)
    j_tiled = jc.tile_batch_for_scales(jd, 3)
    assert set(tiled) == set(j_tiled)
    for key, value in j_tiled.items():
        ref = np.asarray(value)
        if value.ndim >= 4 and value.shape[-1] == 3:
            ref = np.moveaxis(ref, -1, -3)
        np.testing.assert_array_equal(tiled[key].numpy(), ref)
    key = data["keyframe"]
    _close(tc.compute_errors(_nchw(key + 0.5), _nchw(data["stereoframe"] + 0.5)),
           jc.compute_errors(jnp.asarray(key + 0.5), jnp.asarray(data["stereoframe"] + 0.5)),
           rtol=1e-5, atol=1e-6)
    _close(tc.edge_aware_smoothness_loss(_nchw(inv), _nchw(key)),
           jc.edge_aware_smoothness_loss(jnp.asarray(inv), jnp.asarray(key)), rtol=1e-5, atol=0)
    _close(tc.edge_aware_smoothness_loss(_nchw(inv), _nchw(key), reduce=False)[:, 0],
           jc.edge_aware_smoothness_loss(jnp.asarray(inv), jnp.asarray(key), reduce=False)[..., 0],
           rtol=1e-5, atol=1e-7)
    gt = data["target"]
    for l2 in (False, True):
        _close(tc.sparse_depth_loss(_nchw(inv), _nchw(gt), l2=l2),
               jc.sparse_depth_loss(jnp.asarray(inv), jnp.asarray(gt), l2=l2), rtol=1e-5, atol=0)
        t_err, t_inv = tc.sparse_depth_loss(_nchw(inv), _nchw(gt), l2=l2, reduce=False)
        j_err, j_inv = jc.sparse_depth_loss(jnp.asarray(inv), jnp.asarray(gt), l2=l2,
                                            reduce=False)
        _close(t_err[:, 0], np.asarray(j_err)[..., 0], rtol=1e-5, atol=0)
        np.testing.assert_array_equal(t_inv[:, 0].numpy(), np.asarray(j_inv)[..., 0])
    # An all-invalid GT: the reference's NaN is guarded to 0.
    assert float(tc.sparse_depth_loss(_nchw(inv), torch.zeros(B, 1, H, W))) == 0.0
    for scale, border in ((0, 0), (1, 3)):
        _close(tc.selfsup_loss(_nchw(inv), td, scale=scale, mask_border=border),
               jc.selfsup_loss(jnp.asarray(inv), jd, scale=scale, mask_border=border))
    for h, w in ((H * 2, W * 2), (H + 5, W + 3), (H, W)):
        np.testing.assert_array_equal(
            tc.upsample_nearest_to(_nchw(inv), h, w)[:, 0].numpy(),
            np.asarray(jc.upsample_nearest_to(jnp.asarray(inv), h, w))[..., 0])


def test_mask_mean_matches_jax_including_the_all_invalid_nan():
    rng = np.random.default_rng(8)
    t = rng.uniform(size=(2, 1, 5, 6)).astype(np.float32)
    inv = rng.uniform(size=t.shape) < 0.4
    inv[1] = True
    _close(mask_mean(torch.from_numpy(t), torch.from_numpy(inv)),
           j_mask_mean(jnp.asarray(t), jnp.asarray(inv)), rtol=1e-5, atol=0)
    per = mask_mean(torch.from_numpy(t), torch.from_numpy(inv), dim=(1, 2, 3)).numpy()
    j_per = np.asarray(j_mask_mean(jnp.asarray(t), jnp.asarray(inv), axis=(1, 2, 3)))
    np.testing.assert_allclose(per, j_per, rtol=1e-5)
    assert np.isnan(per[1]) and np.isnan(j_per[1])


@pytest.mark.parametrize("roi,max_distance", [(None, 80), (None, None), ((2, 20, 3, 30), 10)])
def test_sparse_metrics_match_jax(roi, max_distance):
    rng = np.random.default_rng(9)
    result = rng.uniform(0.0, 0.4, (B, H, W, 1)).astype(np.float32)
    target = rng.uniform(0.005, 0.4, (B, H, W, 1)).astype(np.float32)
    target[rng.uniform(size=target.shape) < 0.3] = 0.0
    t_data = {"result": _nchw(result), "target": _nchw(target)}
    j_data = {"result": jnp.asarray(result), "target": jnp.asarray(target)}
    sparse = [name for name in METRICS if name.endswith("_sparse_metric")]
    assert len(sparse) == 7
    for name in sparse:
        fn = METRICS[name]
        assert fn.__name__ == name and get_metric(name) is fn
        _close(fn(t_data, roi, max_distance), j_get_metric(name)(j_data, roi, max_distance),
               rtol=1e-5, atol=1e-7)
    with pytest.raises(KeyError, match="unknown metric"):
        get_metric("a4_metric")


@pytest.mark.parametrize("kwargs", [
    dict(length=5, target_image_size=(16, 24), frame_count=2),
    dict(length=6, target_image_size=(8, 16), frame_count=3, return_stereo=True,
         return_mvobj_mask=2, seed=4),
])
def test_synthetic_sweep_dataset_and_loader_match_jax(kwargs):
    port, ref = SyntheticSweepDataset(**kwargs), JSyntheticSweepDataset(**kwargs)
    assert len(port) == len(ref)
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert set(a) == set(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])
    loader = DataLoader(port, batch_size=2, validation_split=2)
    j_loader = JDataLoader(ref, batch_size=2, validation_split=2, device_put=False)
    assert len(loader) == len(j_loader)
    for _ in range(2):  # two epochs: the same seeded shuffles
        for got, want in zip(loader, j_loader):
            np.testing.assert_array_equal(got["image_id"].numpy(), want["image_id"])
            np.testing.assert_array_equal(got["keyframe"].numpy(),
                                          np.moveaxis(want["keyframe"], -1, 1))
    val, j_val = loader.split_validation(), j_loader.split_validation()
    assert len(val) == len(j_val) == 1
    np.testing.assert_array_equal(next(iter(val))["image_id"].numpy(),
                                  next(iter(j_val))["image_id"])
