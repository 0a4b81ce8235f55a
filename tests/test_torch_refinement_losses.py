"""The port's stage 3-4 losses (``monorec_tpu_torch/losses/monorec_losses.py``:
``mask_refinement_loss``, ``depth_refinement_loss``, ``depth_aux_mask_loss``)
against the JAX package's on the same seeded numpy inputs, on the CPU: every
key of the loss dict, and the gradients with respect to the mono
predictions, ``cv_mask`` and the stereo predictions (``jax.grad`` against
autograd). Both sides run their plain versions here: the JAX XLA sampler and
jnp SSIM, the port's K2 and K3 plain versions.

This file holds stage 3's ``mask_refinement_loss`` with every option set
(``dist_diff_loss`` at 96x128, where its crop, rows 4b to -b with b = 16 at
scale 0, keeps pixels at every scale; the rest at B=2, 24x32, four scales)
and the helpers; ``tests/test_torch_depth_refinement_losses.py`` holds stage
4's and ``depth_aux_mask_loss``, so that the two spread over two workers.

Tolerance: rtol 5e-4 / atol 1e-5 for losses and gradients
(``tests/test_reprojection_parity.py:120``, PARITY.md row 9). The bilinear
warp's coordinate gradient jumps where a sample coordinate crosses an
integer; where one lies within 1e-4 px of an integer (and not on it), the
two packages' float32 coordinates may fall on either side, and both subgradients are
right. Those gradient elements (any frame, any scale the element feeds) are
left out of the gradient comparison and counted: at most 0.1% of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorec_tpu.losses import monorec_losses as jl
from monorec_tpu_torch.data.synthetic import batch_to_torch
from monorec_tpu_torch.losses import monorec_losses as tl
from monorec_tpu_torch.losses.common import loss_warp_grids, upsample_nearest_to
from monorec_tpu_torch.ops.sampling import pixel_coordinates

B, FR = 2, 2
TOL = dict(rtol=5e-4, atol=1e-5)
INV_MIN, INV_MAX = 0.33, 0.0025  # the trainer's data["inv_depth_min"] / ["inv_depth_max"]


def _data(h, w, seed=0, cv="random"):
    """A numpy NHWC batch (``tests/test_torch_losses.py``'s geometry: two
    frames, a stereo frame, fx = 30, so border pixels warp out of view),
    with a moving-object mask, ``cv_mask`` and four scales of mono and
    stereo inverse depths, each with a near object and a far region over
    the moving blob."""
    rng = np.random.default_rng(seed)
    k = np.zeros((4, 4), np.float32)
    k[0, 0] = k[1, 1] = 30.0
    k[0, 2], k[1, 2] = w / 2 - 0.5, h / 2 - 0.5
    k[2, 2] = k[3, 3] = 1
    kb = np.tile(k, (B, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (B, FR, 1, 1))
    poses[:, 0, 0, 3] = 0.25
    poses[:, 1, 0, 3] = -0.25
    poses[:, 1, 2, 3] = 0.3
    stereo_pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    stereo_pose[:, 0, 3] = 0.54
    target = rng.uniform(0.02, 0.3, (B, h, w, 1)).astype(np.float32)
    target[rng.uniform(size=target.shape) < 0.3] = 0.0
    mvobj = (rng.uniform(size=(B, h, w, 1)) > 0.9).astype(np.float32)
    mvobj[:, h // 2 :, w // 4 : w // 2] = 1.0  # a moving blob
    cv_mask = {"random": lambda: rng.uniform(0, 1, (B, h, w, 1)),
               "static": lambda: np.full((B, h, w, 1), 0.2),
               "dynamic": lambda: np.full((B, h, w, 1), 0.8)}[cv]().astype(np.float32)

    def preds(seed_):
        r = np.random.default_rng(seed_)
        out = []
        for s in range(4):
            hs, ws = h >> s, w >> s
            p = r.uniform(0.05, 0.3, (B, hs, ws, 1)).astype(np.float32)
            p[:, : hs // 3, ws // 2 :] = 0.6  # a near object
            p[:, hs // 2 :, ws // 4 : ws * 3 // 8] = 0.01  # far, over the moving blob
            out.append(p)
        return out

    return {
        "keyframe": rng.uniform(-0.5, 0.5, (B, h, w, 3)).astype(np.float32),
        "keyframe_pose": np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)),
        "keyframe_intrinsics": kb,
        "frames": rng.uniform(-0.5, 0.5, (B, FR, h, w, 3)).astype(np.float32),
        "poses": poses,
        "intrinsics": np.tile(kb[:, None], (1, FR, 1, 1)),
        "stereoframe": rng.uniform(-0.5, 0.5, (B, h, w, 3)).astype(np.float32),
        "stereoframe_pose": stereo_pose,
        "stereoframe_intrinsics": kb,
        "target": target,
        "mvobj_mask": mvobj,
        "cv_mask": cv_mask,
    }, preds(seed + 10), preds(seed + 20)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _kinks(td, preds):
    """Per scale, the elements of ``preds`` (NCHW) whose warp by any frame
    (two mono, one stereo) samples within 1e-4 px of an integer coordinate
    but not on it (exact integers, as a pure x translation gives in y, come
    out exact in both packages)."""
    h, w = td["keyframe"].shape[-2:]
    poses = torch.cat([td["poses"], td["stereoframe_pose"][:, None]], 1)
    intr = torch.cat([td["intrinsics"], td["stereoframe_intrinsics"][:, None]], 1)
    out = []
    for s, p in enumerate(preds):
        depth = 1.0 / upsample_nearest_to(p.detach(), h, w)[:, 0]
        grids = loss_warp_grids(depth, poses, intr, td["keyframe_pose"], td["keyframe_intrinsics"])
        xs, ys = pixel_coordinates(grids.reshape(-1, h, w, 2), h, w)
        dx, dy = (xs - xs.round()).abs(), (ys - ys.round()).abs()
        near = ((dx > 0) & (dx < 1e-4)) | ((dy > 0) & (dy < 1e-4))
        near = near.reshape(B, -1, h, w).any(1, keepdim=True).float()
        out.append(torch.nn.functional.max_pool2d(near, 2**s)[:, 0].numpy() > 0)
    return out


def _compare(name, options, h, w, cv="random", seed=0):
    """The loss dict and the gradients of both packages; returns the port's
    dict and the gradients (mono, cv_mask, stereo) of both."""
    data, mono, stereo = _data(h, w, seed, cv)
    fixed = {"inv_depth_min": INV_MIN, "inv_depth_max": INV_MAX}
    jd = {k: jnp.asarray(v) for k, v in data.items() if k != "cv_mask"}

    def j_loss(m, c, s):
        return getattr(jl, name)({**jd, **fixed, "cv_mask": c, "mono_pred": m,
                                  "stereo_pred": s}, 0.5, None, options)

    j_args = ([jnp.asarray(p) for p in mono], jnp.asarray(data["cv_mask"]),
              [jnp.asarray(p) for p in stereo])
    j_dict = j_loss(*j_args)
    j_grads = jax.grad(lambda *a: j_loss(*a)["loss"], argnums=(0, 1, 2))(*j_args)

    td = batch_to_torch({k: v for k, v in data.items() if k != "cv_mask"}, "cpu")
    tm = [_nchw(p).requires_grad_() for p in mono]
    tc = _nchw(data["cv_mask"]).requires_grad_()
    ts = [_nchw(p).requires_grad_() for p in stereo]
    t_dict = getattr(tl, name)({**td, **fixed, "cv_mask": tc, "mono_pred": tm,
                                "stereo_pred": ts}, 0.5, None, options)
    t_dict["loss"].backward()

    assert set(t_dict) == set(j_dict)
    for key in j_dict:
        np.testing.assert_allclose(np.asarray(t_dict[key].detach()), np.asarray(j_dict[key]),
                                   err_msg=key, **TOL)
    assert t_dict["warp_uncovered"].item() == 0.0

    def grad_of(t):
        return np.zeros(tuple(t.shape)) if t.grad is None else t.grad.numpy()

    t_grads = ([grad_of(p)[:, 0] for p in tm], grad_of(tc)[:, 0], [grad_of(p)[:, 0] for p in ts])
    jm, jc, js = j_grads
    want = ([np.asarray(g)[..., 0] for g in jm], np.asarray(jc)[..., 0],
            [np.asarray(g)[..., 0] for g in js])
    np.testing.assert_allclose(t_grads[1], want[1], err_msg="cv_mask", **TOL)
    for key, preds, got_all, ref_all in (("mono_pred", tm, t_grads[0], want[0]),
                                         ("stereo_pred", ts, t_grads[2], want[2])):
        kinks = _kinks(td, preds)
        assert sum(k.sum() for k in kinks) <= 1e-3 * sum(k.size for k in kinks), key
        for i, (got, ref, kink) in enumerate(zip(got_all, ref_all, kinks)):
            np.testing.assert_allclose(got[~kink], ref[~kink], err_msg=f"{key}[{i}]", **TOL)
    return t_dict, t_grads


@pytest.mark.parametrize("options,h,w", [
    ((), 24, 32),
    (("mask_loss",), 24, 32),
    (("dist_diff_loss",), 96, 128),
    (("mask_loss", "dist_diff_loss"), 96, 128),
])
def test_mask_refinement_loss_matches_jax(options, h, w):
    t_dict, (g_mono, g_cv, g_stereo) = _compare("mask_refinement_loss", options, h, w)
    assert np.isfinite(t_dict["loss"].item())
    assert all(np.abs(g).max() > 0 for g in g_mono + g_stereo) and np.abs(g_cv).max() > 0
    if "dist_diff_loss" in options:
        assert all(t_dict[f"dist_diff_{s}"].item() > 0 for s in range(4))
    if "mask_loss" in options:
        # The total adds the BCE once; the log shows it four times. With
        # dist_diff_loss too, the dist_diff terms are logged but left out.
        others = {k: v for k, v in t_dict.items() if k not in ("loss", "mask_loss")}
        sdl = sum(others[f"sdl_{s}"].item() for s in range(4))
        md2l = sum(others[f"md2l_{s}"].item() for s in range(4))
        np.testing.assert_allclose(t_dict["loss"].item(),
                                   4 * sdl + md2l + t_dict["mask_loss"].item() / 4, rtol=1e-5)
