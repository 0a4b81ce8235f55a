"""Port geometry (monorec_tpu_torch.geometry) against the JAX package on the
same random numpy inputs. Float32 on both sides; atol 1e-5 (depths up to
400 m also get rtol 1e-6, one float32 ulp there is 3e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorec_tpu import geometry as jgeo
from monorec_tpu_torch import geometry as tgeo

H, W = 6, 9


def _pose(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = q
    p[:3, 3] = rng.standard_normal(3)
    return p


def _intrinsics(rng):
    k = np.eye(4, dtype=np.float32)
    k[0, 0], k[1, 1] = rng.uniform(5, 20, 2)
    k[0, 2], k[1, 2] = rng.uniform(2, 6, 2)
    return k


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rtol=0.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_invert_pose(seed):
    poses = np.stack([_pose(np.random.default_rng(seed + 10 * i)) for i in range(3)])
    _close(tgeo.invert_pose(_t(poses)), jgeo.invert_pose(jnp.asarray(poses)))


@pytest.mark.parametrize("seed", [0, 1])
def test_invert_intrinsics(seed):
    k = _intrinsics(np.random.default_rng(seed))
    _close(tgeo.invert_intrinsics(_t(k)), jgeo.invert_intrinsics(jnp.asarray(k)))


def test_pixel_grid():
    _close(tgeo.pixel_grid(H, W), jgeo.pixel_grid(H, W))


@pytest.mark.parametrize("seed", [0, 1])
def test_backproject_then_project(seed):
    rng = np.random.default_rng(seed)
    k = _intrinsics(rng)
    depths = rng.uniform(1, 10, (4, H, W)).astype(np.float32)
    jpts = jgeo.backproject(jnp.asarray(depths), jgeo.invert_intrinsics(jnp.asarray(k)), H, W)
    tpts = tgeo.backproject(_t(depths), tgeo.invert_intrinsics(_t(k)), H, W)
    _close(tpts, jpts, rtol=1e-6)
    # A mild relative motion keeps points in front of the camera (z well
    # away from 0), where the normalized coordinates are well conditioned.
    rel = np.eye(4, dtype=np.float32)
    rel[:3, 3] = rng.uniform(-0.2, 0.2, 3)
    jgrid = jgeo.project(jpts, jnp.asarray(k), jnp.asarray(rel), H, W)
    tgrid = tgeo.project(tpts, _t(k), _t(rel), H, W)
    assert tgrid.shape == (4, H, W, 2)
    _close(tgrid, jgrid)


def test_depth_hypotheses_keep_far_to_near_order():
    # The model's argument order: the smaller inverse depth first.
    t = tgeo.depth_hypotheses(0.0025, 0.33, 32)
    j = jgeo.depth_hypotheses(jnp.float32(0.0025), jnp.float32(0.33), 32)
    _close(t, j, rtol=1e-6)
    assert t[0] > t[-1]
