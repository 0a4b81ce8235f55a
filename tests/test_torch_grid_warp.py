"""The port's loss warp (kernel K2's plain version, ``ops/grid_warp.py``, and
``ops/sampling.py::grid_sample_planar``) against the JAX package on the same
seeded numpy inputs, on the CPU: the Pallas kernel ``grid_warp`` /
``grid_warp_jac`` / ``grid_warp_grad`` in interpret mode at (2, 3, 32, 128)
(its gate needs H % 32 and W % 128), and the JAX XLA sampler with
``jax.grad`` of the coordinates.

Coordinates carry a depth edge (a 8 px jump in x across rows), integer
fractions (every third row) and samples far outside the image. Budgets
(``tests/test_grid_warp.py:51,298``): values atol 2e-4, Jacobians and
gradients atol 2e-5 in pixel units.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from monorec_tpu.ops.pallas.grid_warp import grid_warp, grid_warp_grad, grid_warp_jac
from monorec_tpu.ops.sampling import grid_sample_planar as j_grid_sample_planar
from monorec_tpu_torch.ops import grid_warp as gw
from monorec_tpu_torch.ops.sampling import grid_sample_planar, pixel_coordinates

N, C, H, W = 2, 3, 32, 128


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    dx = np.where(ys > H // 2, 9.4, 1.3) + 0.1 * np.sin(xs / 5.0)
    dx = np.where(ys % 3 == 0, np.round(dx), dx)  # integer fractions
    dx = np.where((xs < W // 4) & (ys < H // 4), -200.0, dx)  # far outside
    dy = np.where(xs % 7 == 0, 1.0, 0.6 + 0.2 * np.cos(xs / 11.0))
    x = np.stack([xs + dx + 0.37 * i for i in range(N)]).astype(np.float32)
    y = np.stack([ys + dy for _ in range(N)]).astype(np.float32)
    # The value range of tests/test_grid_warp.py, where the budgets come from.
    images = rng.uniform(-0.5, 0.5, (N, C, H, W)).astype(np.float32)
    cot = rng.uniform(-1.0, 1.0, (N, C, H, W)).astype(np.float32)
    return images, x, y, cot


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_grid_warp_plain_version_matches_pallas_kernel():
    images, x, y, cot = _inputs()
    ti, tx, ty, tc = _t(images, x, y, cot)

    ref, cov = grid_warp(images, x, y, interpret=True)
    assert float(jnp.max(cov)) == 0.0  # the Pallas kernel reached every sample
    out = gw.grid_warp(ti, tx, ty)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)

    (_, rjx, rjy), _ = grid_warp_jac(images, x, y, interpret=True)
    jout, jx, jy = gw.grid_warp_jac(ti, tx, ty)
    np.testing.assert_array_equal(jout.numpy(), out.numpy())
    np.testing.assert_allclose(jx.numpy(), np.asarray(rjx), atol=2e-5)
    np.testing.assert_allclose(jy.numpy(), np.asarray(rjy), atol=2e-5)

    rgx, rgy = grid_warp_grad(images, x, y, cot, interpret=True)
    gx, gy = gw.grid_warp_grad(ti, tx, ty, tc)
    np.testing.assert_allclose(gx.numpy(), np.asarray(rgx), atol=2e-5)
    np.testing.assert_allclose(gy.numpy(), np.asarray(rgy), atol=2e-5)


def _normalize(p, size):
    return (2.0 * p + 1.0) / size - 1.0


def test_grid_sample_planar_matches_jax_xla_path_and_its_gradient():
    images, x, y, cot = _inputs(seed=1)
    grids = np.stack([_normalize(x, W), _normalize(y, H)], -1).astype(np.float32)

    def j_loss(g):
        return jnp.sum(j_grid_sample_planar(jnp.asarray(images), g, backend="xla") * cot)

    ref = j_grid_sample_planar(jnp.asarray(images), jnp.asarray(grids), backend="xla")
    j_grad = np.asarray(jax.grad(j_loss)(jnp.asarray(grids)))

    tg = torch.from_numpy(grids).requires_grad_()
    ti = torch.from_numpy(images).requires_grad_()
    out = grid_sample_planar(ti, tg)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-4)
    assert ti.grad is None  # the images are data
    # d/d grid = d/d pixel * size / 2: compare in pixel units.
    scale = np.array([2.0 / W, 2.0 / H], np.float32)
    np.testing.assert_allclose(tg.grad.numpy() * scale, j_grad * scale, atol=2e-5)


def test_all_outside_samples_are_exactly_zero():
    """The reprojection loss marks invalid pixels by ``== 0``: a sample with
    no tap inside must be exactly 0.0 (and its Jacobian 0), in the port and
    in the JAX kernel alike; one tap inside is not 0."""
    rng = np.random.default_rng(2)
    images = rng.uniform(1.0, 2.0, (1, C, H, W)).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    x = np.where(xs < W // 2, -1.25 - 0.5 * (xs % 3), xs + 0.25)[None].astype(np.float32)
    x[0, 0, 0] = -0.75  # taps at x = -1 (outside) and 0 (inside)
    y = (ys + 0.5)[None].astype(np.float32)
    out, jx, jy = gw.grid_warp_jac(*_t(images, x, y))
    assert (out[0, :, :, 1 : W // 2] == 0).all()
    assert (jx[0, :, :, 1 : W // 2] == 0).all() and (jy[0, :, :, 1 : W // 2] == 0).all()
    assert (out[0, :, :, W // 2 :] != 0).all() and (out[0, :, 0, 0] != 0).all()
    ref, _ = grid_warp(images, x, y, interpret=True)
    np.testing.assert_array_equal(out.numpy()[:, 0] == 0, np.asarray(ref)[:, 0] == 0)


def test_warp_pixels_gradient_equals_autograd_of_plain_version():
    images, x, y, cot = _inputs(seed=3)
    ti, tx, ty, tc = _t(images, x, y, cot)
    xg, yg = tx.clone().requires_grad_(), ty.clone().requires_grad_()
    (gw.warp_pixels(ti, xg, yg) * tc).sum().backward()
    rgx, rgy = gw.grid_warp_grad_reference(ti, tx, ty, tc)
    torch.testing.assert_close(xg.grad, rgx, rtol=0, atol=2e-5)
    torch.testing.assert_close(yg.grad, rgy, rtol=0, atol=2e-5)
    with torch.no_grad():  # no coordinate gradient: the values mode
        torch.testing.assert_close(gw.warp_pixels(ti, tx, ty), gw.grid_warp_reference(ti, tx, ty))


def test_pixel_coordinates_clamp_far_samples():
    g = torch.tensor([[[[-50.0, 0.0], [0.0, 50.0], [0.25, -0.5]]]])
    xs, ys = pixel_coordinates(g, 1, 3)
    assert xs.tolist() == [[[-3.0, 1.0, 1.375]]]
    assert ys.tolist() == [[[0.0, 3.0, -0.25]]]
