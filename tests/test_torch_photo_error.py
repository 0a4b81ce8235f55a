"""The port's fused photometric error (kernel K3's plain version,
``ops/photo_error.py``) against the JAX package on the same seeded numpy
inputs, on the CPU: the Pallas kernels ``photo_error_fwd`` /
``photo_error_bwd`` in interpret mode at (2, 3, 32, 128), and the JAX jnp
path of ``compute_errors_planar`` at a ragged shape the Pallas gate refuses.

Budgets (``tests/test_photo_error.py:44,62``): forward rtol 1e-5 /
atol 1e-6; backward rtol 1e-3 / atol 2e-5 (the analytic backward regroups
the quotient-rule terms, so float32 cancellation reaches ~1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorec_tpu.losses.common import compute_errors_planar as j_compute_errors_planar
from monorec_tpu.ops.pallas.photo_error import photo_error_bwd, photo_error_fwd
from monorec_tpu_torch.losses.common import compute_errors_planar
from monorec_tpu_torch.ops import photo_error as pe


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    # Keyframe-space values in [1, 2], as the losses feed them; a block of
    # exact zeros exercises the L1 sign and the invalid-pixel values.
    x = rng.uniform(1.0, 2.0, shape).astype(np.float32)
    y = rng.uniform(1.0, 2.0, shape).astype(np.float32)
    x[0, :, :3, :5] = 0.0
    m, _, h, w = shape
    cot = rng.uniform(-1.0, 1.0, (m, h, w)).astype(np.float32)
    return x, y, cot


def test_photo_error_plain_version_matches_pallas_kernels():
    x, y, cot = _inputs((2, 3, 32, 128))
    tx, ty, tc = (torch.from_numpy(a) for a in (x, y, cot))
    out = pe.photo_error_fwd(tx, ty)
    np.testing.assert_allclose(out.numpy(), np.asarray(photo_error_fwd(x, y, interpret=True)),
                               rtol=1e-5, atol=1e-6)
    ref_gx = np.asarray(photo_error_bwd(x, y, cot, interpret=True))
    np.testing.assert_allclose(pe.photo_error_bwd(tx, ty, tc).numpy(), ref_gx,
                               rtol=1e-3, atol=2e-5)
    # The differentiable error routes its backward through the same function.
    xg = tx.clone().requires_grad_()
    (pe.photo_error(xg, ty) * tc).sum().backward()
    np.testing.assert_allclose(xg.grad.numpy(), ref_gx, rtol=1e-3, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 3, 21, 45), (1, 1, 8, 8)])
def test_compute_errors_planar_matches_jax_at_ragged_shapes(shape):
    x, y, cot = _inputs(shape, seed=1)
    ref = j_compute_errors_planar(jnp.asarray(x), jnp.asarray(y))
    j_gx = jax.grad(lambda a: jnp.sum(j_compute_errors_planar(a, jnp.asarray(y)) * cot))(
        jnp.asarray(x))
    xg = torch.from_numpy(x).requires_grad_()
    out = compute_errors_planar(xg, torch.from_numpy(y))
    (out * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xg.grad.numpy(), np.asarray(j_gx), rtol=1e-3, atol=2e-5)


def test_keyframe_gets_no_gradient_unless_it_is_not_data():
    """``img1`` is data on the kernel path (y gets no gradient, on every
    device); ``img1_is_data=False`` takes the symmetric plain path."""
    x, y, _ = _inputs((2, 3, 16, 24), seed=2)
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    pe.photo_error(tx, ty).sum().backward()
    assert ty.grad is None and tx.grad.abs().max() > 0
    ty.grad = None
    compute_errors_planar(tx, ty).sum().backward()
    assert ty.grad is None
    compute_errors_planar(tx, ty, img1_is_data=False).sum().backward()
    j_gy = jax.grad(lambda b: jnp.sum(
        j_compute_errors_planar(jnp.asarray(x), b, img1_is_data=False)))(jnp.asarray(y))
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(j_gy), rtol=1e-3, atol=2e-5)
