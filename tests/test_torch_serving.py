"""The serving precision policy's kernel paths against the JAX package on the
same seeded numpy inputs, on the CPU: the cost volume on bf16 sources (K1's
plain version on the bf16-quantized frames) and the loss warp on bf16
sources (K2's plain version).

The JAX XLA paths ignore the warp dtypes, so the serving side of the JAX
package is reached through its Pallas kernels in interpret mode, as its
own tests reach them (tests/test_pallas_kernel.py:117-132,
tests/test_grid_warp.py:192-265). Budgets: per-frame CVs within 1.2e-4 of
the interpret route (the f32 kernel budget: both sides sum float32 warps
of the same bf16 values), the fused CV to the same budget at this size,
both within 5e-3 of the exact XLA path; warped values within 2e-4 of the
XLA sampler on the same quantized images (tests/test_grid_warp.py:51) with
the exact-zero mask identical; the reprojection loss within 1e-5 of the
JAX serving loss and 2e-3 of the exact XLA loss (tests/test_grid_warp.py:
262-263).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monorec_tpu.ops.sampling as j_sampling
from monorec_tpu import precision as j_prec
from monorec_tpu.losses import common as j_common
from monorec_tpu.ops.cost_volume import CostVolumeConfig as JConfig
from monorec_tpu.ops.cost_volume import compute_cost_volume as j_cost_volume
from monorec_tpu_torch import precision as prec
from monorec_tpu_torch.losses.common import reprojection_loss
from monorec_tpu_torch.ops import plane_sweep
from monorec_tpu_torch.ops.cost_volume import CostVolumeConfig, compute_cost_volume
from monorec_tpu_torch.ops.sampling import grid_sample_planar

INV_MAX, INV_MIN = 0.0025, 0.33


@pytest.fixture
def policies():
    """Both packages' process-wide policies, restored afterwards."""
    saved = (prec._current, prec._consumed), (j_prec._current, j_prec._consumed)
    yield
    (prec._current, prec._consumed), (j_prec._current, j_prec._consumed) = saved


def _cv_args(b=2, h=32, w=128, f=2, seed=0):
    """tests/test_pallas_kernel.py::_cv_args: the same draws, NHWC numpy."""
    rng = np.random.default_rng(seed)
    k = np.zeros((4, 4), np.float32)
    k[0, 0] = k[1, 1] = 0.8 * w
    k[0, 2], k[1, 2] = w / 2 - 0.5, h / 2 - 0.5
    k[2, 2] = k[3, 3] = 1.0
    kb = np.tile(k, (b, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (b, f, 1, 1))
    for i in range(f):
        poses[:, i, 0, 3] = 0.3 * (i - f / 2 + 0.5)
    return (rng.uniform(-0.5, 0.5, (b, h, w, 3)).astype(np.float32), kb,
            np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
            rng.uniform(-0.5, 0.5, (b, f, h, w, 3)).astype(np.float32),
            np.tile(kb[:, None], (1, f, 1, 1)), poses)


def _jax_cv(backend, **cfg):
    fused, sfcv = j_cost_volume(*(jnp.asarray(a) for a in _cv_args()), jnp.float32(INV_MAX),
                                jnp.float32(INV_MIN), JConfig(depth_steps=4, **cfg),
                                backend=backend, interpret=backend == "pallas")
    return np.moveaxis(np.asarray(fused), -1, 1), np.moveaxis(np.asarray(sfcv), -1, 2)


@pytest.mark.parametrize("use_ssim", [1, -1])
def test_serving_cost_volume_matches_the_pallas_route(use_ssim):
    a = _cv_args()
    args = [torch.from_numpy(np.moveaxis(a[0], -1, 1)), torch.from_numpy(a[1]),
            torch.from_numpy(a[2]), torch.from_numpy(np.moveaxis(a[3], -1, 2)),
            torch.from_numpy(a[4]), torch.from_numpy(a[5])]
    before = plane_sweep.plane_sweep_sad.launches, plane_sweep.plane_sweep_sad.launches_bf16
    fused, sfcv = (t.numpy() for t in compute_cost_volume(
        *args, INV_MAX, INV_MIN, CostVolumeConfig(depth_steps=4, use_ssim=use_ssim,
                                                  warp_dtype="bfloat16")))
    assert (plane_sweep.plane_sweep_sad.launches,
            plane_sweep.plane_sweep_sad.launches_bf16) == before  # the plain version on CPU
    exact_f, exact_s = (t.numpy() for t in compute_cost_volume(
        *args, INV_MAX, INV_MIN, CostVolumeConfig(depth_steps=4, use_ssim=use_ssim)))
    assert not np.array_equal(sfcv, exact_s)  # the sources were quantized

    fused_p, sfcv_p = _jax_cv("pallas", use_ssim=use_ssim, warp_dtype="bfloat16")
    np.testing.assert_allclose(sfcv, sfcv_p, atol=1.2e-4)
    np.testing.assert_allclose(fused, fused_p, atol=1.2e-4)
    fused_x, sfcv_x = _jax_cv("xla", use_ssim=use_ssim)
    for got in (sfcv, sfcv_p):
        np.testing.assert_allclose(got, sfcv_x, atol=5e-3)
    for got in (fused, fused_p):
        np.testing.assert_allclose(got, fused_x, atol=5e-3)


def _warp_inputs(n=2, c=3, h=32, w=128, seed=0):
    """Images in the loss's value range and sampling grids with a depth edge,
    integer fractions and samples far outside (tests/test_torch_grid_warp.py)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    dx = np.where(ys > h // 2, 9.4, 1.3) + 0.1 * np.sin(xs / 5.0)
    dx = np.where(ys % 3 == 0, np.round(dx), dx)
    dx = np.where((xs < w // 4) & (ys < h // 4), -200.0, dx)
    dy = np.where(xs % 7 == 0, 1.0, 0.6 + 0.2 * np.cos(xs / 11.0))
    x = np.stack([xs + dx + 0.37 * i for i in range(n)])
    y = np.stack([ys + dy for _ in range(n)])
    grids = np.stack([(2.0 * x + 1.0) / w - 1.0, (2.0 * y + 1.0) / h - 1.0], -1)
    images = rng.uniform(1.0, 2.0, (n, c, h, w)).astype(np.float32)
    return images, grids.astype(np.float32)


def test_serving_loss_warp_matches_jax_on_quantized_images():
    images, grids = _warp_inputs()
    got = grid_sample_planar(torch.from_numpy(images), torch.from_numpy(grids),
                             kernel_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    quantized = np.asarray(jnp.asarray(images, jnp.bfloat16).astype(jnp.float32))
    assert not np.array_equal(quantized, images)
    ref = np.asarray(j_sampling.grid_sample_planar(jnp.asarray(quantized), jnp.asarray(grids),
                                                   backend="xla"))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)
    np.testing.assert_array_equal(got.numpy()[:, 0] == 0, ref[:, 0] == 0)
    assert (got.numpy()[:, 0] == 0).any()
    exact = grid_sample_planar(torch.from_numpy(images), torch.from_numpy(grids))
    assert not torch.equal(got, exact)


def _loss_data(b=1, h=32, w=128):
    """tests/test_grid_warp.py::test_reprojection_loss_tpu_path_matches_xla's
    batch, NHWC numpy."""
    rng = np.random.default_rng(6)
    k = np.zeros((4, 4), np.float32)
    k[0, 0] = k[1, 1] = 0.8 * w
    k[0, 2], k[1, 2] = w / 2 - 0.5, h / 2 - 0.5
    k[2, 2] = k[3, 3] = 1.0
    poses = np.tile(np.eye(4, dtype=np.float32), (b, 2, 1, 1))
    poses[:, 0, 0, 3] = 0.15
    poses[:, 1, 0, 3] = -0.15
    data = {
        "keyframe": rng.uniform(-0.5, 0.5, (b, h, w, 3)).astype(np.float32),
        "keyframe_pose": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        "keyframe_intrinsics": np.tile(k, (b, 1, 1)),
        "frames": rng.uniform(-0.5, 0.5, (b, 2, h, w, 3)).astype(np.float32),
        "poses": poses,
        "intrinsics": np.tile(k[None], (b, 2, 1, 1)),
    }
    return data, rng.uniform(0.05, 0.3, (b, h, w, 1)).astype(np.float32)


def test_serving_reprojection_loss_matches_the_jax_kernel_route(monkeypatch, policies):
    data, inv_depth = _loss_data()
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    j_exact = float(j_common.reprojection_loss(jnp.asarray(inv_depth), jdata, automasking=True))

    # The JAX loss's kernel route: its planar sampler forced onto the Pallas
    # kernel in interpret mode (tests/test_grid_warp.py:229-235).
    orig = j_sampling.grid_sample_planar
    calls = []

    def forced(images, grids, backend="xla", **kw):
        kw.pop("interpret", None)
        calls.append(kw.get("kernel_dtype"))
        return orig(images, grids, backend="tpu", interpret=True, **kw)

    monkeypatch.setattr(j_common, "grid_sample_planar", forced)
    j_prec.set_precision("serving", expect_rebuild=True)
    j_serving = float(j_common.reprojection_loss(jnp.asarray(inv_depth), jdata, automasking=True))
    assert calls and all(d == jnp.bfloat16 for d in calls)

    prec.set_precision("serving", expect_rebuild=True)
    tdata = {k: torch.from_numpy(np.moveaxis(v, -1, -3) if k in ("keyframe", "frames") else v)
             for k, v in data.items()}
    port = reprojection_loss(torch.from_numpy(np.moveaxis(inv_depth, -1, 1)), tdata,
                             automasking=True).item()
    prec.set_precision("exact", expect_rebuild=True)
    port_exact = reprojection_loss(torch.from_numpy(np.moveaxis(inv_depth, -1, 1)), tdata,
                                   automasking=True).item()
    assert port != port_exact  # the policy reached the warp
    np.testing.assert_allclose(port, j_serving, atol=1e-5)
    np.testing.assert_allclose(port, j_exact, atol=2e-3)
    np.testing.assert_allclose(port_exact, j_exact, atol=1e-5)
