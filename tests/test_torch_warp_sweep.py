"""The port's plane-sweep warp K4 (``ops/warp_sweep.py``, its plain version on
the CPU) and the cost-volume path it serves, against the JAX package on the
same seeded numpy inputs: the Pallas kernel ``warp_plane_sweep`` and
``compute_cost_volume(backend="pallas")`` (which takes
``_compute_cost_volume_pallas_warp`` where the fused kernel cannot serve)
in interpret mode, as tests/test_pallas_kernel.py runs them, and the exact
XLA path.

The JAX kernel cannot take bf16 sources in interpret mode on the CPU (its
one-hot gathers become bf16 x bf16 -> f32 dots, which XLA's CPU backend
does not run). Its bf16 contract is float32 sums of the bf16 values,
rounded to bf16 (``warp_kernel.py:286,379``), so the bf16 cases run it on
the bf16-quantized sources in float32 and round its output to bf16
(``_j_warp``), also inside the JAX cost volume.

Budgets: the warp as tests/test_pallas_kernel.py:44-49,70 (warped rtol 1e-4
/ atol 5e-5, wmask atol 5e-5), except where a bf16 stack rounds two float32
sums that straddle a rounding boundary to neighbouring bf16 values (one bf16
step, 2^-9 at |v| <= 0.5, counted and bounded below). Cost volumes: per-frame
CVs within 1.2e-4 of the interpret route for float32 sources (the f32
kernel budget, README.md) and 1e-3 for bf16 sources (the bf16 budget, which
also covers such a rounding step); the fused CV to the same budgets at this
size; both within 5e-3 of the exact XLA path (tests/test_pallas_kernel.py:
117-132).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monorec_tpu.ops.pallas as j_pallas
from monorec_tpu.ops.cost_volume import CostVolumeConfig as JConfig
from monorec_tpu.ops.cost_volume import compute_cost_volume as j_cost_volume
from monorec_tpu.ops.pallas.warp_kernel import warp_plane_sweep as j_warp_plane_sweep
from monorec_tpu_torch.ops import warp_sweep
from monorec_tpu_torch.ops.cost_volume import (
    CostVolumeConfig,
    compute_cost_volume,
    plane_sweep_homographies,
)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
BF16_STEP = 2.0**-9  # one bf16 step at |v| in [0.25, 0.5]


def _j_warp(images, homographies, border_radius=2, interpret=False):
    """The JAX kernel K4 on bf16 sources as it computes them: float32 sums of
    the bf16 values, rounded to the sources' dtype (module doc)."""
    warped, wmask, cov = j_warp_plane_sweep(images.astype(jnp.float32), homographies,
                                            border_radius=border_radius, interpret=interpret)
    return warped.astype(images.dtype), wmask, cov


def _warp_both(images, homs, dtype, border_radius=2):
    """K4 on both sides: (port warped, wmask), (JAX ...) as numpy."""
    tdtype, jdtype = DTYPES[dtype]
    port = warp_sweep.warp_plane_sweep(torch.from_numpy(images).to(tdtype),
                                       torch.from_numpy(homs), border_radius)
    assert port[0].dtype == tdtype and port[1].dtype == torch.float32
    ref = _j_warp(jnp.asarray(images, jdtype), jnp.asarray(homs, jnp.float32),
                  border_radius=border_radius, interpret=True)[:2]
    assert ref[0].dtype == jdtype
    return ([t.float().numpy() for t in port],
            [np.asarray(jnp.asarray(t, jnp.float32)) for t in ref])


def _assert_warps_close(port, ref, dtype):
    (w, m), (rw, rm) = port, ref
    assert w.shape == rw.shape and m.shape == rm.shape
    close = np.isclose(w, rw, rtol=1e-4, atol=5e-5)
    if dtype == "bfloat16":  # neighbouring bf16 roundings of equal-to-1e-5 float32 sums
        assert np.abs(w - rw)[~close].max(initial=0.0) <= BF16_STEP
        assert (~close).mean() <= 1e-2
    else:
        assert close.all(), np.abs(w - rw).max()
    np.testing.assert_allclose(m, rm, atol=5e-5)
    np.testing.assert_array_equal(m != 0, rm != 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [(0.0, 0.0), (3.25, 0.0), (-2.5, 1.0), (17.0, -2.75)])
def test_warp_plane_sweep_known_shift_matches_pallas(shift, dtype):
    """tests/test_pallas_kernel.py:33-50: translations at 16x128."""
    rng = np.random.default_rng(0)
    images = rng.uniform(-0.5, 0.5, (1, 1, 16, 128)).astype(np.float32)
    m = np.eye(3)
    m[0, 2], m[1, 2] = shift
    port, ref = _warp_both(images, m[None, None], dtype)
    _assert_warps_close(port, ref, dtype)


def _cv_args(b=2, h=32, w=128, f=2, seed=0):
    """tests/test_pallas_kernel.py::_cv_args, the same draws, in the port's
    layout: keyframe (B, 3, H, W), keyframe intrinsics and pose, frames
    (B, F, 3, H, W), their intrinsics and poses, as numpy float32."""
    rng = np.random.default_rng(seed)
    k = np.zeros((4, 4), np.float32)
    k[0, 0] = k[1, 1] = 0.8 * w
    k[0, 2], k[1, 2] = w / 2 - 0.5, h / 2 - 0.5
    k[2, 2] = k[3, 3] = 1.0
    kb = np.tile(k, (b, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (b, f, 1, 1))
    for i in range(f):
        poses[:, i, 0, 3] = 0.3 * (i - f / 2 + 0.5)
    keyframe = rng.uniform(-0.5, 0.5, (b, h, w, 3)).astype(np.float32)
    frames = rng.uniform(-0.5, 0.5, (b, f, h, w, 3)).astype(np.float32)
    return (np.moveaxis(keyframe, -1, 1), kb, np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
            np.moveaxis(frames, -1, 2), np.tile(kb[:, None], (1, f, 1, 1)), poses)


INV_MAX, INV_MIN = 0.0025, 0.33  # the model's order: far -> near


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_plane_sweep_homographies_match_pallas(dtype):
    """The plane-sweep homographies of a forward-moving pair at 16x128."""
    args = _cv_args(b=1, h=16, w=128)
    t = [torch.from_numpy(a) for a in args]
    inv = torch.linspace(INV_MAX, INV_MIN, 6, dtype=torch.float64)
    homs = plane_sweep_homographies(t[1], t[2], t[4], t[5], inv, 16, 128).reshape(2, 6, 3, 3)
    images = args[3].reshape(2, 3, 16, 128)
    port, ref = _warp_both(images, homs.numpy(), dtype, border_radius=3)
    _assert_warps_close(port, ref, dtype)


def _port_cv(args, cfg, plain=False):
    fused, sfcv = compute_cost_volume(*(torch.from_numpy(a) for a in args), INV_MAX, INV_MIN,
                                      cfg, plain=plain)
    return fused.numpy(), sfcv.numpy()


@functools.lru_cache(maxsize=None)
def _jax_cv(backend, **cfg):
    args = _cv_args()
    nhwc = [np.moveaxis(args[0], 1, -1), args[1], args[2], np.moveaxis(args[3], 2, -1),
            args[4], args[5]]
    fused, sfcv = j_cost_volume(*(jnp.asarray(a) for a in nhwc), jnp.float32(INV_MAX),
                                jnp.float32(INV_MIN), JConfig(depth_steps=4, **cfg),
                                backend=backend, interpret=backend == "pallas")
    return np.moveaxis(np.asarray(fused), -1, 1), np.moveaxis(np.asarray(sfcv), -1, 2)


@pytest.mark.parametrize("warp_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_ssim", [1, 0])
@pytest.mark.parametrize("variant", [{"sfcv_mult_mask": False}, {"patch_size": 5}])
def test_warp_cost_volume_matches_pallas_and_xla(monkeypatch, variant, use_ssim, warp_dtype):
    monkeypatch.setattr(j_pallas, "warp_plane_sweep", _j_warp)
    cfg = dict(variant, use_ssim=use_ssim)
    before = warp_sweep.warp_plane_sweep.launches, warp_sweep.warp_plane_sweep.launches_bf16
    fused, sfcv = _port_cv(_cv_args(), CostVolumeConfig(depth_steps=4, warp_dtype=warp_dtype,
                                                        **cfg))
    # On CPU tensors K4 runs its plain version: no kernel launch.
    assert (warp_sweep.warp_plane_sweep.launches,
            warp_sweep.warp_plane_sweep.launches_bf16) == before
    tol = 1.2e-4 if warp_dtype == "float32" else 1e-3
    fused_p, sfcv_p = _jax_cv("pallas", warp_dtype=warp_dtype, **cfg)
    np.testing.assert_allclose(sfcv, sfcv_p, atol=tol)
    np.testing.assert_allclose(fused, fused_p, atol=tol)
    fused_x, sfcv_x = _jax_cv("xla", **cfg)
    np.testing.assert_allclose(sfcv, sfcv_x, atol=5e-3)
    np.testing.assert_allclose(fused, fused_x, atol=5e-3)
    if warp_dtype == "float32":  # the plain path serves the same configuration
        fused_plain, sfcv_plain = _port_cv(_cv_args(), CostVolumeConfig(depth_steps=4, **cfg),
                                           plain=True)
        np.testing.assert_allclose(sfcv, sfcv_plain, atol=1.2e-4)
        np.testing.assert_allclose(fused, fused_plain, atol=1.2e-4)
