"""The port's stage-2 ``mask_loss`` against the JAX package's
(``monorec_tpu/losses/monorec_losses.py``) on the same numpy inputs at
B=2..4, 32x64: the class-balanced BCE with and without
``multiplicative_weight_mask``, masks that saturate at 0 and 1 (the -100
clamp of each log term), and the four stats, among them the empty-mask and
empty-union cases of the finite convention (``PARITY.md:319-329``).

Tolerances: the loss rtol 1e-5 against the exact (float64) mean of the JAX
function's own float32 per-pixel terms (``mask_loss`` on one pixel is that
pixel's term). The JAX package's float32 mean sums its terms one after
another, which on these inputs lies outside rtol 1e-5 of that exact mean;
the port's float32 mean lies inside. The gradient
with respect to ``cv_mask`` (elementwise, both float32) rtol 1e-5, atol
1e-7 for its zeros. The stats acc, prec, rec and iou count the same
thresholded pixels; their batch means agree to one float32 ulp (rtol
2.5e-7): XLA divides a sum by its count as a multiplication by the count's
reciprocal, torch divides. The cases with a known answer (1 for an empty
union, 0 for a miss) are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorec_tpu.losses.monorec_losses import mask_loss as j_mask_loss
from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.losses import LOSSES, mask_loss

H, W = 32, 64
STATS = ("acc", "prec", "rec", "iou")


def _inputs(b: int, seed: int, weight: bool = False, saturate: bool = False):
    rng = np.random.default_rng(seed)
    gt = (rng.uniform(0, 1, (b, H, W, 1)) > 0.9).astype(np.float32)
    cv = rng.uniform(0, 1, (b, H, W, 1)).astype(np.float32)
    if saturate:
        cv[:, :4] = 0.0
        cv[:, 4:8] = 1.0
    data = {"mvobj_mask": gt, "cv_mask": cv}
    if weight:
        data["multiplicative_weight_mask"] = rng.uniform(0, 2, (b, H, W, 1)).astype(np.float32)
    return data


def _jax_exact_mean(data) -> float:
    """The float64 mean of the JAX function's float32 per-pixel terms."""
    pixels = {k: jnp.asarray(v.reshape(-1, 1, 1, 1, 1)) for k, v in data.items()}
    terms = jax.vmap(lambda d: j_mask_loss(d)["loss"])(pixels)
    return float(np.asarray(terms, np.float64).mean())


def _compare(data):
    j_out = j_mask_loss({k: jnp.asarray(v) for k, v in data.items()})
    t_data = {k: torch.from_numpy(np.moveaxis(v, -1, 1)) for k, v in data.items()}
    t_out = mask_loss(t_data)
    assert set(t_out) == set(j_out) == {"loss", *STATS}
    np.testing.assert_allclose(t_out["loss"].item(), _jax_exact_mean(data), rtol=1e-5)
    for k in STATS:
        np.testing.assert_allclose(t_out[k].item(), float(j_out[k]), rtol=2.5e-7, atol=0,
                                   err_msg=k)
    return t_out


@pytest.mark.parametrize("weight,saturate", [(False, False), (True, False), (False, True)])
def test_mask_loss_matches_jax(weight, saturate):
    out = _compare(_inputs(3, 0, weight, saturate))
    assert np.isfinite(out["loss"].item())


def test_mask_loss_gradient_matches_jax():
    data = _inputs(2, 1, weight=True, saturate=True)

    def j_loss(cv):
        return j_mask_loss({**{k: jnp.asarray(v) for k, v in data.items()}, "cv_mask": cv})["loss"]

    ref = np.asarray(jax.grad(j_loss)(jnp.asarray(data["cv_mask"])))
    t_data = {k: torch.from_numpy(np.moveaxis(v, -1, 1)) for k, v in data.items()}
    cv = t_data["cv_mask"].clone().requires_grad_()
    mask_loss({**t_data, "cv_mask": cv})["loss"].backward()
    np.testing.assert_allclose(cv.grad.numpy(), np.moveaxis(ref, -1, 1), rtol=1e-5, atol=1e-7)


def test_mask_stats_empty_mask_and_empty_union():
    """Sample 0: nothing moves and nothing is predicted (empty union: prec,
    rec, iou 1). Sample 1: nothing moves, something is predicted (prec 0).
    Sample 2: something moves, nothing is predicted (rec 0, prec 1).
    Sample 3: a partial hit."""
    gt = np.zeros((4, H, W, 1), np.float32)
    cv = np.full((4, H, W, 1), 0.2, np.float32)
    cv[1, :4, :4] = 0.9
    gt[2, 8:12, 8:12] = 1.0
    gt[3, :8, :8] = 1.0
    cv[3, 4:12, 4:12] = 0.7
    out = _compare({"mvobj_mask": gt, "cv_mask": cv})
    inter, pred, moving = 16.0, 64.0, 64.0
    for i, (prec, rec, iou) in enumerate(((1.0, 1.0, 1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0))):
        one = {"mvobj_mask": gt[i : i + 1], "cv_mask": cv[i : i + 1]}
        j_one = j_mask_loss({k: jnp.asarray(v) for k, v in one.items()})
        t_one = mask_loss({k: torch.from_numpy(np.moveaxis(v, -1, 1)) for k, v in one.items()})
        for k, want in (("prec", prec), ("rec", rec), ("iou", iou)):
            assert t_one[k].item() == float(j_one[k]) == want, (i, k)
    np.testing.assert_allclose(out["prec"].item(), (1 + 0 + 1 + inter / pred) / 4, rtol=1e-6)
    np.testing.assert_allclose(out["rec"].item(), (1 + 1 + 0 + inter / moving) / 4, rtol=1e-6)
    np.testing.assert_allclose(out["iou"].item(), (1 + 0 + 0 + inter / (pred + moving - inter)) / 4,
                               rtol=1e-6)


def test_mask_loss_is_registered_for_configs():
    assert LOSSES["mask_loss"] is mask_loss
    assert config_mod.build_loss({"loss": "mask_loss"}) is mask_loss
