"""The port's stage-4 ``depth_refinement_loss`` and ``depth_aux_mask_loss``
against the JAX package's on the same seeded numpy inputs, on the CPU, with
the helpers and tolerances of ``tests/test_torch_refinement_losses.py``:
every key of the loss dict and the gradients with respect to the mono
predictions, ``cv_mask`` and the stereo predictions, at B=2, 24x32, four
scales, for every option set, and for an all-static and an all-dynamic
``cv_mask``, which give NaN in the same keys and equal, finite gradients.
"""

import numpy as np
import pytest
import torch

from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.losses import LOSSES
from monorec_tpu_torch.losses import monorec_losses as tl
from test_torch_refinement_losses import _compare


@pytest.mark.parametrize("options", [
    (), ("stereo",), ("stereo_repr",), ("stereo", "stereo_repr"), ("no_mono_stereodl",),
    ("stereo", "stereo_repr", "no_mono_stereodl"),
])
def test_depth_refinement_loss_matches_jax(options):
    t_dict, (g_mono, g_cv, g_stereo) = _compare("depth_refinement_loss", options, 24, 32)
    assert np.isfinite(t_dict["loss"].item())
    assert all(np.abs(g).max() > 0 for g in g_mono)
    # Both sparse-depth terms are detached and cv_mask enters through its
    # threshold: no gradient reaches cv_mask or the stereo predictions.
    assert not np.abs(g_cv).any() and not any(np.abs(g).any() for g in g_stereo)


@pytest.mark.parametrize("cv", ["static", "dynamic"])
def test_depth_refinement_loss_nan_keys_and_finite_gradients_match_jax(cv):
    """No moving pixel (ratio 0) or only moving pixels (ratio 1): a masked mean
    over nothing is NaN in the same keys as JAX's; the gradients stay
    finite and equal."""
    t_dict, (g_mono, _, _) = _compare("depth_refinement_loss", ("stereo", "stereo_repr"), 24, 32,
                                      cv=cv, seed=3)
    nan = {k for k, v in t_dict.items() if torch.isnan(v).item()}
    assert "loss" in nan and nan == {k for k in nan if k.startswith(
        ("loss", "sdl_", "md2l_", "static_md2l_", "dynamic_md2l_"))}
    assert all(np.isfinite(g).all() and np.abs(g).max() > 0 for g in g_mono)


def test_depth_aux_mask_loss_matches_jax():
    t_dict, (g_mono, g_cv, _) = _compare("depth_aux_mask_loss", (), 24, 32, seed=5)
    assert np.isfinite(t_dict["loss"].item())
    assert all(np.abs(g).max() > 0 for g in g_mono) and not np.abs(g_cv).any()


def test_refinement_losses_are_registered_for_configs():
    for name in ("mask_refinement_loss", "depth_refinement_loss", "depth_aux_mask_loss"):
        assert LOSSES[name] is getattr(tl, name)
        assert config_mod.build_loss({"loss": name}) is LOSSES[name]
