"""All 33 depth metric names of the port against the JAX package's, and
``median_scaling``, on the same numpy inputs (NHWC for JAX, NCHW for the
port): predictions with exact zeros, GT with zeros and with depths beyond
``max_distance``, a moving-object mask, with and without an ``roi``.
Tolerances: metrics rtol 1e-5 / atol 1e-6 (inf and NaN where JAX gives
them, without ``max_distance``), median scaling rtol 1e-6.

The ``_sparse_onlydynamic`` metrics run without an roi: the JAX package
does not crop the moving-object mask to it, so there an roi does not
broadcast (the port keeps that)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorec_tpu.metrics.depth_metrics import METRICS as J_METRICS
from monorec_tpu.utils import median_scaling as j_median_scaling
from monorec_tpu_torch.metrics import METRICS, get_metric
from monorec_tpu_torch.utils import median_scaling

B, H, W = 3, 24, 40
ROI = (2, 20, 3, 30)


def _inputs(seed=9):
    rng = np.random.default_rng(seed)
    result = rng.uniform(0.0, 0.4, (B, H, W, 1)).astype(np.float32)
    result[rng.uniform(size=result.shape) < 0.1] = 0.0
    target = rng.uniform(0.005, 0.4, (B, H, W, 1)).astype(np.float32)
    target[rng.uniform(size=target.shape) < 0.3] = 0.0
    target[rng.uniform(size=target.shape) < 0.1] = 0.01  # beyond max_distance 80
    mvobj = (rng.uniform(size=(B, H, W, 1)) < 0.4).astype(np.float32)
    return {"result": result, "target": target, "mvobj_mask": mvobj}


def test_the_registry_has_the_jax_names():
    assert sorted(METRICS) == sorted(J_METRICS) and len(METRICS) == 33


@pytest.mark.parametrize("name", sorted(J_METRICS))
def test_metric_matches_jax(name):
    nhwc = _inputs()
    j_data = {k: jnp.asarray(v) for k, v in nhwc.items()}
    t_data = {k: torch.from_numpy(np.moveaxis(v, -1, 1).copy()) for k, v in nhwc.items()}
    fn = get_metric(name)
    assert fn.__name__ == name
    rois = [None] if "onlydynamic" in name else [None, ROI]
    for roi in rois:
        for max_distance in (80, None):
            got = fn(t_data, roi, max_distance).item()
            want = float(J_METRICS[name](j_data, roi, max_distance))
            # Without max_distance a zero depth makes some of them inf or NaN:
            # then both must be.
            assert np.isfinite(want) or max_distance is None, (name, roi)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} roi={roi} max_distance={max_distance}")


def test_median_scaling_matches_jax():
    nhwc = _inputs(4)
    result, target = nhwc["result"] + 0.01, nhwc["target"]
    target[1, :, :, :] = 0.0  # no valid pixel: NaN in both
    target[2, 0, 0, 0] = 0.0
    target[2, 0, 1, 0] = 0.2  # one sample with an even count, one with an odd
    assert (target[0] > 0).sum() % 2 != (target[2] > 0).sum() % 2
    want = np.asarray(j_median_scaling(jnp.asarray(result), jnp.asarray(target)))
    got = median_scaling(torch.from_numpy(np.moveaxis(result, -1, 1).copy()),
                         torch.from_numpy(np.moveaxis(target, -1, 1).copy())).numpy()
    np.testing.assert_allclose(got, np.moveaxis(want, -1, 1), rtol=1e-6)
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()
