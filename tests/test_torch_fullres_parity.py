"""The port's whole forward on the CPU against the JAX package's XLA path
(``monorec_tpu/ops/cost_volume.py``) at full resolution: 256x512, D=32,
F=2, B=1, for the flagship (ResNet-18, pretrain mode 0) and for ResNet-50
with ``simple_mask``. The other parity tests run at 32x128 or smaller.

Weights: the flax variables of each model (from ``jax.eval_shape``) filled
from a numpy seed, carried to the port by ``state_dict_from_flax``.

Budgets: per-frame CVs atol 2e-4; the fused CV 5e-4 (at 256x512 two
float32 implementations part by up to ~4e-4 where both frames' cost
curves are flat, ROADMAP.md); ``cv_mask`` atol 2e-3; the depths and
``result`` rtol 1e-3 / atol 2e-4. Each max |diff| is printed (run with
``-s``). Marked ``slow``: ~1-2 min per model on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorec_tpu.models import MonoRec as JMonoRec
from monorec_tpu.models import MonoRecConfig as JConfig
from monorec_tpu_torch.convert import state_dict_from_flax
from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from torch_flax import fill, nchw

pytestmark = pytest.mark.slow

B, H, W, F, D = 1, 256, 512, 2, 32
SFCV_ATOL, CV_ATOL, MASK_ATOL = 2e-4, 5e-4, 2e-3
RESULT_RTOL, RESULT_ATOL = 1e-3, 2e-4


@pytest.mark.parametrize("cfg", [{}, {"resnet_layers": 50, "simple_mask": True}],
                         ids=["resnet18", "resnet50_simple_mask"])
def test_full_resolution_forward_matches_jax_xla(cfg):
    nb = make_batch(B, H, W, F, seed=7, tz=0.5)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    jm = JMonoRec(JConfig(cv_depth_steps=D, **cfg))
    shapes = jax.eval_shape(lambda b: jm.init({"params": jax.random.PRNGKey(0)}, b, False), jb)
    v = fill(shapes, 13)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(lambda v, b: jm.apply(v, b, False))(v, jb))

    port = MonoRec(MonoRecConfig(cv_depth_steps=D, **cfg))
    port.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        out = port.eval()(batch_to_torch(nb, "cpu"))

    checks = [("single_frame_cvs", nchw(ref["single_frame_cvs"], 2), 0.0, SFCV_ATOL),
              ("cost_volume", nchw(ref["cost_volume"]), 0.0, CV_ATOL),
              ("cv_mask", nchw(ref["cv_mask"]), 0.0, MASK_ATOL)]
    checks += [(f"predicted_inverse_depths[{i}]", nchw(r), RESULT_RTOL, RESULT_ATOL)
               for i, r in enumerate(ref["predicted_inverse_depths"])]
    checks.append(("result", nchw(ref["result"]), RESULT_RTOL, RESULT_ATOL))
    failed = []
    for key, want, rtol, atol in checks:
        got = (out["predicted_inverse_depths"][int(key[-2])] if key.startswith("predicted")
               else out[key]).numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), key
        diff = np.abs(got - want)
        ratio = (diff / (atol + rtol * np.abs(want))).max()
        print(f"{key}: max|diff| {diff.max():.3e}, largest share of the budget {ratio:.3f} "
              f"(rtol {rtol:g}, atol {atol:g})")
        if ratio > 1.0:
            failed.append(key)
    assert not failed, f"over budget: {failed}"
