"""One stage-3 and one stage-4 step of the port against the JAX package on
the CPU, at B=2, 32x64, D=4, F=2, on flax weights carried across by
``state_dict_from_flax``: ``MonoRecTrainer._feed`` with the stage's real
loss and its gradient, against JAX ``MonoRecTrainer._feed`` and
``jax.grad``.

* Stage 3 (``monorec_mask_ref.json``): pretrain mode 0, the depth flip,
  mono and stereo predictions, ``mask_refinement_loss -o mask_loss``; the
  MaskModule and the DepthModule train.
* Stage 4 (``monorec_depth_ref.json``): the mask on the cost volume
  (``mult_mask_on_cv``), ``freeze_module: ["att"]``,
  ``depth_refinement_loss -o stereo stereo_repr``; the DepthModule trains.

The draws are injected into both packages, and the conv biases drawn
non-zero, with the helpers of ``tests/test_torch_monorec_trainer.py`` (see
its docstring for why).

Tolerances: that file's forward budget, rtol 1e-3 / atol 2e-4, for every
key of the loss dict and, with the atol scaled by each tensor's largest
gradient, for the MaskModule's gradients. The loss's gradient with respect
to the mono predictions, each package's on its own forward, within 1e-4 of
its largest value (3.1e-5 measured at stage 4). The DepthModule's gradients
within 1e-3 of each tensor's largest gradient at stage 3, the budget of
``tests/test_torch_train.py``'s stage-1 step, and 2e-3 at stage 4: there the
median tensor agrees within 9e-6 of its largest gradient, but two decoder
tensors next to the output part by up to 1.03e-3, where the forward's ~1e-4
cost-volume differences (under the mask's attenuation) put pre-activations
on the two sides of the LeakyReLU's kink, whose slopes are 1 and 0.1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monorec_tpu.train.monorec_trainer as j_trainer_mod
import test_torch_monorec_trainer as base
from monorec_tpu.losses import monorec_losses as jl
from monorec_tpu_torch.convert import state_dict_from_flax
from monorec_tpu_torch.data.synthetic import batch_to_torch
from monorec_tpu_torch.losses import LOSSES

STAGES = {
    "stage3": (dict(compute_mono_pred=True, compute_stereo_pred=True), {},
               "mask_refinement_loss", ("mask_loss",), ("att_module.", "depth_module.")),
    "stage4": (dict(compute_stereo_pred=True, mult_mask_on_cv=True), {"freeze_module": ("att",)},
               "depth_refinement_loss", ("stereo", "stereo_repr"), ("depth_module.",)),
}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_refinement_step_matches_jax_feed_and_grad(monkeypatch, tmp_path, stage):
    flags, arch, loss, options, trained = STAGES[stage]
    base._patch_flip(monkeypatch, (True, False))
    calls = base._patch_dropout(monkeypatch, base._keep_masks(11))
    v = base._flax_variables(0)
    ns = base._jax_trainer(0, flags, augmentation="depth", **arch)
    ns.loss_fn, ns.options = getattr(jl, loss), options
    nb = base._batch_cached(1)
    jb = {k: jnp.asarray(x) for k, x in nb.items()}

    def losses(params):
        loss_dict, data = j_trainer_mod.MonoRecTrainer._feed(
            ns, params, v["batch_stats"], jb, jax.random.PRNGKey(0), True, 0.5)
        return loss_dict["loss"], (loss_dict, data)

    (_, (j_dict, j_data)), j_grads = jax.jit(jax.value_and_grad(losses, has_aux=True))(
        v["params"])
    j_grads = jax.tree_util.tree_map(np.asarray, j_grads)
    j_pred_grads = jax.grad(lambda m: getattr(jl, loss)(
        {**j_data, "mono_pred": m}, 0.5, None, options)["loss"])(list(j_data["mono_pred"]))

    trainer = base._trainer(tmp_path, 0, flags, 1, augmentation="depth",
                            freeze_module=list(arch.get("freeze_module", ())))
    trainer.loss_fn, trainer.options = LOSSES[loss], options
    trainer.model.train()
    t_dict, t_data = trainer._feed(batch_to_torch(nb, "cpu"), True, 0.5)
    trainer.optimizer.zero_grad(set_to_none=True)
    t_dict["loss"].backward()
    assert calls == {"port": 5, "jax": 5}

    assert set(t_dict) == set(j_dict)
    for key in j_dict:
        base._close(t_dict[key], j_dict[key], key)
    assert np.isfinite(t_dict["loss"].item())

    data = {k: ([p.detach() for p in x] if isinstance(x, list) else
                x.detach() if isinstance(x, torch.Tensor) else x) for k, x in t_data.items()}
    preds = [p.clone().requires_grad_() for p in data["mono_pred"]]
    LOSSES[loss]({**data, "mono_pred": preds}, 0.5, None, options)["loss"].backward()
    for i, (p, g) in enumerate(zip(preds, j_pred_grads)):
        want = base._nchw(g)
        base._close(p.grad, want, f"d loss / d mono_pred[{i}]", 0, 1e-4 * np.abs(want).max())

    ref = state_dict_from_flax(j_grads, v["batch_stats"])
    checked = 0
    for key, param in trainer.model.named_parameters():
        if not key.startswith(trained):
            assert param.grad is None, key  # the frozen encoder, and stage 4's MaskModule
            continue
        want = ref[key].numpy()
        assert np.isfinite(param.grad.numpy()).all(), key
        if key.startswith("depth_module."):
            budget = 1e-3 if stage == "stage3" else 2e-3
            base._close(param.grad, want, key, 0, budget * np.abs(want).max())
        else:
            base._close(param.grad, want, key, base.RTOL, base.ATOL * np.abs(want).max())
        checked += 1
    assert checked > (60 if stage == "stage3" else 25)
