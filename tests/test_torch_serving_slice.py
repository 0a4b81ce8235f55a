"""The slice under the serving precision policy: the port's eval forward and
one stage-1 training step, against the JAX package run under
``set_precision("serving")`` on the CPU with the same flax weights (carried
across by ``state_dict_from_flax``), at B=2, 32x64, D=4, F=2.

On the CPU the JAX package's XLA paths ignore the two warp dtypes, so only
its ``compute_dtype`` acts there; the port also quantizes the cost-volume
and loss-warp sources to bf16 (its kernels' plain versions). The budget is
the sum of the serving budgets: cost volume 5e-3 (tests/test_torch_serving.py),
loss warp 2e-3, bf16 U-Nets 2e-2 mean-relative (tests/test_torch_precision.py).
Forward: per-frame CVs atol 5e-3; ``result`` and ``cv_mask`` mean |diff| /
mean |ref| < 2e-2 + 5e-3. Step: the loss dict rtol 2e-2 + 2e-3 (the U-Net
term dominates: the loss reads the bf16-computed predictions); the
depth-module gradients finite, every tensor's non-zero, and each tensor's
gradient within 0.1 of the JAX one in cosine distance; one optimizer step
moves every depth-module tensor.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monorec_tpu.models.monorec as j_monorec_mod
import monorec_tpu_torch.models.monorec as t_monorec_mod
from monorec_tpu import precision as j_prec
from monorec_tpu.losses.monorec_losses import depth_loss as j_depth_loss
from monorec_tpu.models import MonoRec as JMonoRec
from monorec_tpu.models import MonoRecConfig as JConfig
from monorec_tpu_torch import precision as prec
from monorec_tpu_torch.convert import state_dict_from_flax
from monorec_tpu_torch.data.loader import collate
from monorec_tpu_torch.data.synthetic import SyntheticSweepDataset, batch_to_torch, make_batch
from monorec_tpu_torch.losses import depth_loss
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from monorec_tpu_torch.train import make_optimizer

B, H, W, D, F = 2, 32, 64, 4, 2
U_NET, CV, LOSS = 2e-2, 5e-3, 2e-3  # the serving budgets
_RNGS = {"dropout": jax.random.PRNGKey(1), "augment": jax.random.PRNGKey(2)}


@pytest.fixture
def serving():
    """Both packages under the serving policy, restored afterwards."""
    saved = (prec._current, prec._consumed), (j_prec._current, j_prec._consumed)
    prec.set_precision("serving", expect_rebuild=True)
    j_prec.set_precision("serving", expect_rebuild=True)
    yield
    (prec._current, prec._consumed), (j_prec._current, j_prec._consumed) = saved


@functools.lru_cache(maxsize=None)
def _flax_variables(pretrain_mode):
    model = JMonoRec(JConfig(cv_depth_steps=D, pretrain_mode=pretrain_mode))
    batch = {k: jnp.asarray(v) for k, v in make_batch(B, H, W, F).items()}
    v = jax.jit(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b, False))(batch)
    return jax.tree_util.tree_map(np.asarray, v)


def _models(pretrain_mode=0, **cfg):
    """The JAX and the port model, each configured by its own policy."""
    kw = dict(cv_depth_steps=D, pretrain_mode=pretrain_mode, **cfg)
    jm = JMonoRec(JConfig(**j_prec.apply_to_model_kwargs(kw)))
    tm = MonoRec(MonoRecConfig(**prec.apply_to_model_kwargs(kw)))
    for c in (jm.config, tm.config):
        assert (c.cv_warp_dtype, c.compute_dtype) == ("bfloat16", "bfloat16")
    v = _flax_variables(pretrain_mode)
    tm.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]))
    return jm, tm, v


def _mean_rel(got, ref):
    return np.abs(got - ref).mean() / np.abs(ref).mean()


def test_serving_forward_matches_jax(serving):
    jm, tm, v = _models()
    nb = make_batch(B, H, W, F, stereo=False, mask=False, seed=11, tz=0.5)
    ref = jax.jit(lambda b: jm.apply(v, b, False))({k: jnp.asarray(x) for k, x in nb.items()})
    with torch.no_grad():
        out = tm.eval()(batch_to_torch(nb, "cpu"))
    np.testing.assert_allclose(out["single_frame_cvs"].numpy(),
                               np.moveaxis(np.asarray(ref["single_frame_cvs"]), -1, 2), atol=CV)
    for key in ("result", "cv_mask"):
        assert out[key].dtype == torch.float32 and torch.isfinite(out[key]).all()
        got, want = out[key].numpy(), np.moveaxis(np.asarray(ref[key]), -1, 1)
        assert _mean_rel(got, want) < U_NET + CV, key


def _batch():
    ds = SyntheticSweepDataset(length=B, target_image_size=(H, W), frame_count=F)
    return collate([ds[i] for i in range(B)])


def test_serving_step_matches_jax(monkeypatch, serving):
    """One stage-1 step (tests/test_torch_train.py::test_stage1_step_matches_jax_grad)
    under the serving policy."""
    cond = np.asarray((True, False))
    monkeypatch.setattr(j_monorec_mod, "sample_flip_conditions", lambda rng, b: jnp.asarray(cond))
    monkeypatch.setattr(t_monorec_mod, "sample_flip_conditions",
                        lambda gen, b: torch.from_numpy(cond))
    jm, tm, v = _models(pretrain_mode=1, augmentation="depth", pretrain_dropout=0.0)
    nb = _batch()
    jb = {k: jnp.asarray(x) for k, x in nb.items()}

    def losses(params):
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jb, True, rngs=_RNGS)
        loss_dict = j_depth_loss({**jb, **out}, 0.5, None, ())
        return loss_dict["loss"], loss_dict

    (_, j_dict), j_grads = jax.jit(jax.value_and_grad(losses, has_aux=True))(v["params"])
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, j_grads), v["batch_stats"])

    batch = batch_to_torch(nb, "cpu")
    out = tm(batch, train=True, generator=torch.Generator().manual_seed(0))
    t_dict = depth_loss({**batch, **out}, 0.5, None, ())
    t_dict["loss"].backward()
    for key in j_dict:
        np.testing.assert_allclose(t_dict[key].detach().numpy(), np.asarray(j_dict[key]),
                                   rtol=U_NET + LOSS, atol=1e-5, err_msg=key)

    params = {k: p for k, p in tm.named_parameters() if k.startswith("depth_module.")}
    assert len(params) > 50
    for key, p in params.items():
        g = p.grad
        assert g is not None and g.dtype == torch.float32 and torch.isfinite(g).all(), key
        assert g.abs().max() > 0, key
        want = ref[key].flatten()
        cos = torch.nn.functional.cosine_similarity(g.flatten(), want, dim=0).item()
        assert cos > 0.9, (key, cos)
    before = {k: p.detach().clone() for k, p in params.items()}
    opt = make_optimizer(list(params.values()), {"type": "Adam", "args": {"lr": 1e-4}})
    opt.step()
    assert all(not torch.equal(p, before[k]) for k, p in params.items())
