"""The port's precision policy (``monorec_tpu_torch.precision``) against the
JAX package's (``monorec_tpu.precision``), its config plumbing, and the bf16
U-Nets of the serving policy against flax ``compute_dtype="bfloat16"`` on
the same converted weights, at B=2, 32x64, D=4, F=2 on the CPU.

The U-Net comparison pins ``cv_warp_dtype="float32"`` on both sides: the
JAX XLA cost volume ignores the warp dtype, so only ``compute_dtype`` acts.
Budgets (``tests/test_models.py::test_bfloat16_compute_dtype_close_to_f32``):
port-bf16 against flax-bf16 mean |diff| / mean |ref| < 1e-2 (two bf16
implementations that round at different places); each bf16 forward against
its own float32 forward < 2e-2.
"""

import functools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorec_tpu import precision as j_prec
from monorec_tpu.models import MonoRec as JMonoRec
from monorec_tpu.models import MonoRecConfig as JConfig
from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch import precision as prec
from monorec_tpu_torch.convert import state_dict_from_flax
from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
from monorec_tpu_torch.models import MonoRec, MonoRecConfig

B, H, W, F, D = 2, 32, 64, 2, 4


@pytest.fixture
def policy():
    """The port's policy module, restored afterwards (it is process-wide)."""
    saved = prec._current, prec._consumed
    yield prec
    prec._current, prec._consumed = saved


@pytest.mark.parametrize("name", ["exact", "serving"])
def test_policies_equal_the_jax_policies(policy, name):
    assert set(policy.POLICIES) == set(j_prec.POLICIES)
    assert policy.POLICIES[name] == j_prec.POLICIES[name]
    j_saved = j_prec._current, j_prec._consumed
    try:
        j_prec.set_precision(name, expect_rebuild=True)
        want = jnp.dtype(j_prec.loss_warp_dtype()).name
    finally:
        j_prec._current, j_prec._consumed = j_saved
    policy.set_precision(name, expect_rebuild=True)
    assert policy.loss_warp_dtype() == getattr(torch, want)
    for knob, dtype_name in policy.POLICIES[name].items():
        assert policy.torch_dtype(dtype_name) == getattr(torch, dtype_name), knob
    assert policy.precision_policy() == name


def test_explicit_knobs_win_over_the_policy(policy):
    policy.set_precision("serving", expect_rebuild=True)
    assert policy.apply_to_model_kwargs({}) == {"cv_warp_dtype": "bfloat16",
                                                "compute_dtype": "bfloat16"}
    kw = policy.apply_to_model_kwargs({"cv_warp_dtype": "float32", "cv_depth_steps": 4})
    assert kw == {"cv_warp_dtype": "float32", "compute_dtype": "bfloat16", "cv_depth_steps": 4}
    policy.set_precision("exact", expect_rebuild=True)
    assert policy.apply_to_model_kwargs({"compute_dtype": "bfloat16"})["cv_warp_dtype"] == "float32"


def test_unknown_policy_or_dtype_raises(policy):
    with pytest.raises(ValueError, match="unknown precision policy"):
        policy.set_precision("fast-but-wrong")
    with pytest.raises(ValueError, match="unknown dtype"):
        MonoRecConfig(compute_dtype="float16")
    with pytest.raises(ValueError, match="unknown dtype"):
        policy.torch_dtype("int8")


def test_switching_a_consumed_policy_warns(policy):
    """The JAX package's rule (tests/test_config_eval_export.py): a model
    built under the old policy keeps its dtypes, so switching warns."""
    policy._consumed = None
    policy.set_precision("exact")
    policy.loss_warp_dtype()  # consumed
    with pytest.warns(policy.PrecisionPolicyWarning):
        policy.set_precision("serving")
    with warnings.catch_warnings():
        warnings.simplefilter("error", policy.PrecisionPolicyWarning)
        policy.apply_to_model_kwargs({})  # built after the switch: fine
        policy.set_precision("serving")  # same name: nothing is stale
    with pytest.warns(policy.PrecisionPolicyWarning):
        policy.set_precision("exact")  # the same-name call kept the memory
    policy.loss_warp_dtype()
    with warnings.catch_warnings():
        warnings.simplefilter("error", policy.PrecisionPolicyWarning)
        policy.set_precision("serving", expect_rebuild=True)


def test_config_precision_key_selects_the_policy(policy, tmp_path):
    base = {"name": "prec", "arch": {"type": "MonoRecModel", "args": {"cv_depth_steps": D}}}
    for key, want in (("serving", "bfloat16"), ("exact", "float32"), (None, "float32")):
        cfg = dict(base, **({} if key is None else {"precision": key}))
        path = tmp_path / f"{key}.json"
        path.write_text(json.dumps(cfg))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", policy.PrecisionPolicyWarning)
            loaded = config_mod.load_config(str(path))
        assert policy.precision_policy() == (key or "exact")
        model_cfg = config_mod.build_model_config(loaded["arch"]["args"])
        assert (model_cfg.cv_warp_dtype, model_cfg.compute_dtype) == (want, want)
        assert policy.loss_warp_dtype() == getattr(torch, want)
    policy.set_precision("serving", expect_rebuild=True)
    model_cfg = config_mod.build_model_config({"cv_depth_steps": D, "cv_warp_dtype": "float32"})
    assert (model_cfg.cv_warp_dtype, model_cfg.compute_dtype) == ("float32", "bfloat16")
    assert model_cfg.cv_config().warp_dtype == "float32"


def test_bf16_convolutions_keep_float32_parameters():
    model = MonoRec(MonoRecConfig(cv_depth_steps=D, compute_dtype="bfloat16"),
                    generator=torch.Generator().manual_seed(0))
    exact = MonoRec(MonoRecConfig(cv_depth_steps=D), generator=torch.Generator().manual_seed(0))
    assert model.state_dict().keys() == exact.state_dict().keys()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    batch = batch_to_torch(make_batch(1, H, W, F, stereo=False, mask=False), "cpu")
    out = model(batch)
    sum(p.sum() for p in out["predicted_inverse_depths"]).backward()
    grads = [p.grad for p in model.depth_module.parameters()]
    assert all(g is not None and g.dtype == torch.float32 for g in grads)
    assert out["result"].dtype == out["cv_mask"].dtype == torch.float32


@functools.lru_cache(maxsize=None)
def _flax_variables():
    model = JMonoRec(JConfig(cv_depth_steps=D))
    batch = {k: jnp.asarray(v) for k, v in make_batch(B, H, W, F).items()}
    v = jax.jit(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b, False))(batch)
    return jax.tree_util.tree_map(np.asarray, v)


def _flax_forward(compute_dtype, nb):
    model = JMonoRec(JConfig(cv_depth_steps=D, compute_dtype=compute_dtype,
                             cv_warp_dtype="float32"))
    out = jax.jit(lambda v, b: model.apply(v, b, False))(
        _flax_variables(), {k: jnp.asarray(x) for k, x in nb.items()})
    return {k: np.asarray(out[k]) for k in ("result", "cv_mask")}


def _port_forward(compute_dtype, nb):
    v = _flax_variables()
    model = MonoRec(MonoRecConfig(cv_depth_steps=D, compute_dtype=compute_dtype,
                                  cv_warp_dtype="float32"))
    model.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        out = model.eval()(batch_to_torch(nb, "cpu"))
    for key in ("result", "cv_mask"):
        assert out[key].dtype == torch.float32 and torch.isfinite(out[key]).all()
    return {k: np.moveaxis(out[k].numpy(), 1, -1) for k in ("result", "cv_mask")}


def _mean_rel(got, ref):
    return np.abs(got - ref).mean() / np.abs(ref).mean()


@pytest.mark.parametrize("tz", [0.0, 0.5])
def test_bf16_unets_match_flax_bf16(tz):
    nb = make_batch(B, H, W, F, stereo=False, mask=False, seed=11, tz=tz)
    port16, flax16 = _port_forward("bfloat16", nb), _flax_forward("bfloat16", nb)
    port32, flax32 = _port_forward("float32", nb), _flax_forward("float32", nb)
    for key in ("result", "cv_mask"):
        assert _mean_rel(port16[key], flax16[key]) < 1e-2, key
        assert _mean_rel(port16[key], port32[key]) < 2e-2, key
        assert _mean_rel(flax16[key], flax32[key]) < 2e-2, key
        # The bf16 policy changes the answer: the comparisons above are not vacuous.
        assert not np.array_equal(port16[key], port32[key]), key
