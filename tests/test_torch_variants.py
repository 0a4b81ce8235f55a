"""The port's model variants against the flax ones of the JAX package, on the
same numpy inputs, float32 on the CPU: ResNet-34/50/101/152 encoders, the
MaskModule's ``use_cv`` / ``use_features``, ``SimpleMaskModule``, and the
``simple_mask``, ``no_cv``, ``mask_use_cv`` and ``mask_use_feats`` knobs
through ``MonoRec.forward``, its gradient, the weight conversions, the
trainers' handling of the knobs and the ImageNet encoder files.

Weights: flax variable trees (from ``jax.eval_shape``, no compile) filled
from a numpy seed, every conv bias non-zero (flax starts them at 0, where
torch's and flax's LeakyReLU subgradients part), carried to the port by
``state_dict_from_flax``. Sizes and tolerances are those of
tests/test_torch_models.py and tests/test_torch_slice.py: 32x64, D=8, F=2,
B=1; cost volumes atol 2e-4, cv_mask atol 2e-3, result rtol 1e-3 / atol
2e-4, encoder features rtol 1e-3 / atol 2e-3.
"""

import functools
import inspect
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_reference as tr
from torch_flax import fill, nchw
from chip_smoke import torchvision_resnet
from monorec_tpu.convert import convert_state_dict
from monorec_tpu.models import MonoRec as JMonoRec
from monorec_tpu.models import MonoRecConfig as JConfig
from monorec_tpu.models import pretrained as j_pretrained
from monorec_tpu.models.mask_module import MaskModule as JMask
from monorec_tpu.models.mask_module import SimpleMaskModule as JSimpleMask
from monorec_tpu.models.resnet import ResNetEncoder as JResNet
from monorec_tpu.train.trainer import Trainer as JTrainer
from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch import tracing
from monorec_tpu_torch.cli import train_monorec
from monorec_tpu_torch.convert import state_dict_from_flax
from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
from monorec_tpu_torch.models import MonoRec, MonoRecConfig, pretrained
from monorec_tpu_torch.models.mask_module import MaskModule, SimpleMaskModule
from monorec_tpu_torch.models.resnet import ResNetEncoder, encoder_channels
from monorec_tpu_torch.train import MonoRecTrainer, Trainer

B, H, W, F, D = 1, 32, 64, 2, 8
CV_ATOL, MASK_ATOL = 2e-4, 2e-3
RESULT_RTOL, RESULT_ATOL = 1e-3, 2e-4
FEAT_RTOL, FEAT_ATOL = 1e-3, 2e-3
GRAD_RTOL = 1e-3  # of each parameter's largest |gradient| (tests/test_torch_train.py)
DEPTHS = (18, 34, 50, 101, 152)
BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
          152: (3, 8, 36, 3)}
ENC = "_feature_extractor.encoder."


def _t(a, lead=1):
    return torch.from_numpy(nchw(a, lead).copy())


@functools.lru_cache(maxsize=None)
def _nb():
    return make_batch(B, H, W, F, seed=11, tz=0.5)


def _jb():
    return {k: jnp.asarray(v) for k, v in _nb().items()}


def _jconfig(**cfg):
    return JConfig(cv_depth_steps=D, **cfg)


@functools.lru_cache(maxsize=None)
def _variables(resnet_layers=18, simple_mask=False, seed=0):
    """Filled flax variables of a mode-0 MonoRec (every submodule)."""
    model = JMonoRec(_jconfig(resnet_layers=resnet_layers, simple_mask=simple_mask))
    shapes = jax.eval_shape(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b, False),
                            _jb())
    return fill(shapes, seed)


def _flax_forward(**cfg):
    model = JMonoRec(_jconfig(**cfg))
    v = _variables(cfg.get("resnet_layers", 18), cfg.get("simple_mask", False))
    out = jax.jit(lambda v, b: model.apply(v, b, False))(v, _jb())
    return jax.tree_util.tree_map(np.asarray, out)


def _port(**cfg):
    """The port's MonoRec as the CLIs build it, from ``arch.args``, on the
    flax variables of its tree."""
    model = MonoRec(config_mod.build_model_config(dict(cfg, cv_depth_steps=D)))
    v = _variables(cfg.get("resnet_layers", 18), cfg.get("simple_mask", False))
    sd = state_dict_from_flax(v["params"], v["batch_stats"])
    if not model.config.has_mask_module:
        sd = {k: t for k, t in sd.items() if not k.startswith("att_module.")}
    model.load_state_dict(sd)
    return model.eval()


# ----- the encoders ---------------------------------------------------------------


@pytest.mark.parametrize("layers", [34, 50])
def test_deep_encoder_matches_flax(layers):
    x = np.random.default_rng(layers).uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    module = JResNet(layers)
    v = fill(jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x)), layers)
    port = ResNetEncoder(layers)
    sd = state_dict_from_flax({"encoder": v["params"]}, {"encoder": v["batch_stats"]})
    port.load_state_dict({k[len("_feature_extractor."):]: t for k, t in sd.items()})
    ref = jax.jit(module.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        out = port.eval()(_t(x))
    for i, (p, r, c) in enumerate(zip(out, ref, encoder_channels(layers))):
        assert p.shape == (B, c, H >> (i + 1), W >> (i + 1))
        np.testing.assert_allclose(p.numpy(), nchw(r), rtol=FEAT_RTOL, atol=FEAT_ATOL,
                                   err_msg=f"scale {i}")


def _torchvision_keys(layers):
    """torchvision's ResNet-``layers`` state_dict keys without ``fc.*``, by
    its naming rule."""
    bn = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")
    bottleneck = layers > 34
    convs = (1, 2, 3) if bottleneck else (1, 2)
    keys = {"conv1.weight"} | {f"bn1.{p}" for p in bn}
    for stage, count in enumerate(BLOCKS[layers], 1):
        for b in range(count):
            pre = f"layer{stage}.{b}."
            for c in convs:
                keys |= {f"{pre}conv{c}.weight"} | {f"{pre}bn{c}.{p}" for p in bn}
            if b == 0 and (stage > 1 or bottleneck):
                keys |= {f"{pre}downsample.0.weight"} | {f"{pre}downsample.1.{p}" for p in bn}
    return keys


@pytest.mark.parametrize("layers", DEPTHS)
def test_flax_encoder_converts_to_the_torchvision_layout(layers):
    shapes = jax.eval_shape(JResNet(layers).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, H, W, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_flax({"encoder": zeros["params"]}, {"encoder": zeros["batch_stats"]})
    own = {ENC + k: tuple(t.shape) for k, t in ResNetEncoder(layers).encoder.state_dict().items()}
    assert {k: tuple(t.shape) for k, t in sd.items()} == own
    assert set(own) == {ENC + k for k in _torchvision_keys(layers)}


def test_unknown_resnet_depth_is_refused():
    with pytest.raises(ValueError, match="unsupported resnet depth 26"):
        ResNetEncoder(26)


# ----- the mask modules -----------------------------------------------------------


def _features(seed, channels=encoder_channels(18)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (B, H >> (i + 1), W >> (i + 1), c)).astype(np.float32)
            for i, c in enumerate(channels)]


def _load(port, params, prefix="att_module."):
    sd = state_dict_from_flax({"att": params}, {})
    port.load_state_dict({k[len(prefix):]: t for k, t in sd.items()})
    return port.eval()


@pytest.mark.parametrize("use_cv,use_features", [(False, True), (True, False), (False, False)])
def test_mask_module_inputs_off_match_flax(use_cv, use_features):
    rng = np.random.default_rng(6)
    sfcv = rng.uniform(-1, 1, (B, F, H, W, D)).astype(np.float32)
    feats = _features(7)
    module = JMask(D, use_cv, use_features)
    args = (jnp.asarray(sfcv), [jnp.asarray(f) for f in feats])
    params = fill(jax.eval_shape(module.init, jax.random.PRNGKey(0), *args), 8)["params"]
    port = _load(MaskModule(D, use_cv, use_features), params)
    ref = jax.jit(module.apply)({"params": params}, *args)
    with torch.no_grad():
        out = port(_t(sfcv, 2), [_t(f) for f in feats])
        full = _load(MaskModule(D), params)(_t(sfcv, 2), [_t(f) for f in feats])
    np.testing.assert_allclose(out.numpy(), nchw(ref), rtol=1e-3, atol=MASK_ATOL)
    assert not torch.allclose(out, full)  # the switched-off input mattered


def _simple_mask_inputs():
    rng = np.random.default_rng(0)
    sfcv = rng.uniform(-1, 1, (B, F, H, W, D)).astype(np.float32)
    # Exact zeros, so the non-zero-count averaging is exercised
    # (tests/test_variants.py).
    sfcv[:, 0, : H // 4] = 0.0
    sfcv[:, :, -2:] = 0.0
    keyframe = rng.uniform(-0.5, 0.5, (B, H, W, 3)).astype(np.float32)
    pred = rng.uniform(0.01, 0.3, (B, H, W, 1)).astype(np.float32)
    return sfcv, keyframe, pred, _features(1)


def test_simple_mask_module_matches_flax():
    sfcv, keyframe, pred, feats = _simple_mask_inputs()
    module = JSimpleMask(D)
    args = (jnp.asarray(sfcv), jnp.asarray(keyframe), jnp.asarray(pred),
            [jnp.asarray(f) for f in feats])
    params = fill(jax.eval_shape(module.init, jax.random.PRNGKey(0), *args), 9)["params"]
    port = _load(SimpleMaskModule(D), params)
    ref = jax.jit(module.apply)({"params": params}, *args)
    with torch.no_grad():
        out = port(_t(sfcv, 2), _t(keyframe), _t(pred), [_t(f) for f in feats])
    assert out.shape == (B, 1, H, W)
    np.testing.assert_allclose(out.numpy(), nchw(ref), rtol=1e-3, atol=MASK_ATOL)


def test_simple_mask_module_loads_the_reference_state_dict():
    torch.manual_seed(0)
    oracle = tr.SimpleMaskModule(depth_steps=D).eval()
    port = SimpleMaskModule(D).eval()
    assert list(port.state_dict()) == list(oracle.state_dict())
    port.load_state_dict(oracle.state_dict())
    sfcv, keyframe, pred, feats = _simple_mask_inputs()
    with torch.no_grad():
        want = oracle([_t(sfcv[:, i]) for i in range(F)], _t(keyframe), _t(pred),
                      [_t(f) for f in feats])
        got = port(_t(sfcv, 2), _t(keyframe), _t(pred), [_t(f) for f in feats])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


# ----- the whole forward ----------------------------------------------------------

FORWARDS = {
    "resnet50": dict(resnet_layers=50),
    "simple_mask": dict(simple_mask=True),
    "no_cv_stereo": dict(no_cv=True, use_stereo=True),
    "mask_inputs_off": dict(mask_use_cv=False, mask_use_feats=False),
}


@pytest.mark.parametrize("name", list(FORWARDS))
def test_forward_matches_flax(name):
    cfg = FORWARDS[name]
    ref = _flax_forward(**cfg)
    with torch.no_grad():
        out = _port(**cfg)(batch_to_torch(_nb(), "cpu"))
    assert ("cv_uncovered" in out) == ("cv_uncovered" in ref) == (not cfg.get("no_cv", False))
    n_frames = F + (1 if cfg.get("use_stereo") else 0)
    assert out["single_frame_cvs"].shape == (B, n_frames, D, H, W)
    np.testing.assert_allclose(out["single_frame_cvs"].numpy(),
                               nchw(ref["single_frame_cvs"], 2), atol=CV_ATOL)
    np.testing.assert_allclose(out["cost_volume"].numpy(), nchw(ref["cost_volume"]),
                               atol=CV_ATOL)
    np.testing.assert_allclose(out["cv_mask"].numpy(), nchw(ref["cv_mask"]), atol=MASK_ATOL)
    for p, r in zip(out["predicted_inverse_depths"], ref["predicted_inverse_depths"]):
        np.testing.assert_allclose(p.numpy(), nchw(r), rtol=RESULT_RTOL, atol=RESULT_ATOL)
    np.testing.assert_allclose(out["result"].numpy(), nchw(ref["result"]), rtol=RESULT_RTOL,
                               atol=RESULT_ATOL)
    if cfg.get("no_cv"):
        assert not out["cost_volume"].any() and not out["single_frame_cvs"].any()


def test_simple_mask_mode2_is_mode0s_mask():
    """The JAX package builds no depth module in mode 2, so its simple mask
    cannot run there; the port's mode-2 result is the cv_mask of flax's mode
    0 with the same weights."""
    with pytest.raises(AttributeError, match="depth_net"):
        jax.eval_shape(lambda b: JMonoRec(_jconfig(simple_mask=True, pretrain_mode=2)).init(
            {"params": jax.random.PRNGKey(0)}, b, False), _jb())
    ref = _flax_forward(simple_mask=True)
    with torch.no_grad():
        out = _port(simple_mask=True, pretrain_mode=2)(batch_to_torch(_nb(), "cpu"))
    assert "predicted_inverse_depths" not in out
    np.testing.assert_allclose(out["result"].numpy(), nchw(ref["cv_mask"]), atol=MASK_ATOL)


def test_simple_mask_gradient_matches_jax_grad():
    """d mean(result) / d every trainable parameter, simple_mask mode 0: the
    depth module gets its gradient from the second pass only, since the
    first pass's prediction enters the mask detached."""
    v = _variables(18, True)
    model = JMonoRec(_jconfig(simple_mask=True))
    jb = _jb()

    def mean_result(params):
        return jnp.mean(model.apply({"params": params, "batch_stats": v["batch_stats"]}, jb,
                                    False)["result"])

    j_grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(mean_result))(v["params"]))
    assert not np.abs(j_grads["encoder"]["Conv_0"]["kernel"]).any()  # frozen encoder
    port = _port(simple_mask=True)
    port(batch_to_torch(_nb(), "cpu"))["result"].mean().backward()
    want = state_dict_from_flax(j_grads, v["batch_stats"])
    checked = 0
    for key, param in port.named_parameters():
        if key.startswith("_feature_extractor."):
            assert param.grad is None
            continue
        ref = want[key].numpy()
        # The coarser scales' heads do not reach ``result``: no gradient.
        got = torch.zeros_like(param) if param.grad is None else param.grad
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * np.abs(ref).max(), err_msg=key)
        checked += 1
    assert checked == sum(1 for k, _ in port.named_parameters()
                          if not k.startswith("_feature_extractor.")) > 80


# ----- weights -------------------------------------------------------------------


@pytest.mark.parametrize("layers,simple_mask", [(34, False), (18, True), (50, False)])
def test_weights_round_trip_through_reference_converter(layers, simple_mask):
    """flax -> port -> ``monorec_tpu.convert.convert_state_dict`` gives the
    flax tree back; for a bottleneck encoder, which that converter refuses,
    every other subtree."""
    v = _variables(layers, simple_mask)
    sd = {k: t.numpy() for k, t in _port(resnet_layers=layers,
                                         simple_mask=simple_mask).state_dict().items()}
    back_params, back_stats, unused = convert_state_dict(sd)
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    if layers > 34:
        assert "encoder" not in back_params and unused
        assert all(k.startswith(ENC) for k in unused)
        params.pop("encoder"), stats.pop("encoder")
    else:
        assert unused == []
    flat = jax.tree_util.tree_flatten_with_path
    for a, b in ((params, back_params), (stats, back_stats)):
        (la, ta), (lb, tb) = flat(a), flat(b)
        assert ta == tb
        for (path, x), (_, y) in zip(la, lb):
            assert np.array_equal(x, y), jax.tree_util.keystr(path)


def test_resnet34_imagenet_file_injects_bit_for_bit(tmp_path):
    weights = torchvision_resnet(34, layers=34)
    path = tmp_path / "resnet34.pth"
    torch.save(weights, path)
    model = MonoRec(MonoRecConfig(cv_depth_steps=D, resnet_layers=34),
                    generator=torch.Generator().manual_seed(0))
    assert pretrained.inject_imagenet_encoder(model, path, 34)
    state = model.state_dict()
    for k, value in weights.items():
        if not k.startswith("fc."):
            assert torch.equal(state[ENC + k], value), k


def test_bottleneck_imagenet_file_is_refused_by_both(tmp_path, caplog):
    path = tmp_path / "resnet50.pth"
    torch.save(torchvision_resnet(50, layers=50), path)
    v = _variables(50)
    _, _, j_ok = j_pretrained.inject_imagenet_encoder(dict(v["params"]),
                                                      dict(v["batch_stats"]), str(path), 50)
    model = MonoRec(MonoRecConfig(cv_depth_steps=D, resnet_layers=50),
                    generator=torch.Generator().manual_seed(0))
    before = {k: t.clone() for k, t in model.state_dict().items()}
    assert not j_ok and not pretrained.inject_imagenet_encoder(model, path, 50)
    assert all(torch.equal(t, before[k]) for k, t in model.state_dict().items())
    assert "bottleneck" in caplog.text


# ----- config and trainers --------------------------------------------------------


def test_config_parses_every_variant_key():
    for layers in DEPTHS:
        assert config_mod.build_model_config({"resnet_layers": layers}).resnet_layers == layers
    cfg = config_mod.build_model_config({"simple_mask": True, "no_cv": True,
                                         "mask_use_cv": False, "mask_use_feats": False})
    assert (cfg.simple_mask, cfg.no_cv, cfg.mask_use_cv, cfg.mask_use_feats) == (
        True, True, False, False)
    default = MonoRecConfig()
    assert (default.simple_mask, default.no_cv, default.mask_use_cv, default.mask_use_feats) == (
        JConfig().simple_mask, JConfig().no_cv, JConfig().mask_use_cv, JConfig().mask_use_feats)


def _jax_module_time_keys(**cfg):
    """The keys JAX ``Trainer._module_times`` returns for a config, on a stub
    model (its timed functions return placeholders)."""
    stub = lambda v, *args, method: (jnp.zeros(()), jnp.zeros(()))  # noqa: E731
    fake = types.SimpleNamespace(
        model=types.SimpleNamespace(config=_jconfig(**cfg), apply=stub),
        state=types.SimpleNamespace(params={}, batch_stats={}), _timed_fns=None)
    return set(JTrainer._module_times(fake, {"keyframe": jnp.zeros((1,))}))


@pytest.mark.parametrize("cfg", [{}, {"simple_mask": True}, {"no_cv": True},
                                 {"no_cv": True, "simple_mask": True}, {"pretrain_mode": 1},
                                 {"pretrain_mode": 2}, {"pretrain_mode": 3, "no_cv": True}],
                         ids=str)
def test_module_time_keys_match_the_jax_trainer(cfg):
    """The port times the layers its step runs, from the step's own spans;
    the JAX trainer re-runs them alone and leaves out more: under ``no_cv``
    the mask and depth that the step runs on zero cost volumes, under
    ``simple_mask`` the mask (its re-run would need a depth prediction)."""
    assert "no_cv" in inspect.getsource(JTrainer._module_times)
    config = MonoRecConfig(cv_depth_steps=D, **cfg)
    model = MonoRec(config, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), tracing.capture(False) as recorder:
        model(batch_to_torch(_nb(), "cpu"))
    keys = set(Trainer._module_times(recorder.collect()))
    jax_keys = _jax_module_time_keys(**cfg)
    beyond_jax = set()
    if config.no_cv:
        beyond_jax |= {"mask_module_time"} if config.has_mask_module else set()
        beyond_jax |= {"depth_module_time"} if config.has_depth_module else set()
    if config.simple_mask and config.has_mask_module:
        beyond_jax.add("mask_module_time")
    assert jax_keys <= keys and keys - jax_keys == beyond_jax
    assert all(re.fullmatch(r"(cv|resnet|mask|depth)_module_time", k) for k in keys)


def test_stage2_4_trainer_refuses_simple_mask():
    model = MonoRec(MonoRecConfig(cv_depth_steps=D, simple_mask=True))
    with pytest.raises(NotImplementedError, match="simple_mask"):
        MonoRecTrainer(model, None, [], None, {}, None)


def test_stage2_4_trainer_computes_cost_volumes_under_no_cv(tmp_path):
    data = {"length": B, "batch_size": B, "frame_count": F, "target_image_size": [H, W],
            "return_stereo": True, "return_mvobj_mask": 2, "shuffle": False}
    config = {
        "name": "stage", "loss": "mask_loss", "metrics": [],
        "arch": {"type": "MonoRecModel",
                 "args": {"pretrain_mode": 2, "cv_depth_steps": D, "no_cv": True}},
        "data_loader": {"type": "SyntheticSweepDataloader", "args": data},
        "optimizer": {"type": "Adam", "args": {"lr": 1e-4}},
        "trainer": {"epochs": 1, "save_dir": str(tmp_path), "tensorboard": False,
                    "compute_mono_pred": False, "compute_stereo_pred": False},
    }
    trainer = train_monorec.build_trainer(config, "cpu", run_dir=tmp_path / "run")
    assert trainer.model.config.no_cv
    batch = next(iter(trainer.data_loader))
    with torch.no_grad():
        _, data_out = trainer._feed(dict(batch), False, 0.5)
        cv, _ = trainer.model.cost_volume(batch)
    assert "cv_uncovered" in data_out and data_out["cost_volume"].abs().sum() > 0
    torch.testing.assert_close(data_out["cost_volume"], cv, rtol=0, atol=0)
