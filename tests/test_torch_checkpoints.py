"""The port's checkpoint loader (``train/checkpoints.py``) on the reference's
own files: the dict its trainer saves (``{arch, epoch, state_dict,
optimizer, monitor_best, config}`` with the pickled
``parse_config.ConfigParser`` and its ``PosixPath`` folders), its
``module.`` (``DataParallel``) and ``0.`` (``Sequential(model, loss)``)
keys with digit-led ones among them, and a bare state dict, each in the zip
and in the legacy (before torch 1.6) format.

The ``parse_config`` and ``utils.parse_config`` modules exist in this
process only while a file is saved, as on a machine with the reference's
code: the loader never imports them. The loaded tensors equal
``monorec_tpu.convert._strip_data_parallel``'s on the same dict; a model
loaded from each file through ``load_submodule_state`` and
``init_model_with_checkpoints`` gives the flax forward of the JAX package's
conversion of that file (``convert_state_dict``), within
tests/test_torch_variants.py's tolerances (32x64, D=8, F=2, B=1). Any
other global raises naming it; ``resume`` refuses a reference file.
"""

import collections
import functools
import os
import pathlib
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorec_tpu.convert import _strip_data_parallel, convert_state_dict
from monorec_tpu.models import MonoRec as JMonoRec
from monorec_tpu.models import MonoRecConfig as JConfig
from monorec_tpu_torch.cli import train as train_cli
from monorec_tpu_torch.cli.common import init_model_with_checkpoints
from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from monorec_tpu_torch.train import checkpoints
from monorec_tpu_torch.train.checkpoints import (
    ReferenceConfig, load_checkpoint, load_submodule_state, save_checkpoint, state_dict)

B, H, W, F, D = 1, 32, 64, 2, 8
CV_ATOL, MASK_ATOL = 2e-4, 2e-3
RESULT_RTOL, RESULT_ATOL = 1e-3, 2e-4
FORMATS = {"zip": True, "legacy": False}
CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


@functools.lru_cache(maxsize=None)
def _weights():
    """A seeded port model's state dict: the reference's weights."""
    torch.manual_seed(3)
    return MonoRec(MonoRecConfig(cv_depth_steps=D)).state_dict()


def _config_parser_module(name: str):
    """A module ``name`` with the reference's ``ConfigParser``: its config
    an OrderedDict, its folders PosixPaths."""
    module = types.ModuleType(name)

    class ConfigParser:
        def __init__(self):
            self._config = collections.OrderedDict(
                name="MonoRec", arch={"type": "MonoRecModel", "args": {"cv_depth_steps": D}})
            self.resume = pathlib.PosixPath("saved/models/MonoRec/checkpoint.pth")
            self._save_dir = pathlib.PosixPath("saved/models/MonoRec/0101_000000")
            self._log_dir = pathlib.PosixPath("saved/log/MonoRec/0101_000000")
            self.log_levels = {0: 30, 1: 20, 2: 10}

    ConfigParser.__module__ = name
    ConfigParser.__qualname__ = "ConfigParser"
    module.ConfigParser = ConfigParser
    return module


def _reference_dict(kind: str):
    """What the reference's trainer saves, its keys as ``kind`` writes them."""
    weights = _weights()
    if kind == "data_parallel":
        sd = {f"module.{k}": v for k, v in weights.items()}
    else:  # Sequential(model, loss): the model under 0., the loss's tensors under 1.
        sd = {f"0.{k}": v for k, v in weights.items()}
        sd.update({"1.ssim_window": torch.ones(3), "1.loss.weight": torch.ones(2)})
    return sd


def _save(tmp_path, monkeypatch, kind: str, fmt: str, config_module="parse_config"):
    """A file of ``kind`` in ``fmt``; returns (its path, the state dict in it)."""
    path = tmp_path / f"{kind}_{fmt}.pth"
    if kind == "bare":
        sd = dict(_weights())
        torch.save(sd, path, _use_new_zipfile_serialization=FORMATS[fmt])
        return path, sd
    sd = _reference_dict(kind)
    module = _config_parser_module(config_module)
    with monkeypatch.context() as m:
        if "." in config_module:
            m.setitem(sys.modules, "utils", types.ModuleType("utils"))
        m.setitem(sys.modules, config_module, module)
        torch.save({"arch": "DataParallel" if kind == "data_parallel" else "MonoRecModel",
                    "epoch": 7, "state_dict": sd, "optimizer": {"state": {}, "param_groups": []},
                    "monitor_best": 0.0625, "config": module.ConfigParser()},
                   path, _use_new_zipfile_serialization=FORMATS[fmt])
    assert config_module not in sys.modules
    return path, sd


KINDS = ["data_parallel", "sequential", "bare"]


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("kind", KINDS)
def test_reference_file_loads_like_the_jax_converter(tmp_path, monkeypatch, kind, fmt):
    path, sd = _save(tmp_path, monkeypatch, kind, fmt)
    if fmt == "legacy":
        assert not path.read_bytes().startswith(b"PK")
    payload = load_checkpoint(path)
    got = state_dict(payload)
    want = _strip_data_parallel({k: v.numpy() for k, v in sd.items()})
    assert list(got) == list(want) == list(_weights())
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    if kind != "bare":
        config = payload["config"]
        assert type(config) is ReferenceConfig and payload["epoch"] == 7
        assert config._save_dir == pathlib.PosixPath("saved/models/MonoRec/0101_000000")
        assert config._config["arch"]["args"] == {"cv_depth_steps": D}
        assert isinstance(config._config, collections.OrderedDict)


def test_utils_parse_config_class_path_loads(tmp_path, monkeypatch):
    """The ConfigParser under ``utils.parse_config`` (the module's other
    home in the pytorch-template layout)."""
    path, _ = _save(tmp_path, monkeypatch, "data_parallel", "zip", "utils.parse_config")
    payload = load_checkpoint(path)
    assert type(payload["config"]) is ReferenceConfig
    assert isinstance(payload["config"]._log_dir, pathlib.PosixPath)


@functools.lru_cache(maxsize=None)
def _flax_forward(fmt_kind):
    """The JAX package's forward on its conversion of the reference's dict."""
    sd = {k: v.numpy() for k, v in _reference_dict(fmt_kind).items()}
    params, batch_stats, unused = convert_state_dict(sd)
    assert unused == []
    model = JMonoRec(JConfig(cv_depth_steps=D))
    batch = {k: jnp.asarray(v) for k, v in make_batch(B, H, W, F, seed=11, tz=0.5).items()}
    out = jax.jit(lambda v, b: model.apply(v, b, False))(
        {"params": params, "batch_stats": batch_stats}, batch)
    return jax.tree_util.tree_map(np.asarray, out)


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("kind", KINDS)
def test_model_from_reference_file_matches_flax(tmp_path, monkeypatch, kind, fmt):
    """Through the inference example's loader and the CLIs' handoff
    (``checkpoint_location``), a fresh model takes every tensor of the
    file, and its forward is the JAX package's on the same weights."""
    path, _ = _save(tmp_path, monkeypatch, kind, fmt)
    torch.manual_seed(0)
    model = MonoRec(MonoRecConfig(cv_depth_steps=D))
    assert len(load_submodule_state(model, [path])) == len(_weights())
    handoff = init_model_with_checkpoints(MonoRecConfig(cv_depth_steps=D),
                                          {"checkpoint_location": [str(path)]}, "cpu")
    for other in (model, handoff):
        for k, v in _weights().items():
            assert torch.equal(other.state_dict()[k], v), k
    with torch.no_grad():
        out = model.eval()(batch_to_torch(make_batch(B, H, W, F, seed=11, tz=0.5), "cpu"))
    ref = _flax_forward("data_parallel")
    np.testing.assert_allclose(out["cost_volume"].numpy(), _nchw(ref["cost_volume"]),
                               rtol=0, atol=CV_ATOL)
    np.testing.assert_allclose(out["cv_mask"].numpy(), _nchw(ref["cv_mask"]), rtol=0,
                               atol=MASK_ATOL)
    np.testing.assert_allclose(out["result"].numpy(), _nchw(ref["result"]), rtol=RESULT_RTOL,
                               atol=RESULT_ATOL)


class _Evil:
    def __reduce__(self):
        return os.system, ("true",)


def _evil_module():
    module = types.ModuleType("evil")

    class Thing:
        pass

    Thing.__module__, Thing.__qualname__ = "evil", "Thing"
    module.Thing = Thing
    return module


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("what", ["os_system", "evil_thing"])
def test_any_other_global_raises_naming_it(tmp_path, monkeypatch, what, fmt):
    path = tmp_path / "x.pth"
    if what == "os_system":
        obj, name = _Evil(), f"{os.system.__module__}.system"
    else:
        module = _evil_module()
        monkeypatch.setitem(sys.modules, "evil", module)
        obj, name = module.Thing(), "evil.Thing"
    torch.save({"state_dict": dict(_weights()), "config": obj}, path,
               _use_new_zipfile_serialization=FORMATS[fmt])
    monkeypatch.delitem(sys.modules, "evil", raising=False)
    with pytest.raises(pickle.UnpicklingError, match=rf"the class {name}: this loader reads only "
                       "tensors, containers and the reference's parse_config.ConfigParser"):
        load_checkpoint(path)
    with pytest.raises(pickle.UnpicklingError, match=name):
        load_submodule_state(MonoRec(MonoRecConfig(cv_depth_steps=D)), [path])


def test_a_file_without_tensors_raises(tmp_path):
    path = tmp_path / "x.pth"
    torch.save({"epoch": 1, "note": "no weights"}, path)
    with pytest.raises(ValueError, match="holds a 'state_dict' or only tensors"):
        load_submodule_state(MonoRec(MonoRecConfig(cv_depth_steps=D)), [path])


def _trainer(tmp_path):
    import json

    with open(CONFIGS / "smoke" / "train_synthetic.json") as f:
        config = json.load(f)
    config["arch"]["args"].update(cv_depth_steps=4)
    config["data_loader"]["args"].update(length=4, batch_size=2, target_image_size=[32, 64])
    config["trainer"].update(save_dir=str(tmp_path / "runs"), module_timing=False,
                             tensorboard=False)
    return train_cli.build_trainer(config, "cpu")


@pytest.mark.parametrize("kind", ["data_parallel", "bare"])
def test_resume_refuses_a_reference_file(tmp_path, monkeypatch, kind):
    path, _ = _save(tmp_path, monkeypatch, kind, "zip")
    with pytest.raises(ValueError, match="not a checkpoint of one of the port's runs.*"
                                         "checkpoint_location"):
        _trainer(tmp_path).resume(path)


def test_port_file_loads_as_before(tmp_path):
    """The port's own format: the same dict back, its config a dict, and
    ``resume`` continuing from it."""
    trainer = _trainer(tmp_path)
    path = save_checkpoint(tmp_path / "own.pth", trainer.model, trainer.optimizer, 2, 0.5,
                           trainer.config)
    payload = load_checkpoint(path)
    assert set(payload) == {"arch", "epoch", "state_dict", "optimizer", "monitor_best", "config"}
    assert payload["config"] == trainer.config and payload["arch"] == "MonoRec"
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(state_dict(payload)[k], v), k
    again = _trainer(tmp_path)
    again.resume(path)
    assert again.start_epoch == 3 and again.mnt_best == 0.5


def test_strip_matches_the_jax_converter_on_edge_keys():
    """``module.`` cut from every key once one has it; ``0.`` cut after it;
    digit-led keys dropped after both."""
    sd = {"module.a": 1, "module.0.c": 3, "module.1.d": 4, "module.0.0.e": 5}
    assert checkpoints.strip_data_parallel(sd) == _strip_data_parallel(sd)
    sd = {"0.a": 1, "1.b": 2, "c.0": 3, "0.module.d": 4}
    assert checkpoints.strip_data_parallel(sd) == _strip_data_parallel(sd)
