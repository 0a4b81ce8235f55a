"""The port's ImageNet encoder (``monorec_tpu_torch/models/pretrained.py``)
against the JAX package's (``monorec_tpu/models/pretrained.py``).

A seeded torchvision-keyed ResNet-18 ``.pth`` (``chip_smoke.torchvision_resnet``:
with the classifier ``fc.*``, once with and once without BatchNorm's
``num_batches_tracked``) goes into a
flax init through the JAX ``inject_imagenet_encoder`` and into a port
``MonoRec`` through the port's. The JAX encoder carried over by
``state_dict_from_flax`` equals the port's tensors exactly, and the
encoder's features at 32x64 agree with flax's within rtol 1e-4 plus 1e-5
of each scale's largest value (float32 convolutions in two libraries,
summed in different orders). A ResNet-34-keyed file is refused by both; the
file lookups follow the JAX search order.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import torchvision_resnet
from monorec_tpu.models import MonoRec as JMonoRec
from monorec_tpu.models import MonoRecConfig as JConfig
from monorec_tpu.models import pretrained as j_pretrained
from monorec_tpu_torch.cli.common import init_model_with_checkpoints
from monorec_tpu_torch.convert import state_dict_from_flax
from monorec_tpu_torch.models import MonoRec, MonoRecConfig, pretrained
from monorec_tpu_torch.train.checkpoints import save_checkpoint

B, H, W, F, D = 1, 32, 64, 2, 4
FEATURE_RTOL, FEATURE_ATOL = 1e-4, 1e-5  # atol relative to each scale's max |value|
ENC = "_feature_extractor.encoder."


def _batch():
    rng = np.random.default_rng(0)
    eye = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    return {"keyframe": rng.uniform(-0.5, 0.5, (B, H, W, 3)).astype(np.float32),
            "keyframe_pose": eye, "keyframe_intrinsics": eye,
            "frames": rng.uniform(-0.5, 0.5, (B, F, H, W, 3)).astype(np.float32),
            "poses": np.tile(eye[:, None], (1, F, 1, 1)),
            "intrinsics": np.tile(eye[:, None], (1, F, 1, 1))}


@pytest.fixture(scope="module")
def flax_init():
    model = JMonoRec(JConfig(cv_depth_steps=D))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    return model, jax.jit(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b, False))(batch)


def _port_model():
    return MonoRec(MonoRecConfig(cv_depth_steps=D), generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("counters", [True, False], ids=["with_counters", "without_counters"])
def test_injected_encoder_matches_jax(flax_init, tmp_path, counters):
    sd = torchvision_resnet(3, counters=counters)
    path = tmp_path / "resnet18.pth"
    torch.save(sd, path)

    jmodel, init = flax_init
    params, stats, j_ok = j_pretrained.inject_imagenet_encoder(
        dict(init["params"]), dict(init["batch_stats"]), str(path))
    model = _port_model()
    counters_before = {k: v.clone() for k, v in model.state_dict().items()
                       if k.endswith("num_batches_tracked")}
    assert j_ok and pretrained.inject_imagenet_encoder(model, path)

    carried = state_dict_from_flax({"encoder": params["encoder"]},
                                   {"encoder": stats["encoder"]})
    got = model.state_dict()
    compared = 0
    for key, value in carried.items():
        if key.endswith("num_batches_tracked"):
            want = sd[key[len(ENC):]] if counters else counters_before[key]
            assert torch.equal(got[key], want), key
            continue
        assert torch.equal(got[key], value), key
        assert torch.equal(got[key], sd[key[len(ENC):]]), key
        compared += 1
    assert compared == sum(not k.endswith("num_batches_tracked") for k in sd) - 2  # fc.*

    keyframe = _batch()["keyframe"]
    want = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(keyframe),
                        method=JMonoRec.features)
    with torch.no_grad():
        feats = model.features(torch.from_numpy(keyframe).permute(0, 3, 1, 2))
    assert len(feats) == len(want) == 5
    for f, w in zip(feats, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(f.numpy(), w, rtol=FEATURE_RTOL,
                                   atol=FEATURE_ATOL * np.abs(w).max())


def test_resnet34_file_is_refused_by_both(flax_init, tmp_path):
    path = tmp_path / "resnet34.pth"
    torch.save(torchvision_resnet(4, layers=34), path)
    _, init = flax_init
    _, _, j_ok = j_pretrained.inject_imagenet_encoder(
        dict(init["params"]), dict(init["batch_stats"]), str(path))
    model = _port_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert not j_ok and not pretrained.inject_imagenet_encoder(model, path)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_converter_drops_the_classifier_and_keeps_prefixed_keys():
    sd = torchvision_resnet(5)
    converted = pretrained.convert_torchvision_resnet(sd)
    assert not any(".fc." in k for k in converted) and all(k.startswith(ENC) for k in converted)
    again = pretrained.convert_torchvision_resnet(
        {k: v.numpy() for k, v in converted.items()})
    assert set(again) == set(converted)
    assert all(torch.equal(again[k], v) for k, v in converted.items())


def test_lookup_follows_the_jax_search_order(tmp_path, monkeypatch):
    """The environment variable first, then the hub cache under HOME, then
    ``saved/weights``; both packages find the same file (the JAX package's
    hub folders are fixed when it is imported, so they are patched there)."""
    home, work = tmp_path / "home", tmp_path / "work"
    hub = home / ".cache" / "torch" / "hub" / "checkpoints"
    local = work / "saved" / "weights"
    for d in (hub, local):
        d.mkdir(parents=True)
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.chdir(work)
    monkeypatch.delenv(pretrained.ENV_VAR, raising=False)
    monkeypatch.setattr(j_pretrained, "_HUB_DIRS", (hub, Path("saved/weights")))

    def both():
        found = pretrained.find_imagenet_weights(18)
        assert found == j_pretrained.find_imagenet_weights(18)
        return found

    assert both() is None
    (local / "resnet18.pth").write_bytes(b"")
    assert both() == Path("saved/weights/resnet18.pth")
    (hub / "resnet18-f37072fd.pth").write_bytes(b"")
    assert both() == hub / "resnet18-f37072fd.pth"
    (hub / "resnet18-5c106cde.pth").write_bytes(b"")
    assert both() == hub / "resnet18-5c106cde.pth"
    assert pretrained.find_imagenet_weights(34) is None
    explicit = tmp_path / "mine.pth"
    monkeypatch.setenv(pretrained.ENV_VAR, str(explicit))
    assert both() == hub / "resnet18-5c106cde.pth"  # a missing file is passed over
    explicit.write_bytes(b"")
    assert both() == explicit


def test_init_model_injects_only_without_a_full_checkpoint(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(pretrained.ENV_VAR, raising=False)
    sd = torchvision_resnet(6)
    path = tmp_path / "resnet18.pth"
    torch.save(sd, path)
    cfg = MonoRecConfig(cv_depth_steps=D)

    model = init_model_with_checkpoints(cfg, {"imagenet_weights": str(path)}, "cpu")
    assert torch.equal(model.state_dict()[ENC + "conv1.weight"], sd["conv1.weight"])
    assert "RANDOM" not in capsys.readouterr().err

    # A full checkpoint brings its own encoder; the ImageNet file is not read.
    ckpt = save_checkpoint(tmp_path / "checkpoint.pth", _port_model(),
                           torch.optim.SGD(_port_model().parameters(), lr=0.1), 1, 0.0, {})
    model = init_model_with_checkpoints(
        cfg, {"checkpoint_location": [str(ckpt)], "imagenet_weights": str(path)}, "cpu")
    assert torch.equal(model.state_dict()[ENC + "conv1.weight"],
                       _port_model().state_dict()[ENC + "conv1.weight"])
    assert "RANDOM" not in capsys.readouterr().err

    # Neither: the frozen encoder stays random, loudly.
    init_model_with_checkpoints(cfg, {}, "cpu")
    assert "RANDOM" in capsys.readouterr().err
