"""The port's whole MonoRec eval forward against the flax model, with the flax
``init(PRNGKey(0))`` variables carried across by ``state_dict_from_flax``, at
B=1, 32x64, D=8, F=2 on the CPU; the weight round trip through
``monorec_tpu.convert.convert_state_dict``; the synthetic batch; and the
serving entry point at a tiny size.

Tolerances: cost volumes atol 2e-4 (both sides f32; the CV alone agrees to
1e-4, tests/test_torch_cost_volume.py), cv_mask atol 2e-3 and result
rtol 1e-3 / atol 2e-4 (tests/test_convert.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_batch
from monorec_tpu.convert import convert_state_dict
from monorec_tpu.models import MonoRec as JMonoRec
from monorec_tpu.models import MonoRecConfig as JConfig
from monorec_tpu_torch.cli import inference_example
from monorec_tpu_torch.convert import state_dict_from_flax
from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
from monorec_tpu_torch.models import MonoRec, MonoRecConfig

B, H, W, F, D = 1, 32, 64, 2, 8


@functools.lru_cache(maxsize=None)
def _flax_init():
    model = JMonoRec(JConfig(cv_depth_steps=D))
    batch = {k: jnp.asarray(v) for k, v in make_batch(B, H, W, F).items()}
    v = jax.jit(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b, False))(batch)
    return jax.tree_util.tree_map(np.asarray, v)


def _flax(pretrain_mode):
    """Numpy flax variables of one mode's tree: the mode-0 init without the
    submodules that mode lacks (mode 2 has no depth net, 1 and 3 no mask)."""
    v = _flax_init()
    drop = {0: (), 1: ("att",), 2: ("depth_net",), 3: ("att",)}[pretrain_mode]
    return {k: t for k, t in v["params"].items() if k not in drop}, v["batch_stats"]


def _flax_forward(pretrain_mode, nb, use_stereo=False):
    model = JMonoRec(JConfig(cv_depth_steps=D, pretrain_mode=pretrain_mode, use_stereo=use_stereo))
    params, stats = _flax(pretrain_mode)
    out = jax.jit(lambda v, b: model.apply(v, b, False))(
        {"params": params, "batch_stats": stats}, {k: jnp.asarray(x) for k, x in nb.items()})
    return jax.tree_util.tree_map(np.asarray, out)


def _port(pretrain_mode, use_stereo=False):
    params, stats = _flax(pretrain_mode)
    model = MonoRec(MonoRecConfig(cv_depth_steps=D, pretrain_mode=pretrain_mode,
                                  use_stereo=use_stereo))
    model.load_state_dict(state_dict_from_flax(params, stats))
    return model.eval()


def _nchw(a, lead=1):
    return np.moveaxis(a, -1, lead)


@pytest.mark.parametrize("pretrain_mode,tz,use_stereo", [
    (0, 0.0, False), (0, 0.5, False), (0, 0.5, True), (1, 0.5, False), (2, 0.5, False),
    (3, 0.5, False)])
def test_forward_matches_flax(pretrain_mode, tz, use_stereo):
    nb = make_batch(B, H, W, F, seed=11, tz=tz)
    ref = _flax_forward(pretrain_mode, nb, use_stereo)
    with torch.no_grad():
        out = _port(pretrain_mode, use_stereo)(batch_to_torch(nb, "cpu"))
    assert set(ref) - {"image_features"} <= set(out)
    np.testing.assert_allclose(out["single_frame_cvs"].numpy(),
                               _nchw(ref["single_frame_cvs"], 2), atol=2e-4)
    np.testing.assert_allclose(out["cost_volume"].numpy(), _nchw(ref["cost_volume"]), atol=2e-4)
    np.testing.assert_allclose(out["cv_mask"].numpy(), _nchw(ref["cv_mask"]), atol=2e-3)
    np.testing.assert_allclose(out["result"].numpy(), _nchw(ref["result"]), rtol=1e-3, atol=2e-4)
    np.testing.assert_array_equal(out["cv_uncovered"].numpy(), ref["cv_uncovered"])
    if pretrain_mode != 2:
        for p, r in zip(out["predicted_inverse_depths"], ref["predicted_inverse_depths"]):
            np.testing.assert_allclose(p.numpy(), _nchw(r), rtol=1e-3, atol=2e-4)
    for key in ("cost_volume", "single_frame_cvs", "cv_mask", "result"):
        assert torch.isfinite(out[key]).all()


@pytest.mark.parametrize("pretrain_mode", [0, 2])
def test_weights_round_trip_through_reference_converter(pretrain_mode):
    params, stats = _flax(pretrain_mode)
    sd = {k: v.numpy() for k, v in _port(pretrain_mode).state_dict().items()}
    back_params, back_stats, unused = convert_state_dict(sd)
    assert unused == []
    flat = jax.tree_util.tree_flatten_with_path
    for a, b in ((params, back_params), (stats, back_stats)):
        (la, ta), (lb, tb) = flat(a), flat(b)
        assert ta == tb
        for (path, x), (_, y) in zip(la, lb):
            assert x.dtype == y.dtype and np.array_equal(x, y), jax.tree_util.keystr(path)


@pytest.mark.parametrize("args", [(2, 16, 24, 2, True, True, 0, 0.0), (1, 8, 16, 3, False, True, 5, 0.5),
                                  (3, 8, 8, 1, True, False, 2, 1.0)])
def test_make_batch_matches_graft_entry(args):
    port = make_batch(*args)
    ref = _make_batch(*args)
    assert set(port) == set(ref)
    for key in ref:
        assert port[key].dtype == np.asarray(ref[key]).dtype
        np.testing.assert_array_equal(port[key], np.asarray(ref[key]))
    bt = batch_to_torch(port, "cpu")
    assert bt["keyframe"].shape == (args[0], 3, args[1], args[2])
    assert bt["frames"].shape == (args[0], args[3], 3, args[1], args[2])


def test_inference_example_serves_flax_weights(tmp_path, capsys):
    """The serving entry point with weights from an npz of flattened flax
    variables answers like the flax forward."""
    params, stats = _flax(0)
    flat = {}
    for root, tree in (("params", params), ("batch_stats", stats)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat["/".join([root] + [p.key for p in path])] = leaf
    npz = tmp_path / "monorec.npz"
    np.savez(npz, **flat)

    model = inference_example.build_model(MonoRecConfig(cv_depth_steps=D), "cpu", params_path=npz)
    requests = inference_example.make_requests(2, B, H, W, F, "cpu", seed=3)
    outputs, latencies = inference_example.serve(model, requests)
    assert len(latencies) == 2
    ref = _flax_forward(0, make_batch(B, H, W, F, stereo=False, mask=False, seed=4))
    np.testing.assert_allclose(outputs[1]["result"].numpy(), _nchw(ref["result"]),
                               rtol=1e-3, atol=2e-4)

    assert inference_example.main(["--device", "cpu", "--batch", "1", "--requests", "2",
                                   "--height", str(H), "--width", str(W),
                                   "--depth-steps", str(D), "--params", str(npz)]) == 0
    assert "keyframes/s" in capsys.readouterr().out
