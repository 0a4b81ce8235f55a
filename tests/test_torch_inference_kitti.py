"""The KITTI mode of the port's inference example (the golden sample of
``monorec_tpu/cli/inference_example.py``) against the JAX package, on a
sequence-07 tree that holds only frames 168-170, as the reference's example
fixture does (60x200 PNGs of ``chip_smoke``'s textured plane, written with
PIL):

* the port's CLI at 32x64, D=8, with flax weights carried across
  (``state_dict_from_flax``) in a ``.pth``, against ``MonoRec.apply`` on the
  JAX reader's sample: ``result`` rtol 1e-3 / atol 2e-4 and ``cv_mask``
  atol 2e-3, as in ``tests/test_torch_slice.py``;
* the two readers' samples for index 164 at the example's 256x512, equal;
* ``depth.png``, ``mask.png`` and ``kf.png``, decoded with PIL, within one
  level of the JAX example's PIL fallback applied to the JAX outputs;
* ``write_png`` round trips through PIL and ``read_png``.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from monorec_tpu.data import KittiOdometryDataset as JKitti
from monorec_tpu.models import MonoRec as JMonoRec
from monorec_tpu.models import MonoRecConfig as JConfig
from monorec_tpu_torch.cli import inference_example
from monorec_tpu_torch.convert import state_dict_from_flax
from monorec_tpu_torch.data.kitti import KittiOdometryDataset
from monorec_tpu_torch.data.png import read_png, write_png
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from monorec_tpu_torch.train.checkpoints import save_checkpoint
from tests import torch_flax

SIZE = (60, 200)
H, W, D = 32, 64, 8
FRAMES = (168, 169, 170)
JAX_ARGS = dict(sequences=["07"], frame_count=2, depth_folder="image_depth_annotated",
                lidar_depth=True, dso_depth=False, use_dso_poses=True, custom_length=1000)


def _pil_write(path, array):
    Image.fromarray(np.ascontiguousarray(array)).save(path)


def write_golden_tree(root):
    """Sequence 07 with images and annotated depth for frames 168-170 only,
    its calibration and 171 DSO poses (0.8 m forward a frame)."""
    seq_dir = root / "sequences" / "07"
    for sub in ("image_2", "image_depth_annotated"):
        (seq_dir / sub).mkdir(parents=True)
    (root / "poses_dvso").mkdir()
    sx, sy = SIZE[1] / chip_smoke.KITTI_SIZE[1], SIZE[0] / chip_smoke.KITTI_SIZE[0]
    calib = {k: np.asarray(v).reshape(3, 4) * [[sx], [sy], [1]]
             for k, v in chip_smoke.KITTI_CALIB.items()}
    (seq_dir / "calib.txt").write_text("".join(
        f"{k}: " + " ".join(f"{v:.12e}" for v in p.reshape(-1)) + "\n" for k, p in calib.items()))
    rng = np.random.default_rng(0)
    lines = []
    for i in range(FRAMES[-1] + 1):
        pose = np.eye(4)[:3]
        pose[2, 3] = chip_smoke.FRAME_STEP * i
        lines.append(" ".join(f"{v:.12e}" for v in pose.reshape(-1)))
        if i in FRAMES:
            img, depth = chip_smoke.render_plane(calib["P2"][:, :3], pose[:, 3], SIZE)
            _pil_write(seq_dir / "image_2" / f"{i:06d}.png", img)
            sparse = np.where(rng.random(SIZE) < 0.05, np.round(depth * 256), 0)
            _pil_write(seq_dir / "image_depth_annotated" / f"{i:06d}.png",
                       sparse.astype(np.uint16))
    (root / "poses_dvso" / "07.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_golden_tree(tmp_path_factory.mktemp("golden"))


@pytest.fixture(scope="module")
def carried(tree, tmp_path_factory):
    """(flax variables, the port's .pth of them): a seeded numpy fill of
    the flax tree, so no flax init compiles."""
    model = JMonoRec(JConfig(cv_depth_steps=D))
    sample = JKitti(str(tree), target_image_size=(H, W), **JAX_ARGS)[164]
    batch = {k: jnp.asarray(v)[None] for k, v in sample.items()}
    shapes = jax.eval_shape(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b, False),
                            batch)
    variables = torch_flax.fill(shapes, seed=4)
    port = MonoRec(MonoRecConfig(cv_depth_steps=D))
    port.load_state_dict(state_dict_from_flax(variables["params"], variables["batch_stats"]))
    path = save_checkpoint(tmp_path_factory.mktemp("weights") / "checkpoint.pth", port,
                           torch.optim.SGD(port.parameters(), lr=0.0), 0, 0.0, {})
    return variables, path


@pytest.fixture(scope="module")
def jax_outputs(tree, carried):
    """The JAX example's forward at 32x64, D=8: (batch, outputs), numpy."""
    variables, _ = carried
    sample = JKitti(str(tree), target_image_size=(H, W), **JAX_ARGS)[164]
    batch = {k: np.asarray(v)[None] for k, v in sample.items()}
    model = JMonoRec(JConfig(inv_depth_min_max=(0.33, 0.0025), cv_depth_steps=D))
    out = jax.jit(lambda v, b: model.apply(v, b, False))(variables, batch)
    return batch, jax.tree_util.tree_map(np.asarray, out)


def _argv(tree, out_dir, *extra):
    return ["--device", "cpu", "--data", str(tree), "--height", str(H), "--width", str(W),
            "--depth-steps", str(D), "--out", str(out_dir), *extra]


def test_kitti_mode_matches_jax_forward(tree, carried, jax_outputs, tmp_path):
    _, path = carried
    args = argparse.Namespace(
        data=str(tree), index=164, height=H, width=W, depth_steps=D, precision="exact",
        seed=0, params=None, checkpoint=str(path))
    batch, out, ms = inference_example.golden_sample(args, torch.device("cpu"))
    jbatch, ref = jax_outputs
    assert ms > 0
    assert int(batch["image_id"][0, 0]) == 169
    np.testing.assert_array_equal(batch["keyframe"].numpy(), torch_flax.nchw(jbatch["keyframe"]))
    np.testing.assert_allclose(out["cv_mask"].numpy(), torch_flax.nchw(ref["cv_mask"]), atol=2e-3)
    np.testing.assert_allclose(out["result"].numpy(), torch_flax.nchw(ref["result"]),
                               rtol=1e-3, atol=2e-4)


def test_readers_agree_on_the_golden_sample(tree):
    """Index 164 at the example's 256x512: keyframe 169, sources 168 and
    170, every key equal."""
    ref = JKitti(str(tree), target_image_size=(256, 512), **JAX_ARGS)[164]
    got = KittiOdometryDataset(str(tree), target_image_size=(256, 512), **JAX_ARGS)[164]
    assert set(got) == set(ref) and int(got["image_id"][0]) == 169
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def _jax_png(arr) -> np.ndarray:
    """The JAX example's PIL fallback (``monorec_tpu/cli/inference_example.py:
    96-104``) before PIL writes it."""
    arr = np.asarray(arr, dtype=np.float64)
    arr = (arr - arr.min()) / max(arr.max() - arr.min(), 1e-9)
    return (arr * 255).astype(np.uint8)


def test_pngs_match_the_jax_example(tree, carried, jax_outputs, tmp_path, capsys):
    _, path = carried
    assert inference_example.main(_argv(tree, tmp_path, "--checkpoint", str(path))) == 0
    printed = capsys.readouterr()
    assert "Inference took" in printed.out and "WARNING" not in printed.err
    jbatch, ref = jax_outputs
    want = {"depth.png": _jax_png(ref["result"][0, ..., 0]),
            "mask.png": _jax_png(ref["cv_mask"][0, ..., 0]),
            "kf.png": _jax_png(np.asarray(jbatch["keyframe"][0]) + 0.5)}
    for name, w in want.items():
        got = np.asarray(Image.open(tmp_path / name))
        assert got.shape == w.shape, name
        assert np.abs(got.astype(int) - w).max() <= 1, name
        np.testing.assert_array_equal(read_png(tmp_path / name), got)


def test_random_weights_warn(tree, tmp_path, capsys):
    assert inference_example.main(_argv(tree, tmp_path)) == 0
    assert "weights are RANDOM" in capsys.readouterr().err
    assert read_png(tmp_path / "depth.png").shape == (H, W)


@pytest.mark.parametrize("shape", [(5, 7), (6, 9, 3), (1, 1)])
def test_write_png_round_trips(tmp_path, shape):
    a = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    write_png(tmp_path / "a.png", a)
    pil = Image.open(tmp_path / "a.png")
    assert pil.mode == ("L" if len(shape) == 2 else "RGB")
    np.testing.assert_array_equal(np.asarray(pil), a)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), a)
    with pytest.raises(ValueError):
        write_png(tmp_path / "b.png", a.astype(np.uint16))
