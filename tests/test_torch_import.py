"""The PyTorch port imports without JAX, and its GPU smoke test has no CPU
fallback: without a visible CUDA device, or without the package beside it,
``chip_smoke.py`` exits non-zero and prints no result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "cv2", "monorec_tpu"):
    sys.modules[blocked] = None  # any import of these raises ImportError
import monorec_tpu_torch
names = [m.name for m in pkgutil.walk_packages(monorec_tpu_torch.__path__, "monorec_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_port_imports_every_module_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_env(PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    # geometry, precision, convert, config, ops (8 + cuda/build), models (7: + pretrained),
    # data (14: png, resize, color_jitter, kitti, cache, loader, synthetic, pose_interp, bayer,
    # robotcar, jpeg, jpeg_encoder, tum_mono_vo, tum_rgbd), utils (the TSDF export among
    # them), losses (2), metrics, eval, export (2), train (4: + loggers), cli (6: + common),
    # tools (2), with their packages
    assert int(proc.stdout.split()[-1]) >= 67


_READ_ONE_SAMPLE = """
import json, sys
for blocked in ("jax", "jaxlib", "flax", "PIL", "cv2", "monorec_tpu"):
    sys.modules[blocked] = None
from monorec_tpu_torch import config
kind, args = json.loads(sys.argv[1])
sample = config.build_dataset(kind, args)[0]
print(sorted((k, v.shape) for k, v in sample.items()))
"""


@pytest.mark.parametrize("reader", ["OxfordRobotCarDataset", "TUMMonoVODataset",
                                    "TUMRGBDDataset"])
def test_readers_read_without_pil_cv2_or_jax(reader, tmp_path):
    """The readers import their decoders inside their methods too (scipy's
    ``map_coordinates``): one sample of each, read in a process where PIL,
    cv2, JAX and the JAX package cannot be imported."""
    from tests import torch_trees

    if reader == "OxfordRobotCarDataset":
        args = dict(torch_trees.write_robotcar(tmp_path), cutout=[0, 0, 0, 0])
    elif reader == "TUMMonoVODataset":
        # Colour JPEGs, and sample 0's keyframe (frame 1, a CMYK file) with a
        # depth EXR; its sources, frames 0 and 2, progressive RGB and CMYK.
        tree = torch_trees.write_tum_mono(tmp_path, colour=True,
                                          depth={1: {"compression": "ZIP"}},
                                          write=torch_trees.pil_progressive_cmyk)
        args = {"dataset_dir": str(tree), "target_image_size": list(torch_trees.TARGET)}
    else:
        args = {"dataset_dir": str(torch_trees.write_tum_rgbd(tmp_path))}
    proc = subprocess.run(
        [sys.executable, "-c", _READ_ONE_SAMPLE, json.dumps([reader, args])], cwd=ROOT,
        env=_env(PYTHONPATH=str(ROOT)), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "keyframe" in proc.stdout and "target" in proc.stdout


_TSDF_EXPORT = """
import sys
for blocked in ("jax", "jaxlib", "flax", "PIL", "cv2", "monorec_tpu"):
    sys.modules[blocked] = None
import numpy as np, torch
from monorec_tpu_torch.data.jpeg import read_jpeg
from monorec_tpu_torch.data.png import read_png
from monorec_tpu_torch.utils import save_frame_for_tsdf, save_intrinsics_for_tsdf
out = sys.argv[1]
keyframe = torch.linspace(-0.5, 0.5, 3 * 20 * 30).reshape(3, 20, 30)
save_frame_for_tsdf(out, 3, keyframe, torch.full((1, 20, 30), 0.25), torch.eye(4))
save_intrinsics_for_tsdf(out, torch.eye(4))
print(read_jpeg(out + "/frame-000003.color.jpg").shape, read_png(out + "/frame-000003.depth.png").max())
"""


def test_tsdf_export_writes_without_pil_cv2_or_jax(tmp_path):
    """The TSDF export writes its JPEG and 16-bit PNG in a process where PIL,
    cv2, JAX and the JAX package cannot be imported."""
    proc = subprocess.run(
        [sys.executable, "-c", _TSDF_EXPORT, str(tmp_path)], cwd=ROOT,
        env=_env(PYTHONPATH=str(ROOT)), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["(20,", "30,", "3)", "400"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "camera-intrinsics.txt", "frame-000003.color.jpg", "frame-000003.depth.png",
        "frame-000003.pose.txt"]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    else:
        cwd = ROOT
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
