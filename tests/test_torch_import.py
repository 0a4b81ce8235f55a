"""The PyTorch port imports without JAX, and its GPU smoke test has no CPU
fallback: without a visible CUDA device, or without the package beside it,
``chip_smoke.py`` exits non-zero and prints no result."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "monorec_tpu"):
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
    # geometry, precision, convert, config, ops (8 + cuda/build), models (6), data (7: png,
    # resize, color_jitter, kitti, cache, loader, synthetic), utils, losses (2), metrics,
    # eval, export (2), train (3), cli (5), tools (2), with their packages
    assert int(proc.stdout.split()[-1]) >= 57


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
