"""The port's KITTI preparation tool (``monorec_tpu_torch.tools.
preprocess_kitti``) against the JAX tool (``tools/preprocess_kitti.py``,
imported as ``tests/test_preprocess.py`` imports it) on the same inputs: the
same files with the same bytes for all three subcommands, and the same
printed report. The port's ``dist-index`` reads poses only: it runs with
the PNG decoder patched to raise.
"""

import argparse
import json
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from monorec_tpu_torch.data import kitti as port_kitti
from monorec_tpu_torch.data import png as port_png
from monorec_tpu_torch.tools import preprocess_kitti as port

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import preprocess_kitti as jax_tool  # noqa: E402

PNG = b"\x89PNG-fake-payload"
ZIP_ENTRIES = {
    "train/2011_09_30_drive_0027_sync/proj_depth/groundtruth/image_02/0000000005.png": PNG,
    "train/2011_09_30_drive_0027_sync/proj_depth/groundtruth/image_02/0000000006.png": PNG + b"6",
    "val/2011_09_30_drive_0016_sync/proj_depth/groundtruth/image_02/0000000009.png": PNG + b"9",
    "train/2011_09_30_drive_0027_sync/proj_depth/groundtruth/image_03/0000000005.png": b"cam3",
    "train/2011_09_26_drive_0001_sync/proj_depth/groundtruth/image_02/0000000002.png": b"unmapped",
    "train/2011_09_30_drive_0028_sync/proj_depth/groundtruth/image_02/0000000099.png": b"early08",
    "train/2011_09_30_drive_0028_sync/proj_depth/groundtruth/image_02/0000001101.png": PNG + b"08",
    "train/readme.txt": b"x",
}


def _tree_bytes(root: Path) -> dict:
    """Every path under ``root`` (folders as None) with its bytes."""
    return {p.relative_to(root).as_posix(): (p.read_bytes() if p.is_file() else None)
            for p in sorted(root.rglob("*"))}


def _run_both(capsys, port_argv, jax_fn, jax_args):
    port.main(port_argv)
    port_out = capsys.readouterr().out
    jax_fn(argparse.Namespace(**jax_args))
    return port_out, capsys.readouterr().out


def test_extract_depth_same_tree(tmp_path, capsys):
    zpath = tmp_path / "depth.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for name, data in ZIP_ENTRIES.items():
            z.writestr(name, data)
    outs = _run_both(capsys, ["extract-depth", "-i", str(zpath), "-o", str(tmp_path / "port")],
                     jax_tool.extract_depth, dict(input=str(zpath), output=str(tmp_path / "jax"),
                                                  depth_folder="image_depth_annotated"))
    got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert got == want
    assert got["sequences/07/image_depth_annotated/000006.png"] == PNG + b"6"
    assert got["sequences/08/image_depth_annotated/000001.png"] == PNG + b"08"
    assert sum(v is not None for v in got.values()) == 4
    assert outs[0].replace("port", "jax") == outs[1]


def test_mvobj_index_same_json(tmp_path, capsys):
    rng = np.random.default_rng(0)
    for seq in ("00", "07"):
        folder = tmp_path / "sequences" / seq / "mvobj_mask"
        folder.mkdir(parents=True)
        for i in (0, 1, 2, 3, 10, 11):
            mask = (rng.random((8, 16)) < (0.05 if i % 3 else 0.0))
            np.save(folder / f"{i:06d}.npy", mask.astype((np.uint8, bool, np.float32)[i % 3]))
    port_out = {}
    for tag in ("port", "jax"):
        name = f"index_{tag}"
        if tag == "port":
            port.main(["mvobj-index", "-d", str(tmp_path), "-o", name, "-s", "00", "07"])
        else:
            jax_tool.mvobj_index(argparse.Namespace(dataset=str(tmp_path),
                                                    mask_folder="mvobj_mask", output_name=name,
                                                    sequences=["00", "07"]))
        port_out[tag] = capsys.readouterr().out
    for seq in ("00", "07"):
        folder = tmp_path / "sequences" / seq
        got = (folder / "index_port.json").read_bytes()
        assert got == (folder / "index_jax.json").read_bytes()
        index = json.loads(got)
        assert not index["0"] and not index["3"] and list(index) == ["0", "1", "2", "3", "10", "11"]
    assert port_out["port"] == port_out["jax"]


N_FRAMES = 24
SIZE = (24, 80)  # native; both tools read at the reader's default 256x512


def _yaw(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _write_tree(root: Path, seq: str = "07") -> None:
    """A KITTI tree whose trajectory stands still, then turns (0.04 rad a
    frame: a window of three frames spreads 0.08 rad), then drives (0.5 m a
    frame), then turns slowly (0.02 rad) and then drives slowly (0.3 m): the
    windows cross the rotational threshold alone, the spatial one alone, or
    neither."""
    seq_dir = root / "sequences" / seq
    for sub in ("image_2", "image_depth_annotated"):
        (seq_dir / sub).mkdir(parents=True)
    (root / "poses_dvso").mkdir()
    f, cx, cy = 0.8 * SIZE[1], SIZE[1] / 2 - 0.5, SIZE[0] / 2 - 0.5
    p = f"{f} 0 {cx} 0 0 {f} {cy} 0 0 0 1 0"
    (seq_dir / "calib.txt").write_text(f"P0: {p}\nP1: {p}\nP2: {p}\nP3: {p}\n")
    rng = np.random.default_rng(1)
    theta, pos, lines = 0.0, np.zeros(3), []
    for i in range(N_FRAMES):
        step_t, step_r = {0: (0.01, 0.001), 1: (0.05, 0.04), 2: (0.5, 0.0), 3: (0.05, 0.02),
                          4: (0.3, 0.0)}[min(i // 5, 4)]
        theta += step_r
        pos = pos + _yaw(theta) @ np.array([0.0, 0.0, step_t])
        m = np.concatenate([_yaw(theta), pos[:, None]], axis=1)
        lines.append(" ".join(f"{v:.9e}" for v in m.reshape(-1)))
        Image.fromarray(rng.integers(0, 255, SIZE + (3,), dtype=np.uint8)).save(
            seq_dir / "image_2" / f"{i:06d}.png")
        depth = np.where(rng.random(SIZE) < 0.1, rng.integers(256, 65535, SIZE), 0)
        Image.fromarray(depth.astype(np.uint16)).save(
            seq_dir / "image_depth_annotated" / f"{i:06d}.png")
    (root / "poses_dvso" / f"{seq}.txt").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("threshold,rotational", [(0.8, 0.05), (0.55, 0.1)])
def test_dist_index_same_json_without_decoding(tmp_path, capsys, monkeypatch, threshold,
                                               rotational):
    _write_tree(tmp_path)
    out = tmp_path / "sequences" / "07" / "index_mask_dist.json"
    jax_tool.dist_index(argparse.Namespace(dataset=str(tmp_path), sequences=["07"],
                                           threshold=threshold,
                                           rotational_threshold=rotational))
    want, want_out = out.read_bytes(), capsys.readouterr().out
    out.unlink()

    def no_decoding(*_):
        raise AssertionError("dist-index decoded an image")

    monkeypatch.setattr(port_kitti, "read_png", no_decoding)
    monkeypatch.setattr(port_png, "read_png", no_decoding)
    port.main(["dist-index", "-d", str(tmp_path), "-s", "07", "-t", str(threshold),
               "--rotational_threshold", str(rotational)])
    assert out.read_bytes() == want
    assert capsys.readouterr().out == want_out
    kept = json.loads(want)
    assert list(kept) == [str(i) for i in range(5, N_FRAMES - 5)]
    assert 0 < sum(kept.values()) < len(kept)
    if threshold == 0.8:
        # Frames 5-9 turn at 0.04 rad a frame, 15-19 at 0.02, both moving
        # 0.05 m: the first kept by the rotational threshold alone, the
        # second dropped.
        assert kept["7"] and kept["8"] and not kept["17"]
        port.main(["dist-index", "-d", str(tmp_path), "-s", "07", "--rotational_threshold", "9"])
        assert not json.loads(out.read_bytes())["7"]
