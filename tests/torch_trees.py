"""RobotCar, TUM mono VO and TUM RGB-D trees for the port's reader and CLI
tests, written with PIL at small sizes. The RobotCar and TUM mono VO ones
are ``chip_smoke.write_robotcar_tree`` and ``write_tum_tree``'s scenes (a
textured plane, a camera moving forward, LiDAR returns on the plane), the
RobotCar images then replaced by random Bayer samples. Not a test module."""

import json
from pathlib import Path

import numpy as np
from PIL import Image

import chip_smoke

# RobotCar raw size, RobotCar's 960x1280 cut by 10: scale 0.5 and the
# cutout (0, 1/3, 0, 0) leave 32x64. The shipped configs' 0.333333333333333
# leaves 33 rows (chip_smoke.ROBOTCAR_CUTOUT).
ROBOTCAR_RAW = (96, 128)
ROBOTCAR_FRAMES = 10
TUM_RAW = (60, 80)  # cropped to 40x80 and resized to the target's 32x64
TUM_FRAMES = 9
TARGET = (32, 64)
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def pil_png(path, array):
    Image.fromarray(np.ascontiguousarray(array)).save(path)


# chip_smoke's (h, v) sampling factors of the luma -> PIL's ``subsampling``.
PIL_SUBSAMPLING = {(1, 1): 0, (2, 1): 1, (2, 2): 2}


def pil_jpeg(path, array, restart_interval: int = 0, sampling=None):
    extra = {"restart_marker_blocks": restart_interval} if restart_interval else {}
    if sampling is not None:
        extra["subsampling"] = PIL_SUBSAMPLING[sampling[0]]
    Image.fromarray(np.ascontiguousarray(array)).save(path, quality=90, **extra)


def write_robotcar(root) -> dict:
    """The tree's folder arguments; its images are random Bayer samples."""
    args = chip_smoke.write_robotcar_tree(root, ROBOTCAR_RAW, ROBOTCAR_FRAMES, write=pil_png)
    rng = np.random.default_rng(0)
    for path in sorted(Path(args["sequence_folders"][0]).glob("*.png")):
        pil_png(path, rng.integers(0, 256, ROBOTCAR_RAW, dtype=np.uint8))
    return args


def write_tum_mono(root, colour: bool = False, depth=None) -> Path:
    """chip_smoke's TUM mono VO tree at TUM_RAW with PIL's JPEGs (colour at
    4:4:4, 4:2:2 and 4:2:0 with ``colour``) and the depth files ``depth``
    names (``chip_smoke.write_tum_tree``)."""
    chip_smoke.write_tum_tree(root, TUM_RAW, TUM_FRAMES, write=pil_jpeg, colour=colour,
                              depth=depth)
    return Path(root)


def write_tum_rgbd(root, n: int = 8, seed: int = 0) -> Path:
    """RGB and 16-bit depth PNGs at 24x32 on their own clocks, and a
    ground-truth trajectory at a third rate with turning quaternions."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb, depth, gt = ["# rgb"], ["# depth"], ["# timestamp tx ty tz qx qy qz qw"]
    for i in range(n):
        t = 1000.0 + 0.1 * i + rng.uniform(0, 0.01)
        pil_png(root / "rgb" / f"{t:.6f}.png", rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
    for i in range(n + 2):
        t = 999.97 + 0.09 * i
        d = np.where(rng.random((24, 32)) < 0.8, rng.integers(500, 20000, (24, 32)), 0)
        pil_png(root / "depth" / f"{t:.6f}.png", d.astype(np.uint16))
        depth.append(f"{t:.6f} depth/{t:.6f}.png")
    for i in range(3 * n):
        t = 999.9 + 0.04 * i
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        gt.append(f"{t:.4f} " + " ".join(f"{v:.6f}" for v in (*rng.normal(size=3), *q)))
    for name, lines in (("rgb", rgb), ("depth", depth), ("groundtruth", gt)):
        (root / f"{name}.txt").write_text("\n".join(lines) + "\n")
    return root


def shipped(config: str) -> dict:
    return json.loads((CONFIGS / config).read_text())


def robotcar_args(block: dict, tree: dict) -> dict:
    """A shipped RobotCar block's args with the tree's folders and the
    cutout 1/3 to the double's last digit, which the model can take."""
    return dict(block["args"], cutout=chip_smoke.ROBOTCAR_CUTOUT, **tree)


def cut_roi(roi, native):
    """A shipped export roi (top, bottom, left, right), given in pixels of
    the ``native`` (h, w) image, in pixels of TARGET."""
    t, b, l, r = roi
    sy, sx = TARGET[0] / native[0], TARGET[1] / native[1]
    return [round(t * sy), round(b * sy), round(l * sx), round(r * sx)]
