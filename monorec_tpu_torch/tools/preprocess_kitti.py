"""KITTI preparation for the port (``tools/preprocess_kitti.py``; reference
``data_loader/scripts/*.py``). Three subcommands, with the JAX tool's flags
and outputs, byte for byte:

* ``extract-depth``: unpack the KITTI depth-annotated zip into per-sequence
  ``image_depth_annotated/`` folders, through the raw-drive -> odometry
  sequence map (sequence 08 starts at raw frame 1100, so its numbers shift);
* ``mvobj-index``: ``<output_name>.json`` per sequence, marking the frames
  whose moving-object mask (``mvobj_mask/*.npy``) has any moving pixel; the
  stage-2 and stage-3 configs read it through ``use_index_mask``;
* ``dist-index``: ``index_mask_dist.json`` per sequence, marking the samples
  whose poses over the temporal window spread more than a spatial or a
  rotational threshold. It reads each sample's poses through
  ``KittiOdometryDataset.sample_poses`` and decodes no image.

Usage::

    python -m monorec_tpu_torch.tools.preprocess_kitti extract-depth -i depth.zip -o data/dataset
    python -m monorec_tpu_torch.tools.preprocess_kitti mvobj-index -d data/dataset
    python -m monorec_tpu_torch.tools.preprocess_kitti dist-index -d data/dataset -t 0.8
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path
from zipfile import ZipFile

import numpy as np

from monorec_tpu_torch.data.kitti import KittiOdometryDataset

RAW_TO_ODOMETRY = {
    "2011_10_03_drive_0027": "00",
    "2011_10_03_drive_0042": "01",
    "2011_10_03_drive_0034": "02",
    "2011_09_26_drive_0067": "03",
    "2011_09_30_drive_0016": "04",
    "2011_09_30_drive_0018": "05",
    "2011_09_30_drive_0020": "06",
    "2011_09_30_drive_0027": "07",
    "2011_09_30_drive_0028": "08",
    "2011_09_30_drive_0033": "09",
    "2011_09_30_drive_0034": "10",
}
SEQ08_OFFSET = 1100  # odometry sequence 08 begins at raw frame 1100

ALL_SEQUENCES = [f"{i:02d}" for i in range(11)]


def extract_depth(args) -> None:
    out = Path(args.output)
    for seq in RAW_TO_ODOMETRY.values():
        (out / "sequences" / seq / args.depth_folder).mkdir(parents=True, exist_ok=True)
    n = 0
    with ZipFile(args.input) as archive:
        for name in archive.namelist():
            if not name.endswith(".png"):
                continue
            # {train,val}/<drive>_sync/proj_depth/groundtruth/image_0X/NNNNNNNNNN.png
            drive = name[6:27] if name.startswith("t") else name[4:25]
            cam, img = name[-16], name[-10:]
            if cam != "2" or drive not in RAW_TO_ODOMETRY:
                continue
            seq = RAW_TO_ODOMETRY[drive]
            if seq == "08":
                idx = int(img.split(".")[0])
                if idx < SEQ08_OFFSET:
                    continue
                img = f"{idx - SEQ08_OFFSET:06d}.png"
            with archive.open(name) as i, open(
                    out / "sequences" / seq / args.depth_folder / img, "wb") as o:
                shutil.copyfileobj(i, o)
            n += 1
    print(f"extracted {n} depth maps into {out}")


def mvobj_index(args) -> None:
    base = Path(args.dataset)
    total = total_pts = 0
    for seq in args.sequences:
        has_object = {}
        seq_total = seq_pts = 0
        for file in sorted((base / "sequences" / seq / args.mask_folder).glob("*.npy")):
            pts = int(np.load(file).astype(np.int64).sum())
            has_object[int(file.stem)] = pts > 0
            seq_total += pts > 0
            seq_pts += pts
        with open(base / "sequences" / seq / f"{args.output_name}.json", "w") as f:
            json.dump(has_object, f)
        print(f"seq {seq}: {seq_total}/{len(has_object)} samples with moving objects, "
              f"{seq_pts} moving pixels")
        total += seq_total
        total_pts += seq_pts
    print(f"total: {total} samples, {total_pts} moving pixels")


def dist_index(args) -> None:
    base = Path(args.dataset)
    for seq in args.sequences:
        ds = KittiOdometryDataset(str(base), sequences=[seq], use_dso_poses=True,
                                  lidar_depth=True, dso_depth=False,
                                  depth_folder="image_depth_annotated")
        enough = {}
        for i in range(len(ds)):
            keyframe_pose, frame_poses = ds.sample_poses(i)
            poses = np.concatenate([keyframe_pose[None], frame_poses], axis=0)
            t = poses[:, :3, 3]
            spatial = np.linalg.norm(t.max(axis=0) - t.min(axis=0))
            fwd = poses[:, :3, :3] @ np.array([0, 0, 1.0])
            rot = np.linalg.norm(fwd.max(axis=0) - fwd.min(axis=0))
            enough[i + ds._offset] = bool(spatial > args.threshold
                                          or rot > args.rotational_threshold)
        with open(base / "sequences" / seq / "index_mask_dist.json", "w") as f:
            json.dump(enough, f)
        print(f"seq {seq}: kept {sum(enough.values())}/{len(enough)}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("extract-depth")
    e.add_argument("-i", "--input", required=True)
    e.add_argument("-o", "--output", default="data/dataset")
    e.add_argument("-d", "--depth_folder", default="image_depth_annotated")
    e.set_defaults(fn=extract_depth)

    m = sub.add_parser("mvobj-index")
    m.add_argument("-d", "--dataset", default="data/dataset")
    m.add_argument("-m", "--mask_folder", default="mvobj_mask")
    m.add_argument("-o", "--output_name", default="mvobj_index_mask",
                   help="JSON name the training configs reference via use_index_mask")
    m.add_argument("-s", "--sequences", nargs="+", default=ALL_SEQUENCES)
    m.set_defaults(fn=mvobj_index)

    d = sub.add_parser("dist-index")
    d.add_argument("-d", "--dataset", default="data/dataset")
    d.add_argument("-s", "--sequences", nargs="+", default=ALL_SEQUENCES)
    d.add_argument("-t", "--threshold", type=float, default=0.8)
    d.add_argument("--rotational_threshold", type=float, default=0.05)
    d.set_defaults(fn=dist_index)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
