"""Write a dataset into a memory-mapped sample cache (``tools/build_cache.py``;
``data/cache.py`` holds the format, which the JAX package reads too).

    python -m monorec_tpu_torch.tools.build_cache \
        -c configs/train/monorec/monorec_depth.json --out saved/cache/kitti_train
    python -m monorec_tpu_torch.tools.build_cache --dataset KittiOdometryDataset \
        --args '{"dataset_dir": "...", "sequences": ["07"]}' --out saved/cache/s07

The dataset of a config's ``data_loader`` block is built with colour
augmentation off: the cache stores clean images, and ``CachedDataset``
jitters them per sample.
"""

from __future__ import annotations

import argparse
import json
import sys

from monorec_tpu_torch.config import build_dataset
from monorec_tpu_torch.data.cache import build_cache


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-c", "--config", help="config whose data_loader block to cache")
    p.add_argument("--dataset", help="dataset class name (instead of -c)")
    p.add_argument("--args", default="{}", help="JSON arguments of --dataset")
    p.add_argument("--out", required=True, help="output cache directory")
    a = p.parse_args(argv)
    if a.config:
        with open(a.config) as f:
            block = json.load(f)["data_loader"]
        dataset = build_dataset(block["type"], {**block["args"], "use_color_augmentation": False})
    elif a.dataset:
        dataset = build_dataset(a.dataset, json.loads(a.args))
    else:
        p.error("give -c or --dataset")
    if getattr(dataset, "use_color_augmentation", False):
        raise SystemExit("refusing to cache a dataset with use_color_augmentation=True: the "
                         "cache must store clean images (CachedDataset jitters them)")
    out = build_cache(dataset, a.out)
    print(f"cached {len(dataset)} samples -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
