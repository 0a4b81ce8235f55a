"""Stage 2-4 training entry point of the port
(``monorec_tpu/cli/train_monorec.py``): ``cli/train.py`` with the stage 2-4
trainer, ``train/monorec_trainer.py::MonoRecTrainer``.

    python -m monorec_tpu_torch.cli.train_monorec -c <stage config>
    python -m monorec_tpu_torch.cli.train_monorec -c <stage 3 config> -o mask_loss
    python -m monorec_tpu_torch.cli.train_monorec -c <stage 4 config> -o stereo stereo_repr
    python -m monorec_tpu_torch.cli.train_monorec -c <stage config> --device cpu

The shipped stage configs (``configs/train/monorec/monorec_mask.json``,
``monorec_mask_ref.json``, ``monorec_depth_ref.json``) read KITTI, which
the port cannot yet (ROADMAP item 7c): give them a
``SyntheticSweepDataloader`` block with ``return_stereo`` and their own
``return_mvobj_mask`` (2 for stage 2, 1 for stages 3-4). Arguments as in
``cli/train.py``: ``-c``, ``-r``, ``-o`` (loss options), ``--device``
(default cuda), ``--lr``, ``--bs`` and ``--precision``; the model loads the
earlier stages' checkpoints its config names (``depth_cp_loc``,
``mask_cp_loc``).
"""

from __future__ import annotations

import sys

from monorec_tpu_torch.cli import train
from monorec_tpu_torch.train import MonoRecTrainer


def build_trainer(config, device, options=(), run_dir=None) -> MonoRecTrainer:
    """The stage 2-4 trainer of a config dict (``cli/train.py::build_trainer``)."""
    return train.build_trainer(config, device, options, run_dir, trainer_cls=MonoRecTrainer)


def main(argv=None) -> int:
    return train.main(argv, MonoRecTrainer, "monorec_tpu_torch stage 2-4 training")


if __name__ == "__main__":
    sys.exit(main())
