"""Numerical policy of the port.

Only the exact policy of ``monorec_tpu/precision.py`` is ported: float32
everywhere. On CUDA that means TF32 off for both matmuls and cuDNN
convolutions — cuDNN convolutions default to TF32 on Hopper, which moves the
forward by ~1e-3 and would break the card-vs-CPU parity budgets. This is the
analog of the JAX side pinning its 4x4 chains to ``Precision.HIGHEST``.
"""

from __future__ import annotations

import torch


def use_exact_precision() -> None:
    """Pin float32 matmuls and convolutions to full float32 (no TF32).

    Process-wide (these are PyTorch's global backend flags); ``MonoRec``
    calls it on construction, so any forward of the port runs exact.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
