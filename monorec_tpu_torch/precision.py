"""Numerical policy of the port (``monorec_tpu/precision.py``).

Three knobs trade exact reference parity for speed, and one policy selects
all three, so a run is either exact end to end or the serving mixed
precision end to end:

* ``MonoRecConfig.cv_warp_dtype``: the dtype of the source frames that the
  cost-volume kernels (K1, K4) read;
* ``MonoRecConfig.compute_dtype``: the convolution dtype of the Mask and
  Depth U-Nets (parameters and their gradients stay float32);
* the source dtype of the loss warp (``losses/common.py``), read by
  ``loss_warp_dtype`` at every call.

Select it with the top-level ``"precision"`` key of a JSON config
("exact" | "serving", default "exact"), ``--precision`` on the CLIs, or
``set_precision``. A model reads the policy once, when it is built: set it
BEFORE building. ``set_precision`` warns with a ``PrecisionPolicyWarning``
when the previous policy was already consumed, since whatever was built
under it keeps its dtypes.

Everything the policy leaves in float32 is exact float32 on CUDA too:
``use_exact_precision`` turns TF32 off for matmuls and cuDNN convolutions
under both policies (cuDNN defaults to TF32 on Hopper, which moves the
forward by ~1e-3). The only reduced precision is where the policy puts it.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import torch


class PrecisionPolicyWarning(UserWarning):
    """The policy changed after something was built under the old one."""


POLICIES: Dict[str, Dict[str, str]] = {
    # bit-faithful to the reference: float32 everywhere
    "exact": {
        "cv_warp_dtype": "float32",
        "compute_dtype": "float32",
        "loss_warp_dtype": "float32",
    },
    # bf16 sources in the cost volume and the loss warp, bf16 U-Net
    # convolutions; parameters, gradients and losses stay float32
    "serving": {
        "cv_warp_dtype": "bfloat16",
        "compute_dtype": "bfloat16",
        "loss_warp_dtype": "bfloat16",
    },
}

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_current = "exact"
# The policy last consumed (by loss_warp_dtype or apply_to_model_kwargs);
# None until then, and reset by a switch: what is built after a
# set_precision call sees the new policy, the warning is about what was
# built before it.
_consumed: Optional[str] = None


def torch_dtype(name: str) -> torch.dtype:
    """"float32" | "bfloat16" -> the torch dtype; raises on anything else."""
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; one of {sorted(DTYPES)}")
    return DTYPES[name]


def set_precision(name: str, expect_rebuild: bool = False) -> None:
    """Select the process-wide precision policy.

    ``expect_rebuild=True`` silences the ``PrecisionPolicyWarning`` for
    callers that build everything anew after the switch (A/B harnesses).
    """
    global _current, _consumed
    if name not in POLICIES:
        raise ValueError(f"unknown precision policy {name!r}; one of {sorted(POLICIES)}")
    if _consumed is not None and name != _current and not expect_rebuild:
        warnings.warn(
            f"set_precision({name!r}): the {_current!r} policy was already consumed in this "
            "process. Models built before this call keep its dtypes: rebuild them to pick up "
            f"the {name!r} policy.",
            PrecisionPolicyWarning,
            stacklevel=2,
        )
    if name != _current:
        _consumed = None
    _current = name


def precision_policy() -> str:
    return _current


def loss_warp_dtype() -> torch.dtype:
    """Source dtype of the loss reprojection warps under the active policy."""
    global _consumed
    _consumed = _current
    return DTYPES[POLICIES[_current]["loss_warp_dtype"]]


def apply_to_model_kwargs(kwargs: Dict) -> Dict:
    """Fill ``cv_warp_dtype`` / ``compute_dtype`` from the active policy
    unless set explicitly: explicit per-knob values win, so a config can
    pin e.g. an exact cost volume under the serving policy."""
    global _consumed
    _consumed = _current
    policy = POLICIES[_current]
    out = dict(kwargs)
    out.setdefault("cv_warp_dtype", policy["cv_warp_dtype"])
    out.setdefault("compute_dtype", policy["compute_dtype"])
    return out


def use_exact_precision() -> None:
    """Pin float32 matmuls and convolutions to full float32 (no TF32).

    Process-wide (these are PyTorch's global backend flags); ``MonoRec``
    calls it on construction, under either policy.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
