"""The plane-sweep warp: the CUDA kernel K4 and its plain PyTorch version.

``warp_plane_sweep`` is the port of ``monorec_tpu/ops/pallas/warp_kernel.py::
warp_plane_sweep``. On CUDA tensors it launches the hand-written kernel
``cuda/warp_plane_sweep.cu`` (built at first use); on CPU tensors it runs
``warp_plane_sweep_reference``. Nothing else selects between the two, and a
build or launch failure raises.

Contract: warp every source image n, (N, C, H, W) float32 or bfloat16, by
each of its D pixel-unit homographies ``homs[n, d]`` ((N, D, 3, 3) float64,
``m22 == 1``; ``ops/cost_volume.py::plane_sweep_homographies``): bilinear,
zero padding, a sample with no tap inside the image exactly 0.0. Also warp
the border indicator (``border_radius <= p < size - border_radius``) the
same way. Returns warped (N, D, C, H, W) in the images' dtype (bf16
rounded from float32 sums) and wmask (N, D, H, W) float32; the TPU
kernel's coverage count has no counterpart, since a gather has full reach.
The kernel shares its coordinates and footprint with K1
(``cuda/sweep_common.cuh``); ``warp_plane_sweep.launches`` counts launches
on float32 sources and ``warp_plane_sweep.launches_bf16`` those on bf16
sources.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from monorec_tpu_torch.ops.cuda import launch
from monorec_tpu_torch.ops.plane_sweep import _displacements, _gather_bilinear, upcast_bf16

Tensor = torch.Tensor


def warp_plane_sweep_reference(images: Tensor, homographies: Tensor, border_radius: int = 2
                               ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel, on any device (see module doc):
    the sweep's gather on the upcast images, cast to the images' dtype."""
    h, w = images.shape[-2:]
    warped, wmask = _gather_bilinear(upcast_bf16(images), *_displacements(homographies, h, w),
                                     border_radius)
    return warped.to(images.dtype), wmask


_LAUNCH = launch.Entry("warp_plane_sweep", "warp_plane_sweep_launch",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _check_kernel_inputs(images: Tensor, homographies: Tensor) -> None:
    for name, t, dtypes in (("images", images, (torch.float32, torch.bfloat16)),
                            ("homographies", homographies, (torch.float64,))):
        if t.device != images.device:
            raise ValueError(f"{name} is on {t.device}, images on {images.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if images.dim() != 4 or min(images.shape) < 1 or images.shape[0] >= 65536:
        raise ValueError(f"unsupported image batch {tuple(images.shape)}")
    n = images.shape[0]
    if (homographies.dim() != 4 or homographies.shape[0] != n
            or homographies.shape[2:] != (3, 3) or not 0 < homographies.shape[1] < 65536):
        raise ValueError(f"homographies must be (N, D, 3, 3), got {tuple(homographies.shape)}")


@launch.counted("launches", "launches_bf16")
def warp_plane_sweep(images: Tensor, homographies: Tensor, border_radius: int = 2
                     ) -> Tuple[Tensor, Tensor]:
    """Warped stack and border mask (see module doc).

    CUDA tensors launch the kernel, CPU tensors run the plain version.
    """
    if images.device.type == "cpu":
        return warp_plane_sweep_reference(images, homographies, border_radius)
    if not images.is_cuda:
        raise ValueError(f"warp_plane_sweep runs on CUDA or CPU tensors, not {images.device}")
    _check_kernel_inputs(images, homographies)
    n, c, h, w = images.shape
    d = homographies.shape[1]
    bf16 = images.dtype == torch.bfloat16
    warped = torch.empty(n, d, c, h, w, dtype=images.dtype, device=images.device)
    wmask = torch.empty(n, d, h, w, dtype=torch.float32, device=images.device)
    # Three channels are packed into one texel per pixel first (a tap is one
    # load); other channel counts are gathered from their planes.
    texels = (torch.empty(n, h, w, 4, dtype=images.dtype, device=images.device)
              if c == 3 else None)
    _LAUNCH.launch(
        "warp_plane_sweep", images.device, images.data_ptr(), homographies.data_ptr(),
        None if texels is None else texels.data_ptr(), warped.data_ptr(), wmask.data_ptr(),
        n, c, d, h, w, border_radius, int(bf16),
    )
    if bf16:
        warp_plane_sweep.launches_bf16 += 1
    else:
        warp_plane_sweep.launches += 1
    return warped, wmask
