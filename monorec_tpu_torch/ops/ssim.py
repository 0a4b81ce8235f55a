"""SSIM photometric error on NCHW tensors (``monorec_tpu/ops/ssim.py::ssim``).

1-pixel pad (reflect or zeros), 3x3 window statistics (uniform average or
the fixed 3x3 Gaussian of the reference ``GaussianAverage``), C1=0.01^2,
C2=0.03^2, and two clamp modes:
  * default:    clamp((1 - n/d) / 2, 0, 1)
  * comp_mode:  clamp( 1 - n/d,      0, 1) / 2
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_GAUSS_3X3 = (
    (0.0947, 0.1183, 0.0947),
    (0.1183, 0.1478, 0.1183),
    (0.0947, 0.1183, 0.0947),
)
_C1 = 0.01**2
_C2 = 0.03**2


def _window_avg(xp: Tensor, gaussian: bool) -> Tensor:
    """3x3 valid window average over the trailing two dims of padded NCHW."""
    if not gaussian:
        return F.avg_pool2d(xp, 3, stride=1)
    c = xp.shape[1]
    k = torch.tensor(_GAUSS_3X3, dtype=xp.dtype, device=xp.device)
    return F.conv2d(xp, k.expand(c, 1, 3, 3), groups=c)


def ssim_pre_clamp(x: Tensor, y: Tensor, pad_reflection: bool = True,
                   gaussian_average: bool = False) -> Tensor:
    """``1 - n/d``, the SSIM distance before its clamp, of (N, C, H, W)
    batches; output has the same shape."""
    mode = "reflect" if pad_reflection else "constant"
    xp = F.pad(x, (1, 1, 1, 1), mode=mode)
    yp = F.pad(y, (1, 1, 1, 1), mode=mode)
    mu_x = _window_avg(xp, gaussian_average)
    mu_y = _window_avg(yp, gaussian_average)
    sigma_x = _window_avg(xp * xp, gaussian_average) - mu_x * mu_x
    sigma_y = _window_avg(yp * yp, gaussian_average) - mu_y * mu_y
    sigma_xy = _window_avg(xp * yp, gaussian_average) - mu_x * mu_y
    n = (2.0 * mu_x * mu_y + _C1) * (2.0 * sigma_xy + _C2)
    d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    return 1.0 - n / d


def ssim(
    x: Tensor,
    y: Tensor,
    pad_reflection: bool = True,
    gaussian_average: bool = False,
    comp_mode: bool = False,
) -> Tensor:
    """SSIM distance between (N, C, H, W) batches; output has the same shape."""
    v = ssim_pre_clamp(x, y, pad_reflection, gaussian_average)
    if not comp_mode:
        return torch.clamp(v / 2.0, 0.0, 1.0)
    return torch.clamp(v, 0.0, 1.0) / 2.0
