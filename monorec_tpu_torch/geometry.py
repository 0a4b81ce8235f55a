"""Camera geometry primitives (``monorec_tpu/geometry.py``).

Same coordinate conventions as the reference: projected pixel coordinates
are normalized by ``(W - 1, H - 1)`` and mapped to ``[-1, 1]`` via
``(u - 0.5) * 2``, then consumed by a bilinear sampler with
``align_corners=False``. Every function broadcasts over leading batch dims.
The 4x4 chains run in full float32 (TF32 off, see ``precision.py``).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def pixel_grid(height: int, width: int, device=None, dtype=torch.float32) -> Tensor:
    """Homogeneous pixel grid, shape (3, H*W): rows are x, y, 1."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, height * width)


def invert_pose(pose: Tensor) -> Tensor:
    """Closed-form inverse of (..., 4, 4) SE(3) cam-to-world poses."""
    r_t = pose[..., :3, :3].transpose(-1, -2)
    t = pose[..., :3, 3:]
    top = torch.cat([r_t, -(r_t @ t)], dim=-1)
    bottom = torch.zeros_like(pose[..., 3:, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def invert_intrinsics(k: Tensor) -> Tensor:
    """Inverse of (..., 4, 4) intrinsics [[fx,0,cx,0],[0,fy,cy,0],[0,0,1,0],[0,0,0,1]]."""
    fx, fy = k[..., 0, 0], k[..., 1, 1]
    cx, cy = k[..., 0, 2], k[..., 1, 2]
    inv = torch.zeros_like(k)
    inv[..., 0, 0] = 1.0 / fx
    inv[..., 0, 2] = -cx / fx
    inv[..., 1, 1] = 1.0 / fy
    inv[..., 1, 2] = -cy / fy
    inv[..., 2, 2] = 1.0
    inv[..., 3, 3] = 1.0
    return inv


def backproject(depths: Tensor, inv_k: Tensor, height: int, width: int) -> Tensor:
    """Backproject the pixel grid by a stack of depths.

    Args:
      depths: (..., D, H*W) or (..., D, H, W) metric depths.
      inv_k: (..., 4, 4) inverse intrinsics (leading dims as ``depths``'s).

    Returns:
      (..., D, 4, H*W) homogeneous camera-frame points.
    """
    if depths.shape[-2:] == (height, width):
        depths = depths.flatten(-2)
    d = depths.unsqueeze(-2)  # (..., D, 1, HW)
    rays = inv_k[..., :3, :3] @ pixel_grid(height, width, depths.device, depths.dtype)  # (..., 3, HW)
    pts = d * rays.unsqueeze(-3)  # (..., D, 3, HW)
    return torch.cat([pts, torch.ones_like(pts[..., :1, :])], dim=-2)


def project(points: Tensor, k: Tensor, t: Tensor, height: int, width: int) -> Tensor:
    """Project homogeneous points into normalized grid coordinates.

    Args:
      points: (..., 4, H*W) points in the keyframe camera frame.
      k: (..., 4, 4) target intrinsics; t: (..., 4, 4) keyframe -> target.
        Their leading dims broadcast against those of ``points``.

    Returns:
      (..., H, W, 2) coordinates, reference normalization
      ``u / (W-1); (u - .5) * 2``.
    """
    proj = (k @ t)[..., :3, :]
    cam = proj @ points  # (..., 3, HW)
    xy = cam[..., :2, :] / (cam[..., 2:3, :] + 1e-7)
    denom = torch.tensor([width - 1, height - 1], dtype=xy.dtype, device=xy.device)
    xy = (xy / denom[:, None] - 0.5) * 2.0
    return xy.reshape(*xy.shape[:-2], 2, height, width).movedim(-3, -1)


def depth_hypotheses(
    inv_depth_max: float, inv_depth_min: float, steps: int, device=None,
    dtype=torch.float32,
) -> Tensor:
    """Plane-sweep depths 1 / linspace(inv_max, inv_min, D).

    The model passes its *smaller* inverse depth as ``inv_depth_max``
    (``monorec_tpu/models/monorec.py:212-213``), so the sweep runs far ->
    near; keep that argument order.
    """
    inv = torch.linspace(
        float(inv_depth_max), float(inv_depth_min), steps, dtype=dtype, device=device,
    )
    return 1.0 / inv
