"""Seeded synthetic scenes, rendered on the device.

Each sample is a textured plane seen by a pinhole camera that moves along
its optical axis (and, for the stereo frame, sideways by the stereo
baseline). Everything a configuration's ``scene`` block fixes (intrinsics,
motion per frame, plane distances, texture, the density of the sparse
depth) is the same for every seed; the seed draws the plane's distance and
tilt and the texture's frequencies and phases. So every seed gives the
same sizes and the same work, with other content.

The batch follows the program's contract (NCHW, images in [-0.5, 0.5],
cam-to-world poses, 4x4 intrinsics): ``keyframe`` (B, 3, H, W),
``frames`` (B, F, 3, H, W), ``keyframe_pose`` / ``keyframe_intrinsics``
(B, 4, 4), ``poses`` / ``intrinsics`` (B, F, 4, 4), and with ``stereo`` the
``stereoframe`` and its pose and intrinsics; ``target`` is the sparse
inverse depth (0 = no measurement) and ``mvobj_mask`` all zero (the
synthetic scenes hold no moving object).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

Tensor = torch.Tensor
TEXTURE_WAVES = 6


def sub_seed(seed: int, *parts: int) -> int:
    """A generator seed for one use of a run's ``seed`` (any whole number)."""
    value = seed % (2**61 - 1)
    for p in parts:
        value = (value * 1_000_003 + p + 1) % (2**61 - 1)
    return value


def intrinsics(scene: Dict, h: int, w: int) -> Tensor:
    fx, fy, cx, cy = scene["intrinsics_relative"]
    k = torch.eye(4)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = fx * w, fy * h, cx * w, cy * h
    return k


def _render(k: Tensor, cam_pos: Tensor, normal: Tensor, dist: Tensor, waves: Tensor,
            h: int, w: int):
    """Images (N, 3, H, W) in [-0.5, 0.5] and depths (N, H, W) of N planes
    ``normal . X = dist`` seen from cameras at ``cam_pos`` (N, 3), no
    rotation. ``waves`` (N, 3, TEXTURE_WAVES, 4): per channel, the two
    frequencies, the phase and the amplitude of each sinusoid."""
    dev = cam_pos.device
    v, u = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                          torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
    rays = torch.stack([(u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1], torch.ones_like(u)])
    denom = torch.einsum("nc,chw->nhw", normal, rays)
    depth = (dist - (normal * cam_pos).sum(-1))[:, None, None] / denom
    world = cam_pos[:, :, None, None] + depth[:, None] * rays[None]
    # Coordinates on the plane: two axes orthogonal to its normal.
    ax = torch.nn.functional.normalize(torch.linalg.cross(
        normal, torch.tensor([0.0, 1.0, 0.0], device=dev).expand_as(normal)), dim=-1)
    ay = torch.linalg.cross(normal, ax)
    pu = torch.einsum("nc,nchw->nhw", ax, world)
    pv = torch.einsum("nc,nchw->nhw", ay, world)
    f1, f2, ph, amp = waves.unbind(-1)  # (N, 3, W)
    arg = (f1[..., None, None] * pu[:, None, None] + f2[..., None, None] * pv[:, None, None]
           + ph[..., None, None])
    img = (amp[..., None, None] * torch.sin(arg)).sum(2)
    return img.clamp(-0.5, 0.5), depth


def make_batches(scene: Dict, n_batches: int, batch: int, h: int, w: int, frames: int,
                 stereo: bool, seed: int, device, first_row: int = 0,
                 rows: int = None) -> List[Dict[str, Tensor]]:
    """The first ``n_batches`` batches of ``batch`` samples each of the
    stream that ``seed`` draws (batch i is the same whatever ``n_batches``);
    with ``rows``, only the rows ``[first_row, first_row + rows)`` of each
    (a rank's share of a global batch), drawn as the whole batch is."""
    rows = batch if rows is None else rows
    return [_batch(scene, batch, h, w, frames, stereo, sub_seed(seed, 1, i), device, first_row,
                   rows) for i in range(n_batches)]


def _batch(scene: Dict, batch: int, h: int, w: int, frames: int, stereo: bool, seed: int,
           device, first_row: int, rows: int) -> Dict[str, Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    k = intrinsics(scene, h, w).to(device)
    lo, hi = scene["plane_distance_m"]
    tilt = scene["plane_tilt"]
    keep = slice(first_row, first_row + rows)
    draws = torch.rand(batch, 3, generator=gen, device=device)[keep]
    dist = lo + (hi - lo) * draws[:, 0]
    normal = torch.nn.functional.normalize(torch.stack(
        [tilt * (2 * draws[:, 1] - 1), tilt * (2 * draws[:, 2] - 1),
         torch.ones(rows, device=device)], -1), dim=-1)
    fmin, fmax = scene["texture_frequency"]
    w_draw = torch.rand(batch, 3, TEXTURE_WAVES, 4, generator=gen, device=device)[keep]
    waves = torch.stack([
        (fmin + (fmax - fmin) * w_draw[..., 0]) * torch.where(w_draw[..., 3] < 0.5, -1.0, 1.0),
        fmin + (fmax - fmin) * w_draw[..., 1],
        2 * math.pi * w_draw[..., 2],
        torch.full_like(w_draw[..., 0], 0.5 / math.sqrt(TEXTURE_WAVES)),
    ], -1)
    sparse = (torch.rand(batch, h, w, generator=gen, device=device) < scene["target_density"])[keep]
    step = scene["forward_m_per_frame"]
    offsets = [o for o in range(-(frames // 2), frames - frames // 2 + 1) if o != 0][:frames]

    def at(x, y, z):
        return torch.tensor([x, y, z], device=device).expand(rows, 3)

    key_img, key_depth = _render(k, at(0, 0, 0), normal, dist, waves, h, w)
    src = [_render(k, at(0, 0, o * step), normal, dist, waves, h, w)[0] for o in offsets]
    eye = torch.eye(4, device=device)
    out = {
        "keyframe": key_img,
        "keyframe_pose": eye.expand(rows, 4, 4).clone(),
        "keyframe_intrinsics": k.expand(rows, 4, 4).clone(),
        "frames": torch.stack(src, 1),
        "poses": torch.stack([_pose(eye, 0, o * step) for o in offsets])
        .expand(rows, -1, 4, 4).clone(),
        "intrinsics": k.expand(rows, frames, 4, 4).clone(),
        "target": torch.where(sparse, 1.0 / key_depth, 0.0)[:, None],
        "mvobj_mask": torch.zeros(rows, 1, h, w, device=device),
    }
    if stereo:
        base = scene["stereo_baseline_m"]
        out["stereoframe"] = _render(k, at(base, 0, 0), normal, dist, waves, h, w)[0]
        out["stereoframe_pose"] = _pose(eye, base, 0).expand(rows, 4, 4).clone()
        out["stereoframe_intrinsics"] = k.expand(rows, 4, 4).clone()
    return out


def _pose(eye: Tensor, x: float, z: float) -> Tensor:
    p = eye.clone()
    p[0, 3], p[2, 3] = x, z
    return p


def to_host(batch: Dict[str, Tensor], pin: bool) -> Dict[str, Tensor]:
    """The batch in host memory, pinned when ``pin``."""
    out = {}
    for key, v in batch.items():
        t = v.to("cpu").contiguous()
        out[key] = t.pin_memory() if pin else t
    return out
