"""Plane-sweep photometric cost volume (``monorec_tpu/ops/cost_volume.py``).

For every depth hypothesis d (linear in inverse depth, far -> near) and
every source frame f, warp frame f onto the keyframe through the pinhole
homography of d, score the match with SSIM (3x3 window) reduced by a
channel-weighted 3x3 patch SAD, and fuse the frames with an
exp(-alpha * (sad - min_d sad)^2) sharpness weight.

Three paths compute it:
  * the sweep path: per-(b, f, d) 3x3 homographies, then the fused
    scoring and frame fusion ``plane_sweep_cost_volume`` (kernel K1 on CUDA
    tensors, its plain version ``plane_sweep_sad`` -> ``score_and_fuse`` on
    CPU tensors). It serves the 3x3 patch on RGB with ``sfcv_mult_mask``;
  * the warp path, for every other configuration of shared hypotheses
    (``sfcv_mult_mask=False``, which needs the warped values, another
    patch size or channel count): the same homographies, the warp-only
    ``warp_plane_sweep`` (kernel K4, ``ops/warp_sweep.py``), then the
    scoring in plain torch (``monorec_tpu/ops/cost_volume.py::
    _compute_cost_volume_pallas_warp``);
  * the plain path: backproject -> project -> ``grid_sample``, as the
    reference's ``_cost_volume_single``. It serves a per-pixel
    ``cv_depths`` override; ``plain=True`` forces it for A/B checks.

``compute_cost_volume_pair`` gives the stage 2-4 protocol's mono and stereo
cost volumes of one keyframe, from one grouped launch of K1 where the sweep
path serves.

``CostVolumeConfig.warp_dtype="bfloat16"`` (the serving policy) hands the
sweep and warp paths bf16 source frames; the keyframe stays float32. The
plain path ignores it, as the JAX package's XLA path does.

Layout: images NCHW, frames (B, F, C, H, W); the fused cost volume is
(B, D, H, W) and the per-frame ones (B, F, D, H, W), hypotheses in the
channel dimension. Everything runs under ``torch.no_grad()``, as the
reference computes the cost volume.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from monorec_tpu_torch import geometry
from monorec_tpu_torch.ops.plane_sweep import (
    box_sum_3x3,
    photometric_difference,
    plane_sweep_cost_volume,
    score_and_fuse,
    valid_pixels,
)
from monorec_tpu_torch.ops.sampling import bilinear_sample
from monorec_tpu_torch.ops.warp_sweep import warp_plane_sweep
from monorec_tpu_torch.precision import torch_dtype

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CostVolumeConfig:
    depth_steps: int = 32
    patch_size: int = 3
    channel_weights: Tuple[float, ...] = (5 / 32, 16 / 32, 11 / 32)
    alpha: float = 10.0
    # use_ssim: 1 -> SSIM, 2 -> 0.85*SSIM + 0.15*L1, 0 -> raw L1,
    # -1 -> 3x3-avg-pooled L1 (the reference's "else" branch).
    use_ssim: int = 1
    sfcv_mult_mask: bool = True
    not_center_cv: bool = False
    # "float32" (exact) or "bfloat16": the dtype of the source frames that
    # the kernels K1 and K4 read.
    warp_dtype: str = "float32"

    @property
    def border_radius(self) -> int:
        return self.patch_size // 2 + 1


def border_mask(height: int, width: int, border_radius: int, device=None,
                dtype=torch.float32) -> Tensor:
    """(H, W) mask: 1 in the interior, 0 within border_radius of the edge."""
    m = torch.zeros(height, width, dtype=dtype, device=device)
    m[border_radius : height - border_radius, border_radius : width - border_radius] = 1.0
    return m


def plane_sweep_homographies(
    keyframe_intrinsics: Tensor,  # (B, 4, 4)
    keyframe_pose: Tensor,  # (B, 4, 4)
    frame_intrinsics: Tensor,  # (B, F, 4, 4)
    frame_poses: Tensor,  # (B, F, 4, 4)
    inv_depths: Tensor,  # (D,)
    height: int,
    width: int,
) -> Tensor:
    """Fold the warp pipeline into per-(b, f, d) 3x3 homographies (B, F, D, 3, 3).

    Output pixel p = (x, y, 1) maps to source s = M p with xs = s0/s2 and
    ys = s1/s2 directly in align_corners=False pixel units: the reference's
    project -> normalize by (W-1, H-1) -> (u - .5) * 2 -> grid_sample
    unnormalization composed into M, normalized so that M[2, 2] == 1.
    Computed and returned in float64: the scoring evaluates M - I, whose
    digits a float32 M near the identity has already lost.
    """
    keyframe_intrinsics, keyframe_pose, frame_intrinsics, frame_poses, inv_depths = (
        t.to(torch.float64) for t in (
            keyframe_intrinsics, keyframe_pose, frame_intrinsics, frame_poses, inv_depths
        )
    )
    inv_k = geometry.invert_intrinsics(keyframe_intrinsics)[:, :3, :3]
    rel = geometry.invert_pose(frame_poses) @ keyframe_pose[:, None]  # (B, F, 4, 4)
    kt = frame_intrinsics @ rel
    a = kt[:, :, :3, :3] @ inv_k[:, None]  # (B, F, 3, 3)
    t = kt[:, :, :3, 3]  # (B, F, 3)
    e3 = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype, device=a.device)
    m = a[:, :, None] + inv_depths[None, None, :, None, None] * (
        t[:, :, None, :, None] * e3
    )  # (B, F, D, 3, 3)
    sx = width / (width - 1)
    sy = height / (height - 1)
    row0 = sx * m[..., 0, :] - 0.5 * m[..., 2, :]
    row1 = sy * m[..., 1, :] - 0.5 * m[..., 2, :]
    m = torch.stack([row0, row1, m[..., 2, :]], dim=-2)
    return m / m[..., 2:3, 2:3]


def _sweep_path_ok(keyframe: Tensor, cfg: CostVolumeConfig) -> bool:
    """What the fused scoring K1 can serve: masked per-frame CVs, the 3x3
    patch and one weight per channel of an RGB image."""
    return (
        cfg.sfcv_mult_mask
        and cfg.patch_size == 3
        and keyframe.shape[1] == len(cfg.channel_weights) == 3
    )


def _sweep_sources(keyframe, keyframe_intrinsics, keyframe_pose, frames, frame_intrinsics,
                   frame_poses, inv_depth_max, inv_depth_min, cfg):
    """The kernels' inputs: source images (B*F, C, H, W) in ``cfg.warp_dtype``
    and their homographies (B*F, D, 3, 3), float64."""
    b, c, h, w = keyframe.shape
    f = frames.shape[1]
    d = cfg.depth_steps
    inv_depths = torch.linspace(
        float(inv_depth_max), float(inv_depth_min), d,
        dtype=torch.float64, device=keyframe.device,
    )
    homs = plane_sweep_homographies(
        keyframe_intrinsics, keyframe_pose, frame_intrinsics, frame_poses,
        inv_depths, h, w,
    ).reshape(b * f, d, 3, 3)
    images = frames.reshape(b * f, c, h, w).to(torch_dtype(cfg.warp_dtype))
    return images.contiguous(), homs.contiguous()


def _cost_volume_sweep(keyframe, keyframe_intrinsics, keyframe_pose, frames,
                       frame_intrinsics, frame_poses, inv_depth_max, inv_depth_min, cfg,
                       groups=None):
    """K1 over every frame: (fused, sfcv), or with ``groups``
    ``[(fused, sfcv) per group]`` from the one launch."""
    f = frames.shape[1]
    images, homs = _sweep_sources(keyframe, keyframe_intrinsics, keyframe_pose, frames,
                                  frame_intrinsics, frame_poses, inv_depth_max, inv_depth_min,
                                  cfg)
    cw = tuple(float(x) / cfg.patch_size**2 for x in cfg.channel_weights)
    return plane_sweep_cost_volume(
        images,
        keyframe.contiguous(),
        homs,
        border_radius=cfg.border_radius,
        frames_per_image=f,
        use_ssim=cfg.use_ssim,
        channel_weights=cw,
        alpha=cfg.alpha,
        not_center_cv=cfg.not_center_cv,
        groups=groups,
    )


def _score_warped(warped, keyframe, valid, cfg):
    """Score a warped stack (B, F, D, C, H, W) against the keyframe
    (B, C, H, W): the photometric difference by ``use_ssim``, the channel
    weights over patch_size**2, the 3x3 box sum, then ``score_and_fuse``
    with ``valid`` (B, F, H, W). With ``sfcv_mult_mask=False`` a per-frame
    CV is kept where its warped pixel is non-zero in some channel or equals
    the keyframe in all (reference ``monorec_model.py:229-236``)."""
    b, f, d, c, h, w = warped.shape
    key = keyframe[:, None, None].expand(b, f, d, c, h, w)
    diff = photometric_difference(
        warped.reshape(-1, c, h, w), key.reshape(-1, c, h, w), cfg.use_ssim
    )
    cw = [float(x) / cfg.patch_size**2 for x in cfg.channel_weights]
    weighted = cw[0] * diff[:, 0]
    for ci in range(1, c):
        weighted = weighted + cw[ci] * diff[:, ci]
    sad = box_sum_3x3(weighted).reshape(b, f, d, h, w)

    fused, sfcv = score_and_fuse(sad, valid, cfg.alpha, cfg.not_center_cv)
    if not cfg.sfcv_mult_mask:
        any_nonzero = (warped != 0).any(dim=3)
        all_equal = (warped == key).all(dim=3)
        sfcv = (1.0 - 2.0 * sad) * (any_nonzero | all_equal).to(sad.dtype)
    return fused, sfcv


def _cost_volume_warp(keyframe, keyframe_intrinsics, keyframe_pose, frames,
                      frame_intrinsics, frame_poses, inv_depth_max, inv_depth_min, cfg):
    """K4 warps the sources over the hypotheses, plain torch scores them
    (``monorec_tpu/ops/cost_volume.py::_compute_cost_volume_pallas_warp``).
    Under ``warp_dtype="bfloat16"`` the warped stack is bf16, rounded from
    the kernel's float32 sums, and is scored in float32 from there."""
    b, c, h, w = keyframe.shape
    f = frames.shape[1]
    d = cfg.depth_steps
    images, homs = _sweep_sources(keyframe, keyframe_intrinsics, keyframe_pose, frames,
                                  frame_intrinsics, frame_poses, inv_depth_max, inv_depth_min,
                                  cfg)
    warped, wmask = warp_plane_sweep(images, homs, cfg.border_radius)
    warped = warped.to(keyframe.dtype).reshape(b, f, d, c, h, w)
    valid = valid_pixels(wmask, cfg.border_radius).to(keyframe.dtype)  # (N, H, W)
    return _score_warped(warped, keyframe, valid.reshape(b, f, h, w), cfg)


def _cost_volume_plain(keyframe, keyframe_intrinsics, keyframe_pose, frames,
                       frame_intrinsics, frame_poses, depths, cfg):
    """The reference pipeline (``_cost_volume_single``), batched over (B, F)."""
    b, c, h, w = keyframe.shape
    f = frames.shape[1]
    d = depths.shape[1]
    cam = geometry.backproject(
        depths, geometry.invert_intrinsics(keyframe_intrinsics), h, w
    )  # (B, D, 4, HW)
    rel = geometry.invert_pose(frame_poses) @ keyframe_pose[:, None]  # (B, F, 4, 4)
    coords = geometry.project(
        cam[:, None], frame_intrinsics[:, :, None], rel[:, :, None], h, w
    ).clamp(-2.0, 2.0)  # (B, F, D, H, W, 2)
    grid = coords.reshape(b * f, d * h, w, 2)

    warped = bilinear_sample(frames.reshape(b * f, c, h, w), grid)
    warped = warped.reshape(b, f, c, d, h, w).transpose(2, 3)  # (B, F, D, C, H, W)
    bmask = border_mask(h, w, cfg.border_radius, keyframe.device, keyframe.dtype)
    warped_b = bilinear_sample(bmask.expand(b * f, 1, h, w), grid).reshape(b, f, d, h, w)
    # A pixel is valid only if its reprojection hits the interior at ALL
    # hypotheses (reference ``monorec_model.py:219``).
    valid = bmask * (warped_b != 0).to(bmask.dtype).amin(dim=2)  # (B, F, H, W)
    return _score_warped(warped, keyframe, valid, cfg)


def compute_cost_volume(
    keyframe: Tensor,
    keyframe_intrinsics: Tensor,
    keyframe_pose: Tensor,
    frames: Tensor,
    frame_intrinsics: Tensor,
    frame_poses: Tensor,
    inv_depth_max: float,
    inv_depth_min: float,
    cfg: CostVolumeConfig = CostVolumeConfig(),
    cv_depths: Optional[Tensor] = None,
    plain: bool = False,
):
    """Batched plane-sweep cost volume.

    Args:
      keyframe: (B, C, H, W) in [-0.5, 0.5].
      keyframe_intrinsics / keyframe_pose: (B, 4, 4).
      frames: (B, F, C, H, W); frame_intrinsics / frame_poses: (B, F, 4, 4).
      inv_depth_max / inv_depth_min: the sweep runs from the first to the
        second (the model passes its smaller inverse depth first).
      cv_depths: optional (B, D, H, W) per-pixel depth override (the plain
        path serves it).
      plain: force the plain path.

    Returns:
      fused (B, D, H, W) and per-frame (B, F, D, H, W) cost volumes.
    """
    with torch.no_grad():
        if plain or cv_depths is not None:
            if cv_depths is None:
                b, _, h, w = keyframe.shape
                depths = geometry.depth_hypotheses(
                    inv_depth_max, inv_depth_min, cfg.depth_steps, keyframe.device,
                    keyframe.dtype,
                )[None, :, None, None].expand(b, -1, h, w)
            else:
                depths = cv_depths
            return _cost_volume_plain(
                keyframe, keyframe_intrinsics, keyframe_pose, frames,
                frame_intrinsics, frame_poses, depths, cfg,
            )
        else:
            path = _cost_volume_sweep if _sweep_path_ok(keyframe, cfg) else _cost_volume_warp
            return path(
                keyframe, keyframe_intrinsics, keyframe_pose, frames,
                frame_intrinsics, frame_poses, inv_depth_max, inv_depth_min, cfg,
            )


def compute_cost_volume_pair(
    keyframe: Tensor,
    keyframe_intrinsics: Tensor,
    keyframe_pose: Tensor,
    mono_frames: Tensor,
    mono_intrinsics: Tensor,
    mono_poses: Tensor,
    stereo_frame: Tensor,
    stereo_intrinsics: Tensor,
    stereo_pose: Tensor,
    inv_depth_max: float,
    inv_depth_min: float,
    cfg: CostVolumeConfig = CostVolumeConfig(),
    cv_depths: Optional[Tensor] = None,
    plain: bool = False,
):
    """The mono and the stereo cost volume of one keyframe
    (``monorec_tpu/ops/cost_volume.py::compute_cost_volume_pair``): the
    stage 2-4 protocol's two cost volumes, which the reference computes in
    two passes. Where the sweep path serves (``_sweep_path_ok``, no
    ``cv_depths``, not ``plain``), the stereo frame joins the F mono frames
    of its keyframe and ONE launch of K1 sweeps the F + 1 frames, fusing the
    mono group and the stereo group apart; the result equals two
    ``compute_cost_volume`` calls. Otherwise it is those two calls.

    Args:
      mono_frames: (B, F, C, H, W); mono_intrinsics / mono_poses: (B, F, 4, 4).
      stereo_frame: (B, C, H, W); stereo_intrinsics / stereo_pose: (B, 4, 4).
      The rest as ``compute_cost_volume``.

    Returns:
      (mono fused (B, D, H, W), mono per-frame (B, F, D, H, W), stereo fused,
      stereo per-frame (B, 1, D, H, W)), computed without a gradient.
    """
    stereo = (stereo_frame[:, None], stereo_intrinsics[:, None], stereo_pose[:, None])
    if plain or cv_depths is not None or not _sweep_path_ok(keyframe, cfg):
        common = (inv_depth_max, inv_depth_min, cfg, cv_depths, plain)
        return (*compute_cost_volume(keyframe, keyframe_intrinsics, keyframe_pose, mono_frames,
                                     mono_intrinsics, mono_poses, *common),
                *compute_cost_volume(keyframe, keyframe_intrinsics, keyframe_pose, *stereo,
                                     *common))
    with torch.no_grad():
        frames, intr, poses = (torch.cat([m, s], 1) for m, s in zip(
            (mono_frames, mono_intrinsics, mono_poses), stereo))
        (m_fused, m_sfcv), (s_fused, s_sfcv) = _cost_volume_sweep(
            keyframe, keyframe_intrinsics, keyframe_pose, frames, intr, poses, inv_depth_max,
            inv_depth_min, cfg, groups=(mono_frames.shape[1], 1))
    return m_fused, m_sfcv, s_fused, s_sfcv
