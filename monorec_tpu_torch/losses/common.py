"""Shared losses: photometric reprojection, smoothness, sparse depth
(``monorec_tpu/losses/common.py``), on NCHW tensors.

* ``compute_errors_planar``: 0.85 * SSIM (zero pad, gaussian window,
  comp_mode) + 0.15 * L1, channel mean, through the fused kernel K3.
* ``reprojection_loss``: warp every source frame by the predicted depth
  through the loss-warp kernel K2 (on sources in the precision policy's
  ``loss_warp_dtype``; the warped frames come back float32), score it, combine the frames by
  min / avg / rnd with out-of-view masking (inf sentinels), optional
  automasking and mono_auto.
* ``edge_aware_smoothness_loss`` and ``sparse_depth_loss``.

Masks are boolean "invalid" masks. A pixel is out of view when the first
channel of its warp is exactly 0: the frames are shifted by +1.5 before the
warp (into [1, 2]), so only a sample with no tap inside the image is 0.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from monorec_tpu_torch import geometry
from monorec_tpu_torch.ops.cost_volume import border_mask
from monorec_tpu_torch.ops.photo_error import photo_error, photo_error_reference
from monorec_tpu_torch.ops.sampling import grid_sample_planar
from monorec_tpu_torch.parallel import batch_mean, draw_rows
from monorec_tpu_torch.precision import loss_warp_dtype
from monorec_tpu_torch.utils import mask_mean

Tensor = torch.Tensor
INF = float("inf")


def compute_errors(img0: Tensor, img1: Tensor) -> Tensor:
    """0.85 * SSIM + 0.15 * L1, channel mean: (B, C, H, W) -> (B, H, W),
    differentiable in both inputs (the reference ``compute_errors``)."""
    return photo_error_reference(img0, img1)


def compute_errors_planar(img0: Tensor, img1: Tensor, img1_is_data: bool = True) -> Tensor:
    """``compute_errors`` on (..., C, H, W) -> (..., H, W), float32.

    GRADIENT CONTRACT: with ``img1_is_data`` (the default, and every caller
    in this module, which passes the keyframe as ``img1``) a 4-d input goes
    through the kernel K3 (``ops/photo_error.py::photo_error``), whose
    gradient reaches ``img0`` only. ``img1_is_data=False`` takes the
    symmetric plain path on every device, for callers that need
    d/d(img1)."""
    if img0.dim() == 4 and img1_is_data:
        return photo_error(img0.to(torch.float32), img1.to(torch.float32))
    return photo_error_reference(img0, img1).to(torch.float32)


def _nan_to_zero(t: Tensor) -> Tensor:
    return torch.where(torch.isnan(t), 0.0, t)


def _gather_frames(data: Dict, use_mono: bool, use_stereo: bool):
    frames, poses, intr = [], [], []
    if use_mono:
        frames.append(data["frames"])
        poses.append(data["poses"])
        intr.append(data["intrinsics"])
    if use_stereo:
        frames.append(data["stereoframe"][:, None])
        poses.append(data["stereoframe_pose"][:, None])
        intr.append(data["stereoframe_intrinsics"][:, None])
    return torch.cat(frames, 1), torch.cat(poses, 1), torch.cat(intr, 1)


def loss_warp_grids(depth: Tensor, poses: Tensor, intrinsics: Tensor,
                    keyframe_pose: Tensor, keyframe_intrinsics: Tensor) -> Tensor:
    """Normalized sampling grids (B, F, H, W, 2) that warp each source frame
    onto the keyframe by the metric ``depth`` (B, H, W)."""
    h, w = depth.shape[-2:]
    inv_k = geometry.invert_intrinsics(keyframe_intrinsics)  # (B, 4, 4)
    pts = geometry.backproject(depth[:, None], inv_k, h, w)  # (B, 1, 4, HW)
    rel = geometry.invert_pose(poses) @ keyframe_pose[:, None]  # (B, F, 4, 4)
    return geometry.project(pts, intrinsics, rel, h, w)


def _warp_by_depth_planar(depth: Tensor, frames: Tensor, poses: Tensor, intrinsics: Tensor,
                          keyframe_pose: Tensor, keyframe_intrinsics: Tensor,
                          add: float) -> Tensor:
    """Warp each source frame (+add offset) onto the keyframe: (B, F, C, H, W).
    All (sample, frame) pairs go through ONE batched call of the loss-warp
    kernel over the (B*F) stack."""
    b, f, c, h, w = frames.shape
    grids = loss_warp_grids(depth, poses, intrinsics, keyframe_pose, keyframe_intrinsics)
    warped = grid_sample_planar(
        (frames + add).reshape(b * f, c, h, w), grids.reshape(b * f, h, w, 2),
        kernel_dtype=loss_warp_dtype(),
    )
    return warped.reshape(b, f, c, h, w)


def reprojection_loss(
    inv_depth: Tensor,  # (B, 1, H, W) inverse depth prediction
    data: Dict,
    automasking: bool = False,
    use_mono: bool = True,
    use_stereo: bool = False,
    reduce: bool = True,
    combine_frames: str = "min",
    mono_auto: bool = False,
    border: int = 0,
    generator: Optional[torch.Generator] = None,
    automask_errors: Optional[Tensor] = None,
):
    """Multi-frame photometric reprojection loss.

    Returns a scalar if ``reduce`` else a (B, H, W) error map in which
    invalid pixels carry +inf. ``automask_errors`` optionally supplies the identity-reprojection errors (B, F, H, W),
    which depend only on the input frames, so multi-scale callers compute
    them once. ``combine_frames="rnd"`` draws each sample's frame from
    ``generator`` (a CPU ``torch.Generator``).
    """
    keyframe = data["keyframe"]
    b, c, h, w = keyframe.shape
    frames, poses, intrinsics = _gather_frames(data, use_mono, use_stereo)
    f = frames.shape[1]

    depth = 1.0 / inv_depth[:, 0]
    reproj = _warp_by_depth_planar(
        depth, frames, poses, intrinsics, data["keyframe_pose"], data["keyframe_intrinsics"],
        add=1.5,
    )
    invalid = reproj[:, :, 0] == 0  # (B, F, H, W): the first channel hit zero padding
    reproj = reproj - 1.0

    if border > 0:
        bm = border_mask(h, w, border, keyframe.device, keyframe.dtype)
        bm_f = bm.expand(b, f, 1, h, w)
        # The warped border mask feeds only the > 0.5 comparison: no gradient.
        with torch.no_grad():
            warped_bm = _warp_by_depth_planar(
                depth, bm_f, poses, intrinsics, data["keyframe_pose"],
                data["keyframe_intrinsics"], add=0.0,
            )[:, :, 0]
        invalid = ~(warped_bm > 0.5)

    key = (keyframe + 0.5)[:, None].expand(b, f, c, h, w)
    flat = lambda x: x.reshape(b * f, c, h, w)  # noqa: E731
    errors = compute_errors_planar(flat(reproj), flat(key)).reshape(b, f, h, w)
    errors = torch.where(invalid, INF, errors)

    if automasking:
        if automask_errors is None:
            automask_errors = compute_errors_planar(flat(frames + 0.5), flat(key)).reshape(
                b, f, h, w)
        errors = torch.where(automask_errors < errors, INF, errors)

    if mono_auto:
        fm = data["frames"].shape[1]
        key_m = (keyframe + 0.5)[:, None].expand(b, fm, c, h, w).reshape(b * fm, c, h, w)
        e_nw = compute_errors_planar(
            (data["frames"] + 0.5).reshape(b * fm, c, h, w), key_m).reshape(b, fm, h, w)
        e_nw = e_nw.mean(1, keepdim=True)
        e_nw = torch.where(invalid.all(1, keepdim=True), INF, e_nw)
        errors = torch.minimum(errors, e_nw.expand_as(errors))

    if combine_frames == "min":
        errors = torch.amin(errors, 1)
        invalid = torch.isinf(errors)
    elif combine_frames == "avg":
        inv = torch.isinf(errors)
        hits = (~inv).to(errors.dtype).sum(1)
        s = torch.where(inv, 0.0, errors).sum(1)
        invalid = hits == 0
        errors = torch.where(invalid, INF, s / torch.clamp_min(hits, 1.0))
    elif combine_frames == "rnd":
        if generator is None:
            raise ValueError("combine_frames='rnd' requires a generator")
        idx = draw_rows(lambda n: torch.randint(0, f, (n,), generator=generator), b)
        idx = idx.to(errors.device)
        pick = idx[:, None, None, None].expand(b, 1, h, w)
        errors = torch.gather(errors, 1, pick)[:, 0]
        invalid = torch.gather(invalid, 1, pick)[:, 0]
    else:
        raise ValueError("combine_frames must be 'min', 'avg' or 'rnd'")

    return mask_mean(torch.where(invalid, 0.0, errors), invalid) if reduce else errors


def identity_reprojection_errors(data: Dict, use_mono: bool = True,
                                 use_stereo: bool = False) -> Tensor:
    """Per-frame errors of the UN-warped source frames against the keyframe
    (the automasking term, reference ``common_losses.py:80-83``). They
    depend only on the inputs, so multi-scale losses compute them once.
    Returns (B, F, H, W)."""
    keyframe = data["keyframe"]
    b, c, h, w = keyframe.shape
    frames, _, _ = _gather_frames(data, use_mono, use_stereo)
    f = frames.shape[1]
    key = (keyframe + 0.5)[:, None].expand(b, f, c, h, w)
    return compute_errors_planar(
        (frames + 0.5).reshape(b * f, c, h, w), key.reshape(b * f, c, h, w)
    ).reshape(b, f, h, w)


_TILED_KEYS = (
    "keyframe", "keyframe_pose", "keyframe_intrinsics", "frames", "poses", "intrinsics",
    "stereoframe", "stereoframe_pose", "stereoframe_intrinsics",
)


def tile_batch_for_scales(data: Dict, n_scales: int) -> Dict:
    """Tile the entries the reprojection reads ``n_scales`` times along the
    batch axis, so all scales of a multi-scale loss run through ONE batched
    reprojection. Scale s lives at rows [s*B, (s+1)*B)."""
    return {
        k: data[k].repeat(n_scales, *([1] * (data[k].dim() - 1)))
        for k in _TILED_KEYS if k in data
    }


def edge_aware_smoothness_loss(inv_depth: Tensor, keyframe: Tensor, reduce: bool = True):
    """Mean-normalized disparity gradients, attenuated by image gradients.

    ``reduce=True`` -> scalar (mean of the x map + mean of the y map);
    ``reduce=False`` -> (B, 1, H, W) map with both gradients zero-padded back
    to full size.
    """
    d = inv_depth / inv_depth.mean(dim=(2, 3), keepdim=True)
    d_dx = (d[..., :, :-1] - d[..., :, 1:]).abs()
    d_dy = (d[..., :-1, :] - d[..., 1:, :]).abs()
    k_dx = (keyframe[..., :, :-1] - keyframe[..., :, 1:]).abs().mean(1, keepdim=True)
    k_dy = (keyframe[..., :-1, :] - keyframe[..., 1:, :]).abs().mean(1, keepdim=True)
    d_dx = d_dx * torch.exp(-k_dx)
    d_dy = d_dy * torch.exp(-k_dy)
    if reduce:
        return batch_mean(d_dx) + batch_mean(d_dy)
    return torch.nn.functional.pad(d_dx, (0, 1)) + torch.nn.functional.pad(d_dy, (0, 0, 0, 1))


def sparse_depth_loss(pred: Tensor, gt: Tensor, l2: bool = False, reduce: bool = True):
    """L1 / L2 loss on pixels with non-zero GT (inverse-depth domain)."""
    invalid = gt == 0
    errors = (pred - gt) ** 2 if l2 else (pred - gt).abs()
    if reduce:
        return _nan_to_zero(mask_mean(torch.where(invalid, 0.0, errors), invalid))
    return errors, invalid


def selfsup_loss(inv_depth: Tensor, data: Dict, scale: int = 0, automasking: bool = True,
                 use_mono: bool = True, use_stereo: bool = False, combine_frames: str = "min",
                 mask_border: int = 0, generator: Optional[torch.Generator] = None):
    """Reprojection + edge-aware smoothness (scaled 1e-3 / 2^scale)."""
    r = reprojection_loss(
        inv_depth, data, automasking=automasking, use_mono=use_mono, use_stereo=use_stereo,
        reduce=True, combine_frames=combine_frames, border=mask_border, generator=generator,
    )
    s = _nan_to_zero(edge_aware_smoothness_loss(inv_depth, data["keyframe"]))
    return _nan_to_zero(r) + s * 1e-3 / (2**scale)


def upsample_nearest_to(x: Tensor, height: int, width: int) -> Tensor:
    """Nearest-neighbour resize of NCHW to (height, width): source index
    ``i * h // height`` (torch ``F.upsample`` default mode for integer
    factors)."""
    h, w = x.shape[-2:]
    if (h, w) == (height, width):
        return x
    ys = torch.arange(height, device=x.device) * h // height
    xs = torch.arange(width, device=x.device) * w // width
    return x[..., ys, :][..., xs]
