"""Training-time augmentation (``monorec_tpu/models/augmentation.py``) on
NCHW tensors, with every random draw from an explicit ``torch.Generator``.

* The depth augmentation (``DepthAugmentation`` in the reference): a
  per-sample horizontal flip of the keyframe, the cost volumes and the
  masks, and the same flip of every prediction to revert it (a flip is its
  own inverse).
* The mask augmentation (``MaskAugmentation``, kornia's
  RandomHorizontalFlip + RandomResizedCrop with scale 0.8-1 and ratio
  1.9-2.1): one flip and one crop rectangle per sample, applied alike to
  every tensor of the sample and resized back to its own resolution. The
  crop samples through the kernel K2 (``ops/sampling.py::
  grid_sample_planar``), which gives the sampled tensor no gradient. That is
  exact only because every cropped tensor is data or a cost volume computed
  without a gradient; ``apply_mask_aug`` refuses a tensor that requires one
  where autograd would record the crop.

* The colour jitter (the JAX package's on-device replacement for the
  reference's ``ColorJitterMulti``): brightness, contrast, saturation and
  hue, in a random order, one parameter set per sample shared by all of its
  frames and image keys. The draws come from the trainer's generator on the
  CPU; the jitter runs on the images' device, one group of samples per
  (step, operation).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monorec_tpu_torch.ops.sampling import grid_sample_planar
from monorec_tpu_torch.parallel import draw_rows

Tensor = torch.Tensor


def sample_flip_conditions(generator: torch.Generator, batch_size: int) -> Tensor:
    """Per-sample flip decisions (B,) bool, each with probability 0.5, drawn
    on the CPU from ``generator``."""
    return torch.rand(batch_size, generator=generator) < 0.5


def conditional_hflip(x: Tensor, conditions: Tensor) -> Tensor:
    """Flip the samples of (B, ..., H, W) ``x`` along W where ``conditions``."""
    cond = conditions.to(x.device).reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return torch.where(cond, x.flip(-1), x)


class MaskAugParams(NamedTuple):
    """One flip and one crop rectangle per sample, each (B,); the rectangle's
    top-left corner and size in source pixels."""

    flip: Tensor
    y0: Tensor
    x0: Tensor
    crop_h: Tensor
    crop_w: Tensor

    def to(self, device) -> "MaskAugParams":
        return MaskAugParams(*(p.to(device) for p in self))


def sample_mask_aug_params(generator: torch.Generator, batch_size: int, height: int,
                           width: int) -> MaskAugParams:
    """Random flip and resized-crop parameters (scale 0.8-1, ratio 1.9-2.1),
    float32, drawn on the CPU from ``generator``."""
    flip = torch.rand(batch_size, generator=generator) < 0.5
    scale = 0.8 + 0.2 * torch.rand(batch_size, generator=generator)
    ratio = 1.9 + 0.2 * torch.rand(batch_size, generator=generator)
    area = scale * height * width
    crop_w = torch.clamp(torch.sqrt(area * ratio), 1.0, width)
    crop_h = torch.clamp(torch.sqrt(area / ratio), 1.0, height)
    u = torch.rand(batch_size, 2, generator=generator)
    y0 = u[:, 0] * (height - crop_h)
    x0 = u[:, 1] * (width - crop_w)
    return MaskAugParams(flip, y0, x0, crop_h, crop_w)


def crop_grid(params: MaskAugParams, h: int, w: int) -> Tensor:
    """The normalized sampling grid (N, H, W, 2) of the crops, the JAX
    package's: output pixel (i, j) samples its crop at the align_corners=False
    centre y = y0 + (i + 0.5) / H * crop_h - 0.5 (x alike)."""
    n, device = params.y0.shape[0], params.y0.device
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    gy = params.y0[:, None] + ys[None, :] * params.crop_h[:, None]  # (N, H)
    gx = params.x0[:, None] + xs[None, :] * params.crop_w[:, None]  # (N, W)
    ny = (2.0 * gy) / h - 1.0
    nx = (2.0 * gx) / w - 1.0
    return torch.stack([nx[:, None, :].expand(n, h, w), ny[:, :, None].expand(n, h, w)], -1)


def apply_mask_aug(x: Tensor, params: MaskAugParams) -> Tensor:
    """Flip, then crop and resize (N, C, H, W) ``x`` back to (H, W): bilinear
    samples with zero padding at ``crop_grid``."""
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("apply_mask_aug samples through K2, which gives its input no "
                         "gradient: crop data or cost volumes computed without one")
    params = params.to(x.device)
    x = conditional_hflip(x, params.flip)
    return grid_sample_planar(x.contiguous(), crop_grid(params, *x.shape[-2:]))


def apply_mask_aug_frames(x: Tensor, params: MaskAugParams) -> Tensor:
    """``apply_mask_aug`` on (B, F, C, H, W) stacks: the frame axis folds into
    the batch, each sample's parameters repeated F times (one launch)."""
    b, f = x.shape[:2]
    rep = MaskAugParams(*(p.repeat_interleave(f, 0) for p in params))
    return apply_mask_aug(x.reshape((b * f,) + x.shape[2:]), rep).reshape(x.shape)


class ColorJitterBatch(NamedTuple):
    """One jitter per sample: the four factors, each (B,), and the order
    (B, 4) in which the operations brightness (0), contrast (1), saturation
    (2) and hue (3) apply."""

    brightness: Tensor
    contrast: Tensor
    saturation: Tensor
    hue: Tensor
    order: Tensor


def sample_color_jitter_batch(generator: torch.Generator, batch_size: int,
                              brightness: float = 0.2, contrast: float = 0.2,
                              saturation: float = 0.2, hue: float = 0.1) -> ColorJitterBatch:
    """Uniform factors in [1 - x, 1 + x] (the hue shift in [-hue, hue]) and a
    random permutation of the four operations per sample, drawn on the CPU
    from ``generator``."""
    def uniform(lo: float, hi: float) -> Tensor:
        return lo + (hi - lo) * torch.rand(batch_size, generator=generator)

    return ColorJitterBatch(
        uniform(max(0.0, 1 - brightness), 1 + brightness),
        uniform(max(0.0, 1 - contrast), 1 + contrast),
        uniform(max(0.0, 1 - saturation), 1 + saturation),
        uniform(-hue, hue),
        torch.argsort(torch.rand(batch_size, 4, generator=generator), dim=-1),
    )


_LUMA = (0.299, 0.587, 0.114)


def _luma(x: Tensor) -> Tensor:
    """(N, 3, H, W) RGB -> (N, 1, H, W) luma."""
    return x[:, 0:1] * _LUMA[0] + x[:, 1:2] * _LUMA[1] + x[:, 2:3] * _LUMA[2]


def _brightness(x: Tensor, f: Tensor) -> Tensor:
    return torch.clamp(x * f, 0.0, 1.0)


def _contrast(x: Tensor, f: Tensor) -> Tensor:
    m = _luma(x).mean(dim=(1, 2, 3), keepdim=True)  # one mean per image
    return torch.clamp(m + (x - m) * f, 0.0, 1.0)


def _saturation(x: Tensor, f: Tensor) -> Tensor:
    gray = _luma(x)
    return torch.clamp(gray + (x - gray) * f, 0.0, 1.0)


def _hue(x: Tensor, shift: Tensor) -> Tensor:
    """Rotate the hue by ``shift`` turns through an HSV round trip; the hue
    wraps with a floor modulo (``torch.remainder``, JAX's ``%``)."""
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    maxc, minc = x.amax(1), x.amin(1)
    v, delta = maxc, maxc - minc
    sat = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), 0.0)
    safe = torch.clamp_min(delta, 1e-12)
    hh = torch.where(maxc == r, torch.remainder((g - b) / safe, 6.0),
                     torch.where(maxc == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    hh = torch.where(delta == 0, 0.0, hh) / 6.0
    hh = torch.remainder(hh + shift[:, 0], 1.0)
    i = torch.floor(hh * 6.0)
    f = hh * 6.0 - i
    p = v * (1 - sat)
    q = v * (1 - sat * f)
    t = v * (1 - sat * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def choose(opts):
        out = opts[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, opts[k], out)
        return out

    return torch.stack([choose([v, q, p, p, t, v]), choose([t, v, v, q, p, p]),
                        choose([p, p, t, v, v, q])], 1)


_JITTER_OPS = (_brightness, _contrast, _saturation, _hue)


def apply_color_jitter_batch(images: Tensor, params: ColorJitterBatch) -> Tensor:
    """Jitter (B, 3, H, W) or (B, F, 3, H, W) images in [-0.5, 0.5]; each
    sample's parameters are shared by its frames. Every sample takes its own
    order of the four operations: at each step, the samples whose op is k
    go through op k together."""
    b = images.shape[0]
    f = images.shape[1] if images.dim() == 5 else 1
    x = (images.reshape((b * f,) + images.shape[-3:]) + 0.5)
    factors = torch.stack(params[:4], 0).to(x.device, x.dtype)  # (4, B)
    factors = factors.repeat_interleave(f, 1)[..., None, None, None]  # (4, B*F, 1, 1, 1)
    order = params.order.cpu().repeat_interleave(f, 0)  # (B*F, 4): grouping needs no sync
    for step in range(4):
        out = x.clone()
        for k, op in enumerate(_JITTER_OPS):
            rows = torch.nonzero(order[:, step] == k)[:, 0]
            if rows.numel():
                idx = rows.to(x.device)
                out[idx] = op(x[idx], factors[k, idx])
        x = out
    return x.reshape(images.shape) - 0.5


_IMAGE_KEYS = ("keyframe", "frames", "stereoframe")


def jitter_image_keys(batch: dict, generator: torch.Generator) -> dict:
    """Draw one jitter per sample from ``generator`` and apply it to every
    image key of ``batch`` (a new dict; the rest is shared). Under a sharded
    batch the draws are the global batch's and each rank applies its rows'."""
    params = draw_rows(lambda n: sample_color_jitter_batch(generator, n),
                       batch["keyframe"].shape[0])
    out = dict(batch)
    for k in _IMAGE_KEYS:
        if out.get(k) is not None:
            out[k] = apply_color_jitter_batch(out[k], params)
    return out
