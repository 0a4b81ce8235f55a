"""MaskModule: moving-object probability from per-frame cost volumes
(``monorec_tpu/models/mask_module.py::MaskModule``).

A weight-shared encoder runs over each single-frame cost volume (frames
folded into the batch), encoder features are fused by an element-wise max
across frames, and a decoder with skips from the fused CV features and the
ResNet features predicts a 1-channel sigmoid mask. In training, dropout
(rate 0.5, the kept values scaled by 1 / (1 - rate)) acts on each fused
feature map after the frame fusion (``monorec_tpu/models/mask_module.py:
129-130``); its keep masks are drawn from a ``torch.Generator`` on the
features' device, so a step copies nothing from the host, and under a
batch sharded over ranks drawn for the global batch (each rank keeps its
rows). In eval it is
the identity. ``dtype`` is the convolution dtype: the per-frame CVs and the
image features are cast to it at entry, and the mask returns in float32.
``use_cv`` / ``use_features`` off multiply that input by 0.0 (as the JAX
package does, so a non-finite value stays NaN in both).

``SimpleMaskModule`` (``mask_module.py::SimpleMaskModule``) runs the same
encoder once, without the frame max and without dropout, over the
per-frame CVs averaged over their non-zero entries, the keyframe and the
detached finest-scale depth prediction, then the same decoder. Both keep
the reference's submodule names (``enc``, ``dec``, ``classifier``), so one
key layout serves both.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from monorec_tpu_torch.models.layers import ConvLReLU, SamePadConv, Upconv
from monorec_tpu_torch.models.resnet import ENCODER_CHANNELS
from monorec_tpu_torch.parallel import draw_rows

Tensor = torch.Tensor

_ENC_CH_TAIL = (48, 64, 96, 96)
_DEC_CH = (96, 96, 64, 48)
DROPOUT_RATE = 0.5


def dropout_keep(shape, keep_prob: float, generator: torch.Generator,
                 device: torch.device) -> Tensor:
    """Bernoulli(``keep_prob``) keep mask (bool, ``shape``), drawn on
    ``device`` from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def dropout(x: Tensor, generator: torch.Generator) -> Tensor:
    """``flax.linen.Dropout``'s training rule at ``DROPOUT_RATE``: kept values
    scaled by 1 / (1 - rate), the others 0."""
    if generator.device.type != x.device.type:
        raise ValueError(f"the dropout generator is on {generator.device}, the features on "
                         f"{x.device}: draw on the features' device")
    keep_prob = 1.0 - DROPOUT_RATE
    # The global batch's mask, as one process draws it; this rank's rows.
    keep = draw_rows(lambda n: dropout_keep((n,) + tuple(x.shape[1:]), keep_prob, generator,
                                            x.device), x.shape[0])
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class _MaskUNet(nn.Module):
    """The encoder over ``in_channels`` and the decoder with the CV-feature
    and image-feature skips, shared by both mask modules."""

    def __init__(self, in_channels: int, feature_channels: Sequence[int], dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        c = (in_channels,) + _ENC_CH_TAIL
        d = _DEC_CH
        feat = feature_channels
        self.enc = nn.ModuleList(
            [nn.Sequential(ConvLReLU(c[0], c[0], 3), ConvLReLU(c[0], c[0], 3))]
            + [
                nn.Sequential(nn.MaxPool2d(2), ConvLReLU(c[i - 1], c[i], 3), ConvLReLU(c[i], c[i], 3))
                for i in range(1, 5)
            ]
        )
        self.dec = nn.ModuleList(
            [
                nn.Sequential(
                    Upconv(c[4] + feat[3], d[0]),
                    ConvLReLU(d[0] + c[3] + feat[2], d[0], 3),
                    ConvLReLU(d[0], d[0], 3),
                ),
                nn.Sequential(
                    Upconv(d[0], d[0]),
                    ConvLReLU(d[0] + c[2] + feat[1], d[1], 3),
                    ConvLReLU(d[1], d[1], 3),
                ),
                nn.Sequential(
                    Upconv(d[1], d[1]),
                    ConvLReLU(d[1] + c[1] + feat[0], d[2], 3),
                    ConvLReLU(d[2], d[2], 3),
                ),
                nn.Sequential(
                    Upconv(d[2], d[2]),
                    ConvLReLU(d[2] + c[0], d[3], 3),
                    ConvLReLU(d[3], d[3], 3),
                ),
            ]
        )
        self.classifier = nn.Sequential(SamePadConv(d[3], 1, 1), nn.Sigmoid())

    def decode(self, fused: Sequence[Tensor], image_features: Sequence[Tensor]) -> Tensor:
        """Decoder H/16 -> H: each stage upsamples, then takes the CV
        features of its scale and, below full resolution, the ResNet
        features of that scale (layer2, layer1, stem)."""
        image_features = [f.to(self.dtype) for f in image_features]
        x = torch.cat([fused[4], image_features[3]], 1)
        for i, (up, conv_a, conv_b) in enumerate(self.dec):
            x = up(x)
            skips = [fused[3 - i]] + ([image_features[2 - i]] if i < 3 else [])
            x = conv_b(conv_a(torch.cat(skips + [x], 1)))
        # The mask gates the cost volume and feeds the losses in float32.
        return self.classifier(x).to(torch.float32)


class MaskModule(_MaskUNet):
    def __init__(self, depth_steps: int = 32, use_cv: bool = True, use_features: bool = True,
                 feature_channels: Sequence[int] = ENCODER_CHANNELS,
                 dtype: torch.dtype = torch.float32):
        super().__init__(depth_steps, feature_channels, dtype)
        self.use_cv = use_cv
        self.use_features = use_features

    def forward(self, single_frame_cvs: Tensor, image_features: Sequence[Tensor],
                train: bool = False, generator: Optional[torch.Generator] = None) -> Tensor:
        """single_frame_cvs (B, F, D, H, W), image_features NCHW -> mask
        (B, 1, H, W). ``train`` applies the dropout, drawn from
        ``generator`` (on the features' device)."""
        if train and generator is None:
            raise ValueError("the MaskModule's training dropout draws from a generator; pass one")
        if not self.use_cv:
            single_frame_cvs = single_frame_cvs * 0.0
        if not self.use_features:
            image_features = [f * 0.0 for f in image_features]
        b, n_frames = single_frame_cvs.shape[:2]
        x = single_frame_cvs.flatten(0, 1).to(self.dtype)
        fused = []
        for stage in self.enc:
            x = stage(x)
            # amax splits the gradient evenly among tied frames, as jnp.max.
            fused.append(x.unflatten(0, (b, n_frames)).amax(dim=1))
        if train:
            fused = [dropout(f, generator) for f in fused]
        return self.decode(fused, image_features)


class SimpleMaskModule(_MaskUNet):
    def __init__(self, depth_steps: int = 32,
                 feature_channels: Sequence[int] = ENCODER_CHANNELS,
                 dtype: torch.dtype = torch.float32):
        super().__init__(depth_steps + 3 + 1, feature_channels, dtype)

    def forward(self, single_frame_cvs: Tensor, keyframe: Tensor,
                predicted_inverse_depth: Tensor, image_features: Sequence[Tensor]) -> Tensor:
        """single_frame_cvs (B, F, D, H, W), keyframe (B, 3, H, W), the
        finest prediction (B, 1, H, W), image_features NCHW -> mask
        (B, 1, H, W)."""
        counts = (single_frame_cvs != 0).to(keyframe.dtype).sum(1).clamp_min(1)
        cv_avg = single_frame_cvs.sum(1) / counts
        x = torch.cat([cv_avg, keyframe, predicted_inverse_depth.detach()], 1).to(self.dtype)
        feats = []
        for stage in self.enc:
            x = stage(x)
            feats.append(x)
        return self.decode(feats, image_features)
