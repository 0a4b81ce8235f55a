"""The plain reference of MonoRec with a ResNet-50 encoder and the
SimpleMaskModule, in plain PyTorch.

MonoRec's public model code (``model/monorec/monorec_model.py``) builds this
network as ``MonoRecModel(resnet_layers=50, simple_mask=True)``: its
``ResnetEncoder`` wraps torchvision's ResNet-50 (He et al. 2016, v1.5: a
``Bottleneck`` carries its stride on the 3x3 convolution), and its
``SimpleMaskModule`` replaces the MaskModule. The eval forward of pretrain
mode 0 runs

1. the cost volume (fused and per frame),
2. the encoder's features of keyframe + 0.5,
3. a first depth pass on the raw cost volume, without a gradient,
4. the mask, on ``cat(cv_avg, keyframe, d0)``, where ``cv_avg`` averages
   the frames' cost volumes over the frames whose value is not 0 (at
   least one) and ``d0`` is the first pass's finest inverse depth,
5. the depth pass again, on ``(1 - mask) * cost volume``.

Every depth prediction is mapped ``(1 - p) lo + p hi``. The mask's U-Net
is the MaskModule's over D + 4 input channels, its encoder run once and
not once a frame, with no maximum over frames.

It imports nothing of the program. The plain cost volume, the DepthModule,
the MaskModule's U-Net (whose encoder and decoder the SimpleMaskModule
shares), the layers and the precision switch (``PRECISION``: exact float32
or the TF32 control) are those of ``reference/monorec.py``.

Departures from the published description:

* the batch norms of the frozen encoder always use their running
  statistics (MonoRec freezes the encoder; torchvision's module would
  update them in training mode, which the eval forward never enters);
* weights come from ``seeded_state_dict``, not from ImageNet or a
  checkpoint (neither exists on the machines that run the benchmark);
* the MaskModule's ``keep_masks`` dropout has no counterpart: the
  SimpleMaskModule has no dropout, and this forward is the eval one.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from bench_h100.reference.monorec import (
    DepthModule,
    MaskModule,
    conv2d,
    cost_volume,
)

Tensor = torch.Tensor

WIDTHS = (64, 128, 256, 512)
BLOCKS = (3, 4, 6, 3)  # ResNet-50's Bottlenecks a stage
EXPANSION = 4
FEATURE_CHANNELS = (64,) + tuple(c * EXPANSION for c in WIDTHS)


def _conv(m: nn.Conv2d, x):
    return conv2d(x, m.weight, None, m.stride, m.padding)


def _bn(m: nn.BatchNorm2d, x):
    """The encoder is frozen: batch norm with its running statistics."""
    return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, m.eps)


class Bottleneck(nn.Module):
    """1x1 to ``width``, 3x3 with the stride, 1x1 to 4 x ``width``, plus the
    shortcut: torchvision's block and attribute names."""

    def __init__(self, cin, width, stride=1):
        super().__init__()
        cout = width * EXPANSION
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.BatchNorm2d(cout))

    def forward(self, x):
        r = x if self.downsample is None else _bn(self.downsample[1],
                                                  _conv(self.downsample[0], x))
        y = F.relu(_bn(self.bn1, _conv(self.conv1, x)))
        y = F.relu(_bn(self.bn2, _conv(self.conv2, y)))
        return F.relu(_bn(self.bn3, _conv(self.conv3, y)) + r)


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for stage, (width, count) in enumerate(zip(WIDTHS, BLOCKS)):
            blocks = []
            for i in range(count):
                blocks.append(Bottleneck(cin, width, 2 if stage > 0 and i == 0 else 1))
                cin = width * EXPANSION
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        """Features of an image in [0, 1] at strides 2, 4, 8, 16, 32."""
        x = (x - 0.45) / 0.225
        feats = [F.relu(_bn(self.bn1, _conv(self.conv1, x)))]
        x = F.max_pool2d(feats[0], 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)
        return feats


class FeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = ResNet50()

    def forward(self, x):
        return self.encoder(x)


class SimpleMaskModule(MaskModule):
    """The MaskModule's U-Net over D + 4 channels, its encoder run once."""

    def __init__(self, depth_steps: int = 32, feat=FEATURE_CHANNELS):
        super().__init__(depth_steps + 3 + 1, feat)

    def forward(self, single_frame_cvs: Tensor, keyframe: Tensor, inverse_depth: Tensor,
                image_features) -> Tensor:
        """single_frame_cvs (B, F, D, H, W), keyframe (B, 3, H, W) and the
        first pass's finest inverse depth (B, 1, H, W) -> the moving-object
        probability (B, 1, H, W)."""
        frames = (single_frame_cvs != 0).to(single_frame_cvs.dtype).sum(1)
        cv_avg = single_frame_cvs.sum(1) / torch.clamp(frames, min=1)
        x = torch.cat([cv_avg, keyframe, inverse_depth], 1)
        feats = []
        for layer in self.enc:
            x = layer(x)
            feats.append(x)
        return self.decode(feats, image_features)


class MonoRecR50SimpleReference(nn.Module):
    """MonoRec with a ResNet-50 encoder and the SimpleMaskModule, under the
    reference's names (``_feature_extractor.encoder.layer1.0.conv3.weight``,
    ``att_module``, ``depth_module``)."""

    def __init__(self, depth_steps: int = 32, inv_depth_min_max=(0.33, 0.0025)):
        super().__init__()
        self.depth_steps = depth_steps
        self.inv_depth_min_max = tuple(inv_depth_min_max)
        self._feature_extractor = FeatureExtractor()
        self.att_module = SimpleMaskModule(depth_steps, FEATURE_CHANNELS)
        self.depth_module = DepthModule(depth_steps, FEATURE_CHANNELS)

    def depth(self, cv: Tensor, keyframe: Tensor, feats) -> List[Tensor]:
        """Inverse depth at 4 scales: (1 - p) lo + p hi."""
        hi, lo = self.inv_depth_min_max
        return [(1 - p) * lo + p * hi for p in self.depth_module(cv, keyframe, feats)]

    @torch.no_grad()
    def infer(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The eval forward of pretrain mode 0: inverse depth ``result``
        (B, 1, H, W) and the moving-object mask ``cv_mask``."""
        keyframe = batch["keyframe"]
        cv, sfcv = cost_volume(keyframe, batch["keyframe_intrinsics"], batch["keyframe_pose"],
                               batch["frames"], batch["intrinsics"], batch["poses"],
                               self.inv_depth_min_max, self.depth_steps)
        feats = self._feature_extractor(keyframe + 0.5)
        first = self.depth(cv, keyframe, feats)
        cv_mask = self.att_module(sfcv, keyframe, first[0], feats)
        preds = self.depth((1 - cv_mask) * cv, keyframe, feats)
        return {"result": preds[0], "cv_mask": cv_mask}


def template(depth_steps: int) -> Dict[str, torch.Size]:
    """Every tensor of the network's ``state_dict`` and its shape."""
    with torch.device("meta"):
        return {k: v.shape
                for k, v in MonoRecR50SimpleReference(depth_steps).state_dict().items()}


def _is_bn(key: str) -> bool:
    return ".bn" in key or "downsample.1" in key


def seeded_state_dict(depth_steps: int, seed: int, device) -> Dict[str, Tensor]:
    """The network's weights from ``seed``, made on ``device`` in one draw,
    by ``reference/monorec.py``'s rule: every convolution's weights uniform
    in +-sqrt(6 / fan_in) (He; a stride-2 transposed convolution's fan_in
    c_in k^2 / 4), its bias in +-1/sqrt(fan_in); the frozen encoder's batch
    norms at identity statistics, scaled by 1/sqrt(2) on the norm that
    closes each residual branch and on its shortcut's: in a Bottleneck
    ``bn3`` and ``downsample.1``."""
    shapes = template(depth_steps)
    drawn = [k for k, s in shapes.items() if not _is_bn(k)
             and (k.endswith(".bias") or k.endswith(".weight") and len(s) >= 2)]
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(shapes[k].numel() for k in drawn)
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out: Dict[str, Tensor] = {}
    offset = 0
    for key, shape in shapes.items():
        if key in drawn:
            n = shape.numel()
            wkey = key[: -len("bias")] + "weight" if key.endswith(".bias") else key
            ws = shapes[wkey]
            if "conv2d_t" in wkey:
                fan_in = ws[0] * math.prod(ws[2:]) / 4
            else:
                fan_in = ws[1] * math.prod(ws[2:])
            bound = 1 / math.sqrt(fan_in) if key.endswith(".bias") else math.sqrt(6 / fan_in)
            out[key] = flat[offset:offset + n].view(shape) * bound
            offset += n
        elif key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=torch.long, device=device)
        elif key.endswith(".weight"):
            scale = 0.5**0.5 if (".bn3." in key or "downsample.1." in key) else 1.0
            out[key] = torch.full(shape, scale, device=device)
        elif key.endswith("running_var"):
            out[key] = torch.ones(shape, device=device)
        else:
            out[key] = torch.zeros(shape, device=device)
    return out
