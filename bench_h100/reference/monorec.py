"""The plain reference of MonoRec's eval forward, in plain PyTorch.

A frozen copy of the architecture of ``tests/torch_reference.py``
(TensorFlow-"same" padding, separable depth encoder, transposed-convolution
refinements; the reference's attribute names, so ``state_dict`` keys are
those of MonoRec's checkpoints), with a ResNet-18 whose batch norms use
their running statistics, and a plain cost volume written from MonoRec's
``_cost_volume_single``: backproject the keyframe's pixels at each depth
hypothesis, project them into each source frame, ``grid_sample`` the frame
and a border indicator there, score with SSIM (3x3 mean window, reflect
pad) weighted by channel and summed over a 3x3 patch, and fuse the frames
by the sharpness of their cost curves.

It imports nothing of the program. ``exact=False`` computes every
convolution and matrix product with its operands rounded to TF32 (10
mantissa bits, accumulation in float32): the control of the benchmark's
comparison, one precision step below the configuration's float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

CHANNEL_WEIGHTS = (5 / 32, 16 / 32, 11 / 32)
SHARPNESS = 10.0


def round_tf32(x: Tensor) -> Tensor:
    """``x`` (float32) rounded to TF32: the 13 low mantissa bits dropped,
    rounding to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


class Precision:
    """Whether the reference's convolutions run exact (float32) or on
    TF32-rounded operands (the control)."""

    def __init__(self):
        self.exact = True

    def operands(self, *xs: Tensor):
        """The operands as the control's convolutions read them: rounded to
        TF32 in the forward, the gradient passed straight through (on the
        card the backward's convolutions run in TF32 themselves, as
        ``allow_tf32`` lets cuDNN)."""
        if self.exact:
            return xs
        return tuple(None if x is None else x + (round_tf32(x.detach()) - x).detach()
                     for x in xs)

    def __enter__(self):
        import torch.backends.cuda
        import torch.backends.cudnn

        self._flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = not self.exact
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._flags
        self.exact = True


PRECISION = Precision()


def conv2d(x, weight, bias=None, stride=1, padding=0):
    x, weight, bias = PRECISION.operands(x, weight, bias)
    return F.conv2d(x, weight, bias, stride, padding)


def _same_pad(x, k, s):
    ky, kx = k if isinstance(k, tuple) else (k, k)
    sy, sx = s if isinstance(s, tuple) else (s, s)
    h, w = x.shape[-2:]
    py = (sy * (math.ceil(h / sy) - 1) + ky - h) / 2
    px = (sx * (math.ceil(w / sx) - 1) + kx - w) / 2
    return F.pad(x, [math.floor(px), math.ceil(px), math.floor(py), math.ceil(py)])


class Conv(nn.Conv2d):
    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride)


class ConvReLU(nn.Module):
    def __init__(self, cin, cout, k, s=1):
        super().__init__()
        self.k, self.s = k, s
        self.conv = Conv(cin, cout, k, s)

    def forward(self, x):
        return F.leaky_relu(self.conv(_same_pad(x, self.k, self.s)), 0.1)


class ConvReLU2(nn.Module):
    def __init__(self, cin, cout, k, s=1):
        super().__init__()
        self.k, self.s = k, s
        self.conv_y = Conv(cin, cout, (k, 1), (s, 1))
        self.conv_x = Conv(cout, cout, (1, k), (1, s))

    def forward(self, x):
        t = F.leaky_relu(self.conv_y(_same_pad(x, (self.k, 1), (self.s, 1))), 0.1)
        return F.leaky_relu(self.conv_x(_same_pad(t, (1, self.k), (1, self.s))), 0.1)


class Upconv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, 2, 1)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(_same_pad(x, 2, 1))


class Refine(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv2d_t = nn.ConvTranspose2d(cin, cout, 4, 2)

    def forward(self, x):
        x, weight, bias = PRECISION.operands(x, self.conv2d_t.weight, self.conv2d_t.bias)
        y = F.leaky_relu(F.conv_transpose2d(x, weight, bias, 2), 0.1)
        return y[:, :, 1:-1, 1:-1]


class DepthModule(nn.Module):
    def __init__(self, depth_steps=32, feat=(64, 64, 128, 256, 512)):
        super().__init__()
        cin = depth_steps + 3
        e = (48, 64, 128, 192, 256)
        d = (256, 128, 64, 48, 32, 24)
        self.enc = nn.ModuleList([
            nn.Sequential(ConvReLU2(cin, e[0], 7), ConvReLU2(e[0], e[0], 3)),
            nn.Sequential(ConvReLU2(e[0], e[1], 7, 2), ConvReLU2(e[1], e[1], 3)),
            nn.Sequential(ConvReLU2(e[1], e[2], 5, 2), ConvReLU2(e[2], e[2], 3)),
            nn.Sequential(ConvReLU2(e[2], e[3], 5, 2), ConvReLU2(e[3], e[3], 3)),
            nn.Sequential(ConvReLU2(e[3], e[4], 3, 2), ConvReLU2(e[4], e[4], 3)),
        ])
        self.dec = nn.ModuleList([
            Refine(e[4], d[0]),
            nn.Sequential(Refine(e[3] + feat[2] + d[0], d[1]), ConvReLU2(d[1], d[1], 3)),
            nn.Sequential(Refine(e[2] + feat[1] + d[1], d[2]), ConvReLU2(d[2], d[2], 3)),
            Refine(e[1] + feat[0] + d[2], d[3]),
            nn.Sequential(ConvReLU2(e[0] + d[3], d[4], 3), nn.Identity(), Conv(d[4], d[5], 3),
                          nn.LeakyReLU(0.1)),
        ])
        self.predictors = nn.ModuleList(
            [nn.Sequential(nn.Identity(), Conv(c, 1, 3)) for c in (d[0], d[1], d[2], d[5])])

    def _predict(self, x, scale):
        return torch.abs(torch.tanh(self.predictors[scale][1](_same_pad(x, 3, 1))))

    def forward(self, cost_volume, keyframe, image_features):
        """Inverse-depth fractions in [0, 1) at 4 scales, finest first."""
        x = torch.cat([cost_volume, keyframe], dim=1)
        feats = []
        for layer in self.enc:
            x = layer(x)
            feats.append(x)
        preds = []
        x = self.dec[0](feats[4])
        preds.insert(0, self._predict(x, 0))
        x = self.dec[1][1](self.dec[1][0](torch.cat([feats[3], image_features[2], x], 1)))
        preds.insert(0, self._predict(x, 1))
        x = self.dec[2][1](self.dec[2][0](torch.cat([feats[2], image_features[1], x], 1)))
        preds.insert(0, self._predict(x, 2))
        x = self.dec[3](torch.cat([feats[1], image_features[0], x], 1))
        x = self.dec[4][0](torch.cat([feats[0], x], 1))
        x = self.dec[4][3](self.dec[4][2](_same_pad(x, 3, 1)))
        preds.insert(0, self._predict(x, 3))
        return preds


class MaskModule(nn.Module):
    def __init__(self, depth_steps=32, feat=(64, 64, 128, 256, 512)):
        super().__init__()
        c = (depth_steps, 48, 64, 96, 96)
        d = (96, 96, 64, 48)
        self.enc = nn.ModuleList([
            nn.Sequential(ConvReLU(c[0], c[0], 3), ConvReLU(c[0], c[0], 3)),
            nn.Sequential(nn.MaxPool2d(2), ConvReLU(c[0], c[1], 3), ConvReLU(c[1], c[1], 3)),
            nn.Sequential(nn.MaxPool2d(2), ConvReLU(c[1], c[2], 3), ConvReLU(c[2], c[2], 3)),
            nn.Sequential(nn.MaxPool2d(2), ConvReLU(c[2], c[3], 3), ConvReLU(c[3], c[3], 3)),
            nn.Sequential(nn.MaxPool2d(2), ConvReLU(c[3], c[4], 3), ConvReLU(c[4], c[4], 3)),
        ])
        self.dec = nn.ModuleList([
            nn.Sequential(Upconv(c[4] + feat[3], d[0]), ConvReLU(d[0] + c[3] + feat[2], d[0], 3),
                          ConvReLU(d[0], d[0], 3)),
            nn.Sequential(Upconv(d[0], d[0]), ConvReLU(d[0] + c[2] + feat[1], d[1], 3),
                          ConvReLU(d[1], d[1], 3)),
            nn.Sequential(Upconv(d[1], d[1]), ConvReLU(d[1] + c[1] + feat[0], d[2], 3),
                          ConvReLU(d[2], d[2], 3)),
            nn.Sequential(Upconv(d[2], d[2]), ConvReLU(d[2] + c[0], d[3], 3),
                          ConvReLU(d[3], d[3], 3)),
        ])
        self.classifier = nn.Sequential(Conv(d[3], 1, 1), nn.Sigmoid())

    def encode(self, single_frame_cvs: Tensor) -> List[Tensor]:
        """The encoder over each frame's CV (B, F, D, H, W), fused across the
        frames by an element-wise max at every scale."""
        fused: List[Tensor] = []
        for f in range(single_frame_cvs.shape[1]):
            x = single_frame_cvs[:, f]
            for i, layer in enumerate(self.enc):
                x = layer(x)
                fused.append(x) if len(fused) == i else fused.__setitem__(
                    i, torch.maximum(fused[i], x))
        return fused

    def decode(self, cv_feats: Sequence[Tensor], image_features) -> Tensor:
        x = self.dec[0][0](torch.cat([cv_feats[4], image_features[3]], 1))
        x = self.dec[0][2](self.dec[0][1](torch.cat([cv_feats[3], image_features[2], x], 1)))
        x = self.dec[1][0](x)
        x = self.dec[1][2](self.dec[1][1](torch.cat([cv_feats[2], image_features[1], x], 1)))
        x = self.dec[2][0](x)
        x = self.dec[2][2](self.dec[2][1](torch.cat([cv_feats[1], image_features[0], x], 1)))
        x = self.dec[3][0](x)
        x = self.dec[3][2](self.dec[3][1](torch.cat([cv_feats[0], x], 1)))
        return self.classifier(x)

    def forward(self, single_frame_cvs, image_features, keep_masks=None):
        """The moving-object probability (B, 1, H, W); ``keep_masks`` (one
        bool tensor per scale) applies training dropout at rate 0.5 to the
        fused encoder features."""
        fused = self.encode(single_frame_cvs)
        if keep_masks is not None:
            fused = [torch.where(k, f / 0.5, torch.zeros_like(f))
                     for f, k in zip(fused, keep_masks)]
        return self.decode(fused, image_features)


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.BatchNorm2d(cout))

    def forward(self, x):
        r = x if self.downsample is None else _bn(self.downsample[1], _conv(
            self.downsample[0], x))
        y = F.relu(_bn(self.bn1, _conv(self.conv1, x)))
        y = _bn(self.bn2, _conv(self.conv2, y))
        return F.relu(y + r)


def _conv(m: nn.Conv2d, x):
    return conv2d(x, m.weight, None, m.stride, m.padding)


def _bn(m: nn.BatchNorm2d, x):
    """The encoder is frozen: batch norm with its running statistics."""
    return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, m.eps)


class ResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
        self.layer4 = nn.Sequential(BasicBlock(256, 512, 2), BasicBlock(512, 512))

    def forward(self, x):
        """Features of an image in [0, 1] at strides 2, 4, 8, 16, 32."""
        x = (x - 0.45) / 0.225
        feats = [F.relu(_bn(self.bn1, _conv(self.conv1, x)))]
        feats.append(self.layer1(self.maxpool(feats[-1])))
        for layer in (self.layer2, self.layer3, self.layer4):
            feats.append(layer(feats[-1]))
        return feats


class FeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = ResNet18()

    def forward(self, x):
        return self.encoder(x)


# ----- the cost volume ------------------------------------------------------


def _ssim_mean_window(x: Tensor, y: Tensor) -> Tensor:
    """SSIM distance clamp((1 - n/d) / 2, 0, 1) of (N, C, H, W) images, 3x3
    mean window over a reflect-padded border."""
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
    yp = F.pad(y, (1, 1, 1, 1), mode="reflect")
    mu_x, mu_y = F.avg_pool2d(xp, 3, 1), F.avg_pool2d(yp, 3, 1)
    s_x = F.avg_pool2d(xp * xp, 3, 1) - mu_x * mu_x
    s_y = F.avg_pool2d(yp * yp, 3, 1) - mu_y * mu_y
    s_xy = F.avg_pool2d(xp * yp, 3, 1) - mu_x * mu_y
    n = (2 * mu_x * mu_y + 0.01**2) * (2 * s_xy + 0.03**2)
    d = (mu_x * mu_x + mu_y * mu_y + 0.01**2) * (s_x + s_y + 0.03**2)
    return torch.clamp((1 - n / d) / 2, 0, 1)


def _projection_grids(keyframe_intrinsics, keyframe_pose, frame_intrinsics, frame_poses,
                      depths: Tensor, h: int, w: int) -> Tensor:
    """(B, F, D, H, W, 2) sampling grids of every hypothesis depth in every
    frame, in MonoRec's normalization (u / (W - 1) - 0.5) * 2 for
    ``grid_sample(align_corners=False)``; the geometry in float64."""
    f64 = torch.float64
    kinv = torch.linalg.inv(keyframe_intrinsics.to(f64))[:, :3, :3]  # (B, 3, 3)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=f64, device=depths.device),
                            torch.arange(w, dtype=f64, device=depths.device), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, h * w)
    rays = kinv @ pix  # (B, 3, HW)
    rel = torch.linalg.inv(frame_poses.to(f64)) @ keyframe_pose.to(f64)[:, None]  # (B, F, 4, 4)
    proj = (frame_intrinsics.to(f64) @ rel)[:, :, :3]  # (B, F, 3, 4)
    pts = depths.to(f64)[None, :, None, None] * rays[:, None]  # (B, D, 3, HW)
    cam = (proj[:, :, None, :, :3] @ pts[:, None]) + proj[:, :, None, :, 3:]  # (B, F, D, 3, HW)
    xy = cam[..., :2, :] / (cam[..., 2:3, :] + 1e-7)
    denom = torch.tensor([w - 1, h - 1], dtype=f64, device=depths.device)[:, None]
    grid = ((xy / denom - 0.5) * 2).clamp(-2, 2)
    b, fr, d = grid.shape[:3]
    return grid.reshape(b, fr, d, 2, h, w).movedim(3, -1).to(torch.float32)


def cost_volume(keyframe: Tensor, keyframe_intrinsics: Tensor, keyframe_pose: Tensor,
                frames: Tensor, frame_intrinsics: Tensor, frame_poses: Tensor,
                inv_depth_min_max: Sequence[float], depth_steps: int):
    """Fused (B, D, H, W) and per-frame (B, F, D, H, W) cost volumes of
    keyframes (B, 3, H, W) in [-0.5, 0.5] against their frames
    (B, F, 3, H, W), hypotheses far -> near, linear in inverse depth."""
    b, c, h, w = keyframe.shape
    n_frames = frames.shape[1]
    inv = torch.linspace(inv_depth_min_max[1], inv_depth_min_max[0], depth_steps,
                         dtype=torch.float64, device=keyframe.device)
    grids = _projection_grids(keyframe_intrinsics, keyframe_pose, frame_intrinsics, frame_poses,
                              1.0 / inv, h, w)
    r = 2  # the 3x3 patch's radius + 1
    interior = torch.zeros(h, w, device=keyframe.device)
    interior[r:h - r, r:w - r] = 1.0
    sad = keyframe.new_zeros(b, n_frames, depth_steps, h, w)
    valid = keyframe.new_zeros(b, n_frames, h, w)
    box = torch.ones(1, 1, 3, 3, device=keyframe.device)
    for f in range(n_frames):
        reach = interior.expand(b, 1, h, w).clone()
        for d in range(depth_steps):
            g = grids[:, f, d]
            warped = F.grid_sample(frames[:, f], g, "bilinear", "zeros", align_corners=False)
            border = F.grid_sample(interior.expand(b, 1, h, w), g, "bilinear", "zeros",
                                   align_corners=False)
            reach = reach * (border != 0)
            err = _ssim_mean_window(warped + 0.5, keyframe + 0.5)
            err = sum(cw / 9 * err[:, ci] for ci, cw in enumerate(CHANNEL_WEIGHTS))
            sad[:, f, d] = F.conv2d(err[:, None], box, padding=1)[:, 0]
        valid[:, f] = reach[:, 0]
    sfcv = (1 - 2 * sad) * valid[:, :, None]
    sharp = torch.exp(-SHARPNESS * (sad - sad.amin(2, keepdim=True)) ** 2)
    weight = (1 - (sharp.sum(2) - 1) / (depth_steps - 1)) * valid
    total = weight.sum(1)
    fused = (sad * weight[:, :, None]).sum(1) / torch.where(total > 0, total, 1.0)[:, None]
    fused = torch.where((total > 0)[:, None], 1 - 2 * fused, 0.0)
    return fused, sfcv


# ----- the model ------------------------------------------------------------


class MonoRecReference(nn.Module):
    """MonoRec's modules under the reference's names; ``depth_steps`` and
    ``inv_depth_min_max`` as the configuration states."""

    def __init__(self, depth_steps: int = 32, inv_depth_min_max=(0.33, 0.0025),
                 mask: bool = True):
        super().__init__()
        self.depth_steps = depth_steps
        self.inv_depth_min_max = tuple(inv_depth_min_max)
        self._feature_extractor = FeatureExtractor()
        if mask:
            self.att_module = MaskModule(depth_steps)
        self.depth_module = DepthModule(depth_steps)

    def cost_volume(self, batch: Dict[str, Tensor], stereo: bool = False):
        if stereo:
            frames = batch["stereoframe"][:, None]
            intr = batch["stereoframe_intrinsics"][:, None]
            poses = batch["stereoframe_pose"][:, None]
        else:
            frames, intr, poses = batch["frames"], batch["intrinsics"], batch["poses"]
        return cost_volume(batch["keyframe"], batch["keyframe_intrinsics"], batch["keyframe_pose"],
                           frames, intr, poses, self.inv_depth_min_max, self.depth_steps)

    def features(self, keyframe: Tensor):
        with torch.no_grad():
            return self._feature_extractor(keyframe + 0.5)

    def depth(self, cv: Tensor, keyframe: Tensor, feats) -> List[Tensor]:
        """Inverse depth at 4 scales: (1 - p) lo + p hi."""
        hi, lo = self.inv_depth_min_max
        return [(1 - p) * lo + p * hi for p in self.depth_module(cv, keyframe, feats)]

    @torch.no_grad()
    def infer(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The eval forward of the full network (pretrain mode 0): inverse
        depth ``result`` (B, 1, H, W) and the moving-object mask ``cv_mask``."""
        cv, sfcv = self.cost_volume(batch)
        feats = self.features(batch["keyframe"])
        cv_mask = self.att_module(sfcv, feats)
        preds = self.depth((1 - cv_mask) * cv, batch["keyframe"], feats)
        return {"result": preds[0], "cv_mask": cv_mask}


def template(depth_steps: int) -> Dict[str, torch.Size]:
    """Every tensor of the network's ``state_dict`` and its shape."""
    with torch.device("meta"):
        return {k: v.shape for k, v in MonoRecReference(depth_steps).state_dict().items()}


def seeded_state_dict(depth_steps: int, seed: int, device) -> Dict[str, Tensor]:
    """The network's weights from ``seed``, made on ``device`` in one draw.

    He's uniform initialisation, which keeps the activations' scale through
    the leaky ReLUs of both U-Nets (PyTorch's default, a third of that
    variance, leaves a seeded 20-layer U-Net a constant): each convolution's
    weights uniform in +-sqrt(6 / fan_in), fan_in its inputs per output (a
    stride-2 transposed convolution's c_in k^2 / 4), its bias in
    +-1/sqrt(fan_in). The frozen ResNet's batch norms hold identity
    statistics, scaled by 1/sqrt(2) where a residual branch meets its
    shortcut, so the encoder's features keep their scale too."""
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
            scale = 0.5**0.5 if (".bn2." in key or "downsample.1." in key) else 1.0
            out[key] = torch.full(shape, scale, device=device)
        elif key.endswith("running_var"):
            out[key] = torch.ones(shape, device=device)
        else:
            out[key] = torch.zeros(shape, device=device)
    return out


def _is_bn(key: str) -> bool:
    return ".bn" in key or "downsample.1" in key
