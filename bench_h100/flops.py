"""The yardstick's frozen arithmetic: operations and bytes from shapes.

Nothing here reads the program. The counts are a function of a
configuration's sizes (``configs/<name>.json``) alone, so a later change
to the program cannot move them.

Rules (PERF.md, "FLOP and byte rules"):

* a convolution or transposed convolution costs 2 x its multiply-adds:
  ``2 * c_in * c_out * k_h * k_w`` per output pixel of a convolution, per
  input pixel of a transposed one (a transposed convolution is counted
  whole, before its crop);
* the cost volume (kernel K1) costs ``K1_CV_FLOPS`` per (source frame,
  hypothesis, pixel) and ``K1_FUSE_FLOPS_PER_FRAME * F + K1_FUSE_FLOPS``
  per (keyframe, hypothesis, pixel) of each fused group;
* in training, each trained module adds twice its forward convolutions
  (the data gradients and the weight gradients);
* pooling, activations, the losses and the optimizer are not counted.

The K1 counts and the peaks are copied from ``chip_smoke.py``
(``K1_FLOPS``, ``K1_CV_FLOPS``, ``bound``, ``k1_cv_bound``, the K3
``photo_error_bounds``), whose derivation is given there.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# The card's published peaks (H100 SXM data sheet, at a 700 W limit): HBM
# bandwidth, and float32 outside the tensor cores, which the exact policy
# (TF32 off) runs at.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# K1 per (source, hypothesis, pixel) at use_ssim=1: displacement 19,
# footprint 12, 4 taps x 3 channels 24, border indicator 4, +0.5 on 3
# channels, SSIM 34 per channel, channel weights 5, the 3x3 box sum 4; the
# cost-volume epilogue 9 more.
K1_FLOPS = 19 + 12 + 24 + 4 + 3 + 34 * 3 + 5 + 4
K1_CV_FLOPS = K1_FLOPS + 9
K1_FUSE_FLOPS_PER_FRAME, K1_FUSE_FLOPS = 2, 3
# K3 per (pixel, channel) of its forward and its backward.
K3_FLOPS = {"fwd": 44 + 10 + 27, "bwd": 44 + 10 + 41 + 21 + 6 + 10}

# (c_in, c_out, k_h, k_w, pixels, transposed)
Conv = Tuple[int, int, int, int, int, bool]

RESNET18 = ((64, 1), (128, 2), (256, 2), (512, 2))
MASK_ENC = (48, 64, 96, 96)
MASK_DEC = (96, 96, 64, 48)
DEPTH_ENC = (48, 64, 128, 192, 256)
DEPTH_DEC = (256, 128, 64, 48, 32, 24)
DEPTH_KERNELS = (7, 7, 5, 5, 3)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def resnet18_convs(h: int, w: int) -> List[Conv]:
    """ResNet-18's convolutions on an (h, w) keyframe."""
    convs: List[Conv] = []
    h, w = _ceil_div(h, 2), _ceil_div(w, 2)
    convs.append((3, 64, 7, 7, h * w, False))
    h, w = _ceil_div(h, 2), _ceil_div(w, 2)  # the max pool
    cin = 64
    for cout, stride in RESNET18:
        for block in range(2):
            s = stride if block == 0 else 1
            h2, w2 = _ceil_div(h, s), _ceil_div(w, s)
            convs.append((cin, cout, 3, 3, h2 * w2, False))
            convs.append((cout, cout, 3, 3, h2 * w2, False))
            if s != 1 or cin != cout:
                convs.append((cin, cout, 1, 1, h2 * w2, False))
            h, w, cin = h2, w2, cout
    return convs


def feature_channels() -> Tuple[int, ...]:
    return (64,) + tuple(c for c, _ in RESNET18)


def mask_module_convs(h: int, w: int, depth_steps: int, frames: int) -> List[Conv]:
    """The MaskModule: its encoder over each of ``frames`` per-frame cost
    volumes, then one decoder."""
    feat = feature_channels()
    c = (depth_steps,) + MASK_ENC
    d = MASK_DEC
    enc: List[Conv] = []
    for i in range(5):
        hi, wi = h >> i, w >> i
        cin = c[0] if i == 0 else c[i - 1]
        enc.append((cin, c[i], 3, 3, hi * wi, False))
        enc.append((c[i], c[i], 3, 3, hi * wi, False))
    convs = [(a, b, kh, kw, px * frames, t) for a, b, kh, kw, px, t in enc]
    cin = c[4] + feat[3]
    for i in range(4):
        level = 3 - i
        px = (h >> level) * (w >> level)
        up = d[0] if i == 0 else cin  # the first Upconv narrows, the others keep
        convs.append((cin, up, 2, 2, px, False))
        skip = c[level] + (feat[level - 1] if level > 0 else 0)
        convs.append((up + skip, d[i], 3, 3, px, False))
        convs.append((d[i], d[i], 3, 3, px, False))
        cin = d[i]
    convs.append((d[3], 1, 1, 1, h * w, False))  # the classifier
    return convs


def depth_module_convs(h: int, w: int, depth_steps: int) -> List[Conv]:
    """The DepthModule (separable encoder, transposed-convolution decoder,
    four predictors)."""
    feat = feature_channels()
    e, d = DEPTH_ENC, DEPTH_DEC
    convs: List[Conv] = []
    cin = depth_steps + 3
    hh, ww = h, w
    for i, k in enumerate(DEPTH_KERNELS):
        s = 1 if i == 0 else 2
        h2, w2 = _ceil_div(hh, s), _ceil_div(ww, s)
        convs.append((cin, e[i], k, 1, h2 * ww, False))  # (k, 1), stride (s, 1)
        convs.append((e[i], e[i], 1, k, h2 * w2, False))  # (1, k), stride (1, s)
        convs.append((e[i], e[i], 3, 1, h2 * w2, False))
        convs.append((e[i], e[i], 1, 3, h2 * w2, False))
        hh, ww, cin = h2, w2, e[i]

    def px(level):
        return (h >> level) * (w >> level)

    convs.append((e[4], d[0], 4, 4, px(4), True))  # Refine from H/16
    convs.append((d[0], 1, 3, 3, px(3), False))  # predictor 0
    convs.append((e[3] + feat[2] + d[0], d[1], 4, 4, px(3), True))
    convs.append((d[1], d[1], 3, 1, px(2), False))
    convs.append((d[1], d[1], 1, 3, px(2), False))
    convs.append((d[1], 1, 3, 3, px(2), False))
    convs.append((e[2] + feat[1] + d[1], d[2], 4, 4, px(2), True))
    convs.append((d[2], d[2], 3, 1, px(1), False))
    convs.append((d[2], d[2], 1, 3, px(1), False))
    convs.append((d[2], 1, 3, 3, px(1), False))
    convs.append((e[1] + feat[0] + d[2], d[3], 4, 4, px(1), True))
    convs.append((e[0] + d[3], d[4], 3, 1, px(0), False))
    convs.append((d[4], d[4], 1, 3, px(0), False))
    convs.append((d[4], d[5], 3, 3, px(0), False))
    convs.append((d[5], 1, 3, 3, px(0), False))
    return convs


def conv_flops(convs: Sequence[Conv]) -> float:
    return float(sum(2 * a * b * kh * kw * px for a, b, kh, kw, px, _ in convs))


def k1_flops(batch: int, groups: Sequence[int], depth_steps: int, h: int, w: int) -> float:
    """K1's operations for ``batch`` keyframes whose frames fall in
    ``groups`` (one fused cost volume per group)."""
    n = batch * sum(groups)
    fused = batch * depth_steps * h * w
    return float(K1_CV_FLOPS * n * depth_steps * h * w
                 + sum(K1_FUSE_FLOPS_PER_FRAME * g + K1_FUSE_FLOPS for g in groups) * fused)


def k1_bound_s(batch: int, groups: Sequence[int], depth_steps: int, h: int, w: int) -> float:
    """The least time of one K1 launch: its float32 operations at the peak or
    its bytes at HBM bandwidth, whichever is larger. Bytes: the sources
    (N, 3, H, W) f32, the keyframes (B, 3, H, W) f32 and the homographies
    (N, D, 3, 3) f64 in; the per-frame CVs (N, D, H, W) and one fused CV
    (B, D, H, W) per group out, f32."""
    n = batch * sum(groups)
    n_bytes = (n * 3 * h * w * 4 + batch * 3 * h * w * 4 + n * depth_steps * 9 * 8
               + (n + len(groups) * batch) * depth_steps * h * w * 4)
    return max(n_bytes / HBM_BYTES_PER_S,
               k1_flops(batch, groups, depth_steps, h, w) / FP32_FLOPS_PER_S)


def k3_bound_s(kind: str, m: int, h: int, w: int, channels: int = 3) -> float:
    """The least time of one K3 launch on (m, C, H, W): forward x, y in and
    the (M, H, W) map out; backward x, y and the cotangent in, d/dx out."""
    elems = m * channels * h * w
    pixels = m * h * w
    if kind == "fwd":
        n_bytes, ops = 2 * elems * 4 + pixels * 4, K3_FLOPS["fwd"] * elems + pixels
    else:
        n_bytes, ops = 3 * elems * 4 + pixels * 4, K3_FLOPS["bwd"] * elems
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)


def module_flops(shape: Dict) -> Dict[str, float]:
    """Forward operations per keyframe of each module at ``shape`` (the
    configuration's ``height``, ``width``, ``depth_steps``, ``frames``)."""
    h, w, d, f = shape["height"], shape["width"], shape["depth_steps"], shape["frames"]
    return {
        "resnet": conv_flops(resnet18_convs(h, w)),
        "mask": conv_flops(mask_module_convs(h, w, d, f)),
        "depth": conv_flops(depth_module_convs(h, w, d)),
        "k1": k1_flops(1, (f,), d, h, w),
    }


def step_flops(shape: Dict, step: str) -> float:
    """Operations per keyframe of one ``step``:

    * ``infer``: the eval forward: ResNet, K1, MaskModule, DepthModule;
    * ``stage4``: the stage-4 step (``monorec_depth_ref.json``): ResNet
      (frozen), K1 over the mono frames and over the stereo frame, the
      MaskModule forward (its output detached), two depth decodes (stereo
      without a gradient) and the mono decode's backward;
    * ``stage1``: the stage-1 step (``monorec_depth.json``, mode 1): ResNet
      (frozen), K1, one depth decode and its backward.
    """
    m = module_flops(shape)
    h, w, d, f = shape["height"], shape["width"], shape["depth_steps"], shape["frames"]
    if step == "infer":
        return m["resnet"] + m["k1"] + m["mask"] + m["depth"]
    if step == "stage4":
        return (m["resnet"] + m["k1"] + k1_flops(1, (1,), d, h, w) + m["mask"]
                + 2 * m["depth"] + 2 * m["depth"])
    if step == "stage1":
        return m["resnet"] + m["k1"] + m["depth"] + 2 * m["depth"]
    raise ValueError(f"unknown step {step!r}")


def mfu_pct(flops_per_item: float, items: int, seconds: float, chips: int) -> float:
    return 100.0 * flops_per_item * items / seconds / (chips * FP32_FLOPS_PER_S)


def gflop(x: float) -> float:
    return round(x / 1e9, 1)

