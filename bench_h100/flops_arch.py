"""The frozen operation counts of ``flops.py``, for every encoder and mask.

``flops.py`` counts ResNet-18 and the MaskModule, whatever a configuration's
``arch`` says. Here the same rules (a convolution 2 x its multiply-adds, a
transposed one whole, K1 by ``flops.k1_flops``) apply to the architecture
that ``arch`` names: ``resnet_layers`` 18 (``BasicBlock``) or 50
(``Bottleneck``, expansion 4, the stride on the 3x3 convolution), and
``simple_mask``, the SimpleMaskModule: one pass of the
mask's encoder over the frames' averaged cost volume, the keyframe and the
first depth pass's finest prediction (D + 4 channels), in place of one
pass a frame over D channels. Both U-Nets read the encoder's channels in
their skips. Nothing here reads the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from bench_h100.flops import (
    DEPTH_DEC,
    DEPTH_ENC,
    DEPTH_KERNELS,
    MASK_DEC,
    MASK_ENC,
    Conv,
    _ceil_div,
    conv_flops,
    k1_flops,
)

WIDTHS = (64, 128, 256, 512)
# resnet_layers -> (bottleneck, blocks a stage)
RESNETS = {18: (False, (2, 2, 2, 2)), 50: (True, (3, 4, 6, 3))}
EXPANSION = 4


def feature_channels(resnet_layers: int) -> Tuple[int, ...]:
    """Channels of the encoder's five feature scales."""
    bottleneck, _ = RESNETS[resnet_layers]
    return (64,) + tuple(c * (EXPANSION if bottleneck else 1) for c in WIDTHS)


def resnet_convs(resnet_layers: int, h: int, w: int) -> List[Conv]:
    """The encoder's convolutions on an (h, w) keyframe."""
    bottleneck, counts = RESNETS[resnet_layers]
    convs: List[Conv] = []
    h, w = _ceil_div(h, 2), _ceil_div(w, 2)
    convs.append((3, 64, 7, 7, h * w, False))
    h, w = _ceil_div(h, 2), _ceil_div(w, 2)  # the max pool
    cin = 64
    for stage, (width, count) in enumerate(zip(WIDTHS, counts)):
        cout = width * (EXPANSION if bottleneck else 1)
        for block in range(count):
            s = 2 if stage > 0 and block == 0 else 1
            h2, w2 = _ceil_div(h, s), _ceil_div(w, s)
            if bottleneck:
                convs.append((cin, width, 1, 1, h * w, False))
                convs.append((width, width, 3, 3, h2 * w2, False))
                convs.append((width, cout, 1, 1, h2 * w2, False))
            else:
                convs.append((cin, cout, 3, 3, h2 * w2, False))
                convs.append((cout, cout, 3, 3, h2 * w2, False))
            if s != 1 or cin != cout:
                convs.append((cin, cout, 1, 1, h2 * w2, False))
            h, w, cin = h2, w2, cout
    return convs


def mask_convs(h: int, w: int, in_channels: int, passes: int,
               feat: Sequence[int]) -> List[Conv]:
    """The mask U-Net: ``passes`` runs of its encoder over ``in_channels``
    (the MaskModule: one a frame over D; the SimpleMaskModule: one over
    D + 4), then one decoder with the encoder's ``feat`` in its skips."""
    c = (in_channels,) + MASK_ENC
    d = MASK_DEC
    enc: List[Conv] = []
    for i in range(5):
        px = (h >> i) * (w >> i)
        enc.append((c[0] if i == 0 else c[i - 1], c[i], 3, 3, px, False))
        enc.append((c[i], c[i], 3, 3, px, False))
    convs = [(a, b, kh, kw, px * passes, t) for a, b, kh, kw, px, t in enc]
    cin = c[4] + feat[3]
    for i in range(4):
        level = 3 - i
        px = (h >> level) * (w >> level)
        up = d[0] if i == 0 else cin
        convs.append((cin, up, 2, 2, px, False))
        skip = c[level] + (feat[level - 1] if level > 0 else 0)
        convs.append((up + skip, d[i], 3, 3, px, False))
        convs.append((d[i], d[i], 3, 3, px, False))
        cin = d[i]
    convs.append((d[3], 1, 1, 1, h * w, False))  # the classifier
    return convs


def depth_convs(h: int, w: int, depth_steps: int, feat: Sequence[int]) -> List[Conv]:
    """One DepthModule pass with the encoder's ``feat`` in its skips."""
    e, d = DEPTH_ENC, DEPTH_DEC
    convs: List[Conv] = []
    cin, hh, ww = depth_steps + 3, h, w
    for i, k in enumerate(DEPTH_KERNELS):
        s = 1 if i == 0 else 2
        h2, w2 = _ceil_div(hh, s), _ceil_div(ww, s)
        convs.append((cin, e[i], k, 1, h2 * ww, False))
        convs.append((e[i], e[i], 1, k, h2 * w2, False))
        convs.append((e[i], e[i], 3, 1, h2 * w2, False))
        convs.append((e[i], e[i], 1, 3, h2 * w2, False))
        hh, ww, cin = h2, w2, e[i]

    def px(level):
        return (h >> level) * (w >> level)

    convs.append((e[4], d[0], 4, 4, px(4), True))
    convs.append((d[0], 1, 3, 3, px(3), False))
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


def module_flops(shape: Dict, arch: Dict) -> Dict[str, float]:
    """Forward operations per keyframe of each module at ``shape`` for the
    encoder and mask that ``arch`` names."""
    h, w, d, f = shape["height"], shape["width"], shape["depth_steps"], shape["frames"]
    layers = arch.get("resnet_layers", 18)
    feat = feature_channels(layers)
    mask_in, passes = (d + 4, 1) if arch.get("simple_mask", False) else (d, f)
    return {
        "resnet": conv_flops(resnet_convs(layers, h, w)),
        "mask": conv_flops(mask_convs(h, w, mask_in, passes, feat)),
        "depth": conv_flops(depth_convs(h, w, d, feat)),
        "k1": k1_flops(1, (f,), d, h, w),
    }


def infer_flops(shape: Dict, arch: Dict) -> float:
    """Operations per keyframe of the eval forward (pretrain mode 0): ResNet,
    K1, the mask and one depth decode, and under ``simple_mask`` the first
    depth decode that the mask reads."""
    m = module_flops(shape, arch)
    passes = 2 if arch.get("simple_mask", False) else 1
    return m["resnet"] + m["k1"] + m["mask"] + passes * m["depth"]
