"""Carry the JAX package's weights into the port.

``state_dict_from_flax`` takes the flax variables of
``monorec_tpu.models.MonoRec`` (``params`` and ``batch_stats`` as nested
dicts of numpy arrays) and returns a ``state_dict`` with the reference's
keys, which ``monorec_tpu_torch.models.MonoRec.load_state_dict`` takes. It
carries every encoder depth (a ``Bottleneck``'s third conv ``Conv_2`` /
``_BN_2`` becomes ``conv3`` / ``bn3``) and both mask modules (the simple
one has the same layout). For ResNet-18 and -34 it is the exact inverse of
``monorec_tpu.convert.convert_state_dict``; for ResNet-50, -101 and -152 it
is not, because that function refuses bottleneck encoders and converts
their other subtrees only.
Layout rules inverted (``monorec_tpu/utils/torch_compat.py``):

* conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw);
* transposed-conv kernel (kh, kw, I, O), spatially flipped -> weight
  (I, O, kh, kw) (flax does not flip the kernel, torch's transposed conv does);
* BatchNorm scale/bias -> weight/bias, batch_stats mean/var -> running stats.

Pure numpy + torch; the JAX package is not imported.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

FlaxTree = Mapping[str, object]
_Entry = Tuple[str, Tuple[str, ...], str]  # (torch prefix, flax path, kind)


def _resnet_layout(tree: FlaxTree) -> Iterator[_Entry]:
    tp, fp = "_feature_extractor.encoder", ("encoder",)
    yield f"{tp}.conv1", fp + ("Conv_0",), "conv"
    yield f"{tp}.bn1", fp + ("_BN_0", "BatchNorm_0"), "bn"
    for stage in range(1, 5):
        b = 0
        while f"layer{stage}_block{b}" in tree:
            tb, fb = f"{tp}.layer{stage}.{b}", fp + (f"layer{stage}_block{b}",)
            yield f"{tb}.conv1", fb + ("Conv_0",), "conv"
            yield f"{tb}.bn1", fb + ("_BN_0", "BatchNorm_0"), "bn"
            yield f"{tb}.conv2", fb + ("Conv_1",), "conv"
            yield f"{tb}.bn2", fb + ("_BN_1", "BatchNorm_0"), "bn"
            if "Conv_2" in tree[f"layer{stage}_block{b}"]:  # a Bottleneck
                yield f"{tb}.conv3", fb + ("Conv_2",), "conv"
                yield f"{tb}.bn3", fb + ("_BN_2", "BatchNorm_0"), "bn"
            if "downsample_conv" in tree[f"layer{stage}_block{b}"]:
                yield f"{tb}.downsample.0", fb + ("downsample_conv",), "conv"
                yield f"{tb}.downsample.1", fb + ("downsample_bn", "BatchNorm_0"), "bn"
            b += 1


def _depth_layout() -> Iterator[_Entry]:
    tp, fp = "depth_module", ("depth_net",)

    def sep(t, f):
        yield f"{t}.conv_y", fp + (f, "SamePadConv_0", "Conv_0"), "conv"
        yield f"{t}.conv_x", fp + (f, "SamePadConv_1", "Conv_0"), "conv"

    for i in range(5):
        yield from sep(f"{tp}.enc.{i}.0", f"enc{i}a")
        yield from sep(f"{tp}.enc.{i}.1", f"enc{i}b")
    yield f"{tp}.dec.0.conv2d_t", fp + ("dec0", "ConvTranspose_0"), "conv_t"
    yield f"{tp}.dec.1.0.conv2d_t", fp + ("dec1", "ConvTranspose_0"), "conv_t"
    yield from sep(f"{tp}.dec.1.1", "dec1b")
    yield f"{tp}.dec.2.0.conv2d_t", fp + ("dec2", "ConvTranspose_0"), "conv_t"
    yield from sep(f"{tp}.dec.2.1", "dec2b")
    yield f"{tp}.dec.3.conv2d_t", fp + ("dec3", "ConvTranspose_0"), "conv_t"
    yield from sep(f"{tp}.dec.4.0", "dec4a")
    yield f"{tp}.dec.4.2", fp + ("dec4b", "Conv_0"), "conv"
    for i in range(4):
        yield f"{tp}.predictors.{i}.1", fp + (f"pred{i}", "SamePadConv_0", "Conv_0"), "conv"


def _mask_layout() -> Iterator[_Entry]:
    tp, fp = "att_module", ("att",)
    for i in range(5):
        a, b = (0, 1) if i == 0 else (1, 2)  # stages 1-4 start with a MaxPool
        yield f"{tp}.enc.{i}.{a}.conv", fp + ("cv_encoder", f"enc{i}a", "SamePadConv_0", "Conv_0"), "conv"
        yield f"{tp}.enc.{i}.{b}.conv", fp + ("cv_encoder", f"enc{i}b", "SamePadConv_0", "Conv_0"), "conv"
    for i in range(4):
        for j, name in enumerate((f"up{i}", f"dec{i}a", f"dec{i}b")):
            yield f"{tp}.dec.{i}.{j}.conv", fp + ("decoder", name, "SamePadConv_0", "Conv_0"), "conv"
    yield f"{tp}.classifier.0", fp + ("decoder", "classifier"), "conv"


def _get(tree: FlaxTree, path: Tuple[str, ...]) -> Mapping[str, np.ndarray]:
    for p in path:
        tree = tree[p]
    return tree


def state_dict_from_flax(params: FlaxTree, batch_stats: FlaxTree) -> Dict[str, torch.Tensor]:
    """Flax MonoRec variables -> port ``state_dict`` (reference keys)."""
    unknown = set(params) - {"encoder", "att", "depth_net"}
    if unknown:
        raise ValueError(f"flax subtrees not ported yet: {sorted(unknown)}")
    layout = []
    if "encoder" in params:
        layout += list(_resnet_layout(params["encoder"]))
    if "depth_net" in params:
        layout += list(_depth_layout())
    if "att" in params:
        layout += list(_mask_layout())

    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    for prefix, path, kind in layout:
        node = _get(params, path)
        if kind == "conv":
            put(f"{prefix}.weight", np.transpose(node["kernel"], (3, 2, 0, 1)))
        elif kind == "conv_t":
            put(f"{prefix}.weight", np.transpose(np.asarray(node["kernel"])[::-1, ::-1], (2, 3, 0, 1)))
        else:  # bn
            stats = _get(batch_stats, path)
            put(f"{prefix}.weight", node["scale"])
            put(f"{prefix}.running_mean", stats["mean"])
            put(f"{prefix}.running_var", stats["var"])
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
        if "bias" in node:
            put(f"{prefix}.bias", node["bias"])
    return sd


def load_flax_npz(path) -> Tuple[dict, dict]:
    """Read ``params`` / ``batch_stats`` trees from an npz whose keys are
    '/'-joined flax paths, e.g. ``params/encoder/Conv_0/kernel``."""
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    with np.load(path) as z:
        for key in z.files:
            root, *rest = key.split("/")
            if root not in trees or not rest:
                raise ValueError(f"unexpected key {key!r} in {path}")
            node = trees[root]
            for p in rest[:-1]:
                node = node.setdefault(p, {})
            node[rest[-1]] = z[key]
    return trees["params"], trees["batch_stats"]
