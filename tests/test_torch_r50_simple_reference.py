"""The port's ResNet-50 + SimpleMaskModule forward against the benchmark's
plain reference (``bench_h100/reference/monorec_r50_simple.py``) on the CPU,
at a small size: the reference's seeded weights load into
``MonoRec(resnet_layers=50, simple_mask=True)`` key for key, its eval
forward (depth, mask on that depth, depth again) gives the reference's
``result`` and ``cv_mask`` within float32's reach, and the reference's
own TF32 control (every convolution on TF32 operands, one precision step
below the configuration's float32) falls outside that reach."""

import functools

import pytest
import torch

from bench_h100 import harness, scenes
from bench_h100.reference import monorec as plain
from bench_h100.reference.monorec_r50_simple import (
    MonoRecR50SimpleReference,
    seeded_state_dict,
    template,
)
from monorec_tpu_torch.models.monorec import MonoRec, MonoRecConfig

B, H, W, F, D = 2, 64, 128, 2, 8
SEEDS = (2**31 + 5, 2**33 + 6)
SCENE = harness.load_json("configs", "monorec-r50-simple.json")["scene"]
# Both sides compute in float32 with the same operands; they sum in other
# orders (the port pads implicitly and adds the bias in the convolution,
# the reference pads a copy first), and the fused cost volume's frame
# weights are ill-conditioned where a cost curve is flat. Over six seeds at
# this size the gaps were at most 5.1e-6 (result) and 1.9e-5 (cv_mask),
# the TF32 control's at least 1.9e-3 and 9.5e-3: each tolerance leaves
# about 20x above the first and 20x below the second.
RESULT_ATOL = 1e-4  # inverse depth, in [0.0025, 0.33]
MASK_ATOL = 2e-4  # a probability, in [0, 1]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed):
    return scenes.make_batches(SCENE, 1, B, H, W, F, False, seed, "cpu")[0]


@functools.lru_cache(maxsize=None)
def _reference(seed, exact=True):
    ref = MonoRecR50SimpleReference(D).eval()
    ref.load_state_dict(seeded_state_dict(D, seed, "cpu"))
    plain.PRECISION.exact = exact
    with plain.PRECISION:
        out = ref.infer(_batch(seed))
    return out["result"], out["cv_mask"]


def _gaps(seed, exact=True):
    result, mask = _reference(seed, exact)
    ref_result, ref_mask = _reference(seed)
    return (result - ref_result).abs().max().item(), (mask - ref_mask).abs().max().item()


def test_state_dict_keys_match():
    with torch.device("meta"):
        port = MonoRec(MonoRecConfig(cv_depth_steps=D, resnet_layers=50, simple_mask=True))
    shapes = {k: v.shape for k, v in port.state_dict().items()}
    assert shapes == template(D)
    assert "_feature_extractor.encoder.layer4.2.conv3.weight" in shapes


def test_seeded_norms_close_each_residual_branch():
    """1/sqrt(2) on ``bn3`` and ``downsample.1``, 1 on ``bn1`` and ``bn2``."""
    state = seeded_state_dict(D, 3, "cpu")
    prefix = "_feature_extractor.encoder.layer2.0."
    for name, scale in (("bn1", 1.0), ("bn2", 1.0), ("bn3", 0.5**0.5), ("downsample.1", 0.5**0.5)):
        assert torch.all(state[prefix + name + ".weight"] == scale), name
        assert torch.all(state[prefix + name + ".running_var"] == 1.0), name


@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_the_plain_reference(seed):
    port = MonoRec(MonoRecConfig(cv_depth_steps=D, resnet_layers=50, simple_mask=True)).eval()
    port.load_state_dict(seeded_state_dict(D, seed, "cpu"))
    with torch.inference_mode():
        out = port(_batch(seed))
    ref_result, ref_mask = _reference(seed)
    assert out["result"].shape == ref_result.shape == (B, 1, H, W)
    assert (out["result"] - ref_result).abs().max().item() <= RESULT_ATOL
    assert (out["cv_mask"] - ref_mask).abs().max().item() <= MASK_ATOL
    # The mask says something at this size: neither all moving nor all static.
    assert ref_mask.min() < 0.1 and ref_mask.max() > 0.9


def test_tf32_control_fails_the_tolerances():
    result_gap, mask_gap = _gaps(SEEDS[0], exact=False)
    assert result_gap > RESULT_ATOL or mask_gap > MASK_ATOL, (result_gap, mask_gap)
