"""The gate ``chip_smoke.py`` holds K3 to, on the CPU, where K3's wrappers
run the plain version: ``check_photo_error`` compares each element with the
plain version run in float64, within K3's test budgets plus 16 float32
unit roundoffs times ``photo_error_rounding``'s bound of what rounding in
SSIM's window statistics moves it by.

On smooth images (``SyntheticSweepDataset``'s planes, warped by a blocky
inverse depth as the stage-4 loss warps them) the float32 plain version
leaves the bare budgets at a large share of the elements (40% here, 82% at
256x512); the widened gate takes it, and still rejects a backward whose L1
weight is 0.14 instead of 0.15. Tolerances: K3's own
(``tests/test_photo_error.py``), nothing else.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from monorec_tpu_torch.data.synthetic import SyntheticSweepDataset, batch_to_torch
from monorec_tpu_torch.losses.common import _gather_frames, loss_warp_grids
from monorec_tpu_torch.ops import grid_warp as gw
from monorec_tpu_torch.ops import photo_error as pe
from monorec_tpu_torch.ops.sampling import pixel_coordinates

H, W = 64, 128


@pytest.fixture(scope="module")
def smooth_warp():
    """x, y, cot as ``chip_smoke.stage4_kernel_records`` builds them: two
    samples' mono and stereo frames warped by an 8x8-blocky inverse depth
    within 30% of the truth, against their keyframes."""
    ds = SyntheticSweepDataset(length=2, target_image_size=(H, W), frame_count=2,
                               return_stereo=True)
    samples = [ds[i] for i in range(2)]
    batch = batch_to_torch({k: np.stack([s[k] for s in samples]) for k in samples[0]}, "cpu")
    frames, poses, intr = _gather_frames(batch, True, True)
    n = frames.shape[0] * frames.shape[1]
    g = torch.Generator().manual_seed(0)
    noise = torch.rand(2, 1, H // 8, W // 8, generator=g)
    inv = batch["target"] * (1 + 0.3 * noise.repeat_interleave(8, 2).repeat_interleave(8, 3))
    grids = loss_warp_grids(1.0 / inv[:, 0], poses, intr, batch["keyframe_pose"],
                            batch["keyframe_intrinsics"])
    xs, ys = pixel_coordinates(grids.reshape(n, H, W, 2), H, W)
    images = (frames + 1.5).reshape(n, 3, H, W).contiguous()
    x = (gw.grid_warp(images, xs, ys) - 1.0).contiguous()
    y = (batch["keyframe"] + 0.5)[:, None].expand(-1, frames.shape[1], -1, -1, -1).reshape(
        n, 3, H, W).contiguous()
    cot = torch.empty(n, H, W).uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(3))
    return x, y, cot


def test_float32_plain_version_leaves_the_bare_budget_on_smooth_images(smooth_warp):
    x, y, _ = smooth_warp
    p32 = pe.photo_error_reference(x, y).double()
    p64 = pe.photo_error_reference(x.double(), y.double())
    outside = ~chip_smoke.within(p32, p64, chip_smoke.PE_FWD_RTOL, chip_smoke.PE_FWD_ATOL)
    assert outside.float().mean().item() > 0.2  # 0.397 measured
    scale, _ = chip_smoke.photo_error_rounding(x, y, torch.zeros_like(x[:, 0]))
    assert ((p32 - p64).abs() <= chip_smoke.PE_FWD_ATOL + chip_smoke.PE_FWD_RTOL * p64.abs()
            + chip_smoke.PE_ROUNDING * scale).all()


def test_gate_takes_the_float32_plain_version(smooth_warp, monkeypatch):
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    errs = chip_smoke.check_photo_error(*smooth_warp, "[test]")
    for name in ("forward", "backward"):
        assert errs[name]["max_abs_err"] == 0.0
        assert errs[name]["max_abs_err_vs_float64"] == errs[name]["plain_max_abs_err_vs_float64"]


def test_gate_rejects_a_wrong_l1_weight(smooth_warp, monkeypatch):
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    right = pe.photo_error_bwd

    def wrong(x, y, cot):  # 0.14 |x - y| where K3 has 0.15
        return right(x, y, cot) - (0.01 / x.shape[1]) * torch.sign(x - y) * cot[:, None]

    monkeypatch.setattr(pe, "photo_error_bwd", wrong)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_photo_error(*smooth_warp, "[test]")
