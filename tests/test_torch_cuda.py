"""The CUDA kernel against its plain version on the card, at small and ragged
shapes. Marked ``cuda``: each test skips where no CUDA device is visible and
runs on a GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
repository's conftest.py imports JAX, which that machine need not have).
``chip_smoke.py`` runs the same comparison at full size.
"""

import pytest
import torch

from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
from monorec_tpu_torch.ops import plane_sweep
from monorec_tpu_torch.ops.cost_volume import (
    CostVolumeConfig,
    compute_cost_volume,
    plane_sweep_homographies,
)

pytestmark = pytest.mark.cuda
SAD_TOL = 1.2e-4  # f32 kernel-vs-gather budget (README.md, Performance)
_KEYS = ("keyframe", "keyframe_intrinsics", "keyframe_pose", "frames", "intrinsics", "poses")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("use_ssim", [1, 2, 0, -1])
@pytest.mark.parametrize("h,w", [(21, 45), (32, 64)])  # ragged and whole tiles
def test_plane_sweep_sad_kernel_matches_plain_version(cuda, use_ssim, h, w):
    b, f, d = 2, 2, 5
    bt = batch_to_torch(make_batch(b, h, w, f, stereo=False, mask=False, tz=0.5), cuda)
    inv = torch.linspace(0.0025, 0.33, d, dtype=torch.float64, device=cuda)
    homs = plane_sweep_homographies(
        bt["keyframe_intrinsics"], bt["keyframe_pose"], bt["intrinsics"], bt["poses"], inv, h, w
    ).reshape(b * f, d, 3, 3).contiguous()
    images = bt["frames"].reshape(b * f, 3, h, w).contiguous()
    before = plane_sweep.plane_sweep_sad.launches
    sad, wmask, cov = plane_sweep.plane_sweep_sad(images, bt["keyframe"], homs, 2, f, use_ssim)
    torch.cuda.synchronize()
    assert plane_sweep.plane_sweep_sad.launches == before + 1
    rsad, rwmask, _ = plane_sweep.plane_sweep_sad_reference(
        images, bt["keyframe"], homs, 2, f, use_ssim)
    assert (sad - rsad).abs().max().item() <= SAD_TOL
    assert torch.equal(wmask != 0, rwmask != 0)
    assert not cov.any()


def test_cost_volume_kernel_path_matches_cpu(cuda):
    nb = make_batch(2, 32, 64, 2, stereo=False, mask=False, tz=0.5)
    cfg = CostVolumeConfig(depth_steps=8)
    gpu = compute_cost_volume(*(batch_to_torch(nb, cuda)[k] for k in _KEYS), 0.0025, 0.33, cfg)
    cpu = compute_cost_volume(*(batch_to_torch(nb, "cpu")[k] for k in _KEYS), 0.0025, 0.33, cfg)
    for g, c in zip(gpu, cpu):
        assert (g.cpu() - c).abs().max().item() <= SAD_TOL
