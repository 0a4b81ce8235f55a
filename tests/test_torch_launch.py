"""The counter registry of ``monorec_tpu_torch/ops/cuda/launch.py``: every
kernel op's counters, under the attribute names the benchmark and
``chip_smoke.py`` read, zeroed by one ``reset()`` and read by one
``counts()``."""

import collections

from monorec_tpu_torch.models import layers
from monorec_tpu_torch.ops import bias_act, grid_warp, photo_error, plane_sweep, same_conv
from monorec_tpu_torch.ops import warp_sweep
from monorec_tpu_torch.ops.cuda import launch

COUNTERS = {
    plane_sweep.plane_sweep_sad: ("launches", "launches_bf16"),
    plane_sweep.plane_sweep_cost_volume: ("launches", "launches_bf16"),
    warp_sweep.warp_plane_sweep: ("launches", "launches_bf16"),
    grid_warp.grid_warp: ("launches", "launches_bf16", "launches_by_batch"),
    grid_warp.grid_warp_jac: ("launches", "launches_bf16", "launches_by_batch"),
    grid_warp.grid_warp_grad: ("launches", "launches_bf16", "launches_by_batch"),
    photo_error.photo_error_fwd: ("launches", "launches_by_batch"),
    photo_error.photo_error_bwd: ("launches", "launches_by_batch"),
    bias_act.bias_act: ("launches", "launches_bwd"),
    same_conv.same_conv: ("launches", "launches_by_shape", "routed_library"),
}


def _held():
    for op, attrs in COUNTERS.items():
        for attr in attrs:
            yield f"{op.__name__}.{attr}", op, attr


def test_reset_zeroes_every_counter_and_counts_reads_them_all():
    pad_counts = layers.pad_counts
    before = launch.counts()
    for _, op, attr in _held():
        value = getattr(op, attr)
        if isinstance(value, collections.Counter):
            value[(2, 3)] += 1
        else:
            setattr(op, attr, value + 1)
    pad_counts["explicit"] += 1

    after = launch.counts()
    assert set(after) == {name for name, _, _ in _held()} | {"layers.pad_counts"}
    for name, _, attr in _held():
        if "_by_" in attr:
            assert after[name][(2, 3)] == before[name].get((2, 3), 0) + 1, name
        else:
            assert after[name] == before[name] + 1, name
    assert after["layers.pad_counts"]["explicit"] == before["layers.pad_counts"].get(
        "explicit", 0) + 1

    launch.reset()
    assert all(v in (0, {}) for v in launch.counts().values())
    for name, op, attr in _held():
        value = getattr(op, attr)
        assert not value and type(value) is (collections.Counter if "_by_" in attr else int), name
    assert layers.pad_counts is pad_counts and not pad_counts
