"""The CUDA kernels against their plain versions on the card, at small and
ragged shapes. Marked ``cuda``: each test skips where no CUDA device is visible and
runs on a GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
repository's conftest.py imports JAX, which that machine need not have).
``chip_smoke.py`` runs the same comparison at full size.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
from monorec_tpu_torch.models import layers
from monorec_tpu_torch.ops import bias_act as ba
from monorec_tpu_torch.ops import same_conv as sc
from monorec_tpu_torch.ops import grid_warp as gw
from monorec_tpu_torch.ops import photo_error as pe
from monorec_tpu_torch.ops import plane_sweep, warp_sweep
from monorec_tpu_torch.ops.cost_volume import (
    CostVolumeConfig,
    compute_cost_volume,
    plane_sweep_homographies,
)
from monorec_tpu_torch.precision import use_exact_precision

pytestmark = pytest.mark.cuda
SAD_TOL = 1.2e-4  # f32 kernel-vs-gather budget (README.md, Performance)
_KEYS = ("keyframe", "keyframe_intrinsics", "keyframe_pose", "frames", "intrinsics", "poses")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)


def _sweep_inputs(device, h, w, b=2, f=2, d=5):
    bt = batch_to_torch(make_batch(b, h, w, f, stereo=False, mask=False, tz=0.5), device)
    inv = torch.linspace(0.0025, 0.33, d, dtype=torch.float64, device=device)
    homs = plane_sweep_homographies(
        bt["keyframe_intrinsics"], bt["keyframe_pose"], bt["intrinsics"], bt["poses"], inv, h, w
    ).reshape(b * f, d, 3, 3).contiguous()
    return bt["frames"].reshape(b * f, 3, h, w).contiguous(), bt["keyframe"], homs


def _counter(fn, dtype):
    return fn.launches_bf16 if dtype == torch.bfloat16 else fn.launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_ssim", [1, 2, 0, -1])
@pytest.mark.parametrize("h,w", [(21, 45), (32, 64)])  # ragged and whole tiles
def test_plane_sweep_sad_kernel_matches_plain_version(cuda, use_ssim, h, w, dtype):
    f = 2
    images, keyframes, homs = _sweep_inputs(cuda, h, w, f=f)
    images = images.to(dtype)
    before = _counter(plane_sweep.plane_sweep_sad, dtype)
    sad, wmask = plane_sweep.plane_sweep_sad(images, keyframes, homs, 2, f, use_ssim)
    torch.cuda.synchronize()
    assert _counter(plane_sweep.plane_sweep_sad, dtype) == before + 1
    rsad, rwmask = plane_sweep.plane_sweep_sad_reference(
        images.float(), keyframes, homs, 2, f, use_ssim)
    assert (sad - rsad).abs().max().item() <= SAD_TOL
    assert torch.equal(wmask != 0, rwmask != 0)


@pytest.mark.parametrize("not_center_cv", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_ssim", [1, 2, 0, -1])
@pytest.mark.parametrize("d", [2, 8, 32, 96])
@pytest.mark.parametrize("f", [1, 2, 3])
@pytest.mark.parametrize("h,w", [(21, 45), (32, 64)])  # ragged and whole tiles
def test_plane_sweep_cost_volume_kernel_matches_plain_version(cuda, h, w, f, d, use_ssim, dtype,
                                                              not_center_cv):
    images, keyframes, homs = _sweep_inputs(cuda, h, w, f=f, d=d)
    images = images.to(dtype)
    args = (images, keyframes, homs, 2, f, use_ssim, plane_sweep.DEFAULT_CHANNEL_WEIGHTS, 10.0,
            not_center_cv)
    before = _counter(plane_sweep.plane_sweep_cost_volume, dtype)
    fused, sfcv = plane_sweep.plane_sweep_cost_volume(*args)
    torch.cuda.synchronize()
    assert _counter(plane_sweep.plane_sweep_cost_volume, dtype) == before + 1
    rfused, rsfcv = plane_sweep.plane_sweep_cost_volume_reference(*args)
    assert fused.shape == (2, d, h, w) and sfcv.shape == (2, f, d, h, w)
    assert (sfcv - rsfcv).abs().max().item() <= SAD_TOL
    # The fused CV against the plain version in float64 (the frame weights
    # are ill-conditioned at flat cost curves): within the budget, or twice
    # the float32 plain version's own error where that is larger.
    f64, _ = plane_sweep.plane_sweep_cost_volume_reference(
        images.double(), keyframes.double(), *args[2:])
    tol = max(SAD_TOL, 2.0 * (rfused - f64).abs().max().item())
    assert (fused - f64).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [(2, 1), (1, 2), (1, 1, 1), (3, 1)])
@pytest.mark.parametrize("h,w", [(21, 45), (32, 64)])  # ragged and whole tiles
def test_grouped_cost_volume_launch_matches_plain_version_and_a_launch_per_group(
        cuda, h, w, groups, dtype):
    """One launch over every frame, fused per group (the mono frames and the
    stereo frame of the joint cost volume): each group within the budgets
    of the ungrouped test above, and bit-equal to a launch over its frames
    alone."""
    f, d = sum(groups), 8
    images, keyframes, homs = _sweep_inputs(cuda, h, w, f=f, d=d)
    images = images.to(dtype)
    before = _counter(plane_sweep.plane_sweep_cost_volume, dtype)
    outs = plane_sweep.plane_sweep_cost_volume(images, keyframes, homs, 2, f, 1, groups=groups)
    torch.cuda.synchronize()
    assert _counter(plane_sweep.plane_sweep_cost_volume, dtype) == before + 1
    refs = plane_sweep.plane_sweep_cost_volume_reference(images, keyframes, homs, 2, f, 1,
                                                         groups=groups)
    f64s = plane_sweep.plane_sweep_cost_volume_reference(images.double(), keyframes.double(),
                                                         homs, 2, f, 1, groups=groups)
    per_key = lambda t, g: t.reshape((2, f) + t.shape[1:])[:, g].flatten(0, 1)  # noqa: E731
    f0 = 0
    for (fused, sfcv), (rfused, rsfcv), (f64, _), fg in zip(outs, refs, f64s, groups):
        assert fused.shape == (2, d, h, w) and sfcv.shape == (2, fg, d, h, w)
        assert (sfcv - rsfcv).abs().max().item() <= SAD_TOL
        tol = max(SAD_TOL, 2.0 * (rfused - f64).abs().max().item())
        assert (fused - f64).abs().max().item() <= tol
        g = slice(f0, f0 + fg)
        alone = plane_sweep.plane_sweep_cost_volume(per_key(images, g).contiguous(), keyframes,
                                                    per_key(homs, g).contiguous(), 2, fg, 1)
        assert torch.equal(fused, alone[0]) and torch.equal(sfcv, alone[1])
        f0 += fg


def _shifted(t):
    """A contiguous copy of ``t`` that starts one element into its storage:
    no 16-byte alignment, so the kernels take their scalar or 4-byte paths."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view_as(t).copy_(t)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize("shift", [False, True])  # aligned sources, and a view 1 element in
@pytest.mark.parametrize("w", [45, 64, 131])  # W % 4 == 1, 0, 3
@pytest.mark.parametrize("d", [1, 7])
@pytest.mark.parametrize("c", [1, 3, 4])  # planar gathers, packed texels, planar
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_plane_sweep_kernel_matches_plain_version(cuda, dtype, c, d, w, shift):
    h = 21
    rgb, _, homs = _sweep_inputs(cuda, h, w, d=d)
    images = torch.cat([rgb, rgb.flip(1)], 1)[:, :c].contiguous().to(dtype)
    if shift:
        images = _shifted(images)
    before = _counter(warp_sweep.warp_plane_sweep, dtype)
    warped, wmask = warp_sweep.warp_plane_sweep(images, homs, 2)
    torch.cuda.synchronize()
    assert _counter(warp_sweep.warp_plane_sweep, dtype) == before + 1
    rwarped, rwmask = warp_sweep.warp_plane_sweep_reference(images, homs, 2)
    assert warped.dtype == rwarped.dtype == dtype and warped.shape == (4, d, c, h, w)
    # The same float32 operations in the same order: equal bit for bit.
    assert torch.equal(warped, rwarped) and torch.equal(wmask, rwmask)
    assert torch.equal(warped == 0, rwarped == 0)  # exact zeros: the sfcv_mult_mask=False rule
    assert torch.equal(wmask != 0, rwmask != 0)


@pytest.mark.parametrize("cfg", [
    {}, {"warp_dtype": "bfloat16"}, {"not_center_cv": True, "use_ssim": 2},  # K1
    {"sfcv_mult_mask": False}, {"patch_size": 5, "warp_dtype": "bfloat16"},  # K4
])
def test_cost_volume_kernel_path_matches_cpu(cuda, cfg):
    nb = make_batch(2, 32, 64, 2, stereo=False, mask=False, tz=0.5)
    cfg = CostVolumeConfig(depth_steps=8, **cfg)
    gpu = compute_cost_volume(*(batch_to_torch(nb, cuda)[k] for k in _KEYS), 0.0025, 0.33, cfg)
    cpu = compute_cost_volume(*(batch_to_torch(nb, "cpu")[k] for k in _KEYS), 0.0025, 0.33, cfg)
    for g, c in zip(gpu, cpu):
        assert (g.cpu() - c).abs().max().item() <= SAD_TOL


def _warp_inputs(h, w, device, n=2, c=3, seed=0):
    """Images and pixel coordinates with a depth edge (a jump in x), integer
    fractions (every third row) and samples far outside the image."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    dx = np.where(ys > h // 2, 9.4, 1.3) + 0.1 * np.sin(xs / 5.0)
    dx = np.where(ys % 3 == 0, np.round(dx), dx)
    dy = np.where(xs < w // 4, -40.0, 0.6)
    x = np.stack([xs + dx + 0.37 * i for i in range(n)]).astype(np.float32)
    y = np.stack([ys + dy for _ in range(n)]).astype(np.float32)
    images = rng.uniform(1.0, 2.0, (n, c, h, w)).astype(np.float32)
    cot = rng.uniform(-1.0, 1.0, (n, c, h, w)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (images, x, y, cot)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(21, 45), (32, 128)])  # ragged and whole tiles
def test_grid_warp_kernel_matches_plain_version(cuda, h, w, dtype):
    images, xs, ys, cot = _warp_inputs(h, w, cuda)
    images = images.to(dtype)
    entries = (gw.grid_warp, gw.grid_warp_jac, gw.grid_warp_grad)
    before = [_counter(e, dtype) for e in entries]
    out = gw.grid_warp(images, xs, ys)
    jout, jx, jy = gw.grid_warp_jac(images, xs, ys)
    gx, gy = gw.grid_warp_grad(images, xs, ys, cot)
    torch.cuda.synchronize()
    assert [_counter(e, dtype) for e in entries] == [b + 1 for b in before]
    assert out.dtype == jx.dtype == gx.dtype == torch.float32
    ref = gw.grid_warp_reference(images, xs, ys)
    _, rjx, rjy = gw.grid_warp_jac_reference(images, xs, ys)
    rgx, rgy = gw.grid_warp_grad_reference(images, xs, ys, cot)
    assert (out - ref).abs().max().item() <= 2e-4  # tests/test_grid_warp.py:51
    assert torch.equal(jout, out)
    assert torch.equal(out[:, 0] == 0, ref[:, 0] == 0)  # the exact-zero invalid mask
    assert (out[:, :, :, : w // 4 - 1] == 0).all()  # far outside: exactly 0.0
    for got, want in ((jx, rjx), (jy, rjy), (gx, rgx), (gy, rgy)):
        assert (got - want).abs().max().item() <= 2e-5  # tests/test_grid_warp.py:298


def test_grid_warp_kernel_on_unaligned_tensors(cuda):
    # Views that start 4 bytes into their storage: whole planes of four, but
    # no 16-byte alignment, so the kernel takes its scalar accesses.
    images, xs, ys, cot = _warp_inputs(32, 128, cuda)
    sx, sy, scot = (_shifted(t) for t in (xs, ys, cot))
    torch.testing.assert_close(gw.grid_warp(images, sx, sy), gw.grid_warp(images, xs, ys),
                               rtol=0, atol=0)
    for got, want in zip(gw.grid_warp_grad(images, sx, sy, scot),
                         gw.grid_warp_grad(images, xs, ys, cot)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_warp_pixels_gradient_on_the_card(cuda):
    images, xs, ys, cot = _warp_inputs(32, 128, cuda)
    x, y = xs.clone().requires_grad_(), ys.clone().requires_grad_()
    before = gw.grid_warp_jac.launches
    (gw.warp_pixels(images, x, y) * cot).sum().backward()
    assert gw.grid_warp_jac.launches == before + 1
    rgx, rgy = gw.grid_warp_grad_reference(images, xs, ys, cot)
    assert (x.grad - rgx).abs().max().item() <= 2e-5
    assert (y.grad - rgy).abs().max().item() <= 2e-5


@pytest.mark.parametrize("shift", [False, True])  # aligned, and views 4 bytes in
@pytest.mark.parametrize("h,w", [(21, 45), (33, 70), (32, 128), (64, 128), (5, 3)])
@pytest.mark.parametrize("m,c", [(3, 3), (5, 1), (1, 3), (2, 4)])  # odd and even channel counts
def test_photo_error_kernels_match_plain_version(cuda, m, c, h, w, shift):
    # Shapes ragged against the forward's 32x32 and the backward's 30x30
    # tiles and whole ones; widths with W % 4 == 0 take the 16-byte copies,
    # the others the 4-byte copies. An even C ends the channel loop in the
    # second staging buffer.
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0.0, 1.0, (m, c, h, w)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.uniform(0.0, 1.0, (m, c, h, w)).astype(np.float32)).to(cuda)
    x[0, :, :3, :5] = -1.0  # invalid-pixel values of the loss
    cot = torch.from_numpy(rng.uniform(-1, 1, (m, h, w)).astype(np.float32)).to(cuda)
    if shift:
        x, y, cot = _shifted(x), _shifted(y), _shifted(cot)
    before = (pe.photo_error_fwd.launches, pe.photo_error_bwd.launches)
    out = pe.photo_error_fwd(x, y)
    gx = pe.photo_error_bwd(x, y, cot)
    torch.cuda.synchronize()
    assert (pe.photo_error_fwd.launches, pe.photo_error_bwd.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    ref = pe.photo_error_reference(x, y)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)  # tests/test_photo_error.py:44
    xr = x.clone().requires_grad_()
    (rgx,) = torch.autograd.grad((pe.photo_error_reference(xr, y) * cot).sum(), xr)
    torch.testing.assert_close(gx, rgx, rtol=1e-3, atol=2e-5)  # tests/test_photo_error.py:62
    yg = y.clone().requires_grad_()
    xg = x.clone().requires_grad_()
    (pe.photo_error(xg, yg) * cot).sum().backward()
    torch.testing.assert_close(xg.grad, gx, rtol=0, atol=0)
    assert yg.grad is None


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slope", [0.1, 1.0])
@pytest.mark.parametrize("shape,window", [
    ((2, 3, 5, 7), None),  # ragged: element by element
    ((2, 5, 16, 32), None),  # 16-byte vectors
    ((2, 5, 16, 32), (0, 0, 16, 32)),  # a window of the whole plane
    ((3, 2, 70, 4100), None),  # several blocks a plane
    ((1, 3, 9, 13), (1, 1, 8, 12)),  # an implicitly padded k=2 conv's window
    ((2, 4, 66, 130), (1, 1, 64, 128)),  # Refine's crop
])
def test_bias_act_kernel_matches_plain_ops(cuda, dtype, slope, shape, window):
    g = torch.Generator(device=cuda).manual_seed(0)
    y = torch.randn(shape, generator=g, device=cuda).to(dtype)
    bias = torch.randn(shape[1], generator=g, device=cuda).to(dtype)
    y[:, :, 2, :] = -bias.view(1, -1, 1)  # pre-activations of exactly 0
    out_shape = shape[:2] + (window[2:] if window else shape[2:])
    cot = torch.randn(out_shape, generator=g, device=cuda).to(dtype)
    before = (ba.bias_act.launches, ba.bias_act.launches_bwd)
    yk, bk = y.clone().requires_grad_(), bias.clone().requires_grad_()
    out = ba.bias_act(yk, bk, slope, window)
    gy, gb = torch.autograd.grad(out, (yk, bk), cot)
    torch.cuda.synchronize()
    assert (ba.bias_act.launches, ba.bias_act.launches_bwd) == (before[0] + 1, before[1] + 1)
    yr, br = y.clone().requires_grad_(), bias.clone().requires_grad_()
    ref = ba.bias_act_reference(yr, br, slope, window)
    ry, rb = torch.autograd.grad(ref, (yr, br), cot)
    assert out.shape == ref.shape and torch.equal(_bits(out), _bits(ref))
    assert torch.equal(_bits(gy), _bits(ry))
    # The bias gradient sums in another order: within 1e-6 of each channel's
    # sum of |d|, plus (bf16) one bf16 unit of the result, to which both round.
    ulp = 0.0 if dtype == torch.float32 else 2.0**-7
    scale = ry.float().abs().sum((0, 2, 3))
    assert ((gb.float() - rb.float()).abs() <= 1e-6 * scale + ulp * rb.float().abs()).all()


def _grads(out, params, cot):
    return torch.autograd.grad(out, params, cot)


@pytest.mark.parametrize("size", [(16, 20), (15, 21)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [1, 2, 3, 7, (7, 1), (1, 7)])
def test_same_pad_conv_on_the_card_matches_explicit_pad(cuda, kernel, stride, size):
    use_exact_precision()
    torch.manual_seed(0)
    conv = layers.SamePadConv(8, 16, kernel, stride, layers.LEAKY_SLOPE).to(cuda)
    x = torch.randn(2, 8, *size, device=cuda, requires_grad=True)
    params = (x, conv.weight, conv.bias)
    got = conv(x)
    want = F.leaky_relu(F.conv2d(layers.pad_same(x, conv.kernel_size, conv.stride),
                                 conv.weight, conv.bias, conv.stride), 0.1)
    # cuDNN may sum an implicitly padded input in another order.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    cot = torch.randn_like(want)
    for g, w in zip(_grads(got, params, cot), _grads(want, params, cot)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [(8, 10), (7, 11)])
def test_refine_on_the_card_matches_the_cropped_transposed_conv(cuda, size):
    use_exact_precision()
    torch.manual_seed(0)
    m = layers.Refine(16, 8).to(cuda)
    t = m.conv2d_t
    x = torch.randn(2, 16, *size, device=cuda, requires_grad=True)
    params = (x, t.weight, t.bias)
    got = m(x)
    want = F.leaky_relu(F.conv_transpose2d(x, t.weight, t.bias, t.stride), 0.1)[:, :, 1:-1, 1:-1]
    assert got.shape == want.shape == (2, 8, 2 * size[0], 2 * size[1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    cot = torch.randn_like(want)
    for g, w in zip(_grads(got, params, cot), _grads(want, params, cot)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# Every shape the stride-1 kernel takes in the three benchmarked
# configurations, at full widths and one or two images: (N, C_in, H, W,
# C_out, kh, kw, slope).
SAME_CONV_ROUTED = [
    (2, 32, 128, 256, 48, 3, 3, 0.1), (2, 32, 240, 320, 48, 3, 3, 0.1),
    (1, 32, 256, 512, 24, 3, 3, 0.1), (1, 32, 256, 512, 32, 1, 3, 0.1),
    (1, 32, 256, 512, 32, 3, 3, 0.1), (1, 32, 480, 640, 24, 3, 3, 0.1),
    (1, 32, 480, 640, 32, 1, 3, 0.1), (1, 32, 480, 640, 32, 3, 3, 0.1),
    (1, 35, 256, 512, 48, 7, 1, 0.1), (1, 35, 480, 640, 48, 7, 1, 0.1),
    (2, 36, 128, 256, 48, 3, 3, 0.1), (1, 36, 256, 512, 36, 3, 3, 0.1),
    (2, 48, 64, 128, 64, 3, 3, 0.1), (2, 48, 120, 160, 64, 3, 3, 0.1),
    (2, 48, 128, 256, 48, 3, 3, 0.1), (2, 48, 240, 320, 48, 3, 3, 0.1),
    (1, 48, 256, 512, 48, 1, 3, 0.1), (1, 48, 256, 512, 48, 1, 7, 0.1),
    (1, 48, 256, 512, 48, 3, 1, 0.1), (1, 48, 256, 512, 48, 3, 3, 0.1),
    (1, 48, 480, 640, 48, 1, 3, 0.1), (1, 48, 480, 640, 48, 1, 7, 0.1),
    (1, 48, 480, 640, 48, 3, 1, 0.1), (1, 48, 480, 640, 48, 3, 3, 0.1),
    (1, 64, 256, 512, 64, 2, 2, 1.0), (1, 64, 480, 640, 64, 2, 2, 1.0),
    (2, 96, 64, 128, 96, 2, 2, 1.0), (2, 96, 120, 160, 96, 2, 2, 1.0),
    (2, 96, 128, 256, 96, 2, 2, 1.0), (2, 96, 240, 320, 96, 2, 2, 1.0),
    (1, 96, 256, 512, 32, 3, 1, 0.1), (1, 96, 256, 512, 48, 3, 3, 0.1),
    (1, 96, 480, 640, 32, 3, 1, 0.1), (1, 96, 480, 640, 48, 3, 3, 0.1),
    (1, 100, 256, 512, 48, 3, 3, 0.1), (1, 24, 256, 512, 1, 3, 3, 1.0),
    (2, 64, 128, 256, 1, 3, 3, 1.0), (2, 128, 64, 128, 1, 3, 3, 1.0),
    (1, 24, 480, 640, 1, 3, 3, 1.0), (2, 64, 240, 320, 1, 3, 3, 1.0),
    (2, 128, 120, 160, 1, 3, 3, 1.0),
]


def _same_conv_operands(device, n, c_in, h, w, c_out, kh, kw, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, c_in, h, w, generator=g, device=device)
    wt = (torch.rand(c_out, c_in, kh, kw, generator=g, device=device) * 2 - 1) * (
        6 / (c_in * kh * kw)) ** 0.5
    return x, wt, 0.1 * torch.randn(c_out, generator=g, device=device)


def _assert_within_summation_bound(got, x, wt, bias, slope, pad):
    # Two float32 sums of K = C_in kh kw + 1 terms in other orders: within
    # 2 K u of the sum of the terms' magnitudes.
    want = sc.same_conv_reference(x, wt, bias, slope, pad)
    scale = sc.same_conv_reference(x.abs(), wt.abs(), bias.abs(), 1.0, pad)
    k = wt[0].numel() + 1
    assert got.shape == want.shape
    assert ((got - want).abs() <= 2 * k * 2.0**-24 * scale).all()


@pytest.mark.parametrize("shape", SAME_CONV_ROUTED, ids=str)
def test_same_conv_kernel_matches_plain_version_at_the_routed_shapes(cuda, shape):
    n, c_in, h, w, c_out, kh, kw, slope = shape
    assert sc.admits(torch.float32, (1, 1), (kh, kw), c_in, c_out)
    x, wt, bias = _same_conv_operands(cuda, n, c_in, h, w, c_out, kh, kw)
    pad = sc.same_pads(kh, kw)
    before = sc.same_conv.launches
    got = sc.same_conv_fwd(x, wt, bias, slope, pad)
    torch.cuda.synchronize()
    assert sc.same_conv.launches == before + 1
    _assert_within_summation_bound(got, x, wt, bias, slope, pad)


@pytest.mark.parametrize("config", range(len(sc.CONFIGS)))
@pytest.mark.parametrize("size", [(21, 45), (3, 70), (33, 31)])  # ragged tiles
@pytest.mark.parametrize("kernel", sc.KERNELS, ids=str)
def test_same_conv_kernel_on_ragged_planes_and_channels(cuda, kernel, size, config):
    # 13 input channels (a ragged last chunk), 36 output channels (a ragged
    # channel block in every configuration).
    kh, kw = kernel
    x, wt, bias = _same_conv_operands(cuda, 2, 13, *size, 36, kh, kw, seed=1)
    x[:, :, 1, :] = 0.0  # whole rows of zeros: pre-activations of exactly the bias
    pad = sc.same_pads(kh, kw)
    for slope in (0.1, 1.0):
        got = sc.same_conv_fwd(x, wt, bias, slope, pad, config=config)
        torch.cuda.synchronize()
        _assert_within_summation_bound(got, x, wt, bias, slope, pad)


@pytest.mark.parametrize("slope", [0.1, 1.0])
@pytest.mark.parametrize("kernel", [(3, 3), (2, 2), (7, 1), (1, 7), (1, 3)], ids=str)
def test_same_conv_function_gradients_match_the_cudnn_path(cuda, kernel, slope):
    use_exact_precision()
    kh, kw = kernel
    x, wt, bias = _same_conv_operands(cuda, 2, 24, 33, 70, 48, kh, kw, seed=2)
    top, left = sc.same_pads(kh, kw)
    bottom, right = kh - 1 - top, kw - 1 - left
    params_k = [t.clone().requires_grad_() for t in (x, wt, bias)]
    params_l = [t.clone().requires_grad_() for t in (x, wt, bias)]
    before = (sc.same_conv.launches, ba.bias_act.launches_bwd)
    got = sc.same_conv(*params_k, slope, (top, left))
    # Today's cuDNN path: the convolution padded (bottom, right) on both
    # sides without its bias, then bias_act over the kept window.
    want = ba.conv_bias_act(F.conv2d, *params_l, slope, (bottom - top, right - left),
                            padding=(bottom, right))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    cot = torch.randn_like(want)
    for a, b in zip(torch.autograd.grad(got, params_k, cot),
                    torch.autograd.grad(want, params_l, cot)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    torch.cuda.synchronize()
    assert (sc.same_conv.launches, ba.bias_act.launches_bwd) == (before[0] + 1, before[1] + 2)


def test_same_pad_conv_on_the_card_routes_by_the_rule(cuda):
    use_exact_precision()
    torch.manual_seed(0)
    x = torch.randn(2, 64, 16, 20, device=cuda)
    routed = layers.SamePadConv(64, 48, 3, 1, layers.LEAKY_SLOPE).to(cuda)
    wide = layers.SamePadConv(64, 64, 3, 1, layers.LEAKY_SLOPE).to(cuda)
    before = (sc.same_conv.launches, sc.same_conv.routed_library, ba.bias_act.launches)
    with torch.no_grad():
        routed(x), wide(x), wide(x.bfloat16()), routed(x.bfloat16())
    torch.cuda.synchronize()
    # One kernel launch; one float32 call left to cuDNN; three epilogues.
    assert (sc.same_conv.launches, sc.same_conv.routed_library, ba.bias_act.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 3)
