#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``monorec_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA Hopper GPU and
the CUDA toolkit. It builds the port's CUDA kernels from the sources in the
checkout, then:

1. device: name, versions, ``nvidia-smi`` name and power limit;
2. build: compiles ``plane_sweep_sad.cu``, ``grid_warp.cu``,
   ``photo_error.cu`` and ``warp_plane_sweep.cu`` (nvcc, sm_90a), one nvcc
   each, all started together;
3. kernel vs plain: ``plane_sweep_sad`` (K1's raw mode, the TPU kernel's
   contract) against ``plane_sweep_sad_reference`` on the same GPU tensors
   at B=8, F=2, 256x512, D=32, for every use_ssim mode and two motions; then
   K1's cost-volume mode ``plane_sweep_cost_volume`` (the main path's)
   against ``plane_sweep_cost_volume_reference``: per-frame CVs within the
   kernel budget, the fused CV against the plain version in float64 within
   twice the float32 plain version's own error; times each against its
   plain version;
4. cost volume: the kernel path of ``compute_cost_volume`` against its plain
   path run in float64 (the exact answer of the reference pipeline) and in
   float32: per-frame CVs within the kernel budget of the exact answer, the
   fused CV within twice the float32 plain path's own error where that
   exceeds the budget (its frame weights are ill-conditioned at flat cost
   curves); then, for float32 and bf16 sources, the kernel path's time split
   into K1's launches, the other kernels and the device's idle rest;
5. forward parity: the whole MonoRec forward with seeded weights, GPU
   (kernel) against CPU (plain versions), at B=1;
6. serving: the inference entry point answers requests of 8 keyframes, with
   the kernel and with the plain cost volume, timed with CUDA events; the
   kernel's launch count over the kernel run must be one per request;
7. loss warp: ``grid_warp`` / ``grid_warp_jac`` / ``grid_warp_grad``
   against their plain versions at N = 4 scales x B=8 x F=2 = 64,
   3x256x512, at the coordinates of a real depth warp (inverse depths with
   edges, tz 0 and 0.5); the exact-zero invalid mask must match exactly;
   times all three;
8. photometric error: ``photo_error_fwd`` / ``photo_error_bwd`` at M=64,
   3x256x512, held per element to their plain version run in float64,
   within the test budgets widened by a first-order bound of float32
   rounding in SSIM's window statistics (``check_photo_error``); the gate
   must also reject the kernel's output with its L1 term taken out; times
   both, and the forward also at M=16, the step's other launch;
9. the loss: ``depth_loss`` and its gradient w.r.t. the 4 predicted inverse
   depths at B=8, 256x512, F=2, kernels against plain versions; both timed
   in turns, and each one's device time (K2, K3 and the rest) read from a
   torch.profiler trace;
10. training: the stage-1 trainer the CLI builds, from
   ``configs/train/monorec/monorec_depth.json`` with the data loader
   swapped for ``SyntheticSweepDataloader`` at 256x512, B=8, F=2, D=32,
   takes 6 steps and a validation pass; checks finite losses, moved depth
   parameters, a fixed encoder and the kernels' launch counts per step,
   then times steps with the kernels and with the loss's plain versions
   (CUDA events), splits a step into forward, loss, backward and
   optimizer, and reads the device's busy share and largest kernels over
   5 steps from a torch.profiler trace;
11. K1 on bf16 sources (the serving policy's cost volume), both modes,
   against their plain versions on the upcast sources, as phase 3; reports
   the raw mode's distance to the float32 kernel on the same values and
   times the three;
12. K2 on bf16 images (the serving policy's loss warp), all three modes,
   with phase 7's inputs, gates and timings;
13. K4 (``warp_plane_sweep``), float32 and bf16 sources, at N=16, D=32,
   3x256x512 against its plain version, bit for bit, timed; its two
   gather layouts (packed texels, the wrapper's for C = 3, and planar)
   equal and timed in turns; then the cost volume with
   ``sfcv_mult_mask=False`` (the path K4 serves), float32 and bf16, against
   its plain path run in float64, as phase 4;
14. the serving forward: the inference entry point under ``--precision
   serving`` answers phase 6's requests; ``result`` against the exact
   forward, K1 on bf16 sources once per request and never on float32, and
   both forwards timed in turns;
15. serving training: phase 10's trainer with ``"precision": "serving"``
   takes 6 steps and a validation pass; checks as phase 10 with the bf16
   kernels' launch counts, then times the step against the exact step in
   turns, splits it, and reads its busy share from a profiler trace;
16. the convergence check: ``monorec_tpu_torch.tools.convergence_check``
   trains 10 stage-1 steps and 10 stage-4 steps under each policy at
   256x512, B=8, D=32 and evaluates abs_rel on its held-out samples; prints
   both JSON records, and checks finite abs_rel (and stage 1's finite
   losses) and two K3 forward launches per stage-1 step, three per stage-4
   step;
17. stage 2 of the curriculum: the trainer of ``cli/train_monorec.py``, from
   ``configs/train/monorec/monorec_mask.json`` with the data loader swapped
   for ``SyntheticSweepDataloader`` at 256x512, B=8, F=2, D=32 with stereo
   frames and the moving-object mask as target, takes 6 steps and a
   validation pass; checks finite losses, moved MaskModule parameters, a
   fixed encoder, and per step one K1 cost-volume launch, six K2 values
   launches (the mask augmentation's crops) and no K3 launch; holds K2 at
   the per-frame CVs' crop (C=32, N=16) to its plain version and times it
   against ``F.grid_sample``; times the step (CUDA events), splits it and
   reads its busy share from a profiler trace; then loads phase 10's and
   this phase's checkpoints into a pretrain-mode-0 model on the card and
   checks the loaded subtrees equal;
18. stage 3 of the curriculum: the same trainer on
   ``monorec_mask_ref.json -o mask_loss`` at B=4, from phase 10's and
   phase 17's checkpoints, takes 6 steps and a validation pass; checks
   finite losses, moved MaskModule and DepthModule tensors, a fixed encoder
   and the exact launch counts per step; times the step, splits it, and
   reads its peak memory and busy share;
19. stage 4: the same on ``monorec_depth_ref.json -o stereo stereo_repr``
   at B=8, from phase 10's depth and phase 18's mask checkpoints, the
   mask's classifier bias shifted to the median of its logits so that
   static and moving pixels both exist; checks a fixed MaskModule and
   encoder, a moved DepthModule, finite gradients on every step, a finite
   loss on at least one step with both kinds of pixel (and on every such
   step), and the launch counts per step and at N=M=96; times and splits
   the step as phase 18; then holds K2 ``_jac`` at N=96 and K3 at M=96
   (the stage-4 loss's first warp) to their plain versions at the trained
   model's warp of a batch, K3 as in phase 8, and times them;
20. evaluation: writes a KITTI Odometry tree (sequence 07, 24 frames at
   KITTI's native 370x1226, a textured plane seen by a camera moving 0.8 m
   forward per frame, sequence 07's calibration, the poses, annotated depth
   at 5% of the pixels) with its own PNG encoder cycling the five row
   filters, and times the host's ``read_png`` and ``crop_resize_bilinear``
   per image; runs ``cli.evaluate`` on a copy of
   ``configs/evaluate/eval_monorec.json`` with phase 19's checkpoint on the
   card (the main path: one K1 cost-volume launch per batch, 7 finite
   metrics, every batch valid; the config's 8 loader workers) and over its
   first two batches on the card and on the CPU (agreeing within rtol
   1e-3); times the eval forward per batch (CUDA events) and the evaluate
   loop from the tree with 8 workers and with 1 and from a cache
   ``build_cache`` makes of it (keyframes/s, and the device's busy share
   from a torch.profiler pass);
21. the point cloud: ``cli.create_pointcloud`` on a copy of
   ``configs/test/pointcloud_monorec.json`` with the mask on and off (one
   K1 cost-volume launch per frame; the PLY parses, its vertex count fills
   its size, its coordinates are finite, the unmasked cloud has points and
   the masked one no more), and ``pointcloud_masks`` on the card against
   the CPU;
22. RobotCar: writes a tree in the RobotCar SDK's layout at RobotCar's
   native raw size (10 Bayer PNGs at 960x1280 of the plane scene, a
   distortion LUT, ``vo.csv``, extrinsics, LDMRS scans of the plane), times
   the host's ``read_png``, ``demosaic_gb2rgb``, undistortion and
   ``crop_resize_bilinear`` per image; runs ``cli.evaluate`` on a copy of
   ``configs/evaluate/eval_monorec_oxrc.json`` (B=4, scale 0.5, cutout to
   320x640, the cutout written as 1/3 to the double's last digit: the
   shipped 0.333333333333333 leaves 321 rows, which the model cannot take)
   from phase 19's checkpoint (the main path: one K1 cost-volume launch per
   batch, 7 finite metrics, every batch valid), its first batch on the card
   and on the CPU (within rtol 1e-3); times the eval forward and the
   evaluate loop (keyframes/s, busy share); holds K1 at 320x640, B=4, F=2
   to its plain version and times it; exports through
   ``cli.create_pointcloud`` on a copy of
   ``configs/test/pointcloud_monorec_oxrc.json``, mask on and off (one K1
   launch per frame, a PLY that parses);
23. TUM mono VO: writes a sequence of 9 greyscale JPEGs at 1280x1024 with
   its own baseline encoder (``encode_jpeg``: the standard luminance table
   at quality 90, the standard Huffman tables, every third file with
   restart markers), times ``read_jpeg`` and checks its images against the
   encoded ones (mean |diff| under 2 levels); exports through
   ``cli.create_pointcloud`` on a copy of
   ``configs/test/pointcloud_monorec_tmvo.json`` (F=4, 480x640, ``end`` cut
   to the sequence, mask off: one K1 launch per frame, points in the PLY);
   holds K1 at 480x640, B=1, F=4 to its plain version and times it;
24. the stage-1 CLI: ``cli.train.main`` on phase 10's config with
   ``arch.args.imagenet_weights`` pointing at a seeded torchvision-keyed
   ResNet-18 ``.pth`` it writes (``torchvision_resnet``), AdamW under
   CosineAnnealingLR, ``module_timing`` and ``tensorboard``, 6 steps and a
   validation pass; holds the encoder on the card bit for bit to the file
   after the build and after the steps, reads ``loss/train`` of every step
   and the ``*_module_time`` scalars of every log step from
   ``tb/metrics.jsonl``, prints the module times, counts K1-K3 (K1 also
   twice per log step for the timing) and holds every optimizer of
   ``train/state.py`` on the card to the CPU over 5 steps;
25. the model variants (``VARIANTS``), each built from its ``arch.args``
   through ``config.build_model_config``: ResNet-34, -50, -101 and -152,
   ResNet-50 with ``simple_mask``, ``simple_mask`` in pretrain mode 2,
   ``no_cv`` with ``use_stereo``, and the MaskModule's inputs off; each
   serves 5 requests of 8 keyframes through the inference entry point
   (median CUDA-event forward time; K1 once per forward, never under
   ``no_cv``) and runs one keyframe on the card against the CPU
   (``cv_mask`` atol 2e-3, ``result`` rtol 1e-3 / atol 2e-4); then
   ``cli.train.main`` trains a ResNet-50 simple-mask model in pretrain
   mode 0 for 4 steps at B=4 with ``module_timing`` (finite losses, K1-K3
   launched, module times logged for cv, resnet and depth only, as the JAX
   trainer does for a simple mask), and times and splits its step and
   reads its peak memory;
26. the KITTI user's path: writes a stereo KITTI tree (20 frames at
   370x1226), zips its annotated depth in KITTI's raw layout and prepares
   it through ``tools.preprocess_kitti`` (``extract-depth`` byte-equal,
   ``mvobj-index`` on moving-object masks written for 15 of the 20 frames,
   ``dist-index`` timed on the host, each JSON held to what the phase
   computes); trains stage 2 through the trainer of ``cli/train_monorec.py``
   on a copy of ``monorec_mask.json`` pointed at the tree (its index mask,
   colour augmentation and B=4 kept: the loader's length matches the index,
   3 steps, finite losses, K1 once and K2 six times a step; the step time
   and the loader's wait per step) with the config's 8 workers (the main
   path) and with 1; then serves the golden sample through
   ``cli.inference_example --data --checkpoint`` with phase 19's
   checkpoint and with its copy in the reference's save form (``module.``
   keys, ``arch`` ``DataParallel``, a pickled ``parse_config.ConfigParser``
   holding ``PosixPath`` folders; ``reference_copies``), each loaded model
   equal tensor for tensor to the port-format load, as is one from a bare
   state dict in the legacy format (K1 once per forward; the three PNGs
   read back at 256x512; ``depth.png`` within 1 level of a CPU forward on
   99.9% of its pixels);
27. TUM mono VO with colour and depth: writes a sequence of 12 colour
   JPEGs at 1280x1024 with its own encoder (quality 90; frame 0 at 4:4:4,
   frame 1 at 4:2:2, the rest at 4:2:0; every third with restart markers)
   and, on every other frame, ``images_depth/<frame>_d.exr`` with the
   plane's depth (``encode_exr``: float32 ``Y`` under ZIP, one file each
   under NONE, RLE and ZIPS, one of HALF samples, one in decreasing line
   order); times ``read_jpeg`` per colour image (held to the source within
   phase 23's gate) and ``read_exr`` per file (equal to the written
   array); runs ``cli.evaluate`` with ``eval_monorec.json``'s seven sparse
   metrics and batch size over the shipped
   ``configs/test/pointcloud_monorec_tmvo.json``'s data arguments (480x640,
   F=4, scale factor 3) with ``only_keyframes``, from phase 19's
   checkpoint, on the card (the main path, two batches of 2: one K1
   cost-volume launch per batch, 7 finite metrics, every batch valid) and
   over its first batch on the card and on the CPU (within rtol 1e-3);
   times the eval forward and the evaluate loop (keyframes/s, busy share);
   holds K1 at 480x640, B=2, F=4 to its plain version and times it;
28. progressive and CMYK JPEG: writes a TUM mono VO sequence of 8 JPEGs at
   1280x1024 with its own encoder (``PROGRESSIVE_TUM_FILES``: progressive
   colour at 4:2:0 with libjpeg's scan script, progressive greyscale,
   progressive with restart markers, CMYK at 4:4:4 and with C at 2x2, YCCK,
   progressive CMYK, and a sequential frame) with depth EXRs on its two
   keyframes; times ``read_jpeg`` per kind, holds each image to its source
   within phase 23's gate and each progressive file bit for bit to its
   baseline twin (the same quantized coefficients, written sequential);
   runs ``cli.evaluate`` as phase 27 does over the tree on the card (the
   main path, one batch of 2 keyframes: one K1 launch; keyframes/s and
   the busy share over the CLI whole) and on the CPU (within rtol 1e-3).

Every check that fails raises. The script prints a JSON line of kernel
records (each with its launches on the main path, its error against its
plain version, its time, its plain version's, its bound with the bytes and
float32 operations it counts, and the time of one PyTorch call computing the
same function where one exists), the ``nvidia-smi`` line, and last
``{"ok": true, "device": ...}``.
It exits non-zero, printing no result, when no CUDA device is visible or
the package is not beside it.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

SAD_TOL = 1.2e-4  # f32 kernel-vs-gather budget (README.md, Performance)
RESULT_ATOL, RESULT_RTOL = 2e-4, 1e-3  # tests/test_convert.py
MASK_ATOL = 2e-3
B, F, H, W, D = 8, 2, 256, 512, 32  # bench.py's operating point
MODES = (1, 2, 0, -1)
MOTIONS = (0.0, 0.5)  # tz: none, and KITTI-like forward motion
SCALES = 4  # depth_loss stacks its 4 scales into one warp: N = SCALES * B * F
WARP_TOL, JAC_TOL = 2e-4, 2e-5  # tests/test_grid_warp.py:51,298
PE_FWD_RTOL, PE_FWD_ATOL = 1e-5, 1e-6  # tests/test_photo_error.py:44
PE_BWD_RTOL, PE_BWD_ATOL = 1e-3, 2e-5  # tests/test_photo_error.py:62
# K3 is held to its plain version run in float64 within those budgets plus
# this many float32 unit roundoffs times photo_error_rounding's bound: on
# smooth images SSIM's float32 window statistics cancel, and the float32
# plain version itself leaves the budgets there.
PE_ROUNDING = 16 * 2.0**-24
LOSS_RTOL = 5e-4  # PARITY.md row 9, full-chain reprojection
TRAIN_STEPS = 6
PROFILED_STEPS = 5
CONV_STEPS = 10  # phase 16, per policy
SOURCES = ("plane_sweep_sad", "grid_warp", "photo_error", "warp_plane_sweep")
SERVING_CV_TOL = 5e-3  # bf16 sources vs the exact CV (tests/test_pallas_kernel.py:117)
UNET_REL = 2e-2  # bf16 U-Nets vs float32, mean |diff| / mean |ref| (tests/test_models.py)
# A per-frame CV with sfcv_mult_mask=False keeps a pixel by warped != 0, an
# exact test: where a tap weight is exactly 0 in float32 but ~1e-7 in
# float64 (a source coordinate on a pixel boundary), the two disagree.
# Reported, and allowed at up to this share of the per-frame CV.
ALT_VALID_SHARE = 1e-4
# The card's published peaks (H100 SXM data sheet, at a 700 W limit): HBM
# bandwidth and float32 outside the tensor cores, which every kernel here
# uses. A kernel's bound is the larger of its bytes (each input read once,
# each output written once) over the first and its float32 operations over
# the second.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Float32 operations per output element, counted from each function's
# arithmetic (the plain versions spell it out):
# K1, per (source, hypothesis, pixel) at use_ssim=1, the terms that depend
# on the hypothesis only (the keyframe's window sums, moments and their
# constants are the same at every hypothesis): displacement 19 (6 mul,
# 11 add, 2 div), footprint 12, 4 taps x 3 channels mul+add 24 and the
# border indicator 4, +0.5 on 3 channels; SSIM per channel 34: x*x and
# x*y 2, their and x's 3x3 window sums as separable running sums (2 adds
# along the row, 2 down the column) 12, moments 7, numerator 5 and
# denominator 3 (mu_x^2 and mu_x mu_y reused), 1 - n/d clamped and halved
# 5; channel weights 5, the separable 3x3 box sum 4.
K1_FLOPS = 19 + 12 + 24 + 4 + 3 + 34 * 3 + 5 + 4
# The cost-volume epilogue per (source, hypothesis, pixel): min 1,
# exp(-alpha (s - min)^2) 4 with exp as one, its sum 1, sfcv = (1 - 2 s)
# valid 3; the frame weight per (source, pixel) is amortized over D.
K1_CV_FLOPS = K1_FLOPS + 9
# The frame fusion per (keyframe, hypothesis, pixel): F mul + F add, the
# division and the centring 2.
K1_FUSE_FLOPS_PER_FRAME, K1_FUSE_FLOPS = 2, 3
# K2 per (sample, channel): the 4 taps' mul+add 8, plus per sample floor 2,
# fractions 2, 1 - w 2, tap weights 4 (amortized over the 3 channels);
# the Jacobian adds 2 x 4 mul+add per channel, the gradient contracts it
# with the cotangent (another 4).
K2_FLOPS = {"grid_warp": 8 + 4, "grid_warp_jac": 8 + 4 + 16, "grid_warp_grad": 8 + 4 + 16 + 4}
# K3 as its kernels compute it. One staged row's sums, per pixel: x*x, y*y,
# x*y on 3 taps 9, and for each of the 5 statistics the two horizontal
# gaussian sums hA, hB from the pair sum v0 + v2 (1 add, then a mul and a
# mul-add each: 7), 35; the 3-row window 10 (2 adds x 5). The forward per
# (pixel, channel): the row 44 and window 10, then the formula 27 (mu_x^2,
# mu_y^2, mu_x mu_y 3, the sigmas 3, n 5, d 5, its reciprocal, n / d, 1 - it
# and the clamp 5, 0.425 ssim + 0.15 |x - y| into the sum 4, |x - y| 2); per
# pixel the scale by 1 / C, 1. The backward per g-map slot: the row 44 and
# window 10, the formula 41 (a 3, b 4, p 4, q 4, pq 1, its reciprocal 1, ab
# 1, val 2, clamp test 2, g_q 1, 1/pq^2 1, g_mu 11, g_xx 3, g_xy 3); per
# output: the three g-maps' row sums 21 and windows 6, the sum 2 x S_xx +
# y S_xy + S_mu and the L1 term 10.
K3_FLOPS = {"photo_error_fwd": 44 + 10 + 27, "photo_error_bwd": 44 + 10 + 41 + 21 + 6 + 10}
# K4 per (source, hypothesis, pixel): displacement 16 (the row's products
# a01 y, a11 y, a21 y are hoisted: e 3, 1 + e 1, each of dx and dy mul,
# add, add, mul, sub and div 6), footprint 12, taps and border indicator 28.
K4_FLOPS = 16 + 12 + 28

def log(msg: str) -> None:
    print(msg, flush=True)


def edged_inverse_depths(n: int, h: int, w: int, seed: int):
    """(n, 1, h, w) float32 inverse depths with edges: a ground-like ramp
    (far at the top, ~3 m at the bottom) and a few near rectangles."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ys = np.arange(h, dtype=np.float32)[:, None] / h
    inv = np.broadcast_to(0.01 + 0.3 * ys**2, (n, h, w)).copy()
    for i in range(n):
        for _ in range(3):
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w - w // 8)
            inv[i, y0 : y0 + rng.integers(h // 8, h // 2), x0 : x0 + rng.integers(w // 16, w // 4)] = (
                rng.uniform(0.1, 0.33))
    return inv[:, None].astype(np.float32)


@contextlib.contextmanager
def plain_loss_kernels():
    """Route the loss through the plain versions of K2 and K3 on the card
    (the A/B baseline): the loss's two kernel entry points are swapped for
    their plain versions, with the same gradient contracts."""
    from monorec_tpu_torch.losses import common
    from monorec_tpu_torch.ops import grid_warp, photo_error, sampling

    saved = sampling.warp_pixels, common.photo_error
    sampling.warp_pixels = lambda images, xs, ys: grid_warp.grid_warp_reference(
        images.detach(), xs, ys)
    common.photo_error = lambda x, y: photo_error.photo_error_reference(x, y.detach())
    try:
        yield
    finally:
        sampling.warp_pixels, common.photo_error = saved


def within(got, want, rtol: float, atol: float):
    """Boolean map of |got - want| <= atol + rtol |want|."""
    return (got - want).abs() <= atol + rtol * want.abs()


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` back-to-back calls,
    after one untimed call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kernel, plain, k_reps: int, p_reps: int, library=None):
    """Times (plain, kernel, kernel, plain), or with a library call (plain,
    library, kernel, kernel, library, plain); returns (kernel ms, plain ms,
    library ms or None, the times, and their order)."""
    order = ["plain", "kernel", "kernel", "plain"]
    if library is not None:
        order[1:3] = ["library", "kernel", "kernel", "library"]
    fns = {"plain": (plain, p_reps), "kernel": (kernel, k_reps), "library": (library, k_reps)}
    turns = [cuda_ms(*fns[name]) for name in order]
    ms = {name: statistics.mean(t for n, t in zip(order, turns) if n == name)
          for name in set(order)}
    return ms["kernel"], ms["plain"], ms.get("library"), turns, ", ".join(order)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, flops: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    float32 operations over the float32 peak, whichever is larger."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": int(n_bytes), "flops": float(flops)}


def device_ms(fn, reps: int, parts: dict) -> dict:
    """Device time per call of ``fn`` from a torch.profiler trace of ``reps``
    calls after an untimed one: the device activities' durations, summed by
    ``parts`` (a substring of a kernel's name -> its label) and the rest as
    "other". Host ranges traced on the device as annotations are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    out = dict.fromkeys([*parts.values(), "other"], 0.0)
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in host_names:
            label = next((v for k, v in parts.items() if k in e.name), "other")
            out[label] += (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def pixel_grid(xs, ys):
    """Absolute pixel coordinates (N, H, W) as the normalized grid of
    ``grid_sample(align_corners=True)``: the same taps and weights."""
    import torch

    h, w = xs.shape[-2:]
    return torch.stack([xs * (2.0 / (w - 1)) - 1.0, ys * (2.0 / (h - 1)) - 1.0], dim=-1)


def loss_batch(dev, tz: float, seed: int):
    """A synthetic batch of B keyframes (target included) and 4-scale edged
    inverse depths, finest first, each (B, 1, H / 2^s, W / 2^s)."""
    import torch

    from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch

    bt = batch_to_torch(make_batch(B, H, W, F, stereo=False, mask=False, seed=seed, tz=tz), dev)
    inv = torch.from_numpy(edged_inverse_depths(B, H, W, seed)).to(dev)
    preds = [inv if s == 0 else torch.nn.functional.avg_pool2d(inv, 2**s) for s in range(SCALES)]
    return bt, preds


def phase_loss_warp(dev, card: str, dtype=None):
    """Phases 7 (float32 images) and 12 (bf16 images): K2 against its plain
    version at the main path's shapes; returns the kernels' records (keys
    with ``_bf16`` for bf16) and the float32 inputs of the last motion."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    phase = "[12 loss warp, bf16]" if suffix else "[7 loss warp]"

    from monorec_tpu_torch.losses.common import (
        loss_warp_grids,
        tile_batch_for_scales,
        upsample_nearest_to,
    )
    from monorec_tpu_torch.ops import grid_warp as gw
    from monorec_tpu_torch.ops.sampling import pixel_coordinates

    n = SCALES * B * F
    errs = {"grid_warp": 0.0, "grid_warp_jac": 0.0, "grid_warp_grad": 0.0}
    for tz in MOTIONS:
        bt, preds = loss_batch(dev, tz, seed=20)
        stacked = torch.cat([upsample_nearest_to(p, H, W) for p in preds], 0)  # (S*B, 1, H, W)
        tiled = tile_batch_for_scales(bt, SCALES)
        grids = loss_warp_grids(1.0 / stacked[:, 0], tiled["poses"], tiled["intrinsics"],
                                tiled["keyframe_pose"], tiled["keyframe_intrinsics"])
        xs, ys = pixel_coordinates(grids.reshape(n, H, W, 2), H, W)
        images = (tiled["frames"] + 1.5).reshape(n, 3, H, W).contiguous()
        src = images.to(dtype)
        cot = torch.empty_like(images).uniform_(-1.0, 1.0, generator=torch.Generator(dev).manual_seed(1))
        out = gw.grid_warp(src, xs, ys)
        jout, jx, jy = gw.grid_warp_jac(src, xs, ys)
        gx, gy = gw.grid_warp_grad(src, xs, ys, cot)
        torch.cuda.synchronize()
        ref, rjx, rjy = gw.grid_warp_jac_reference(src, xs, ys)  # on src.float()
        rgx, rgy = gw.grid_warp_grad_reference(src, xs, ys, cot)
        e_val = (out - ref).abs().max().item()
        e_jac = max((jx - rjx).abs().max().item(), (jy - rjy).abs().max().item(),
                    (jout - ref).abs().max().item())
        e_grad = max((gx - rgx).abs().max().item(), (gy - rgy).abs().max().item())
        zeros, rzeros = out[:, 0] == 0, ref[:, 0] == 0
        mism = (zeros != rzeros).sum().item()
        log(f"{phase} tz={tz}, N={n}, 3x{H}x{W}: max|diff| values {e_val:.3e}, Jacobian "
            f"{e_jac:.3e}, gradient {e_grad:.3e}; exact-zero (invalid) samples "
            f"{zeros.sum().item()} of {zeros.numel()}, mismatches {mism}")
        if not (torch.isfinite(out).all() and torch.isfinite(jx).all() and torch.isfinite(gx).all()
                and e_val <= WARP_TOL and e_jac <= JAC_TOL and e_grad <= JAC_TOL and mism == 0
                and zeros.any()):
            raise AssertionError(f"grid_warp{suffix} disagrees with its plain version (tz={tz})")
        for k, e in zip(errs, (e_val, e_jac, e_grad)):
            errs[k] = max(errs[k], e)
        del out, jout, jx, jy, gx, gy, ref, rjx, rjy, rgx, rgy

    # The yardsticks, float32 images only (grid_sample wants its grid in the
    # images' dtype, which would round bf16 coordinates): grid_sample on a
    # prebuilt grid for the values, and its backward's grid gradient (in
    # normalized units, the same work) for the coordinate gradient.
    library = {"grid_warp": None, "grid_warp_grad": None}
    if not suffix:
        grid = pixel_grid(xs, ys)
        lib_out = torch.nn.functional.grid_sample(src, grid, "bilinear", "zeros",
                                                  align_corners=True)
        log(f"{phase} yardstick grid_sample(align_corners=True) vs grid_warp max|diff| "
            f"{(lib_out - gw.grid_warp(src, xs, ys)).abs().max().item():.3e}")
        del lib_out
        library = {
            "grid_warp": lambda: torch.nn.functional.grid_sample(src, grid, "bilinear", "zeros",
                                                                 align_corners=True),
            "grid_warp_grad": lambda: torch.ops.aten.grid_sampler_2d_backward(
                cot, src, grid, 0, 0, True, [False, True]),
        }
    timing = {}
    for k, kernel, plain in (
            ("grid_warp", lambda: gw.grid_warp(src, xs, ys),
             lambda: gw.grid_warp_reference(src, xs, ys)),
            ("grid_warp_jac", lambda: gw.grid_warp_jac(src, xs, ys),
             lambda: gw.grid_warp_jac_reference(src, xs, ys)),
            ("grid_warp_grad", lambda: gw.grid_warp_grad(src, xs, ys, cot),
             lambda: gw.grid_warp_grad_reference(src, xs, ys, cot))):
        k_ms, p_ms, l_ms, turns, order = in_turns(kernel, plain, 20, 3, library.get(k))
        timing[k] = (k_ms, p_ms, l_ms)
        log(f"{phase} {k}{suffix} time at N={n}, 3x{H}x{W}, tz=0.5 ({order}): "
            f"{', '.join(f'{t:.3f}' for t in turns)} ms; kernel {k_ms:.3f} ms vs plain "
            f"{p_ms:.3f} ms" + ("" if l_ms is None else f" vs library {l_ms:.3f} ms")
            + f" on {card}")
    plane = n * H * W * 4  # one float32 (N, H, W) map
    n_bytes = {"grid_warp": nbytes(src) + 2 * plane + nbytes(images),
               "grid_warp_jac": nbytes(src) + 2 * plane + 3 * nbytes(images),
               "grid_warp_grad": nbytes(src) + 2 * plane + nbytes(cot) + 2 * plane}
    return {k + suffix: {"max_abs_err": errs[k], "ms": timing[k][0], "plain_ms": timing[k][1],
                         "library_ms": timing[k][2],
                         **bound(n_bytes[k], K2_FLOPS[k] * images.numel())}
            for k in errs}, (images, xs, ys, tiled)


def photo_error_rounding(x, y, cot):
    """Per element of K3's forward (M, H, W) and backward (M, C, H, W), a
    first-order bound on how far it moves per unit relative rounding error
    of SSIM's five 3x3 window statistics (mu_x, mu_y, E[x^2], E[y^2],
    E[xy]), computed in float64 from the inputs alone.

    A relative error e in a window sum takes statistic s_t off by at most
    e a_t, a_t the window sum of its terms' absolute values. Per unit e, the
    forward then moves by sum_t |d out / d s_t| a_t. The backward
    contracts the per-pixel gradients G_s = d sum(cot * out) / d s_s with
    the window and (1, 2 x, y), so it moves by the window sum of
    sum_t |d G_s / d s_t| a_t with the same weights. Where a window's
    variance is small against C2, E[x^2] - mu_x^2 cancels and these terms
    are large (smooth images, or the out-of-view x = -1): any float32
    implementation, the plain version's included, is off by about this
    much there."""
    import torch
    import torch.nn.functional as F_

    from monorec_tpu_torch.ops.ssim import _C1, _C2, _window_avg

    x, y, cot = x.double(), y.double(), cot.double()
    c = x.shape[1]

    def wsum(t):  # the zero-padded gaussian window, as K3's
        return _window_avg(F_.pad(t, (1, 1, 1, 1)), True)

    with torch.enable_grad():
        stats = [wsum(t).requires_grad_() for t in (x, y, x * x, y * y, x * y)]
        mx, my, exx, eyy, exy = stats
        a = [wsum(x.abs()), wsum(y.abs()), exx.detach(), eyy.detach(), wsum((x * y).abs())]
        n = (2.0 * mx * my + _C1) * (2.0 * (exy - mx * my) + _C2)
        d = (mx * mx + my * my + _C1) * (exx - mx * mx + eyy - my * my + _C2)
        part = (0.85 / (2 * c)) * torch.clamp(1.0 - n / d, 0.0, 1.0)  # out's SSIM term
        g = torch.autograd.grad(part.sum(), stats, retain_graph=True)
        fwd = sum(gt.abs() * at for gt, at in zip(g, a)).sum(1)
        G = torch.autograd.grad((part * cot[:, None]).sum(), stats, create_graph=True)
        bwd = torch.zeros_like(x)
        for s, coef in ((0, 1.0), (2, 2.0 * x.abs()), (4, y.abs())):  # mu_x, E[x^2], E[xy]
            h = torch.autograd.grad(G[s].sum(), stats, retain_graph=True, allow_unused=True)
            j = sum(ht.abs() * at for ht, at in zip(h, a) if ht is not None)
            bwd += coef * wsum(j)
    return fwd.detach(), bwd


def check_photo_error(x, y, cot, tag: str) -> dict:
    """K3's two kernels on (M, 3, H, W) ``x``, ``y`` and the (M, H, W)
    cotangent ``cot``, held per element to the plain version run in float64:
    |kernel - plain64| <= atol + rtol |plain64| + PE_ROUNDING x the bound of
    ``photo_error_rounding``, the test budgets widened only where float32
    itself is ill-conditioned. The backward is gated off the SSIM clamp's
    kink (reported there). The gate must also reject the kernel's output
    with K3's L1 term taken out. Returns the kernel's max |diff| to the
    float32 plain version ("max_abs_err", the backward's off the kink) and
    the kernel's and the float32 plain version's max |diff| to float64,
    for "forward" and "backward"."""
    import torch
    import torch.nn.functional as F_

    from monorec_tpu_torch.ops import photo_error as pe
    from monorec_tpu_torch.ops.ssim import ssim_pre_clamp

    out = pe.photo_error_fwd(x, y)
    gx = pe.photo_error_bwd(x, y, cot)
    if x.is_cuda:
        torch.cuda.synchronize()
    if not (torch.isfinite(out).all() and torch.isfinite(gx).all()):
        raise AssertionError(f"{tag} photo_error gave non-finite values")
    m, c, h, w = x.shape
    names = ("forward", "backward")
    err = {k: dict.fromkeys(("kernel_p32", "kernel_p64", "p32_p64", "kink"), 0.0) for k in names}
    count = {k: dict.fromkeys(("fail", "caught", "widened", "kink"), 0) for k in names}
    need = {k: {"kernel": 0.0, "plain": 0.0} for k in names}  # PE_ROUNDING's share used
    tols = {"forward": (PE_FWD_RTOL, PE_FWD_ATOL), "backward": (PE_BWD_RTOL, PE_BWD_ATOL)}
    for i in range(0, m, 16):  # float64 with a double backward: in chunks of 16 images
        xs, ys, cs = x[i:i + 16], y[i:i + 16], cot[i:i + 16]
        k_out, k_gx = out[i:i + 16].double(), gx[i:i + 16].double()
        refs = {}
        for dtype in (torch.float32, torch.float64):
            xr = xs.to(dtype).requires_grad_()
            ref = pe.photo_error_reference(xr, ys.to(dtype))
            (grad,) = torch.autograd.grad((ref * cs.to(dtype)).sum(), xr)
            refs[dtype] = (ref.detach().double(), grad.double())
        (p32, g32), (p64, g64) = refs[torch.float32], refs[torch.float64]
        scale = photo_error_rounding(xs, ys, cs)
        with torch.no_grad():
            # Where SSIM's pre-clamp value sits within float32 rounding of
            # the clamp bounds 0 and 1, kernel and plain version may take
            # different sides of the kink (both subgradients are right). A
            # gradient element reads the clamp of its 3x3 neighbourhood.
            v = ssim_pre_clamp(xs, ys, pad_reflection=False, gaussian_average=True)
            kink = (v.abs() < 1e-5) | ((v - 1.0).abs() < 1e-5)
            kink = F_.max_pool2d(kink.float(), 3, 1, 1) > 0
            l1 = {"forward": 0.15 * (xs - ys).abs().mean(1),
                  "backward": (0.15 / c) * torch.sign(xs - ys) * cs[:, None]}
            for name, k, p_32, p_64, sc, off in (("forward", k_out, p32, p64, scale[0], None),
                                                  ("backward", k_gx, g32, g64, scale[1], kink)):
                rtol, atol = tols[name]
                budget = atol + rtol * p_64.abs()
                allowed = budget + PE_ROUNDING * sc
                gate = lambda got: (got - p_64).abs() <= allowed  # noqa: E731
                on = torch.ones_like(k, dtype=torch.bool) if off is None else ~off
                count[name]["fail"] += (~gate(k) & on).sum().item()
                count[name]["caught"] += (~gate(k - l1[name].double()) & on).sum().item()
                count[name]["widened"] += ((PE_ROUNDING * sc > budget) & on).sum().item()
                count[name]["kink"] += (~on).sum().item()
                for key, a, b in (("kernel_p32", k, p_32), ("kernel_p64", k, p_64),
                                  ("p32_p64", p_32, p_64)):
                    err[name][key] = max(err[name][key], (a - b).abs()[on].max().item())
                if off is not None and off.any():
                    err[name]["kink"] = max(err[name]["kink"], (k - p_32).abs()[off].max().item())
                some = on & (sc > 0)  # elsewhere the allowance is 0: counted as outside
                for who, got in (("kernel", k), ("plain", p_32)):
                    excess = ((got - p_64).abs() - budget).clamp(min=0)[some]
                    used = excess / (PE_ROUNDING * sc[some])
                    need[name][who] = max(need[name][who], used.max().item())
        del refs, p32, g32, p64, g64, scale
    for name in names:
        e, n_ = err[name], count[name]
        total = out.numel() if name == "forward" else gx.numel()
        log(f"{tag} {name} at M={m}, {c}x{h}x{w}: max|diff| to the float32 plain version "
            f"{e['kernel_p32']:.3e}, to float64 {e['kernel_p64']:.3e} (float32 plain "
            f"{e['p32_p64']:.3e}); gate |kernel - float64| <= {tols[name][1]} + "
            f"{tols[name][0]} |float64| + {PE_ROUNDING / 2.0**-24:.0f} u x rounding bound, "
            f"widened past the budget at {n_['widened']} of {total - n_['kink']} elements; "
            f"outside it {n_['fail']}; share of "
            f"the rounding allowance used: kernel {need[name]['kernel']:.4f}, float32 plain "
            f"{need[name]['plain']:.4f}; with K3's L1 term taken out the kernel would fail at "
            f"{n_['caught']}" + ("" if name == "forward" else
                                 f"; {n_['kink']} elements read a clamp within 1e-5 of its bound, "
                                 f"max|diff| there {e['kink']:.3e}"))
    if any(count[k]["fail"] for k in names) or not all(count[k]["caught"] for k in names):
        raise AssertionError(f"{tag} photo_error disagrees with its plain version")
    return {name: {"max_abs_err": err[name]["kernel_p32"],
                   "max_abs_err_vs_float64": err[name]["kernel_p64"],
                   "plain_max_abs_err_vs_float64": err[name]["p32_p64"]} for name in names}


def photo_error_plain_bwd(x, y, cot):
    """K3's backward by autograd through the plain version."""
    import torch

    from monorec_tpu_torch.ops import photo_error as pe

    xg = x.detach().requires_grad_()
    return torch.autograd.grad((pe.photo_error_reference(xg, y) * cot).sum(), xg)


def photo_error_bounds(x, y, cot) -> dict:
    """K3's bounds: x, y in and the (M, H, W) map out (forward); x, y and
    the cotangent in and d/dx out (backward)."""
    pixels = x[:, 0].numel()
    return {"photo_error_fwd": bound(nbytes(x, y) + pixels * 4,  # the map's scale by 1 / C: 1 op
                                     K3_FLOPS["photo_error_fwd"] * x.numel() + pixels),
            "photo_error_bwd": bound(nbytes(x, y, cot) + nbytes(x),
                                     K3_FLOPS["photo_error_bwd"] * x.numel())}


def phase_photo_error(dev, card: str, images, xs, ys, tiled) -> dict:
    """Phase 8: K3 against its plain version, on the warped stack of phase 7
    against its keyframes (the loss's own inputs)."""
    import torch

    from monorec_tpu_torch.ops import grid_warp as gw
    from monorec_tpu_torch.ops import photo_error as pe

    n = images.shape[0]
    x = (gw.grid_warp(images, xs, ys) - 1.0).contiguous()
    y = (tiled["keyframe"] + 0.5)[:, None].expand(-1, F, -1, -1, -1).reshape(n, 3, H, W).contiguous()
    cot = torch.empty(n, H, W, device=dev).uniform_(-1.0, 1.0,
                                                    generator=torch.Generator(dev).manual_seed(2))
    errs = check_photo_error(x, y, cot, "[8 photo error]")

    # The step's other forward launch: the identity errors of the keyframes
    # against their source frames, M = B * F.
    m2 = B * F
    x2, y2 = x[:m2], y[:m2]
    timing = {
        "photo_error_fwd": in_turns(lambda: pe.photo_error_fwd(x, y),
                                    lambda: pe.photo_error_reference(x, y), 20, 3),
        "photo_error_fwd_m2": in_turns(lambda: pe.photo_error_fwd(x2, y2),
                                       lambda: pe.photo_error_reference(x2, y2), 20, 3),
        "photo_error_bwd": in_turns(lambda: pe.photo_error_bwd(x, y, cot),
                                    lambda: photo_error_plain_bwd(x, y, cot), 20, 3),
    }
    for k, (k_ms, p_ms, _, turns, order) in timing.items():
        log(f"[8 photo error] {k} time at M={m2 if k.endswith('_m2') else n}, 3x{H}x{W} "
            f"({order}): {', '.join(f'{t:.3f}' for t in turns)} ms; kernel {k_ms:.3f} ms vs "
            f"plain {p_ms:.3f} ms on {card}")

    bounds = photo_error_bounds(x, y, cot)
    fwd_m2 = photo_error_bounds(x2, y2, cot[:m2])["photo_error_fwd"]
    return {
        "photo_error_fwd": {**errs["forward"], "ms": timing["photo_error_fwd"][0],
                            "plain_ms": timing["photo_error_fwd"][1], "library_ms": None,
                            **bounds["photo_error_fwd"], "second_launch_m": m2,
                            "second_launch_ms": timing["photo_error_fwd_m2"][0],
                            "second_launch_plain_ms": timing["photo_error_fwd_m2"][1],
                            "second_launch_bound_ms": fwd_m2["bound_ms"]},
        "photo_error_bwd": {**errs["backward"], "ms": timing["photo_error_bwd"][0],
                            "plain_ms": timing["photo_error_bwd"][1], "library_ms": None,
                            **bounds["photo_error_bwd"]},
    }


def phase_loss(dev, card: str) -> None:
    """Phase 9: depth_loss and its gradient, kernels against plain versions;
    both timed in turns, and each one's device time from a profiler trace
    (what the event time holds beyond it is the host's issue)."""
    import torch

    from monorec_tpu_torch.losses import depth_loss

    bt, preds = loss_batch(dev, 0.5, seed=30)

    def run():
        ps = [p.clone().requires_grad_() for p in preds]
        loss_dict = depth_loss({**bt, "predicted_inverse_depths": ps}, 0.5, None, ())
        grads = torch.autograd.grad(loss_dict["loss"], ps)
        return loss_dict, grads

    def run_plain():
        with plain_loss_kernels():
            return run()

    k_dict, k_grads = run()
    p_dict, p_grads = run_plain()
    kernel_ms, plain_ms, _, turns, order = in_turns(run, run_plain, 5, 5)
    parts = {"grid_warp_kernel": "K2", "photo_error_fwd_kernel": "K3 fwd",
             "photo_error_bwd_kernel": "K3 bwd"}
    k_dev, p_dev = device_ms(run, 5, parts), device_ms(run_plain, 5, parts)
    rel = abs(k_dict["loss"].item() - p_dict["loss"].item()) / abs(p_dict["loss"].item())
    g_err = [(k - p).abs().max().item() for k, p in zip(k_grads, p_grads)]
    g_max = [p.abs().max().item() for p in p_grads]
    log(f"[9 loss] depth_loss at B={B}, {H}x{W}, F={F}: kernels {k_dict['loss'].item():.7f}, "
        f"plain {p_dict['loss'].item():.7f} (rel diff {rel:.2e}, gate {LOSS_RTOL}); gradient "
        f"max|diff| per scale {', '.join(f'{e:.2e}' for e in g_err)} (max|grad| "
        f"{', '.join(f'{m:.2e}' for m in g_max)}); loss + gradient ({order}) "
        f"{', '.join(f'{t:.3f}' for t in turns)} ms: {kernel_ms:.3f} ms with kernels vs "
        f"{plain_ms:.3f} ms plain on {card}")
    for tag, dev_ms, event_ms in (("kernels", k_dev, kernel_ms), ("plain", p_dev, plain_ms)):
        log(f"[9 loss] {tag}: device time {sum(dev_ms.values()):.3f} ms per call (torch.profiler, "
            f"5 calls) = " + " + ".join(f"{k} {v:.3f}" for k, v in dev_ms.items())
            + f"; the host's rest of the event time {event_ms - sum(dev_ms.values()):.3f} ms")
    if not all(k_dev[p] > 0 for p in parts.values()) or any(p_dev[p] for p in parts.values()):
        raise AssertionError(f"the loss's trace disagrees with its kernels: {k_dev}, {p_dev}")
    finite = all(torch.isfinite(g).all() for g in k_grads) and torch.isfinite(k_dict["loss"])
    if not (finite and rel <= LOSS_RTOL and k_dict["warp_uncovered"].item() == 0):
        raise AssertionError("depth_loss with the kernels disagrees with its plain versions")


def _counted() -> dict:
    """Each kernel wrapper by name; each counts its launches on float32
    sources in ``.launches`` and, where it takes bf16, in ``.launches_bf16``."""
    from monorec_tpu_torch.ops import grid_warp, photo_error, plane_sweep, warp_sweep

    return {"plane_sweep_sad": plane_sweep.plane_sweep_sad,
            "plane_sweep_cost_volume": plane_sweep.plane_sweep_cost_volume,
            "grid_warp": grid_warp.grid_warp,
            "grid_warp_jac": grid_warp.grid_warp_jac, "grid_warp_grad": grid_warp.grid_warp_grad,
            "warp_plane_sweep": warp_sweep.warp_plane_sweep,
            "photo_error_fwd": photo_error.photo_error_fwd,
            "photo_error_bwd": photo_error.photo_error_bwd}


def launch_counts() -> dict:
    counts = {}
    for name, fn in _counted().items():
        counts[name] = fn.launches
        if hasattr(fn, "launches_bf16"):
            counts[name + "_bf16"] = fn.launches_bf16
    return counts


def reset_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0
        if hasattr(fn, "launches_by_batch"):
            fn.launches_by_batch.clear()


def launches_by_batch() -> dict:
    """K2's and K3's float32 launches by their leading dim (N or M)."""
    return {name: dict(fn.launches_by_batch) for name, fn in _counted().items()
            if hasattr(fn, "launches_by_batch")}


def only(**nonzero) -> dict:
    """The launch counts that are ``nonzero`` and 0 for every other kernel."""
    return dict(dict.fromkeys(launch_counts(), 0), **nonzero)


def train_log(run_dir) -> list:
    """Each train step's loss dict with its ``step``, in step order, from
    the ``loss_<key>/train`` scalars of a run's ``tb/metrics.jsonl``."""
    from pathlib import Path

    from monorec_tpu_torch.train.loggers import read_scalars

    scalars = read_scalars(Path(run_dir) / "tb" / "metrics.jsonl")
    return [dict({k.removeprefix("loss_"): v for k, v in scalars[s].items()}, step=s)
            for s in sorted(scalars)]


def stage1_trainer(dev, run_dir, precision: str):
    """The CLI's stage-1 trainer on monorec_depth.json under ``precision``,
    with synthetic data at the operating point."""
    from monorec_tpu_torch.cli.train import build_trainer
    from monorec_tpu_torch.precision import set_precision

    with open("configs/train/monorec/monorec_depth.json") as f:
        config = json.load(f)
    data = {"frame_count": F, "target_image_size": [H, W], "batch_size": B}
    config["data_loader"] = {"type": "SyntheticSweepDataloader",
                             "args": {**data, "length": TRAIN_STEPS * B, "shuffle": True}}
    config["val_data_loader"] = {"type": "SyntheticSweepDataloader",
                                 "args": {**data, "length": B, "shuffle": False, "seed": 1}}
    config["trainer"].update(epochs=1, len_epoch=TRAIN_STEPS, log_step=1,
                             save_dir=f"{run_dir}/{precision}", tensorboard=False)
    config["precision"] = precision
    set_precision(precision, expect_rebuild=True)  # every earlier model is rebuilt or set aside
    return build_trainer(config, dev)


def train_main_path(trainer, tag: str, bf: str) -> dict:
    """Six steps and a validation pass through ``trainer.train()``, the main
    path, with the counts set to 0 just before; ``bf`` ("" or "_bf16")
    names the kernels of the policy's dtype. Returns the launch counts."""
    import torch

    model = trainer.model
    depth0 = {k: p.detach().clone() for k, p in model.depth_module.named_parameters()}
    enc0 = {k: p.detach().clone() for k, p in model._feature_extractor.named_parameters()}
    n_val = len(trainer.valid_data_loader)
    reset_counts()
    log_ = trainer.train()  # the main path
    counts = launch_counts()
    expected = only(**{"plane_sweep_cost_volume" + bf: TRAIN_STEPS + n_val,
                       "grid_warp" + bf: n_val,
                       "grid_warp_jac" + bf: TRAIN_STEPS,
                       "photo_error_fwd": 2 * (TRAIN_STEPS + n_val),
                       "photo_error_bwd": TRAIN_STEPS})
    lines = train_log(trainer.run_dir)
    losses = [r["loss"] for r in lines]
    moved = sum(not torch.equal(p, depth0[k]) for k, p in model.depth_module.named_parameters())
    enc_same = all(torch.equal(p, enc0[k]) for k, p in model._feature_extractor.named_parameters())
    log(f"{tag} {TRAIN_STEPS} steps + {n_val} validation batch(es) through the CLI's "
        f"trainer (monorec_depth.json: pretrain_mode 1, depth flip, frozen encoder, amsgrad, "
        f"StepLR), B={B}, {H}x{W}, F={F}, D={D}, precision {trainer.config['precision']} "
        f"(compute {model.config.compute_dtype}, CV sources {model.config.cv_warp_dtype}): "
        f"losses {', '.join(f'{x:.5f}' for x in losses)}; "
        f"val_loss {log_.get('val_loss', float('nan')):.5f}; depth-module tensors moved {moved} of "
        f"{len(depth0)}, encoder unchanged {enc_same}; launches "
        f"{ {k: v for k, v in counts.items() if v} } (expected the same, every other kernel 0)")
    if not (len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses)
            and moved == len(depth0) and enc_same and counts == expected):
        raise AssertionError(f"{tag} training through the entry point failed its checks")
    return counts


def step_times(trainer, batches, alpha, n_steps: int, policy: str):
    """CUDA-event times of ``n_steps`` train steps under ``policy`` (the loss
    warp reads the policy at each call), each with its launch counts."""
    import torch

    from monorec_tpu_torch.precision import set_precision

    set_precision(policy, expect_rebuild=True)
    times = []
    for i in range(n_steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        before = launch_counts()
        start.record()
        trainer.train_step(batches[i % len(batches)], alpha)
        end.record()
        end.synchronize()
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        times.append((start.elapsed_time(end), delta))
    return times


def step_split(trainer, batches, alpha, n_steps: int):
    """Medians of forward, loss, backward and optimizer (CUDA events)."""
    import torch

    model = trainer.model
    rows = []
    for i in range(n_steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        batch = batches[i % len(batches)]
        torch.cuda.synchronize()
        ev[0].record()
        out = model(batch, train=True, generator=trainer.generator)
        ev[1].record()
        loss_dict = trainer.loss_fn({**batch, **out}, alpha, None, ())
        ev[2].record()
        trainer.optimizer.zero_grad(set_to_none=True)
        loss_dict["loss"].backward()
        ev[3].record()
        trainer.optimizer.step()
        ev[4].record()
        ev[4].synchronize()
        rows.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
    return [statistics.median(c) for c in zip(*rows)]


def profile_steps(tag: str, trainer, batches, alpha, step_median: float) -> None:
    """Device busy share and the largest kernels, from one torch.profiler
    trace of PROFILED_STEPS steps after an untimed profiled one: the window
    runs from the host's start of the first timed step to the end of the
    last device activity, and the busy time is the union of the device
    activities (kernels, copies, fills) in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILED_STEPS + 1):
            with record_function(f"chip_smoke_step_{i}"):
                trainer.train_step(batches[i % len(batches)], alpha)
        torch.cuda.synchronize()
    events = prof.events()
    t0 = min(e.time_range.start for e in events
             if e.name == "chip_smoke_step_1" and e.device_type == DeviceType.CPU)
    # A host-side range (record_function, Optimizer.step#Adam.step) is also
    # traced on the device as an annotation spanning its kernels and the
    # gaps between them: it is not device activity.
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CUDA and e.time_range.end > t0
                   and e.name not in host_names)
    t1 = max(end for _, end, _ in spans)
    busy, reach, per_name = 0.0, t0, {}
    for start, end, kname in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        per_name[kname] = per_name.get(kname, 0.0) + (end - start)
    busy_ms = busy / 1e3 / PROFILED_STEPS
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"{tag} torch.profiler, {PROFILED_STEPS} steps with the kernels: device busy "
        f"{busy_ms:.3f} ms per step = {100.0 * busy / (t1 - t0):.1f}% of the profiled window "
        f"({(t1 - t0) / 1e3 / PROFILED_STEPS:.3f} ms per step) and "
        f"{100.0 * busy_ms / step_median:.1f}% of the unprofiled median step; largest, "
        f"ms per step: " + "; ".join(f"{k[:60]} {v / 1e3 / PROFILED_STEPS:.3f}" for k, v in top))


STEP_NAMES = ("forward", "loss", "backward", "optimizer")


def phase_training(dev, card: str, run_dir):
    """Phase 10: the exact stage-1 trainer of the CLI; returns the launch
    counts of its run and (trainer, batches, alpha) for phase 15."""
    import torch

    trainer = stage1_trainer(dev, run_dir, "exact")
    counts = train_main_path(trainer, "[10 training]", "")

    # Per-step launch counts, step times with the kernels and with the loss's
    # plain versions, in turns.
    batches = [b for _, b in zip(range(3), trainer.data_loader)]
    alpha = trainer._alpha(1)
    step_times(trainer, batches, alpha, 1, "exact")
    turns = []
    for path in ("plain", "kernel", "kernel", "plain"):
        with plain_loss_kernels() if path == "plain" else contextlib.nullcontext():
            turns.append((path, step_times(trainer, batches, alpha, 5, "exact")))
    want = only(plane_sweep_cost_volume=1, grid_warp_jac=1, photo_error_fwd=2,
                photo_error_bwd=1)
    for path, times in turns:
        for _, delta in times:
            if delta != (want if path == "kernel" else only(plane_sweep_cost_volume=1)):
                raise AssertionError(f"a {path} step launched {delta}")
    med = {p: statistics.median(t for path, ts in turns if path == p for t, _ in ts)
           for p in ("kernel", "plain")}
    log(f"[10 training] median step (CUDA events, 10 steps each, in turns plain, kernel, kernel, "
        f"plain) with the kernels {med['kernel']:.3f} ms = {B * 1e3 / med['kernel']:.2f} "
        f"keyframes/s; with the loss's plain versions {med['plain']:.3f} ms = "
        f"{B * 1e3 / med['plain']:.2f} keyframes/s on {card}; per-step launches "
        f"{ {k: v for k, v in want.items() if v} }")
    log("    per-step ms: " + "; ".join(
        f"{path} " + ", ".join(f"{t:.2f}" for t, _ in ts) for path, ts in turns))

    torch.cuda.reset_peak_memory_stats(dev)
    k_split = step_split(trainer, batches, alpha, 5)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    with plain_loss_kernels():
        p_split = step_split(trainer, batches, alpha, 5)
    log(f"[10 training] step split, medians of 5 (CUDA events), kernels: " + ", ".join(
        f"{n} {t:.3f}" for n, t in zip(STEP_NAMES, k_split)) + " ms; plain versions: " + ", ".join(
        f"{n} {t:.3f}" for n, t in zip(STEP_NAMES, p_split)) + f" ms; peak memory {peak:.2f} GiB")
    profile_steps("[10 training]", trainer, batches, alpha, med["kernel"])
    return counts, (trainer, batches, alpha)


def phase_serving_training(dev, card: str, run_dir, exact) -> dict:
    """Phase 15: the stage-1 trainer under the serving policy; its step
    against the exact one of phase 10 in turns. Returns the launch counts
    of its main path."""
    import torch

    trainer = stage1_trainer(dev, run_dir, "serving")
    counts = train_main_path(trainer, "[15 serving training]", "_bf16")
    batches = [b for _, b in zip(range(3), trainer.data_loader)]
    alpha = trainer._alpha(1)
    ex_trainer, ex_batches, ex_alpha = exact
    step_times(trainer, batches, alpha, 1, "serving")
    turns = []
    for policy in ("exact", "serving", "serving", "exact"):
        if policy == "exact":
            turns.append((policy, step_times(ex_trainer, ex_batches, ex_alpha, 5, "exact")))
        else:
            turns.append((policy, step_times(trainer, batches, alpha, 5, "serving")))
    wants = {"serving": only(plane_sweep_cost_volume_bf16=1, grid_warp_jac_bf16=1,
                             photo_error_fwd=2, photo_error_bwd=1),
             "exact": only(plane_sweep_cost_volume=1, grid_warp_jac=1, photo_error_fwd=2,
                           photo_error_bwd=1)}
    for policy, times in turns:
        for _, delta in times:
            if delta != wants[policy]:
                raise AssertionError(f"a {policy} step launched {delta}")
    med = {p: statistics.median(t for q, ts in turns if q == p for t, _ in ts)
           for p in ("serving", "exact")}
    log(f"[15 serving training] median step (CUDA events, 10 steps each, in turns exact, "
        f"serving, serving, exact): serving {med['serving']:.3f} ms = "
        f"{B * 1e3 / med['serving']:.2f} keyframes/s, exact {med['exact']:.3f} ms = "
        f"{B * 1e3 / med['exact']:.2f} keyframes/s on {card}; per-step launches "
        f"{ {k: v for k, v in wants['serving'].items() if v} }")
    log("    per-step ms: " + "; ".join(
        f"{p} " + ", ".join(f"{t:.2f}" for t, _ in ts) for p, ts in turns))
    torch.cuda.reset_peak_memory_stats(dev)
    s_split = step_split(trainer, batches, alpha, 5)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[15 serving training] step split, medians of 5 (CUDA events): " + ", ".join(
        f"{n} {t:.3f}" for n, t in zip(STEP_NAMES, s_split)) + f" ms; peak memory {peak:.2f} GiB")
    profile_steps("[15 serving training]", trainer, batches, alpha, med["serving"])
    return counts


def sweep_batch(dev, tz: float):
    """Phase 3's sweep inputs: sources (N, 3, H, W), keyframes, homographies."""
    import torch

    from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
    from monorec_tpu_torch.ops.cost_volume import plane_sweep_homographies

    bt = batch_to_torch(make_batch(B, H, W, F, stereo=False, mask=False, tz=tz), dev)
    inv_depths = torch.linspace(0.0025, 0.33, D, dtype=torch.float64, device=dev)
    homs = plane_sweep_homographies(
        bt["keyframe_intrinsics"], bt["keyframe_pose"], bt["intrinsics"], bt["poses"],
        inv_depths, H, W,
    ).reshape(B * F, D, 3, 3).contiguous()
    return bt["frames"].reshape(B * F, 3, H, W).contiguous(), bt["keyframe"], homs


def phase_sweep_bf16(dev, card: str) -> dict:
    """Phase 11: K1 on bf16 sources against its plain version (on the
    upcast sources), and its distance to the float32 kernel on the same
    values; times bf16 kernel, float32 kernel and plain version in turns."""
    import torch

    from monorec_tpu_torch.ops import plane_sweep

    max_err, max_vs_f32 = 0.0, 0.0
    for tz in MOTIONS:
        images, keyframes, homs = sweep_batch(dev, tz)
        src = images.to(torch.bfloat16)
        for mode in MODES:
            sad, wmask, cov = plane_sweep.plane_sweep_sad(src, keyframes, homs, 2, F, mode)
            sad32, wmask32, _ = plane_sweep.plane_sweep_sad(src.float(), keyframes, homs, 2, F,
                                                             mode)
            torch.cuda.synchronize()
            rsad, rwmask, _ = plane_sweep.plane_sweep_sad_reference(src, keyframes, homs, 2, F,
                                                                    mode)
            err = (sad - rsad).abs().max().item()
            vs_f32 = max((sad - sad32).abs().max().item(), (wmask - wmask32).abs().max().item())
            mism = ((wmask != 0) != (rwmask != 0)).sum().item()
            log(f"[11 kernel, bf16 sources] tz={tz} use_ssim={mode}: max|sad diff| vs plain "
                f"{err:.3e}; vs the float32 kernel on the same values {vs_f32:.3e}; wmask!=0 "
                f"mismatches {mism}")
            if not (torch.isfinite(sad).all() and err <= SAD_TOL and mism == 0
                    and (cov == 0).all()):
                raise AssertionError(f"plane_sweep_sad on bf16 sources disagrees with its plain "
                                     f"version (tz={tz}, use_ssim={mode})")
            max_err, max_vs_f32 = max(max_err, err), max(max_vs_f32, vs_f32)
            del sad, wmask, sad32, wmask32, rsad, rwmask
    images, keyframes, homs = sweep_batch(dev, 0.0)
    src = images.to(torch.bfloat16)
    bf16 = lambda: plane_sweep.plane_sweep_sad(src, keyframes, homs, 2, F, 1)  # noqa: E731
    f32 = lambda: plane_sweep.plane_sweep_sad(images, keyframes, homs, 2, F, 1)  # noqa: E731
    plain = lambda: plane_sweep.plane_sweep_sad_reference(src, keyframes, homs, 2, F, 1)  # noqa: E731
    turns = [("plain", cuda_ms(plain, 3)), ("bf16", cuda_ms(bf16, 20)), ("f32", cuda_ms(f32, 20)),
             ("f32", cuda_ms(f32, 20)), ("bf16", cuda_ms(bf16, 20)), ("plain", cuda_ms(plain, 3))]
    ms = {k: statistics.mean(t for n, t in turns if n == k) for k in ("bf16", "f32", "plain")}
    log(f"[11 kernel, bf16 sources] time at N={B * F}, D={D}, {H}x{W}, use_ssim=1 (plain, bf16, "
        f"f32, f32, bf16, plain): {', '.join(f'{t:.3f}' for _, t in turns)} ms; bf16 sources "
        f"{ms['bf16']:.3f} ms, float32 sources {ms['f32']:.3f} ms, plain {ms['plain']:.3f} ms "
        f"on {card}; max|diff| to the float32 kernel on the upcast sources {max_vs_f32:.3e}")
    return {"max_abs_err": max_err, "ms": ms["bf16"], "plain_ms": ms["plain"],
            "library_ms": None, **k1_raw_bound(src, keyframes, homs)}


def k1_raw_bound(images, keyframes, homs) -> dict:
    """K1's raw mode: sources, keyframes and homographies in; sad, wmask
    (N, D, H, W) and coverage (N, D) out."""
    n, _, h, w = images.shape
    d = homs.shape[1]
    return bound(nbytes(images, keyframes, homs) + (2 * h * w + 1) * n * d * 4,
                 K1_FLOPS * n * d * h * w)


def k1_cv_bound(images, keyframes, homs, frames: int = F) -> dict:
    """K1's cost-volume mode: sources, keyframes and homographies in; the
    per-frame CVs (N, D, H, W) and the fused CV (B, D, H, W) out, B = N /
    ``frames``."""
    n, _, h, w = images.shape
    d = homs.shape[1]
    fused = n // frames * d * h * w
    return bound(nbytes(images, keyframes, homs) + (n * d * h * w + fused) * 4,
                 K1_CV_FLOPS * n * d * h * w
                 + (K1_FUSE_FLOPS_PER_FRAME * frames + K1_FUSE_FLOPS) * fused)


def phase_cost_volume_kernel(dev, card: str, dtype) -> dict:
    """Phases 3 (float32 sources) and 11 (bf16 sources), the cost-volume
    mode of K1: ``plane_sweep_cost_volume`` against its plain version on the
    same sources, for every use_ssim and both motions. The per-frame CVs are
    held to the kernel budget of the float32 plain version; the fused CV to
    the plain version run in float64 (on the same float32 displacements),
    within twice the float32 plain version's own error there where that
    exceeds the budget (its frame weights are ill-conditioned at flat cost
    curves). Times the kernel against its plain version in turns."""
    import torch

    from monorec_tpu_torch.ops import plane_sweep

    bf16 = dtype == torch.bfloat16
    tag = "[11 cost-volume mode, bf16 sources]" if bf16 else "[3 cost-volume mode]"
    max_err = sfcv_err = 0.0  # both outputs against the float32 plain version; sfcv alone
    for tz in MOTIONS:
        images, keyframes, homs = sweep_batch(dev, tz)
        src = images.to(dtype)
        for mode in MODES:
            fused, sfcv = plane_sweep.plane_sweep_cost_volume(src, keyframes, homs, 2, F, mode)
            torch.cuda.synchronize()
            pf, psf = plane_sweep.plane_sweep_cost_volume_reference(src, keyframes, homs, 2, F,
                                                                    mode)
            e_sfcv, e32 = (sfcv - psf).abs().max().item(), (fused - pf).abs().max().item()
            e64, e32_64 = 0.0, 0.0
            for b in range(B):  # float64 one keyframe at a time, to bound memory
                frames = slice(b * F, (b + 1) * F)
                f64, _ = plane_sweep.plane_sweep_cost_volume_reference(
                    src[frames].double(), keyframes[b : b + 1].double(), homs[frames], 2, F,
                    mode)
                e64 = max(e64, (fused[b : b + 1] - f64).abs().max().item())
                e32_64 = max(e32_64, (pf[b : b + 1] - f64).abs().max().item())
            fused_tol = max(SAD_TOL, 2.0 * e32_64)
            log(f"{tag} tz={tz} use_ssim={mode}: max|sfcv diff| vs plain {e_sfcv:.3e} (gate "
                f"{SAD_TOL}); fused vs plain float64 {e64:.3e} (gate {fused_tol:.3e}), plain "
                f"float32 vs float64 {e32_64:.3e}, vs plain float32 {e32:.3e}")
            if not (fused.shape == (B, D, H, W) and sfcv.shape == (B, F, D, H, W)
                    and torch.isfinite(fused).all() and torch.isfinite(sfcv).all()
                    and e_sfcv <= SAD_TOL and e64 <= fused_tol):
                raise AssertionError(f"plane_sweep_cost_volume ({dtype}) disagrees with its "
                                     f"plain version (tz={tz}, use_ssim={mode})")
            max_err = max(max_err, e_sfcv, e32)
            sfcv_err = max(sfcv_err, e_sfcv)
            del fused, sfcv, pf, psf, f64

    images, keyframes, homs = sweep_batch(dev, 0.0)
    src = images.to(dtype)
    kernel = lambda: plane_sweep.plane_sweep_cost_volume(src, keyframes, homs, 2, F, 1)  # noqa: E731
    plain = lambda: plane_sweep.plane_sweep_cost_volume_reference(src, keyframes, homs, 2, F, 1)  # noqa: E731
    k_ms, p_ms, _, turns, order = in_turns(kernel, plain, 20, 3)
    log(f"{tag} time at N={B * F}, D={D}, {H}x{W}, use_ssim=1 ({order}): "
        f"{', '.join(f'{t:.3f}' for t in turns)} ms; kernel {k_ms:.3f} ms vs plain "
        f"{p_ms:.3f} ms on {card}")
    return {"max_abs_err": max_err, "sfcv_max_abs_err": sfcv_err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": None, **k1_cv_bound(src, keyframes, homs)}


def cost_volume_split(dev, card: str, args, warp_dtype: str) -> None:
    """One line: the sweep path of ``compute_cost_volume`` at B=8, a CUDA-event
    mean over 10 calls back to back, split into the device time of K1's
    launches (the source packing, the kernel, the frame fusion) and of the
    other kernels (homographies, the sources' cast) from a torch.profiler
    trace of 5 calls, and the device's idle rest; beside it the
    homographies and sources alone (CUDA events, 10 calls)."""
    from monorec_tpu_torch.ops.cost_volume import (
        CostVolumeConfig,
        _sweep_sources,
        compute_cost_volume,
    )

    cfg = CostVolumeConfig(depth_steps=D, warp_dtype=warp_dtype)
    run = lambda: compute_cost_volume(*args, 0.0025, 0.33, cfg)  # noqa: E731
    whole = cuda_ms(run, 10)
    homs_ms = cuda_ms(lambda: _sweep_sources(*args, 0.0025, 0.33, cfg), 10)
    names = {"plane_sweep_kernel": "K1", "pack_texels": "packing", "fuse_frames_kernel": "fusion"}
    parts = device_ms(run, 5, names)
    if not all(parts[p] > 0 for p in names.values()):
        raise AssertionError(f"the cost volume's trace misses a launch of K1: {parts}")
    log(f"[4 cost volume] split, B={B}, D={D}, F={F}, {H}x{W}, {warp_dtype} sources: "
        f"{whole:.3f} ms per call = device K1 {parts['K1']:.3f} + source packing "
        f"{parts['packing']:.3f} + frame fusion {parts['fusion']:.3f} + other kernels "
        f"{parts['other']:.3f} + idle {whole - sum(parts.values()):.3f} ms; homographies and "
        f"sources alone {homs_ms:.3f} ms on {card}")


def warp_sweep_planar(src, homs):
    """K4 with planar gathers, the layout the wrapper takes for C != 3,
    launched through its library on C = 3 sources (no texels) to time it
    against the packed layout; counted on no launch counter."""
    import torch

    from monorec_tpu_torch.ops import warp_sweep

    n, c, h, w = src.shape
    d = homs.shape[1]
    warped = torch.empty(n, d, c, h, w, dtype=src.dtype, device=src.device)
    wmask = torch.empty(n, d, h, w, dtype=torch.float32, device=src.device)
    code = warp_sweep._library().warp_plane_sweep_launch(
        src.data_ptr(), homs.data_ptr(), None, warped.data_ptr(), wmask.data_ptr(), n, c, d, h, w,
        2, int(src.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"warp_plane_sweep (planar) launch failed ({code})")
    return warped, wmask


def phase_warp_sweep(dev, card: str) -> dict:
    """Phase 13: K4 against its plain version, then the cost volume it
    serves against the plain path in float64; returns the records of both
    dtypes, with the launches of the cost-volume runs."""
    import torch

    from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
    from monorec_tpu_torch.ops import plane_sweep, warp_sweep
    from monorec_tpu_torch.ops.cost_volume import CostVolumeConfig, compute_cost_volume

    images, _, homs = sweep_batch(dev, 0.5)
    records = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        src = images.to(dtype)
        warped, wmask, cov = warp_sweep.warp_plane_sweep(src, homs, 2)
        torch.cuda.synchronize()
        rwarped, rwmask, _ = warp_sweep.warp_plane_sweep_reference(src, homs, 2)
        err = (warped.float() - rwarped.float()).abs().max().item()
        unequal = (warped != rwarped).sum().item()
        zeros = ((warped == 0) != (rwarped == 0)).sum().item()
        m_err = (wmask - rwmask).abs().max().item()
        mism = ((wmask != 0) != (rwmask != 0)).sum().item()
        pwarped, pwmask = warp_sweep_planar(src, homs)
        torch.cuda.synchronize()
        layouts_equal = torch.equal(pwarped, warped) and torch.equal(pwmask, wmask)
        log(f"[13 warp sweep] {name} sources, N={B * F}, D={D}, 3x{H}x{W}: warped "
            f"{tuple(warped.shape)} {warped.dtype}, max|diff| {err:.3e} ({unequal} of "
            f"{warped.numel()} elements not bit-equal), exact-zero mismatches {zeros}; wmask "
            f"max|diff| {m_err:.3e}, wmask!=0 mismatches {mism}; planar gathers equal to the "
            f"packed texels' {layouts_equal}")
        if not (warped.dtype == dtype and torch.isfinite(warped).all() and unequal == 0
                and m_err == 0 and zeros == 0 and mism == 0 and layouts_equal
                and (cov == 0).all()):
            raise AssertionError(f"warp_plane_sweep ({name}) disagrees with its plain version")
        del warped, wmask, rwarped, rwmask, pwarped, pwmask
        # The two gather layouts at C = 3, in turns: the wrapper's packed
        # texels (the packing pass included) and planar gathers.
        packed = lambda: warp_sweep.warp_plane_sweep(src, homs, 2)  # noqa: E731
        planar = lambda: warp_sweep_planar(src, homs)  # noqa: E731
        layout_turns = [cuda_ms(f, 10) for f in (packed, planar, planar, packed)]
        packed_ms = statistics.mean(layout_turns[0::3])
        planar_ms = statistics.mean(layout_turns[1:3])
        log(f"[13 warp sweep] {name} gather layouts (packed, planar, planar, packed): "
            f"{', '.join(f'{t:.3f}' for t in layout_turns)} ms; packed texels {packed_ms:.3f} ms, "
            f"planar gathers {planar_ms:.3f} ms on {card}")
        kernel = lambda: warp_sweep.warp_plane_sweep(src, homs, 2)  # noqa: E731
        plain = lambda: warp_sweep.warp_plane_sweep_reference(src, homs, 2)  # noqa: E731
        library = None
        if dtype == torch.float32:
            # The yardstick: grid_sample of the stack on a prebuilt grid of
            # the same displacements (no border indicator), float32 only.
            dx, dy = plane_sweep._displacements(homs, H, W)
            ys_, xs_ = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                                      torch.arange(W, device=dev, dtype=torch.float32),
                                      indexing="ij")
            grid = pixel_grid(xs_ + dx, ys_ + dy).reshape(B * F, D * H, W, 2)
            del dx, dy
            library = lambda: torch.nn.functional.grid_sample(  # noqa: E731
                src, grid, "bilinear", "zeros", align_corners=True)
        k_ms, p_ms, l_ms, turns, order = in_turns(kernel, plain, 10, 2, library)
        library = grid = None  # the yardstick's grid is 0.5 GB
        log(f"[13 warp sweep] {name} time ({order}): {', '.join(f'{t:.3f}' for t in turns)} ms; "
            f"kernel {k_ms:.3f} ms vs plain {p_ms:.3f} ms"
            + ("" if l_ms is None else f" vs library {l_ms:.3f} ms") + f" on {card}")
        key = "warp_plane_sweep" + ("_bf16" if name == "bfloat16" else "")
        n_out = B * F * D * H * W
        records[key] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                        "planar_gather_ms": planar_ms,
                        **bound(nbytes(src, homs) + n_out * (3 * src.element_size() + 4)
                                + B * F * D * 4, K4_FLOPS * n_out)}
    del images, homs, src
    torch.cuda.empty_cache()

    # The cost volume K4 serves, against its plain path in float64.
    bt = batch_to_torch(make_batch(B, H, W, F, stereo=False, mask=False, tz=0.5), dev)
    args = [bt[k] for k in ("keyframe", "keyframe_intrinsics", "keyframe_pose",
                            "frames", "intrinsics", "poses")]
    for name in ("float32", "bfloat16"):
        cfg = CostVolumeConfig(depth_steps=D, sfcv_mult_mask=False, warp_dtype=name)
        reset_counts()
        fused, sfcv = compute_cost_volume(*args, 0.0025, 0.33, cfg)  # the K4 path
        counts = launch_counts()
        bf = "_bf16" if name == "bfloat16" else ""
        if counts != only(**{"warp_plane_sweep" + bf: 1}):
            raise AssertionError(f"the sfcv_mult_mask=False cost volume launched {counts}")
        records["warp_plane_sweep" + bf]["launches"] = counts["warp_plane_sweep" + bf]
        # The plain path (which ignores warp_dtype) in float32, on the sources
        # as the policy quantizes them: its own error against the exact answer
        # bounds what the fused CV's conditioning makes of that quantization.
        q_args = list(args)
        q_args[3] = args[3].to(torch.bfloat16).float() if bf else args[3]
        pf, ps = compute_cost_volume(*q_args, 0.0025, 0.33, cfg, plain=True)
        e64, e32_64, alt = [0.0, 0.0], [0.0, 0.0], 0
        for b in range(B):  # float64 one sample at a time, to bound memory
            f64, s64 = compute_cost_volume(*(a[b : b + 1].double() for a in args), 0.0025, 0.33,
                                           cfg, plain=True)
            agree = (sfcv[b : b + 1] != 0) == (s64 != 0)
            alt += (~agree).sum().item()
            e64[0] = max(e64[0], (fused[b : b + 1] - f64).abs().max().item())
            e64[1] = max(e64[1], (sfcv[b : b + 1] - s64).abs()[agree].max().item())
            e32_64[0] = max(e32_64[0], (pf[b : b + 1] - f64).abs().max().item())
            e32_64[1] = max(e32_64[1], (ps[b : b + 1] - s64).abs().max().item())
        tol = SAD_TOL if name == "float32" else SERVING_CV_TOL
        fused_tol = max(tol, 2.0 * e32_64[0])
        log(f"[13 warp sweep] cost volume, sfcv_mult_mask=False, {name} sources: max|diff| fused "
            f"/ sfcv: K4 path vs plain float64 {e64[0]:.3e} / {e64[1]:.3e} (sfcv where both keep "
            f"the pixel; they disagree on {alt} of {sfcv.numel()}); plain float32 "
            f"{'on the bf16-quantized sources ' if bf else ''}vs float64 {e32_64[0]:.3e} / "
            f"{e32_64[1]:.3e} (sfcv everywhere); fused gate {fused_tol:.3e}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not (torch.isfinite(fused).all() and torch.isfinite(sfcv).all() and e64[1] <= tol
                and e64[0] <= fused_tol and alt <= ALT_VALID_SHARE * sfcv.numel()):
            raise AssertionError(f"the K4 cost volume ({name}) is off")
        del fused, sfcv, pf, ps
    cfg = CostVolumeConfig(depth_steps=D, sfcv_mult_mask=False)
    k_ms, p_ms, _, turns, _ = in_turns(
        lambda: compute_cost_volume(*args, 0.0025, 0.33, cfg),
        lambda: compute_cost_volume(*args, 0.0025, 0.33, cfg, plain=True), 3, 2)
    log(f"[13 warp sweep] cost volume, sfcv_mult_mask=False, float32, B={B}, D={D}, {H}x{W} "
        f"(plain path, K4 path, K4 path, plain path): {', '.join(f'{t:.3f}' for t in turns)} ms; "
        f"K4 path {k_ms:.3f} ms vs plain path {p_ms:.3f} ms on {card}")
    return records


def phase_convergence(dev) -> None:
    """Phase 16: the port's serving-vs-exact convergence check
    (``monorec_tpu_torch.tools.convergence_check.run_policy``) for
    CONV_STEPS steps under each policy at its defaults (256x512, D=32) and
    B=8, for stage 1 (K3's forward twice per step) and stage 4 (three times
    per step: the identity errors, the mono and stereo frames' warps and the
    stereo_repr warp)."""
    from monorec_tpu_torch.ops import photo_error
    from monorec_tpu_torch.tools import convergence_check as cc

    for stage, per_step in ((1, 2), (4, 3)):
        res = {}
        for policy in cc.POLICIES:
            before, t = photo_error.photo_error_fwd.launches, time.perf_counter()
            res[policy] = cc.run_policy(policy, CONV_STEPS, B, 5, stage, device=dev)
            launched = photo_error.photo_error_fwd.launches - before
            log(f"[16 convergence check] stage {stage}, {policy}: {CONV_STEPS} steps and abs_rel "
                f"on 16 held-out samples in {time.perf_counter() - t:.1f} s; photo_error_fwd "
                f"launches {launched} (expected {per_step * CONV_STEPS})")
            if launched != per_step * CONV_STEPS:
                raise AssertionError(f"the stage-{stage} {policy} convergence run launched K3's "
                                     f"forward {launched} times in {CONV_STEPS} steps")
        record = cc.summarize(stage, CONV_STEPS, B, res["exact"], res["serving"])
        log(json.dumps(record))
        # Stage 4's losses are NaN where no pixel or every pixel is moving
        # (its seed-0 MaskModule puts them all above 0.5): only abs_rel is
        # held finite there.
        keys = ("abs_rel_exact", "abs_rel_serving") + (
            ("final_loss_exact", "final_loss_serving") if stage == 1 else ())
        if not all(math.isfinite(record[k]) for k in keys):
            raise AssertionError(f"the stage-{stage} convergence check gave a number that is not "
                                 f"finite: {[k for k in keys if not math.isfinite(record[k])]}")


def mean_rel(got, ref) -> float:
    return ((got - ref).abs().mean() / ref.abs().mean()).item()


def phase_serving_forward(dev, card: str, requests) -> dict:
    """Phase 14: the inference entry point under ``--precision serving``;
    returns the launch counts of its main path."""
    import torch

    from monorec_tpu_torch.cli.inference_example import build_model, model_config, serve
    from monorec_tpu_torch.precision import set_precision

    set_precision("exact", expect_rebuild=True)
    exact = build_model(model_config(D, "exact"), dev, seed=0)
    set_precision("serving", expect_rebuild=True)
    model = build_model(model_config(D, "serving"), dev, seed=0)
    if (model.config.cv_warp_dtype, model.config.compute_dtype) != ("bfloat16", "bfloat16"):
        raise AssertionError(f"--precision serving built {model.config}")
    serve(model, requests[:1])
    serve(exact, requests[:1])
    reset_counts()
    outs, s1 = serve(model, requests)  # the main path
    counts = launch_counts()
    ref, e1 = serve(exact, requests)
    _, e2 = serve(exact, requests)
    _, s2 = serve(model, requests)
    n_req = len(requests)
    if counts != only(plane_sweep_cost_volume_bf16=n_req):
        raise AssertionError(f"the serving forwards launched {counts}")
    rels = [mean_rel(o["result"], r["result"]) for o, r in zip(outs, ref)]
    mask_rels = [mean_rel(o["cv_mask"], r["cv_mask"]) for o, r in zip(outs, ref)]
    for out in outs:
        r = out["result"]
        if (r.shape != (B, 1, H, W) or r.dtype != torch.float32 or not torch.isfinite(r).all()
                or (r <= 0).any()):
            raise AssertionError("served inverse depth is not finite, positive float32")
    med_s, med_e = statistics.median(s1 + s2), statistics.median(e1 + e2)
    log(f"[14 serving forward] {n_req} requests x {B} keyframes, {H}x{W}, D={D}, F={F}, "
        f"--precision serving: result vs the exact forward, mean|diff|/mean|ref| max "
        f"{max(rels):.3e} (gate {UNET_REL}), cv_mask {max(mask_rels):.3e}; launches "
        f"{ {k: v for k, v in counts.items() if v} }; median forward (CUDA events, in turns "
        f"serving, exact, exact, serving) serving {med_s:.3f} ms = {B * 1e3 / med_s:.2f} "
        f"keyframes/s, exact {med_e:.3f} ms = {B * 1e3 / med_e:.2f} keyframes/s on {card}")
    log(f"    per-request ms, serving: {', '.join(f'{t:.3f}' for t in s1)}; exact: "
        f"{', '.join(f'{t:.3f}' for t in e1)}; exact: {', '.join(f'{t:.3f}' for t in e2)}; "
        f"serving: {', '.join(f'{t:.3f}' for t in s2)}")
    if max(rels) > UNET_REL:
        raise AssertionError("the serving forward is off the exact one")
    return counts


def stage2_trainer(dev, run_dir):
    """The trainer of ``cli/train_monorec.py`` on monorec_mask.json (stage 2:
    pretrain mode 2, the mask augmentation, mask_loss), with synthetic data
    at the operating point: stereo frames and the moving-object mask as the
    target."""
    from monorec_tpu_torch.cli.train_monorec import build_trainer
    from monorec_tpu_torch.precision import set_precision

    with open("configs/train/monorec/monorec_mask.json") as f:
        config = json.load(f)
    data = {"frame_count": F, "target_image_size": [H, W], "batch_size": B,
            "return_stereo": True, "return_mvobj_mask": 2}
    config["data_loader"] = {"type": "SyntheticSweepDataloader",
                             "args": {**data, "length": TRAIN_STEPS * B, "shuffle": True}}
    config["val_data_loader"] = {"type": "SyntheticSweepDataloader",
                                 "args": {**data, "length": B, "shuffle": False, "seed": 1}}
    config["trainer"].update(epochs=1, len_epoch=TRAIN_STEPS, log_step=1,
                             save_dir=f"{run_dir}/stage2", tensorboard=False)
    set_precision("exact", expect_rebuild=True)
    return build_trainer(config, dev)


STAGE2_CROPS = 6  # keyframe, frames, stereo frame, mask, CV, per-frame CVs
STAGE2_NAMES = ("cost volume", "augmentation", "features + MaskModule", "loss", "backward",
                "optimizer")


def stage2_split(trainer, batches, alpha, n_steps: int):
    """Medians of a stage-2 step's parts (CUDA events), the ops of
    ``MonoRecTrainer._feed`` under stage 2's flags in its order, with the
    cost volume first: cost volume, augmentation (the six crops),
    features + MaskModule, loss, backward, optimizer."""
    import torch

    from monorec_tpu_torch.models.augmentation import (
        apply_mask_aug,
        apply_mask_aug_frames,
        sample_mask_aug_params,
    )

    model = trainer.model
    rows = []
    for i in range(n_steps):
        batch = batches[i % len(batches)]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        torch.cuda.synchronize()
        ev[0].record()
        with torch.no_grad():
            cv, sfcv, _ = model.cost_volume(batch, return_coverage=True, use_mono=True,
                                            use_stereo=False)
        ev[1].record()
        params = sample_mask_aug_params(trainer.generator, B, H, W).to(cv.device)
        crop = {k: apply_mask_aug(batch[k], params) for k in ("keyframe", "stereoframe",
                                                                 "mvobj_mask")}
        crop["frames"] = apply_mask_aug_frames(batch["frames"], params)
        crop["cost_volume"] = apply_mask_aug(cv, params)
        sfcv_c = apply_mask_aug_frames(sfcv, params)
        ev[2].record()
        mask = model.mask(sfcv_c, model.features(crop["keyframe"]), True, trainer.device_generator)
        ev[3].record()
        target = (crop["mvobj_mask"] > 0.5).float()
        loss_dict = trainer.loss_fn({"mvobj_mask": target, "cv_mask": mask}, alpha, None, ())
        ev[4].record()
        trainer.optimizer.zero_grad(set_to_none=True)
        loss_dict["loss"].backward()
        ev[5].record()
        trainer.optimizer.step()
        ev[6].record()
        ev[6].synchronize()
        rows.append([ev[j].elapsed_time(ev[j + 1]) for j in range(6)])
    return [statistics.median(c) for c in zip(*rows)]


def k2_crop_c32(dev, card: str, trainer, batch) -> dict:
    """K2's values mode at the crop of the per-frame cost volumes, its widest
    launch on the stage-2 path: (B * F, D, H, W) at the augmentation's
    coordinates, against its plain version and timed against
    ``F.grid_sample`` on the same normalized grid."""
    import torch

    from monorec_tpu_torch.models.augmentation import (
        MaskAugParams,
        conditional_hflip,
        crop_grid,
        sample_mask_aug_params,
    )
    from monorec_tpu_torch.ops import grid_warp as gw
    from monorec_tpu_torch.ops.sampling import pixel_coordinates

    with torch.no_grad():
        _, sfcv = trainer.model.cost_volume(batch, use_mono=True, use_stereo=False)
    params = sample_mask_aug_params(torch.Generator().manual_seed(5), B, H, W)
    rep = MaskAugParams(*(p.repeat_interleave(F, 0) for p in params)).to(dev)
    src = conditional_hflip(sfcv.reshape(B * F, D, H, W), rep.flip).contiguous()
    grid = crop_grid(rep, H, W)
    xs, ys = pixel_coordinates(grid, H, W)
    out = gw.grid_warp(src, xs, ys)
    torch.cuda.synchronize()
    ref = gw.grid_warp_reference(src, xs, ys)
    lib = torch.nn.functional.grid_sample(src, grid, "bilinear", "zeros", align_corners=False)
    err, lib_err = (out - ref).abs().max().item(), (out - lib).abs().max().item()
    del ref, lib
    log(f"[17 stage 2] K2 values at the per-frame CVs' crop, N={B * F}, C={D}, {H}x{W}: max|diff| "
        f"to the plain version {err:.3e} (gate {WARP_TOL}); to grid_sample on the same grid "
        f"{lib_err:.3e}")
    if not (torch.isfinite(out).all() and err <= WARP_TOL):
        raise AssertionError("grid_warp at C=32 disagrees with its plain version")
    k_ms, p_ms, l_ms, turns, order = in_turns(
        lambda: gw.grid_warp(src, xs, ys), lambda: gw.grid_warp_reference(src, xs, ys), 20, 3,
        lambda: torch.nn.functional.grid_sample(src, grid, "bilinear", "zeros",
                                                align_corners=False))
    log(f"[17 stage 2] K2 values time at N={B * F}, C={D}, {H}x{W} ({order}): "
        f"{', '.join(f'{t:.3f}' for t in turns)} ms; kernel {k_ms:.3f} ms vs plain {p_ms:.3f} ms "
        f"vs grid_sample {l_ms:.3f} ms on {card}")
    pixels = B * F * H * W
    # Bytes: the CVs read, the two coordinate planes read, the crop written.
    # Operations: the 4 taps' mul+add per value, and 10 per pixel for the
    # floor, fractions and tap weights.
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            **bound(nbytes(src, xs, ys, out), 8 * src.numel() + 10 * pixels)}


def phase_stage2(dev, card: str, run_dir, stage1_checkpoint):
    """Phase 17: stage 2 of the curriculum. The trainer of
    ``cli/train_monorec.py`` takes 6 steps and a validation pass; then the
    per-step launches, K2 at C=32, the step time and its split, the busy
    share, and the handoff of phase 10's and this phase's checkpoints into a
    pretrain-mode-0 model. Returns the main path's launch counts and K2's
    C=32 record."""
    import torch

    from monorec_tpu_torch import config as config_mod
    from monorec_tpu_torch.models import MonoRec
    from monorec_tpu_torch.train.checkpoints import load_checkpoint, load_stage_checkpoints

    trainer = stage2_trainer(dev, run_dir)
    model = trainer.model
    att0 = {k: p.detach().clone() for k, p in model.att_module.named_parameters()}
    enc0 = {k: p.detach().clone() for k, p in model._feature_extractor.named_parameters()}
    n_val = len(trainer.valid_data_loader)
    reset_counts()
    log_ = trainer.train()  # the main path
    counts = launch_counts()
    expected = only(plane_sweep_cost_volume=TRAIN_STEPS + n_val,
                    grid_warp=STAGE2_CROPS * TRAIN_STEPS)
    lines = train_log(trainer.run_dir)
    losses = [r["loss"] for r in lines]
    moved = sum(not torch.equal(p, att0[k]) for k, p in model.att_module.named_parameters())
    enc_same = all(torch.equal(p, enc0[k]) for k, p in model._feature_extractor.named_parameters())
    ious = ", ".join(f"{r['iou']:.4f}" for r in lines)
    log(f"[17 stage 2] {TRAIN_STEPS} steps + {n_val} validation batch(es) through the trainer of "
        f"cli/train_monorec.py (monorec_mask.json: pretrain_mode 2, mask augmentation, "
        f"mask_loss, frozen encoder, amsgrad), B={B}, {H}x{W}, F={F}, D={D}: losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; iou {ious}; "
        f"val_loss {log_.get('val_loss', float('nan')):.5f}; MaskModule tensors moved {moved} of "
        f"{len(att0)}, encoder unchanged {enc_same}; launches "
        f"{ {k: v for k, v in counts.items() if v} } (expected the same, every other kernel 0)")
    if not (len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses)
            and moved == len(att0) and enc_same and counts == expected):
        raise AssertionError("stage-2 training through the entry point failed its checks")

    batches = [b for _, b in zip(range(3), trainer.data_loader)]
    alpha = trainer._alpha(1)
    record = k2_crop_c32(dev, card, trainer, batches[0])
    torch.cuda.empty_cache()

    step_times(trainer, batches, alpha, 1, "exact")
    times = step_times(trainer, batches, alpha, 10, "exact")
    want = only(plane_sweep_cost_volume=1, grid_warp=STAGE2_CROPS)
    for _, delta in times:
        if delta != want:
            raise AssertionError(f"a stage-2 step launched {delta}, expected {want}")
    med = statistics.median(t for t, _ in times)
    log(f"[17 stage 2] median step (CUDA events, 10 steps) {med:.3f} ms = "
        f"{B * 1e3 / med:.2f} keyframes/s on {card}; per-step launches "
        f"{ {k: v for k, v in want.items() if v} }; per-step ms "
        + ", ".join(f"{t:.2f}" for t, _ in times))
    torch.cuda.reset_peak_memory_stats(dev)
    split = stage2_split(trainer, batches, alpha, 5)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[17 stage 2] step split, medians of 5 (CUDA events): " + ", ".join(
        f"{n} {t:.3f}" for n, t in zip(STAGE2_NAMES, split)) + f" ms; peak memory {peak:.2f} GiB")
    profile_steps("[17 stage 2]", trainer, batches, alpha, med)

    # The handoff: a stage-3 (pretrain mode 0) model on the card from phase
    # 10's stage-1 checkpoint (depth) and this phase's (mask).
    stage2_checkpoint = trainer.run_dir / "checkpoint.pth"
    with open("configs/train/monorec/monorec_mask_ref.json") as f:
        arch = json.load(f)["arch"]["args"]
    arch.update(depth_cp_loc=[str(stage1_checkpoint)], mask_cp_loc=[str(stage2_checkpoint)])
    stage3 = MonoRec(config_mod.build_model_config(arch), dev,
                     generator=torch.Generator().manual_seed(0))
    load_stage_checkpoints(stage3, config_mod.checkpoint_locations(arch))
    state = {k: v.cpu() for k, v in stage3.state_dict().items()}
    sources = {"depth_module.": load_checkpoint(stage1_checkpoint, "cpu")["state_dict"],
               "att_module.": load_checkpoint(stage2_checkpoint, "cpu")["state_dict"]}
    equal = {prefix: all(torch.equal(v, src[k]) for k, v in state.items() if k.startswith(prefix))
             and any(k.startswith(prefix) for k in state) for prefix, src in sources.items()}
    with torch.no_grad():
        out = stage3(batches[0])
    finite = all(torch.isfinite(out[k]).all().item() for k in ("result", "cv_mask"))
    log(f"[17 stage 2] handoff into a pretrain-mode-0 model on the card: depth_module.* equal to "
        f"phase 10's checkpoint {equal['depth_module.']}, att_module.* equal to this phase's "
        f"{equal['att_module.']}; its eval forward finite {finite}")
    if not (all(equal.values()) and finite):
        raise AssertionError("the stage handoff did not load the earlier stages' subtrees")
    return counts, record, stage2_checkpoint


def refinement_trainer(dev, run_dir, name: str, batch_size: int, options, checkpoints: dict):
    """The trainer of ``cli/train_monorec.py`` on ``configs/train/monorec/
    <name>.json`` with synthetic data at the operating point (stereo frames,
    the config's moving-object mask) and batch ``batch_size``, starting from
    the ``checkpoints`` ({"depth_cp_loc": path, "mask_cp_loc": path})."""
    from monorec_tpu_torch.cli.train_monorec import build_trainer
    from monorec_tpu_torch.precision import set_precision

    with open(f"configs/train/monorec/{name}.json") as f:
        config = json.load(f)
    data = {"frame_count": F, "target_image_size": [H, W], "batch_size": batch_size,
            "return_stereo": True, "return_mvobj_mask": 1}
    config["data_loader"] = {"type": "SyntheticSweepDataloader",
                             "args": {**data, "length": TRAIN_STEPS * batch_size, "shuffle": True}}
    config["val_data_loader"] = {"type": "SyntheticSweepDataloader",
                                 "args": {**data, "length": batch_size, "shuffle": False,
                                          "seed": 1}}
    config["arch"]["args"].update({k: [str(v)] for k, v in checkpoints.items()})
    config["trainer"].update(epochs=1, len_epoch=TRAIN_STEPS, log_step=1,
                             save_dir=f"{run_dir}/{name}", tensorboard=False)
    set_precision("exact", expect_rebuild=True)
    return build_trainer(config, dev, options)


REFINEMENT_NAMES = ("cost volumes", "features + mask", "depth decodes", "loss", "backward",
                    "optimizer")


def refinement_split(trainer, batches, alpha, n_steps: int):
    """Medians of a stage-3 or stage-4 step's parts (CUDA events), the ops of
    ``MonoRecTrainer._feed`` under the stage's flags (the flip left out):
    the two cost volumes, features + MaskModule, the two depth decodes, the
    loss, backward, optimizer."""
    import torch

    model = trainer.model
    lo, hi = model.config.inv_depth_min_max[1], model.config.inv_depth_min_max[0]
    rows = []
    for i in range(n_steps):
        batch = batches[i % len(batches)]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        torch.cuda.synchronize()
        ev[0].record()
        with torch.no_grad():
            cv_s, _ = model.cost_volume(batch, use_mono=False, use_stereo=True)
            cv_m, sfcv_m = model.cost_volume(batch, use_mono=True, use_stereo=False)
        ev[1].record()
        feats = model.features(batch["keyframe"])
        cv_mask = model.mask(sfcv_m, feats, True, trainer.device_generator)
        if trainer.mult_mask_on_cv:
            cv_m = cv_m * (1.0 - cv_mask)
        ev[2].record()
        with torch.no_grad():
            stereo_pred = model.depth(cv_s, batch["keyframe"], feats)
        mono_pred = model.depth(cv_m, batch["keyframe"], feats)
        ev[3].record()
        data = {**batch, "cv_mask": cv_mask, "mono_pred": mono_pred, "stereo_pred": stereo_pred,
                "inv_depth_min": hi, "inv_depth_max": lo}
        loss_dict = trainer.loss_fn(data, alpha, None, trainer.options)
        ev[4].record()
        trainer.optimizer.zero_grad(set_to_none=True)
        loss_dict["loss"].backward()
        ev[5].record()
        trainer.optimizer.step()
        ev[6].record()
        ev[6].synchronize()
        rows.append([ev[j].elapsed_time(ev[j + 1]) for j in range(6)])
    return [statistics.median(c) for c in zip(*rows)]


def refinement_main_path(tag: str, trainer, trained: tuple, fixed: tuple, per_step: dict):
    """Six steps and a validation pass through ``trainer.train()``, the main
    path, with the counts set to 0 just before. Checks that every tensor of
    the ``trained`` modules moved and none of the ``fixed`` ones did, and
    the launches: ``per_step`` per train step, and per validation batch the
    same forwards with every K2 launch in values mode and no backward.
    Returns the counts, K2's and K3's counts by leading dim, the log lines
    and each step's moving share."""
    import torch

    model = trainer.model
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    n_val = len(trainer.valid_data_loader)
    ratios = []

    stage_loss = trainer.loss_fn

    def loss_fn(data, *args):
        ratios.append((data["cv_mask"] > 0.5).float().mean().item())
        return stage_loss(data, *args)

    trainer.loss_fn = loss_fn
    reset_counts()
    log_ = trainer.train()  # the main path
    counts, by_batch = launch_counts(), launches_by_batch()
    trainer.loss_fn = stage_loss
    k2_val = per_step.get("grid_warp", 0) + per_step.get("grid_warp_jac", 0)
    expected = only(**{k: v * TRAIN_STEPS for k, v in per_step.items()})
    for k, v in (("plane_sweep_cost_volume", per_step["plane_sweep_cost_volume"]),
                 ("grid_warp", k2_val), ("photo_error_fwd", per_step["photo_error_fwd"])):
        expected[k] += v * n_val
    lines = train_log(trainer.run_dir)
    moved = {prefix: sum(not torch.equal(p, start[k]) for k, p in model.named_parameters()
                         if k.startswith(prefix)) for prefix in trained + fixed}
    total = {prefix: sum(k.startswith(prefix) for k in start) for prefix in trained + fixed}
    losses = ", ".join(f"{r['loss']:.5f}" for r in lines)
    shares = [", ".join(f"{x:.4f}" for x in part)
              for part in (ratios[:TRAIN_STEPS], ratios[TRAIN_STEPS:])]
    log(f"{tag} {TRAIN_STEPS} steps + {n_val} validation batch(es) through the trainer of "
        f"cli/train_monorec.py (options {' '.join(trainer.options)}), "
        f"B={trainer.data_loader.batch_size}, {H}x{W}, F={F}, D={D}: losses {losses}; moving "
        f"share per step {shares[0]} (validation {shares[1]}); val_loss "
        f"{log_.get('val_loss', float('nan')):.5f}; tensors moved "
        + ", ".join(f"{p[:-1]} {moved[p]} of {total[p]}" for p in trained + fixed)
        + f"; launches { {k: v for k, v in counts.items() if v} } (expected the same, every "
        f"other kernel 0)")
    if not (len(lines) == TRAIN_STEPS and counts == expected
            and all(moved[p] == total[p] > 0 for p in trained)
            and all(moved[p] == 0 for p in fixed)):
        raise AssertionError(f"{tag} training through the entry point failed its checks")
    return counts, by_batch, lines, ratios[:TRAIN_STEPS]


def refinement_timing(tag: str, card: str, dev, trainer, per_step: dict) -> None:
    """The median of 10 steps (CUDA events) with each step's launches, the
    split of 5, the peak memory and the busy share of a profiler trace."""
    import torch

    batches = [b for _, b in zip(range(3), trainer.data_loader)]
    alpha = trainer._alpha(1)
    step_times(trainer, batches, alpha, 1, "exact")
    times = step_times(trainer, batches, alpha, 10, "exact")
    want = only(**per_step)
    for _, delta in times:
        if delta != want:
            raise AssertionError(f"a {tag} step launched {delta}, expected {want}")
    med = statistics.median(t for t, _ in times)
    b = trainer.data_loader.batch_size
    log(f"{tag} median step (CUDA events, 10 steps) {med:.3f} ms = {b * 1e3 / med:.2f} "
        f"keyframes/s at B={b} on {card}; per-step launches "
        f"{ {k: v for k, v in want.items() if v} }; per-step ms "
        + ", ".join(f"{t:.2f}" for t, _ in times))
    torch.cuda.reset_peak_memory_stats(dev)
    split = refinement_split(trainer, batches, alpha, 5)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"{tag} step split, medians of 5 (CUDA events): " + ", ".join(
        f"{n} {t:.3f}" for n, t in zip(REFINEMENT_NAMES, split)) + f" ms (sum {sum(split):.3f}); "
        f"peak memory {peak:.2f} GiB")
    profile_steps(tag, trainer, batches, alpha, med)


STAGE3_STEP = {"plane_sweep_cost_volume": 2, "grid_warp": 2, "grid_warp_jac": 1,
               "photo_error_fwd": 2, "photo_error_bwd": 1}
STAGE4_STEP = {"plane_sweep_cost_volume": 2, "grid_warp": 1, "grid_warp_jac": 2,
               "photo_error_fwd": 3, "photo_error_bwd": 2}
STAGE3_B = 4  # monorec_mask_ref.json's batch size


def phase_stage3(dev, card: str, run_dir, stage1_checkpoint, stage2_checkpoint):
    """Phase 18: stage 3 of the curriculum (mask refinement) from phase 10's
    and phase 17's checkpoints. Returns the launch counts of its main path
    and its checkpoint."""
    import torch

    trainer = refinement_trainer(dev, run_dir, "monorec_mask_ref", STAGE3_B, ("mask_loss",),
                                 {"depth_cp_loc": stage1_checkpoint,
                                  "mask_cp_loc": stage2_checkpoint})
    counts, _, lines, _ = refinement_main_path("[18 stage 3]", trainer,
                                               ("att_module.", "depth_module."),
                                               ("_feature_extractor.",), STAGE3_STEP)
    if not all(math.isfinite(r["loss"]) for r in lines):
        raise AssertionError("a stage-3 loss is not finite")
    log("[18 stage 3] per step mask_loss (logged x4) "
        + ", ".join(f"{r['mask_loss']:.5f}" for r in lines) + "; iou "
        + ", ".join(f"{r['iou']:.4f}" for r in lines))
    refinement_timing("[18 stage 3]", card, dev, trainer, STAGE3_STEP)
    torch.cuda.empty_cache()
    return counts, trainer.run_dir / "checkpoint.pth"


def stage4_kernel_records(dev, card: str, trainer, batch) -> dict:
    """K2 ``_jac`` at N=96 and K3 at M=96 (4 scales x B=8 x the two mono
    and one stereo frame: the stage-4 loss's first warp) against their plain
    versions, at the coordinates of the trained model's warp of ``batch``;
    timed, with their bounds."""
    import torch

    from monorec_tpu_torch.losses.common import (
        _gather_frames,
        loss_warp_grids,
        tile_batch_for_scales,
        upsample_nearest_to,
    )
    from monorec_tpu_torch.ops import grid_warp as gw
    from monorec_tpu_torch.ops import photo_error as pe
    from monorec_tpu_torch.ops.sampling import pixel_coordinates

    with torch.no_grad():
        _, data = trainer._feed(batch, True, 0.5)
        stacked = torch.cat([upsample_nearest_to(p, H, W) for p in data["mono_pred"]], 0)
    tiled = tile_batch_for_scales(batch, SCALES)
    frames, poses, intr = _gather_frames(tiled, True, True)
    n = frames.shape[0] * frames.shape[1]
    grids = loss_warp_grids(1.0 / stacked[:, 0], poses, intr, tiled["keyframe_pose"],
                            tiled["keyframe_intrinsics"])
    xs, ys = pixel_coordinates(grids.reshape(n, H, W, 2), H, W)
    images = (frames + 1.5).reshape(n, 3, H, W).contiguous()
    out, jx, jy = gw.grid_warp_jac(images, xs, ys)
    torch.cuda.synchronize()
    ref, rjx, rjy = gw.grid_warp_jac_reference(images, xs, ys)
    e_val = (out - ref).abs().max().item()
    e_jac = max((jx - rjx).abs().max().item(), (jy - rjy).abs().max().item())
    mism = ((out[:, 0] == 0) != (ref[:, 0] == 0)).sum().item()
    log(f"[19 stage 4] K2 _jac at N={n}, 3x{H}x{W} (the trained model's warp of 4 scales x B={B} "
        f"x 3 frames): max|diff| values {e_val:.3e} (gate {WARP_TOL}), Jacobian {e_jac:.3e} "
        f"(gate {JAC_TOL}); exact-zero mismatches {mism}")
    if not (torch.isfinite(out).all() and torch.isfinite(jx).all() and e_val <= WARP_TOL
            and e_jac <= JAC_TOL and mism == 0):
        raise AssertionError("grid_warp_jac at N=96 disagrees with its plain version")
    x = (out - 1.0).contiguous()
    y = (tiled["keyframe"] + 0.5)[:, None].expand(-1, frames.shape[1], -1, -1, -1).reshape(
        n, 3, H, W).contiguous()
    del out, jx, jy, ref, rjx, rjy
    cot = torch.empty(n, H, W, device=dev).uniform_(-1.0, 1.0,
                                                    generator=torch.Generator(dev).manual_seed(3))
    k3_errs = check_photo_error(x, y, cot, "[19 stage 4] K3 at the stage-4 warp,")
    timing = {
        "grid_warp_jac": in_turns(lambda: gw.grid_warp_jac(images, xs, ys),
                                  lambda: gw.grid_warp_jac_reference(images, xs, ys), 20, 3),
        "photo_error_fwd": in_turns(lambda: pe.photo_error_fwd(x, y),
                                    lambda: pe.photo_error_reference(x, y), 20, 3),
        "photo_error_bwd": in_turns(lambda: pe.photo_error_bwd(x, y, cot),
                                    lambda: photo_error_plain_bwd(x, y, cot), 20, 3),
    }
    for k, (k_ms, p_ms, _, turns, order) in timing.items():
        log(f"[19 stage 4] {k} time at {'N' if k.startswith('grid') else 'M'}={n}, 3x{H}x{W} "
            f"({order}): {', '.join(f'{t:.3f}' for t in turns)} ms; kernel {k_ms:.3f} ms vs "
            f"plain {p_ms:.3f} ms on {card}")
    plane = n * H * W * 4
    bounds = {"grid_warp_jac": bound(nbytes(images) + 2 * plane + 3 * nbytes(images),
                                     K2_FLOPS["grid_warp_jac"] * images.numel()),
              **photo_error_bounds(x, y, cot)}
    errs = {"grid_warp_jac": {"max_abs_err": max(e_val, e_jac)},
            "photo_error_fwd": k3_errs["forward"], "photo_error_bwd": k3_errs["backward"]}
    # No PyTorch call computes the warp's Jacobian or K3's error: library_ms null.
    suffix = {"grid_warp_jac": f"_n{n}", "photo_error_fwd": f"_m{n}", "photo_error_bwd": f"_m{n}"}
    return {k + suffix[k]: {**errs[k], "ms": timing[k][0], "plain_ms": timing[k][1],
                            "library_ms": None, **bounds[k]}
            for k in timing}


def mixed_mask(trainer, batch) -> float:
    """Shift the loaded MaskModule's classifier bias by the median of its
    logits on ``batch`` (an evaluation forward), so that about half of its
    pixels are moving. After six synthetic steps stage 3's mask calls every
    pixel moving, which would leave stage 4's static branch (the automasked
    reprojection) weight 0 and its loss NaN. Returns the shift."""
    import torch

    model = trainer.model
    conv = model.att_module.classifier[0]
    logits = []
    hook = conv.register_forward_hook(lambda mod, args, out: logits.append(out.float()))
    with torch.no_grad():
        _, sfcv = model.cost_volume(batch, use_mono=True, use_stereo=False)
        model.att_module(sfcv, model.features(batch["keyframe"]), False)
        hook.remove()
        shift = logits[0].median()
        conv.bias -= shift.to(conv.bias.dtype)
    return shift.item()


def phase_stage4(dev, card: str, run_dir, stage1_checkpoint, stage3_checkpoint):
    """Phase 19: stage 4 of the curriculum (depth refinement) from phase
    10's depth checkpoint and phase 18's mask checkpoint, its mask shifted
    to a mixed moving share, then the stage-4 kernel records. Returns the
    launch counts of its main path, the records, each with its launches at
    the shape it names, and its checkpoint."""
    import torch

    trainer = refinement_trainer(dev, run_dir, "monorec_depth_ref", B, ("stereo", "stereo_repr"),
                                 {"depth_cp_loc": stage1_checkpoint,
                                  "mask_cp_loc": stage3_checkpoint})
    shift = mixed_mask(trainer, next(iter(trainer.data_loader)))
    log(f"[19 stage 4] the stage-3 MaskModule's classifier bias lowered by {shift:.5f}, the "
        f"median of its logits on the first batch, so that about half its pixels are moving")
    counts, by_batch, lines, ratios = refinement_main_path(
        "[19 stage 4]", trainer, ("depth_module.",), ("_feature_extractor.", "att_module."),
        STAGE4_STEP)
    # skip_nonfinite_updates (on in the config) reads every step's gradients.
    skipped = [r["skipped_nonfinite"] for r in lines]
    bad = [i for i, (r, q) in enumerate(zip(lines, ratios))
           if not math.isfinite(r["loss"]) and 0.0 < q < 1.0]
    mixed = [i for i, (r, q) in enumerate(zip(lines, ratios))
             if math.isfinite(r["loss"]) and 0.0 < q < 1.0]
    log(f"[19 stage 4] steps skipped for non-finite gradients {skipped}; steps with static and "
        f"moving pixels and a finite loss {mixed}; losses not finite on such steps {bad}")
    if any(skipped) or bad or not mixed:
        raise AssertionError("stage 4 gave non-finite gradients, a NaN loss where static and "
                             "moving pixels both exist, or no step with both")
    # The records' shapes: one K2 _jac (N=96) and one K3 backward (M=96) per
    # step, one K3 forward (M=96) per step and per validation batch.
    n96 = SCALES * B * (F + 1)
    n_val = len(trainer.valid_data_loader)
    launches = {"grid_warp_jac": TRAIN_STEPS, "photo_error_fwd": TRAIN_STEPS + n_val,
                "photo_error_bwd": TRAIN_STEPS}
    at96 = {k: by_batch[k].get(n96, 0) for k in launches}
    log(f"[19 stage 4] launches at N=M={n96}: {at96} (expected {launches}); all shapes {by_batch}")
    if at96 != launches:
        raise AssertionError(f"stage 4 launched K2 / K3 at N=M={n96} {at96}, expected {launches}")
    refinement_timing("[19 stage 4]", card, dev, trainer, STAGE4_STEP)
    torch.cuda.empty_cache()
    batch = next(iter(trainer.data_loader))
    records = stage4_kernel_records(dev, card, trainer, batch)
    for k, record in records.items():
        record["launches"] = at96[k.rsplit("_", 1)[0]]
    return counts, records, trainer.run_dir / "checkpoint.pth"


# ---- phases 20-21: a KITTI-layout tree written without PIL ------------------

# KITTI odometry sequence 07's calib.txt (P0-P3 of sequences 04-12), at its
# native image size 370x1226; write_kitti_tree scales it to other sizes.
KITTI_SIZE = (370, 1226)
KITTI_CALIB = {
    "P0": (707.0912, 0.0, 601.8873, 0.0, 0.0, 707.0912, 183.1104, 0.0, 0.0, 0.0, 1.0, 0.0),
    "P1": (707.0912, 0.0, 601.8873, -379.8145, 0.0, 707.0912, 183.1104, 0.0, 0.0, 0.0, 1.0,
           0.0),
    "P2": (707.0912, 0.0, 601.8873, 46.88783, 0.0, 707.0912, 183.1104, 0.1178601, 0.0, 0.0,
           1.0, 0.006203223),
    "P3": (707.0912, 0.0, 601.8873, -333.4597, 0.0, 707.0912, 183.1104, 1.930130, 0.0, 0.0,
           1.0, 0.003318498),
}
FRAME_STEP = 0.8  # metres forward per frame, KITTI's ~8 m/s at 10 Hz
# The scene's plane: n . X = PLANE_D in the world frame (the first camera's),
# tilted about both image axes: its depth runs from ~20 m (top right) to
# ~60 m (bottom left) at the first camera.
PLANE_N = (0.3, -1.0, 1.0)
PLANE_D = 30.0


def encode_png(img, n_idat: int = 3) -> bytes:
    """A PNG of a uint8 or uint16 (H, W) or (H, W, 3) array, row r filtered
    with filter r % 5 (None, Sub, Up, Average, Paeth), the compressed data
    split over ``n_idat`` IDAT chunks."""
    import struct
    import zlib

    import numpy as np

    img = np.asarray(img)
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    bpp = channels * depth // 8
    raw = (img.astype(">u2") if depth == 16 else img.astype(np.uint8)).tobytes()
    x = np.frombuffer(raw, np.uint8).reshape(h, w * bpp).astype(np.int32)
    a = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]  # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]  # up
    c = np.pad(b, ((0, 0), (bpp, 0)))[:, :-bpp]  # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [0 * x, a, b, (a + b) // 2, paeth]
    kinds = np.arange(h) % 5
    filtered = np.stack([(x[r] - preds[k][r]) % 256 for r, k in enumerate(kinds)])
    scan = np.concatenate([kinds[:, None], filtered], axis=1).astype(np.uint8).tobytes()
    data = zlib.compress(scan, 6)
    cuts = np.linspace(0, len(data), n_idat + 1).astype(int)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    colour = 0 if channels == 1 else 2
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                                             0, 0, 0))
            + b"".join(chunk(b"IDAT", data[s:e]) for s, e in zip(cuts[:-1], cuts[1:]))
            + chunk(b"IEND", b""))


def write_png(path, img) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def render_plane(k, cam_pos, size):
    """The textured plane seen by a camera at ``cam_pos`` (world axes): an
    (H, W, 3) uint8 image and its (H, W) depth in metres."""
    import numpy as np

    h, w = size
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([(u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1], np.ones_like(u)], -1)
    n = np.asarray(PLANE_N)
    depth = (PLANE_D - n @ np.asarray(cam_pos)) / (rays @ n)
    world = np.asarray(cam_pos) + depth[..., None] * rays
    px, py = world[..., 0], world[..., 1] + world[..., 2] * 0.5  # coordinates on the plane
    img = np.empty((h, w, 3))
    for ch, (f1, f2, ph) in enumerate(((1.3, 0.7, 0.0), (0.9, 1.9, 1.0), (2.3, 1.1, 2.0))):
        img[..., ch] = (0.5 + 0.25 * np.sin(f1 * px + ph) * np.cos(f2 * py)
                        + 0.15 * np.sin(5.1 * px + 3.7 * py + ph))
    return np.clip(np.round(img * 255), 0, 255).astype(np.uint8), depth


def write_kitti_tree(root, size=KITTI_SIZE, n_frames: int = 24, seq: str = "07",
                     write=write_png, depth_share: float = 0.05, stereo: bool = False,
                     seed: int = 0):
    """A KITTI Odometry tree under ``root``: sequence ``seq`` with
    ``n_frames`` images (image_2, and image_3 when ``stereo``) of the plane
    scene seen by a camera moving FRAME_STEP m forward per frame, a
    calib.txt (sequence 07's, scaled to ``size``), the poses in poses/ and
    poses_dvso/, and 16-bit annotated depth PNGs (depth x 256) at
    ``depth_share`` of the pixels in image_depth_annotated/. ``write(path,
    array)`` writes each PNG. Returns the depth maps in metres."""
    from pathlib import Path

    import numpy as np

    root = Path(root)
    seq_dir = root / "sequences" / seq
    for sub in ("image_2", "image_3", "image_depth_annotated"):
        (seq_dir / sub).mkdir(parents=True, exist_ok=True)
    (root / "poses").mkdir(exist_ok=True)
    (root / "poses_dvso").mkdir(exist_ok=True)
    sx, sy = size[1] / KITTI_SIZE[1], size[0] / KITTI_SIZE[0]
    calib = {}
    for name, vals in KITTI_CALIB.items():
        p = np.asarray(vals).reshape(3, 4).copy()
        p[0] *= sx
        p[1] *= sy
        calib[name] = p
    (seq_dir / "calib.txt").write_text("".join(
        f"{name}: " + " ".join(f"{v:.12e}" for v in p.reshape(-1)) + "\n"
        for name, p in calib.items()))
    k = calib["P2"][:, :3]
    baseline = abs(calib["P3"][0, 3] / calib["P3"][0, 0] - calib["P2"][0, 3] / calib["P2"][0, 0])
    rng = np.random.default_rng(seed)
    lines, depths = [], []
    for i in range(n_frames):
        pos = (0.0, 0.0, FRAME_STEP * i)
        pose = np.eye(4)[:3]
        pose[:, 3] = pos
        lines.append(" ".join(f"{v:.12e}" for v in pose.reshape(-1)))
        img, depth = render_plane(k, pos, size)
        write(seq_dir / "image_2" / f"{i:06d}.png", img)
        if stereo:
            write(seq_dir / "image_3" / f"{i:06d}.png",
                  render_plane(k, (baseline, 0.0, FRAME_STEP * i), size)[0])
        sparse = np.where(rng.random(size) < depth_share, np.round(depth * 256), 0)
        write(seq_dir / "image_depth_annotated" / f"{i:06d}.png", sparse.astype(np.uint16))
        depths.append(depth)
    for d in ("poses", "poses_dvso"):
        (root / d / f"{seq}.txt").write_text("\n".join(lines) + "\n")
    return depths


EVAL_FRAMES = 24  # phase 20's tree: annotated depth leaves out 5 frames at each end
EVAL_RTOL = 1e-3  # the forward's budget (tests/test_convert.py)


def write_config(path, config) -> str:
    with open(path, "w") as f:
        json.dump(config, f)
    return str(path)


def eval_config(work, tree, checkpoint, tag: str, **data_args):
    """A copy of configs/evaluate/eval_monorec.json on the phase-20 tree
    (sequence 07) and ``checkpoint``; returns its path and run directory."""
    from pathlib import Path

    with open("configs/evaluate/eval_monorec.json") as f:
        config = json.load(f)
    config["models"][0]["args"]["checkpoint_location"] = [str(checkpoint)]
    config["data_loader"]["args"].update(dataset_dir=str(tree), sequences=["07"],
                                         target_image_size=[H, W], **data_args)
    config["evaluater"].update(save_dir=str(Path(work) / tag), verbosity=0)
    path = write_config(Path(work) / f"{tag}.json", config)
    return path, Path(work) / tag / "log" / config["name"] / config["timestamp_replacement"]


def busy_window(fn):
    """(wall ms, device busy ms) of one call of ``fn`` under torch.profiler:
    the window runs from the host's start of the call to the end of the last
    device activity, busy is the union of the device activities in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_window"):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    t0 = min(e.time_range.start for e in events
             if e.name == "chip_smoke_window" and e.device_type == DeviceType.CPU)
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and e.name not in host_names)
    t1 = max(end for _, end in spans)
    busy, reach = 0.0, t0
    for start, end in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return (t1 - t0) / 1e3, busy / 1e3


def phase_evaluate(dev, card: str, work, checkpoint) -> dict:
    """Phase 20: evaluation on the card through ``cli.evaluate`` on a
    KITTI-layout tree at KITTI's native size, from phase 19's checkpoint.
    Returns the K1 launches of its main path."""
    from pathlib import Path

    import numpy as np
    import torch

    from monorec_tpu_torch import config as config_mod
    from monorec_tpu_torch.cli import evaluate
    from monorec_tpu_torch.data.cache import CachedDataset, build_cache
    from monorec_tpu_torch.data.kitti import compute_crop_and_intrinsics, load_calib
    from monorec_tpu_torch.data.loader import DataLoader
    from monorec_tpu_torch.data.png import read_png
    from monorec_tpu_torch.data.resize import crop_resize_bilinear
    from monorec_tpu_torch.eval import Evaluator
    from monorec_tpu_torch.models import MonoRec
    from monorec_tpu_torch.train.checkpoints import load_stage_checkpoints

    tree = Path(work) / "kitti"
    t = time.perf_counter()
    write_kitti_tree(tree, n_frames=EVAL_FRAMES)
    log(f"[20 evaluate] wrote a KITTI tree (sequence 07, {EVAL_FRAMES} frames at "
        f"{KITTI_SIZE[0]}x{KITTI_SIZE[1]}, PNG row filters cycling 0-4) in "
        f"{time.perf_counter() - t:.2f} s")

    # The host's decode and resize of one native image.
    seq = tree / "sequences" / "07"
    box, _ = compute_crop_and_intrinsics(load_calib(seq / "calib.txt")["P2"], KITTI_SIZE, (H, W))
    decode, resize = [], []
    for p in sorted((seq / "image_2").glob("*.png"))[:8]:
        t0 = time.perf_counter()
        img = read_png(p)
        t1 = time.perf_counter()
        crop_resize_bilinear(img, box, (H, W))
        decode.append((t1 - t0) * 1e3)
        resize.append((time.perf_counter() - t1) * 1e3)
    log(f"[20 evaluate] host per {KITTI_SIZE[0]}x{KITTI_SIZE[1]} RGB image (8 images, median): "
        f"read_png {statistics.median(decode):.3f} ms, crop_resize_bilinear to {H}x{W} "
        f"{statistics.median(resize):.3f} ms, together "
        f"{statistics.median(a + b for a, b in zip(decode, resize)):.3f} ms (host clock, the "
        f"host of {card})")

    # The main path: the CLI on the card.
    n_samples = EVAL_FRAMES - 10
    n_batches = n_samples // 2
    path, run_dir = eval_config(work, tree, checkpoint, "eval_card")
    reset_counts()
    evaluate.main(["-c", path, "--device", str(dev)])
    counts = launch_counts()
    if counts != only(plane_sweep_cost_volume=n_batches):
        raise AssertionError(f"the evaluation launched {counts}, expected plane_sweep_cost_volume "
                             f"once per batch ({n_batches})")
    result = json.loads((run_dir / "results_0.json").read_text())["metrics"]
    log(f"[20 evaluate] cli.evaluate on the card: {n_batches} batches of 2, one K1 cost-volume "
        f"launch each; valid_batches {result['valid_batches']}, num_samples "
        f"{result['num_samples']}; " + ", ".join(
            f"{k} {result[k]:.6f}" for k in result if k.endswith("_metric")))
    if not (len(result["metrics"]) == 7 and all(math.isfinite(v) for v in result["metrics"])
            and result["valid_batches"] == n_batches and result["num_samples"] == n_samples):
        raise AssertionError(f"the evaluation's results are off: {result}")

    # The same evaluation over the first two batches, on the card and on the
    # CPU (the plain versions).
    first = {}
    for tag, device in (("card", str(dev)), ("cpu", "cpu")):
        path, run_dir = eval_config(work, tree, checkpoint, f"eval_first_{tag}", start=0, end=4)
        evaluate.main(["-c", path, "--device", device])
        first[tag] = json.loads((run_dir / "results_0.json").read_text())["metrics"]
    g, c = np.asarray(first["card"]["metrics"]), np.asarray(first["cpu"]["metrics"])
    rel = np.abs(g - c) / np.where(c == 0, 1.0, np.abs(c))
    log(f"[20 evaluate] first 2 batches, card vs CPU: max relative diff {rel.max():.3e} "
        f"(metrics {', '.join(f'{v:.6f}' for v in g)} vs {', '.join(f'{v:.6f}' for v in c)})")
    if not np.isclose(g, c, rtol=EVAL_RTOL, atol=0).all() or first["card"]["valid_batches"] != 2:
        raise AssertionError("the card's evaluation disagrees with the CPU's")

    # Timing: the forward per batch, and the evaluate loop from the raw tree
    # and from a cache of it.
    with open(path) as f:
        config = json.load(f)
    model_cfg, locations = config_mod.build_models(config)[0]
    model = MonoRec(model_cfg, dev)
    load_stage_checkpoints(model, locations)
    model.eval()
    raw_args = dict(config["data_loader"]["args"], start=0, end=n_samples)
    raw = config_mod.build_data_loader({"type": "KittiOdometryDataloader", "args": raw_args}, dev)
    raw_1 = config_mod.build_data_loader({"type": "KittiOdometryDataloader",
                                          "args": dict(raw_args, num_workers=1)}, dev)
    if (raw.num_workers, raw_1.num_workers) != (8, 1):
        raise AssertionError(f"the loaders run {raw.num_workers} and {raw_1.num_workers} workers")
    batch = next(iter(raw))
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model(batch), 10)
    log(f"[20 evaluate] eval forward, batch 2 at {H}x{W}, D={D}, F={F}: {fwd_ms:.3f} ms per batch "
        f"(CUDA events, 10 calls) on {card}")
    t = time.perf_counter()
    build_cache(raw.dataset, Path(work) / "cache", log_every=0)
    cache_s = time.perf_counter() - t
    cached = DataLoader(CachedDataset(str(Path(work) / "cache")), 2, shuffle=False, device=dev)
    metric_fns = config_mod.build_metrics(config)
    logs = {}
    for tag, loader in (("raw tree, 8 workers", raw), ("raw tree, 1 worker", raw_1),
                        ("cache", cached)):
        evaluator = Evaluator(model, metric_fns, config, loader, Path(work) / "timing")
        torch.cuda.synchronize()
        t = time.perf_counter()
        logs[tag] = evaluator.eval()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        window_ms, busy_ms = busy_window(evaluator.eval)
        log(f"[20 evaluate] evaluate loop from the {tag}: {n_samples} keyframes in {wall:.3f} s = "
            f"{n_samples / wall:.3f} keyframes/s (host clock); profiled pass: device busy "
            f"{busy_ms:.1f} of {window_ms:.1f} ms = {100 * busy_ms / window_ms:.1f}% on {card}")
    cached_m = np.asarray(logs["cache"]["metrics"])
    raw_m = np.asarray(logs["raw tree, 8 workers"]["metrics"])
    raw_1_m = np.asarray(logs["raw tree, 1 worker"]["metrics"])
    log(f"[20 evaluate] cache of {n_samples} samples built in {cache_s:.3f} s; its metrics vs "
        f"the raw tree's: max |diff| {np.abs(cached_m - raw_m).max():.3e}; the raw tree's with 1 "
        f"worker vs 8: max |diff| {np.abs(raw_1_m - raw_m).max():.3e}")
    if not (np.allclose(cached_m, raw_m, rtol=1e-6, atol=0)
            and np.allclose(raw_1_m, raw_m, rtol=1e-6, atol=0)):
        raise AssertionError("the cache's or one worker's evaluation differs from the raw tree's")
    del model, batch
    torch.cuda.empty_cache()
    return {"eval_launches": counts["plane_sweep_cost_volume"]}


def read_ply(path):
    """(vertices (N, 6)) of a binary little-endian PLY; raises when the
    header does not parse or the vertex count does not match the size."""
    import numpy as np

    data = open(path, "rb").read()
    head, sep, body = data.partition(b"end_header\n")
    lines = head.decode("ascii").splitlines()
    if not sep or lines[:2] != ["ply", "format binary_little_endian 1.0"]:
        raise AssertionError(f"{path}: not a binary little-endian PLY")
    n = int(next(line for line in lines if line.startswith("element vertex")).split()[-1])
    if len([line for line in lines if line.startswith("property float")]) != 6 or (
            len(body) != n * 6 * 4):
        raise AssertionError(f"{path}: {n} vertices do not fill its {len(body)} bytes")
    return np.frombuffer(body, "<f4").reshape(n, 6)


def phase_pointcloud(dev, card: str, work, checkpoint) -> dict:
    """Phase 21: ``cli.create_pointcloud`` on phase 20's tree with the mask on
    and off, and ``pointcloud_masks`` on the card against the CPU. Returns
    the K1 launches of its main path."""
    from pathlib import Path

    import numpy as np
    import torch

    from monorec_tpu_torch.cli import create_pointcloud
    from monorec_tpu_torch.export import pointcloud_masks

    n_frames = EVAL_FRAMES - 10
    points, launches = {}, 0
    for use_mask in (True, False):
        with open("configs/test/pointcloud_monorec.json") as f:
            config = json.load(f)
        config["arch"]["args"]["checkpoint_location"] = [str(checkpoint)]
        config["data_set"]["args"].update(dataset_dir=str(Path(work) / "kitti"),
                                          target_image_size=[H, W])
        # The checkpoint is a few steps of synthetic training: its depths need
        # not fall inside the shipped 3-30 m, so every depth the model can
        # give (up to 1 / 0.0025 m) is kept.
        config.update(output_dir=str(Path(work) / "pointclouds"), use_mask=use_mask, max_d=400)
        config["file_name"] = f"seq07_mask_{use_mask}.ply"
        path = write_config(Path(work) / f"pointcloud_{use_mask}.json", config)
        reset_counts()
        t = time.perf_counter()
        create_pointcloud.main(["-c", path, "--device", str(dev)])
        wall = time.perf_counter() - t
        counts = launch_counts()
        if counts != only(plane_sweep_cost_volume=n_frames):
            raise AssertionError(f"the export launched {counts}, expected plane_sweep_cost_volume "
                                 f"once per frame ({n_frames})")
        launches += counts["plane_sweep_cost_volume"]
        cloud = read_ply(Path(config["output_dir"]) / config["file_name"])
        if not np.isfinite(cloud).all():
            raise AssertionError("a point-cloud coordinate is not finite")
        points[use_mask] = len(cloud)
        log(f"[21 pointcloud] use_mask={use_mask}: {len(cloud)} points from {n_frames} frames "
            f"({n_frames - 4} exported) in {wall:.3f} s (host clock, the CLI whole) on {card}")
    if points[False] == 0 or points[True] > points[False]:
        raise AssertionError(f"point counts off: {points}")
    rng = np.random.default_rng(0)
    cv_mask = rng.uniform(0, 0.1, (2, 1, H, W)).astype(np.float32)
    cv_mask.reshape(-1)[rng.choice(cv_mask.size, 16, replace=False)] = 0.5  # sparse hits
    cv_mask = torch.from_numpy(cv_mask)
    on_card = pointcloud_masks(cv_mask.to(dev)).cpu()
    if not torch.equal(on_card, pointcloud_masks(cv_mask)):
        raise AssertionError("pointcloud_masks on the card differs from the CPU")
    log(f"[21 pointcloud] pointcloud_masks on the card equals the CPU's (kept share "
        f"{on_card.mean().item():.4f} on a random cv_mask)")
    return {"pointcloud_launches": launches}


# ---- phases 22-23: RobotCar and TUM mono VO trees written without PIL -------

# RobotCar's stereo narrow-left camera at its native raw size (960x1280):
# RobotCar-like intrinsics, fx fy cx cy.
ROBOTCAR_SIZE = (960, 1280)
ROBOTCAR_K = (983.044, 983.044, 643.647, 493.379)
ROBOTCAR_FRAMES = 10  # 8 samples at F=2: two batches of 4
ROBOTCAR_DT_US = 62500  # 16 Hz
ROBOTCAR_STEP = 0.6  # metres forward per frame
# The RobotCar SDK's extrinsics as x y z roll pitch yaw. The camera's turns
# the SDK's body axes (x forward, y right, z down) into the camera's axes
# (x right, y down, z forward), so that the reader's projection of the
# LiDAR returns agrees with the poses; the LiDAR sits at the body's origin.
ROBOTCAR_CAMERA_XYZRPY = (0.0, 0.0, 0.0, 0.0, -math.pi / 2, -math.pi / 2)
# The shipped oxrc configs' cutout (0, 0.333333333333333, 0, 0) leaves 321
# of 480 rows at scale 0.5 (int(0.333333333333333 * 480) = 159), which the
# model's U-Net cannot take; 1/3 to the double's last digit leaves 320.
ROBOTCAR_CUTOUT = [0, 1 / 3, 0, 0]
TUM_SIZE = (1024, 1280)  # TUM mono VO's native size
TUM_FRAMES = 9  # 5 samples at F=4
TUM_K = (0.7, 0.875, 0.5, 0.5)  # relative fx fy cx cy: a pinhole of 71 x 60 degrees
TUM_STEP = 0.3  # metres forward per frame
TUM_SCALE = 3.0  # the shipped config's scale_factor; result.txt holds step / scale
JPEG_LEVELS = 2.0  # mean |decoded - encoded source| of a quality-90 frame, in levels
TUM_DEPTH_MAX = 60.0  # metres: the depth files hold 0 (no measurement) beyond it
# The JPEG standard's luminance quantization table (Annex K.1), natural
# order, and its luminance DC and AC Huffman tables (K.3, K.5): the count of
# codes of each length 1-16, then the symbols.
JPEG_LUMA_QUANT = (
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
JPEG_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
JPEG_DC_SYMBOLS = tuple(range(12))
JPEG_AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)
JPEG_AC_SYMBOLS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
JPEG_ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

# The chrominance quantization table (Annex K.2) and Huffman tables (K.4, K.6).
JPEG_CHROMA_QUANT = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99) + (99,) * 32
JPEG_CHROMA_DC_BITS = (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0)
JPEG_CHROMA_DC_SYMBOLS = tuple(range(12))
JPEG_CHROMA_AC_BITS = (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77)
JPEG_CHROMA_AC_SYMBOLS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")


def jpeg_quant_table(quality: int, base=JPEG_LUMA_QUANT):
    """The table ``base`` (the luminance one by default) scaled to
    ``quality`` as libjpeg scales it, each entry kept in 1..255 (8-bit
    tables)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [min(max((q * scale + 50) // 100, 1), 255) for q in base]


def _huffman_codes(bits, symbols) -> dict:
    """symbol -> (code, length) of a canonical Huffman table."""
    codes, code, k = {}, 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _forward_dct(plane, quant):
    """The quantized DCT coefficients (rows, cols, 64), natural order, of a
    float plane whose sides are multiples of 8 (level shift included)."""
    import numpy as np

    rows, cols = plane.shape[0] // 8, plane.shape[1] // 8
    blocks = (plane - 128.0).reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
    u = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)
    q = np.asarray(quant, np.int64).reshape(8, 8)
    return np.round(dct @ blocks @ dct.T / q).astype(np.int64).reshape(rows, cols, 64)


def encode_jpeg(img, quality: int = 90, restart_interval: int = 0, sampling=None,
                separate_scans: bool = False, adobe_rgb: bool = False, progressive=False,
                ycck: bool = False) -> bytes:
    """A JPEG of an (H, W) greyscale, (H, W, 3) RGB or (H, W, 4) CMYK uint8
    array: the standard tables (Annex K: luminance for the first component,
    chrominance for the others) at ``quality``, with ``restart_interval`` >
    0 an RSTn marker every that many MCUs (``jpeg_from_components``).
    Colour is YCbCr (JFIF) with each component's (h, v) ``sampling``
    factors (1 or 2; the default is 4:2:0, the first component at 2x2 and
    the others at 1x1; for YCCK Y and K at 2x2), a downsampled component
    averaged over the pixels
    each sample covers, all components in one interleaved scan or, with
    ``separate_scans``, each in a scan of its own; ``adobe_rgb`` writes the
    RGB samples untransformed under an Adobe APP14 segment with transform 0
    instead of JFIF. CMYK is written as PIL writes and reads it, inverted
    (255 - v), under Adobe transform 0, every component with the luminance
    tables, or with ``ycck`` under transform 2: Y, Cb and Cr of the array's
    C, M and Y taken as R, G and B, then the inverted K, Y and K with the
    luminance tables (libjpeg's choices). ``progressive`` (a scan script, or True for
    ``progressive_script``'s) writes a progressive file of the same
    quantized coefficients as the sequential one."""
    import numpy as np

    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    if channels == 1:
        bh, bw = -(-h // 8), -(-w // 8)
        padded = np.pad(img, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge").astype(np.float64)
        quant = jpeg_quant_table(quality)
        return jpeg_from_components([_forward_dct(padded, quant)], [(1, 1)], [quant], h, w,
                                    restart_interval, progressive=progressive)
    # libjpeg's jpeg_set_colorspace: CMYK reads the luminance tables for
    # every component, YCCK for Y and K.
    table_of = {3: [0, 1, 1], 4: [0, 1, 1, 0] if ycck else [0, 0, 0, 0]}[channels]
    sampling = list(sampling or [(2, 2)] + [(1, 1)] * (channels - 1 - ycck) + [(2, 2)] * ycck)
    hmax, vmax = max(f[0] for f in sampling), max(f[1] for f in sampling)
    my, mx = -(-h // (8 * vmax)), -(-w // (8 * hmax))
    px = np.pad(img, ((0, my * 8 * vmax - h), (0, mx * 8 * hmax - w), (0, 0)),
                mode="edge").astype(np.float64)
    adobe = None
    if channels == 4:
        adobe = 2 if ycck else 0
        rgb = px[..., :3] if ycck else None
        planes = [255.0 - px[..., c] for c in range(4)]
    else:
        rgb = None if adobe_rgb else px
        planes = [px[..., c] for c in range(3)]
        adobe = 0 if adobe_rgb else None
    if rgb is not None:
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        planes[:3] = [0.299 * r + 0.587 * g + 0.114 * b,
                      -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                      0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
    grids, quants = [], []
    for c, (fh, fv) in enumerate(sampling):
        sy, sx = vmax // fv, hmax // fh
        p = planes[c]
        p = p.reshape(p.shape[0] // sy, sy, p.shape[1] // sx, sx).mean(axis=(1, 3))
        quant = jpeg_quant_table(quality, (JPEG_LUMA_QUANT, JPEG_CHROMA_QUANT)[table_of[c]])
        grids.append(_forward_dct(p, quant))
        quants.append(quant)
    return jpeg_from_components(grids, sampling, quants, h, w, restart_interval,
                                separate_scans, adobe, progressive, table_of)


def jpeg_from_coefficients(coef, quant, h: int, w: int, restart_interval: int = 0) -> bytes:
    """A baseline greyscale JFIF of quantized coefficients ``coef`` (one row
    of 64 per 8x8 block, natural order, blocks row by row) of an h x w
    image, with the (8, 8) quantization table ``quant`` (8-bit entries)
    (``jpeg_from_components``)."""
    import numpy as np

    grid = np.asarray(coef).reshape(-(-h // 8), -(-w // 8), 64)
    return jpeg_from_components([grid], [(1, 1)], [np.asarray(quant).reshape(-1)], h, w,
                               restart_interval)


def progressive_script(ncomp: int, ycc: bool = True) -> list:
    """libjpeg's ``jpeg_simple_progression`` as (components, Ss, Se, Ah, Al)
    scans: for YCbCr colour the DC of all components at Al=1; luma 1-5 at
    Al=2; chroma 1-63 at Al=1; luma 6-63 at Al=2; luma 1-63 from Al=2 to 1;
    the DC's last bit; chroma and then luma 1-63 to Al=0. For one component,
    four or an RGB file: the DC at Al=1, each component's 1-5 and then 6-63
    at Al=2, 1-63 to Al=1, the DC's last bit, 1-63 to Al=0."""
    comps = tuple(range(ncomp))
    if ncomp == 3 and ycc:
        return [(comps, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                (comps, 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    return ([(comps, 0, 0, 0, 1)] + [((c,), 1, 5, 0, 2) for c in comps]
            + [((c,), 6, 63, 0, 2) for c in comps] + [((c,), 1, 63, 2, 1) for c in comps]
            + [(comps, 0, 0, 1, 0)] + [((c,), 1, 63, 1, 0) for c in comps])


def optimal_huffman(freq: dict) -> tuple:
    """``jchuff.c::jpeg_gen_optimal_table`` (Annex K.2): the counts of codes
    of each length 1-16 and the symbols of a Huffman table for the symbol
    frequencies ``freq``, no code longer than 16 bits and none all ones."""
    f = [0] * 257
    for sym, n in freq.items():
        f[sym] = n
    f[256] = 1  # reserves the all-ones code
    size, others = [0] * 257, [-1] * 257
    while True:
        live = [i for i in range(257) if f[i]]
        if len(live) < 2:
            break
        c1 = min(live, key=lambda i: (f[i], -i))  # the smallest; the largest index on ties
        c2 = min((i for i in live if i != c1), key=lambda i: (f[i], -i))
        f[c1] += f[c2]
        f[c2] = 0
        for c in (c1, c2):
            size[c] += 1
            while others[c] >= 0:
                c = others[c]
                size[c] += 1
        c = c1
        while others[c] >= 0:
            c = others[c]
        others[c] = c2
    bits = [0] * 33
    for s in size:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved code
    symbols = [s for n in range(1, 33) for s in range(256) if size[s] == n]
    return tuple(bits[1:17]), bytes(symbols)


def _pack_bits(codes, lengths) -> bytes:
    """The bit strings (code, length), in order, padded with 1-bits to a
    byte and byte-stuffed."""
    import numpy as np

    codes, lengths = np.asarray(codes, np.int64), np.asarray(lengths, np.int64)
    starts = np.cumsum(lengths) - lengths
    idx = np.arange(int(lengths.sum())) - np.repeat(starts, lengths)
    bits = (np.repeat(codes, lengths) >> (np.repeat(lengths, lengths) - 1 - idx)) & 1
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.int64)])
    return np.packbits(bits.astype(np.uint8)).tobytes().replace(b"\xff", b"\xff\x00")


def _magnitude(v: int) -> tuple:
    """(category, magnitude bits) of a coefficient or DC difference."""
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _progressive_tokens(zz, slots, ss: int, se: int, ah: int, al: int) -> list:
    """The coded data of a run of blocks (zig-zag rows ``zz``, block ``i``
    of component ``slots[i]``) in one progressive scan, as ``jcphuff.c``
    codes it: (symbol or -1, value, its bits) tokens, a symbol followed by
    ``bits`` raw bits of ``value``. The DC predictors, EOBRUN and the
    buffered correction bits start from nothing and are flushed at the
    end."""
    import numpy as np

    out = []
    if ss == 0 and ah:  # DC refinement: the next bit of each DC
        return [(-1, (int(v) >> al) & 1, 1) for v in zz[:, 0]]
    if ss == 0:  # DC first: the differences of the DC shifted right by Al
        pred = {}
        for c, v in zip(slots, zz[:, 0].tolist()):
            s, m = _magnitude((v >> al) - pred.get(c, 0))
            pred[c] = v >> al
            out.append((s, m, s))
        return out
    eob = [0, []]  # EOBRUN and the buffered correction bits BE

    def flush():
        if eob[0]:
            nb = eob[0].bit_length() - 1
            out.append((nb << 4, eob[0] & ((1 << nb) - 1), nb))
            out.extend((-1, b, 1) for b in eob[1])
            eob[0], eob[1] = 0, []

    mag = np.abs(zz[:, ss : se + 1]) >> al  # the point transform
    rows, cols = np.nonzero(mag)
    per_block = np.split(cols, np.searchsorted(rows, np.arange(1, len(zz))))
    for b, nz in enumerate(per_block):
        m, sign = mag[b].tolist(), (zz[b, ss : se + 1] >= 0).tolist()
        last = -1
        if not ah:  # AC first
            for k in nz.tolist():
                run = k - last - 1
                flush()
                while run > 15:
                    out.append((0xF0, 0, 0))
                    run -= 16
                v = m[k] if sign[k] else -m[k]
                s, bits = _magnitude(v)
                out.append(((run << 4) | s, bits, s))
                last = k
            if last < se - ss:
                eob[0] += 1
                if eob[0] == 0x7FFF:
                    flush()
            continue
        # AC refinement: a new coefficient is 1 at this precision, an old one
        # gives its next bit, buffered until the next symbol.
        end = max([k for k in nz.tolist() if m[k] == 1], default=-1)
        run, buffered = 0, []
        for k in nz.tolist():
            run += k - last - 1
            last = k
            while run > 15 and k <= end:
                flush()
                out.append((0xF0, 0, 0))
                run -= 16
                out.extend((-1, x, 1) for x in buffered)
                buffered = []
            if m[k] > 1:
                buffered.append(m[k] & 1)
                continue
            flush()
            out.append(((run << 4) | 1, int(sign[k]), 1))
            out.extend((-1, x, 1) for x in buffered)
            buffered, run = [], 0
        run += se - ss - last
        if run > 0 or buffered:
            eob[0] += 1
            eob[1] += buffered
            if eob[0] == 0x7FFF or len(eob[1]) > 1000 - 64 + 1:
                flush()
    flush()
    return out


def jpeg_from_components(grids, sampling, quants, h: int, w: int, restart_interval: int = 0,
                         separate_scans: bool = False, adobe=None, progressive=False,
                         table_of=None) -> bytes:
    """A JPEG of an h x w image from each component's quantized
    coefficients ``grids[c]`` (block rows, block columns, 64; natural
    order), its (h, v) ``sampling`` factors and its quantization table
    ``quants[c]`` (64 entries, natural order, 8 bits), with a COM segment
    and JFIF (or, with ``adobe`` not None, an Adobe APP14 segment of that
    transform). ``table_of[c]`` is component c's table number, 0 or 1, for
    its quantization and Huffman tables (the components of one number share
    the first one's quantization table); by default 0 for the first
    component and 1 for the others. Sequential (SOF0): the standard
    luminance Huffman tables for table 0, chrominance for table 1; one
    component, or ``separate_scans``, gives a scan per
    component over its downsampled blocks, otherwise one interleaved scan of
    MCUs. Progressive (SOF2): ``progressive`` is the scan script,
    (components, Ss, Se, Ah, Al) per scan, or True for
    ``progressive_script``'s, each scan with Huffman tables made for it
    (``optimal_huffman``) in a DHT segment before it, as libjpeg writes
    them. ``restart_interval`` > 0 writes a DRI segment and an RSTn marker
    every that many MCUs, numbered from 0 in each scan."""
    import struct

    import numpy as np

    ncomp = len(grids)
    table_of = list(table_of or [0] + [1] * (ncomp - 1))
    hmax, vmax = max(f[0] for f in sampling), max(f[1] for f in sampling)
    if progressive is True:
        progressive = progressive_script(ncomp, ycc=adobe is None)

    def segment(marker: int, body: bytes) -> bytes:
        return bytes((0xFF, marker)) + struct.pack(">H", len(body) + 2) + body

    def scan_blocks(comps):
        """The blocks of a scan of ``comps`` in coding order as (zig-zag
        rows, their components, blocks per MCU)."""
        if len(comps) == 1:
            c = comps[0]
            fh, fv = sampling[c]
            rows, cols = -(-h * fv // (8 * vmax)), -(-w * fh // (8 * hmax))
            return zig[c][:rows, :cols].reshape(-1, 64), [c] * (rows * cols), 1
        my, mx = -(-h // (8 * vmax)), -(-w // (8 * hmax))
        parts, slots = [], []
        for c in comps:
            fh, fv = sampling[c]
            g = zig[c][: my * fv, : mx * fh].reshape(my, fv, mx, fh, 64).transpose(0, 2, 1, 3, 4)
            parts.append(g.reshape(my * mx, fv * fh, 64))
            slots += [c] * (fv * fh)
        return (np.concatenate(parts, axis=1).reshape(-1, 64), slots * (my * mx), len(slots))

    def intervals(slots, per_mcu):
        per = (restart_interval or len(slots)) * per_mcu
        return [slice(start, start + per) for start in range(0, len(slots), per)]

    def with_restarts(pieces) -> bytes:
        return b"".join((bytes((0xFF, 0xD0 + (i - 1) % 8)) if i else b"") + p
                        for i, p in enumerate(pieces))

    zig = [np.asarray(g).reshape(g.shape[0], g.shape[1], 64)[..., list(JPEG_ZIGZAG)]
           for g in grids]
    body = b""
    if not progressive:
        tables = [(_huffman_codes(JPEG_DC_BITS, JPEG_DC_SYMBOLS),
                   _huffman_codes(JPEG_AC_BITS, JPEG_AC_SYMBOLS)),
                  (_huffman_codes(JPEG_CHROMA_DC_BITS, JPEG_CHROMA_DC_SYMBOLS),
                   _huffman_codes(JPEG_CHROMA_AC_BITS, JPEG_CHROMA_AC_SYMBOLS))]

        def interval(zz, slots) -> bytes:
            """The entropy-coded data of a run of blocks (zig-zag rows
            ``zz``, each of component ``slots[i]``), the DC predictors from
            0."""
            codes, lengths, pred = [], [], [0] * ncomp
            nz_blocks, nz_pos = np.nonzero(zz[:, 1:])
            nz_by_block = np.split(nz_pos + 1, np.searchsorted(nz_blocks, np.arange(1, len(zz))))
            for b, (c, nz) in enumerate(zip(slots, nz_by_block)):
                dc_codes, ac_codes = tables[table_of[c]]
                s, m = _magnitude(int(zz[b, 0]) - pred[c])
                pred[c] = int(zz[b, 0])
                code, length = dc_codes[s]
                codes.append((code << s) | m)
                lengths.append(length + s)
                last = 0
                for k in nz.tolist():
                    run = k - last - 1
                    while run > 15:
                        code, length = ac_codes[0xF0]
                        codes.append(code)
                        lengths.append(length)
                        run -= 16
                    s, m = _magnitude(int(zz[b, k]))
                    code, length = ac_codes[(run << 4) | s]
                    codes.append((code << s) | m)
                    lengths.append(length + s)
                    last = k
                if last < 63:
                    code, length = ac_codes[0x00]
                    codes.append(code)
                    lengths.append(length)
            return _pack_bits(codes, lengths)

        for comps in ([[c] for c in range(ncomp)] if ncomp == 1 or separate_scans
                      else [list(range(ncomp))]):
            zz, slots, per_mcu = scan_blocks(comps)
            data = with_restarts(interval(zz[i], slots[i]) for i in intervals(slots, per_mcu))
            sos = bytes([len(comps)]) + b"".join(bytes((c + 1, 0x11 * table_of[c])) for c in comps)
            body += segment(0xDA, sos + bytes((0, 63, 0))) + data
        dht = (b"\x00" + bytes(JPEG_DC_BITS) + bytes(JPEG_DC_SYMBOLS)
               + b"\x10" + bytes(JPEG_AC_BITS) + JPEG_AC_SYMBOLS)
        if 1 in table_of:
            dht += (b"\x01" + bytes(JPEG_CHROMA_DC_BITS) + bytes(JPEG_CHROMA_DC_SYMBOLS)
                    + b"\x11" + bytes(JPEG_CHROMA_AC_BITS) + JPEG_CHROMA_AC_SYMBOLS)
        body = segment(0xC4, dht) + body
    else:
        for comps, ss, se, ah, al in progressive:
            zz, slots, per_mcu = scan_blocks(list(comps))
            pieces = [(_progressive_tokens(zz[i], slots[i], ss, se, ah, al), slots[i])
                      for i in intervals(slots, per_mcu)]
            # One table per table number the scan reads: DC for a first DC
            # scan, AC for an AC scan, none for a DC refinement.
            kind = 0 if ss == 0 else 1
            freq = {}
            for tokens, slots_i in pieces:
                it = iter(slots_i)
                for sym, _, _ in tokens:
                    if sym >= 0:
                        t = table_of[next(it) if kind == 0 else comps[0]]
                        freq.setdefault(t, {})
                        freq[t][sym] = freq[t].get(sym, 0) + 1
            codes_of, dht = {}, b""
            for t in sorted(freq):
                bits, symbols = optimal_huffman(freq[t])
                codes_of[t] = _huffman_codes(bits, symbols)
                dht += bytes([(kind << 4) | t]) + bytes(bits) + symbols
            data = []
            for tokens, slots_i in pieces:
                codes, lengths, it = [], [], iter(slots_i)
                for sym, value, nbits in tokens:
                    if sym < 0:
                        codes.append(value)
                        lengths.append(nbits)
                        continue
                    t = table_of[next(it) if kind == 0 else comps[0]]
                    code, length = codes_of[t][sym]
                    codes.append((code << nbits) | value)
                    lengths.append(length + nbits)
                data.append(_pack_bits(codes, lengths))
            sos = bytes([len(comps)]) + b"".join(bytes((c + 1, 0x11 * table_of[c])) for c in comps)
            body += ((segment(0xC4, dht) if dht else b"")
                     + segment(0xDA, sos + bytes((ss, se, (ah << 4) | al))) + with_restarts(data))

    marker = (segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
              if adobe is not None else
              segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    q_zz = [bytes(int(np.asarray(q).reshape(-1)[k]) for k in JPEG_ZIGZAG) for q in quants]
    dqt = b"".join(bytes([t]) + q_zz[table_of.index(t)] for t in sorted(set(table_of)))
    sof = struct.pack(">BHHB", 8, h, w, ncomp) + b"".join(
        bytes((c + 1, (fh << 4) | fv, table_of[c])) for c, (fh, fv) in enumerate(sampling))
    return (b"\xff\xd8" + marker + segment(0xFE, b"chip_smoke.py JPEG encoder")
            + segment(0xDB, dqt) + segment(0xC2 if progressive else 0xC0, sof)
            + (segment(0xDD, struct.pack(">H", restart_interval)) if restart_interval else b"")
            + body + b"\xff\xd9")


def rgb_to_cmyk(rgb):
    """PIL's ``convert("CMYK")`` of an (H, W, 3) uint8 RGB array
    (``Convert.c::rgb2cmyk``): C, M and Y the complements of R, G and B, K
    0; its ``convert("RGB")`` gives ``rgb`` back."""
    import numpy as np

    rgb = np.asarray(rgb, np.uint8)
    return np.concatenate([255 - rgb, np.zeros_like(rgb[..., :1])], -1)


def write_jpeg(path, img, **kwargs) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, **kwargs))


EXR_COMPRESSIONS = {"NONE": 0, "RLE": 1, "ZIPS": 2, "ZIP": 3}
EXR_PIXEL_TYPES = {"UINT": (0, "<u4"), "HALF": (1, "<f2"), "FLOAT": (2, "<f4")}


def _exr_rle(buf: bytes) -> bytes:
    """OpenEXR's run-length code of ``buf``: a run of 3-128 equal bytes as
    (its length - 1, the byte), other bytes in literal runs of up to 127
    after their negated count."""
    import numpy as np

    a = np.frombuffer(buf, np.uint8)
    starts = np.flatnonzero(np.r_[True, a[1:] != a[:-1]])
    ends = np.r_[starts[1:], len(a)]
    out, literal = bytearray(), bytearray()

    def flush():
        for i in range(0, len(literal), 127):
            piece = literal[i : i + 127]
            out.append(256 - len(piece))
            out.extend(piece)
        literal.clear()

    for start, end in zip(starts.tolist(), ends.tolist()):
        n = end - start
        if n < 3:
            literal.extend(buf[start:end])
            continue
        flush()
        while n >= 3:
            k = min(n, 128)
            out += bytes((k - 1, a[start]))
            n -= k
        literal.extend(buf[end - n : end])
    flush()
    return bytes(out)


def encode_exr(channels, compression: str = "ZIP", pixel_type: str = "FLOAT",
               line_order: str = "INCREASING_Y", origin=(0, 0)) -> bytes:
    """A single-part scanline OpenEXR file of ``channels``: a 2-D array (the
    channel ``Y``) or a dict of equal-shaped 2-D arrays by channel name,
    each stored as ``pixel_type`` (HALF, FLOAT or UINT) under
    ``compression`` (NONE, RLE, ZIPS or ZIP: the bytes of a chunk split into
    their even and odd positions, each byte stored as its difference from
    the previous plus 128, then zlib or OpenEXR's runs; a chunk that does
    not shrink stored raw), with the data window's top-left corner at
    ``origin`` (x, y) and the chunks in ``line_order`` (INCREASING_Y or
    DECREASING_Y; the offset table by increasing y either way)."""
    import struct
    import zlib

    import numpy as np

    if not isinstance(channels, dict):
        channels = {"Y": channels}
    names = sorted(channels)
    height, width = np.asarray(channels[names[0]]).shape
    code, dtype = EXR_PIXEL_TYPES[pixel_type]
    x0, y0 = origin

    def attr(name: str, kind: str, value: bytes) -> bytes:
        return b"%s\x00%s\x00" % (name.encode(), kind.encode()) + struct.pack("<i", len(value)) + value

    chlist = b"".join(n.encode() + b"\x00" + struct.pack("<iB3xii", code, 0, 1, 1)
                      for n in names) + b"\x00"
    window = struct.pack("<iiii", x0, y0, x0 + width - 1, y0 + height - 1)
    header = (b"\x76\x2f\x31\x01" + struct.pack("<I", 2)
              + attr("channels", "chlist", chlist)
              + attr("compression", "compression", bytes((EXR_COMPRESSIONS[compression],)))
              + attr("dataWindow", "box2i", window) + attr("displayWindow", "box2i", window)
              + attr("lineOrder", "lineOrder", bytes((0 if line_order == "INCREASING_Y" else 1,)))
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\x00")
    planes = [np.asarray(channels[n]).astype(dtype) for n in names]
    per = 16 if compression == "ZIP" else 1
    chunks = []
    for y in range(0, height, per):
        raw = b"".join(p[r].tobytes() for r in range(y, min(y + per, height)) for p in planes)
        packed = raw
        if compression != "NONE":
            b = np.frombuffer(raw, np.uint8)
            split = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
            diff = split.copy()
            diff[1:] = (split[1:] - split[:-1] + 128) & 0xFF
            diff = diff.astype(np.uint8).tobytes()
            packed = _exr_rle(diff) if compression == "RLE" else zlib.compress(diff, 6)
            if len(packed) >= len(raw):
                packed = raw
        chunks.append(struct.pack("<ii", y0 + y, len(packed)) + packed)
    order = list(range(len(chunks)))
    if line_order != "INCREASING_Y":
        order.reverse()
    offsets, at = [0] * len(chunks), len(header) + 8 * len(chunks)
    for i in order:
        offsets[i] = at
        at += len(chunks[i])
    return (header + struct.pack(f"<{len(chunks)}Q", *offsets)
            + b"".join(chunks[i] for i in order))


def mosaic_gb(rgb):
    """The Bayer samples of an (H, W, 3) image in the pattern OpenCV calls
    GB (``COLOR_BayerGB2RGB``): red on even rows at odd columns, blue on odd
    rows at even columns, green elsewhere."""
    import numpy as np

    h, w = rgb.shape[:2]
    rows, cols = np.mgrid[0:h, 0:w] % 2
    channel = np.where(rows == cols, 1, np.where(rows == 0, 0, 2))
    return np.take_along_axis(rgb, channel[..., None], axis=2)[..., 0]


def write_robotcar_tree(root, size=ROBOTCAR_SIZE, n_frames: int = ROBOTCAR_FRAMES,
                        write=write_png):
    """A RobotCar tree in the SDK's layout under ``root``: ``stereo/centre``
    with ``n_frames`` Bayer PNGs (``mosaic_gb``) of the plane scene seen by a
    camera moving ROBOTCAR_STEP m forward per frame; ``models/`` with the
    intrinsics (ROBOTCAR_K scaled to ``size``) and a distortion LUT that
    samples each pixel ~0.3 px off; ``vo/vo.csv`` with the motion;
    ``extrinsics/`` for the camera and the LDMRS; and ``ldmrs/`` scans, one
    per frame and one between frames, of 400 points on the plane each, with
    a point repeated in the next scan and one behind it on the same ray
    (two returns on one pixel). ``write(path, array)`` writes each PNG.
    Returns the reader's folder arguments."""
    from pathlib import Path

    import numpy as np

    root = Path(root)
    for sub in ("stereo/centre", "models", "vo", "extrinsics", "ldmrs"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    h, w = size
    sy, sx = h / ROBOTCAR_SIZE[0], w / ROBOTCAR_SIZE[1]
    fx, fy, cx, cy = (ROBOTCAR_K[0] * sx, ROBOTCAR_K[1] * sy, ROBOTCAR_K[2] * sx,
                      ROBOTCAR_K[3] * sy)
    (root / "models" / "stereo_narrow_left.txt").write_text(f"{fx} {fy} {cx} {cy}\n")
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    lut = np.stack([u + 0.3 - 0.4 * v / h, v - 0.2 + 0.3 * u / w])
    lut.reshape(-1).tofile(root / "models" / "stereo_narrow_left_distortion_lut.bin")
    (root / "extrinsics" / "stereo_narrow_left.txt").write_text(
        " ".join(repr(x) for x in ROBOTCAR_CAMERA_XYZRPY) + "\n")
    (root / "extrinsics" / "ldmrs.txt").write_text("0 0 0 0 0 0\n")
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    t0 = 1_400_000_000_000_000
    times = [t0 + ROBOTCAR_DT_US * i for i in range(n_frames)]
    lines = ["source_timestamp,destination_timestamp,x,y,z,roll,pitch,yaw"]
    for i in range(1, n_frames):
        lines.append(f"{times[i]},{times[i - 1]},{ROBOTCAR_STEP},0,0,0,0,0")
    (root / "vo" / "vo.csv").write_text("\n".join(lines) + "\n")
    for i, t in enumerate(times):
        rgb, _ = render_plane(k, (0.0, 0.0, ROBOTCAR_STEP * i), size)
        write(root / "stereo" / "centre" / f"{t}.png", mosaic_gb(rgb))
    # A scan at each frame and halfway between: the points on the plane in
    # the body frame at the scan's time, (z, x, y) of the camera's.
    rng = np.random.default_rng(0)
    repeat = None
    for j in range(2 * n_frames - 1):
        s = ROBOTCAR_STEP * j / 2
        pu, pv = rng.uniform(0, w - 1, 400), rng.uniform(0, h - 1, 400)
        rays = np.stack([(pu - cx) / fx, (pv - cy) / fy, np.ones_like(pu)], -1)
        n = np.asarray(PLANE_N)
        depth = (PLANE_D - n[2] * s) / (rays @ n)
        cam = rays * depth[:, None]
        if repeat is not None:
            cam[0] = repeat - (0.0, 0.0, ROBOTCAR_STEP / 2)  # the last scan's first point
        repeat = cam[0].copy()
        cam = np.concatenate([cam, cam[1:2] * 1.05])  # a farther return on a ray
        scan = cam[:, [2, 0, 1]]
        scan.astype(np.float64).tofile(root / "ldmrs" / f"{t0 + ROBOTCAR_DT_US * j // 2}.bin")
    return {"sequence_folders": [str(root / "stereo" / "centre")],
            "pose_files": [str(root / "vo" / "vo.csv")],
            "lidar_folders": [str(root / "ldmrs")], "model_folder": str(root / "models"),
            "extrinsics_folder": str(root / "extrinsics")}


def tum_depth(size, i: int):
    """Frame ``i``'s depth on write_tum_tree's sequence at ``size``: the
    plane's depth in metres, float32, 0 (no measurement) beyond
    TUM_DEPTH_MAX."""
    import numpy as np

    h, w = size
    k = np.array([[TUM_K[0] * w, 0, TUM_K[2] * w], [0, TUM_K[1] * h, TUM_K[3] * h], [0, 0, 1]])
    _, depth = render_plane(k, (0.0, 0.0, TUM_STEP * i), size)
    return np.where(depth < TUM_DEPTH_MAX, depth, 0.0).astype(np.float32)


def tum_sampling(i: int):
    """The chroma sampling of write_tum_tree's colour frame ``i``: 4:4:4 for
    frame 0, 4:2:2 for frame 1, 4:2:0 for the rest."""
    return (((1, 1), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1)))[i] if i < 2 else (
        (2, 2), (1, 1), (1, 1))


def write_tum_tree(root, size=TUM_SIZE, n_frames: int = TUM_FRAMES, write=write_jpeg,
                   colour: bool = False, depth=None):
    """A TUM mono VO sequence under ``root``: ``images/`` with ``n_frames``
    JPEGs of the plane scene seen by a camera moving TUM_STEP m forward per
    frame (every third file with a restart interval of 61 MCUs), greyscale
    (the scene's mean over its channels) or, with ``colour``, RGB at
    ``tum_sampling``'s chroma sampling; ``times.txt``, ``result.txt`` (the
    motion divided by TUM_SCALE), an identity ``pcalib.txt`` and
    ``camera.txt`` with relative intrinsics after a model name.
    ``write(path, array, **kwargs)`` writes each JPEG (``sampling`` among
    the kwargs of a colour frame). ``depth`` maps frame indices to
    ``encode_exr`` keyword arguments: each such frame gets
    ``images_depth/<frame>_d.exr`` holding ``tum_depth``. Returns the
    images."""
    from pathlib import Path

    import numpy as np

    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    h, w = size
    k = np.array([[TUM_K[0] * w, 0, TUM_K[2] * w], [0, TUM_K[1] * h, TUM_K[3] * h], [0, 0, 1]])
    times, result, images = [], [], []
    for i in range(n_frames):
        rgb, _ = render_plane(k, (0.0, 0.0, TUM_STEP * i), size)
        img = rgb if colour else np.round(rgb.mean(axis=2)).astype(np.uint8)
        kwargs = {"restart_interval": 61} if i % 3 == 0 else {}
        if colour:
            kwargs["sampling"] = tum_sampling(i)
        write(root / "images" / f"{i:05d}.jpg", img, **kwargs)
        images.append(img)
        t = 1000.0 + 0.05 * i
        times.append(f"{i:05d} {t:.6f} 0.0200")
        result.append(f"{t:.6f} 0 0 {TUM_STEP * i / TUM_SCALE:.9f} 0 0 0 1")
    for i, options in (depth or {}).items():
        (root / "images_depth").mkdir(exist_ok=True)
        (root / "images_depth" / f"{i:05d}_d.exr").write_bytes(
            encode_exr(tum_depth(size, i), **options))
    (root / "times.txt").write_text("\n".join(times) + "\n")
    (root / "result.txt").write_text("\n".join(result) + "\n")
    (root / "pcalib.txt").write_text(" ".join(str(v) for v in range(256)) + "\n")
    (root / "camera.txt").write_text("Pinhole " + " ".join(str(v) for v in TUM_K) + " 0\n"
                                     f"{w} {h}\ncrop\n640 480\n")
    return images


def k1_hold(dev, card: str, tag: str, batch, frames: int) -> dict:
    """K1's cost-volume mode at a main path's shapes: the sources, keyframes
    and homographies the model's cost volume builds from ``batch`` (a
    reader's batch on the card), for every use_ssim, against its plain
    version run in float64 (the exact answer): the per-frame and the fused
    CVs each within the kernel budget, or within twice the float32 plain
    version's own error where that is larger (SSIM in float32 is
    ill-conditioned on smooth images: on phase 23's grey plane the float32
    plain version's per-frame CVs leave the budget). Times both in turns at
    the model's use_ssim=1."""
    import torch

    from monorec_tpu_torch.ops import plane_sweep
    from monorec_tpu_torch.ops.cost_volume import CostVolumeConfig, _sweep_sources

    images, homs = _sweep_sources(batch["keyframe"], batch["keyframe_intrinsics"],
                                  batch["keyframe_pose"], batch["frames"], batch["intrinsics"],
                                  batch["poses"], 0.0025, 0.33, CostVolumeConfig(depth_steps=D))
    keyframes = batch["keyframe"].contiguous()
    b, _, h, w = keyframes.shape
    max_err = sfcv_err = vs64 = plain_vs64 = 0.0
    for mode in MODES:
        fused, sfcv = plane_sweep.plane_sweep_cost_volume(images, keyframes, homs, 2, frames, mode)
        torch.cuda.synchronize()
        pf, psf = plane_sweep.plane_sweep_cost_volume_reference(images, keyframes, homs, 2,
                                                                frames, mode)
        e32 = [(fused - pf).abs().max().item(), (sfcv - psf).abs().max().item()]
        e64, e32_64 = [0.0, 0.0], [0.0, 0.0]  # [fused, sfcv]
        for k in range(b):  # float64 one keyframe at a time, to bound memory
            exact = plane_sweep.plane_sweep_cost_volume_reference(
                images[k * frames : (k + 1) * frames].double(), keyframes[k : k + 1].double(),
                homs[k * frames : (k + 1) * frames], 2, frames, mode)
            for i, (kern, plain, x) in enumerate(zip((fused, sfcv), (pf, psf), exact)):
                e64[i] = max(e64[i], (kern[k : k + 1] - x).abs().max().item())
                e32_64[i] = max(e32_64[i], (plain[k : k + 1] - x).abs().max().item())
        gates = [max(SAD_TOL, 2.0 * e) for e in e32_64]
        log(f"{tag} K1 cost-volume mode at B={b}, F={frames}, D={D}, {h}x{w}, use_ssim={mode}: "
            f"max|diff| fused / sfcv: kernel vs plain float64 {e64[0]:.3e} / {e64[1]:.3e} "
            f"(gates {gates[0]:.3e} / {gates[1]:.3e}); plain float32 vs float64 "
            f"{e32_64[0]:.3e} / {e32_64[1]:.3e}; kernel vs plain float32 {e32[0]:.3e} / "
            f"{e32[1]:.3e}")
        if not (fused.shape == (b, D, h, w) and sfcv.shape == (b, frames, D, h, w)
                and torch.isfinite(fused).all() and torch.isfinite(sfcv).all()
                and e64[0] <= gates[0] and e64[1] <= gates[1]):
            raise AssertionError(f"plane_sweep_cost_volume disagrees with its plain version at "
                                 f"B={b}, F={frames}, {h}x{w} (use_ssim={mode})")
        max_err, sfcv_err = max(max_err, *e32), max(sfcv_err, e32[1])
        vs64, plain_vs64 = max(vs64, *e64), max(plain_vs64, *e32_64)
        del fused, sfcv, pf, psf, exact
    kernel = lambda: plane_sweep.plane_sweep_cost_volume(  # noqa: E731
        images, keyframes, homs, 2, frames, 1)
    plain = lambda: plane_sweep.plane_sweep_cost_volume_reference(  # noqa: E731
        images, keyframes, homs, 2, frames, 1)
    k_ms, p_ms, _, turns, order = in_turns(kernel, plain, 20, 3)
    record = {"max_abs_err": max_err, "sfcv_max_abs_err": sfcv_err,
              "max_abs_err_vs_float64": vs64, "plain_max_abs_err_vs_float64": plain_vs64,
              "ms": k_ms, "plain_ms": p_ms, "library_ms": None,
              **k1_cv_bound(images, keyframes, homs, frames)}
    log(f"{tag} K1 time at B={b}, F={frames}, D={D}, {h}x{w}, use_ssim=1 ({order}): "
        f"{', '.join(f'{t:.3f}' for t in turns)} ms; kernel {k_ms:.3f} ms vs plain {p_ms:.3f} "
        f"ms, bound {record['bound_ms']:.3f} ms ({record['bound_by']}) on {card}")
    return record


def shipped_copy(work, name: str, tag: str, checkpoint, data_args: dict, **top) -> str:
    """A copy of ``configs/<name>`` with phase 19's ``checkpoint``, its data
    block's args updated by ``data_args`` and its top level by ``top`` (a
    dict updates the block of its key)."""
    from pathlib import Path

    with open(f"configs/{name}") as f:
        config = json.load(f)
    (config.get("models") or [config.get("arch")])[0]["args"]["checkpoint_location"] = [
        str(checkpoint)]
    (config.get("data_loader") or config["data_set"])["args"].update(data_args)
    for key, value in top.items():
        if isinstance(value, dict):
            config[key].update(value)
        else:
            config[key] = value
    return write_config(Path(work) / f"{tag}.json", config)


def export_run(dev, card: str, tag: str, path: str, n_frames: int) -> dict:
    """``cli.create_pointcloud`` on the config at ``path``: one K1 launch per
    frame, a PLY that parses with finite coordinates. Returns the launches,
    the points and the CLI's wall time."""
    from pathlib import Path

    import numpy as np

    from monorec_tpu_torch.cli import create_pointcloud

    with open(path) as f:
        config = json.load(f)
    reset_counts()
    t = time.perf_counter()
    create_pointcloud.main(["-c", path, "--device", str(dev)])
    wall = time.perf_counter() - t
    counts = launch_counts()
    if counts != only(plane_sweep_cost_volume=n_frames):
        raise AssertionError(f"{tag}: the export launched {counts}, expected "
                             f"plane_sweep_cost_volume once per frame ({n_frames})")
    cloud = read_ply(Path(config["output_dir"]) / config["file_name"])
    if not np.isfinite(cloud).all():
        raise AssertionError(f"{tag}: a point-cloud coordinate is not finite")
    log(f"{tag} cli.create_pointcloud, use_mask={config['use_mask']}: {len(cloud)} points from "
        f"{n_frames} frames ({max(n_frames - 4, 0)} exported), one K1 launch each, in "
        f"{wall:.3f} s (host clock, the CLI whole) on {card}")
    return {"launches": counts["plane_sweep_cost_volume"], "points": len(cloud)}


def phase_robotcar(dev, card: str, work, checkpoint) -> dict:
    """Phase 22: RobotCar through the port's CLIs from phase 19's checkpoint,
    on a tree in the SDK's layout at RobotCar's native raw size. Returns
    K1's record at the evaluation's shape, with its launches."""
    from pathlib import Path

    import numpy as np
    import torch

    from monorec_tpu_torch import config as config_mod
    from monorec_tpu_torch.cli import evaluate
    from monorec_tpu_torch.data.bayer import demosaic_gb2rgb
    from monorec_tpu_torch.data.png import read_png
    from monorec_tpu_torch.data.resize import crop_resize_bilinear
    from monorec_tpu_torch.data.robotcar import CameraModel
    from monorec_tpu_torch.eval import Evaluator
    from monorec_tpu_torch.models import MonoRec
    from monorec_tpu_torch.train.checkpoints import load_stage_checkpoints

    tag = "[22 robotcar]"
    t = time.perf_counter()
    folders = write_robotcar_tree(Path(work) / "robotcar")
    log(f"{tag} wrote a RobotCar tree ({ROBOTCAR_FRAMES} Bayer PNGs at {ROBOTCAR_SIZE[0]}x"
        f"{ROBOTCAR_SIZE[1]}, a distortion LUT, vo.csv, extrinsics, "
        f"{2 * ROBOTCAR_FRAMES - 1} LDMRS scans) in {time.perf_counter() - t:.2f} s")

    # The host's chain per raw image, as the reader runs it.
    h, w = ROBOTCAR_SIZE
    model = CameraModel(folders["model_folder"], folders["sequence_folders"][0])
    steps = {k: [] for k in ("read_png", "demosaic_gb2rgb", "undistort", "crop_resize_bilinear")}
    for path in sorted(Path(folders["sequence_folders"][0]).glob("*.png"))[:4]:
        t0 = time.perf_counter()
        raw = read_png(path)
        t1 = time.perf_counter()
        rgb = demosaic_gb2rgb(raw)
        t2 = time.perf_counter()
        undistorted = model.undistort(rgb.astype(np.float64))
        t3 = time.perf_counter()
        crop_resize_bilinear((undistorted / 256.0 * 255).astype(np.uint8), (0, 0, w, h),
                             (h // 2, w // 2))
        t4 = time.perf_counter()
        for k, dt in zip(steps, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            steps[k].append(dt * 1e3)
    log(f"{tag} host per {h}x{w} Bayer image (4 images, median): " + ", ".join(
        f"{k} {statistics.median(v):.3f} ms" for k, v in steps.items())
        + f", together {statistics.median(map(sum, zip(*steps.values()))):.3f} ms "
        f"(host clock, the host of {card})")

    # The main path: cli.evaluate on the shipped eval config, on the card.
    data = dict(folders, cutout=ROBOTCAR_CUTOUT)
    n_samples = ROBOTCAR_FRAMES - 2
    n_batches = n_samples // 4

    def eval_copy(name, **extra):
        path = shipped_copy(work, "evaluate/eval_monorec_oxrc.json", name, checkpoint,
                            dict(data, **extra),
                            evaluater={"save_dir": str(Path(work) / name), "verbosity": 0})
        return path, Path(work) / name / "log" / "Eval_monorec_oxrc" / "00"

    path, run_dir = eval_copy("oxrc_card")
    reset_counts()
    evaluate.main(["-c", path, "--device", str(dev)])
    counts = launch_counts()
    if counts != only(plane_sweep_cost_volume=n_batches):
        raise AssertionError(f"{tag} the evaluation launched {counts}, expected "
                             f"plane_sweep_cost_volume once per batch ({n_batches})")
    result = json.loads((run_dir / "results_0.json").read_text())["metrics"]
    log(f"{tag} cli.evaluate on the card: {n_batches} batches of 4 at 320x640, one K1 "
        f"cost-volume launch each; valid_batches {result['valid_batches']}, num_samples "
        f"{result['num_samples']}; " + ", ".join(
            f"{k} {result[k]:.6f}" for k in result if k.endswith("_metric")))
    if not (len(result["metrics"]) == 7 and all(math.isfinite(v) for v in result["metrics"])
            and result["valid_batches"] == n_batches and result["num_samples"] == n_samples):
        raise AssertionError(f"{tag} the evaluation's results are off: {result}")

    # The first batch on the card and on the CPU (the plain versions).
    first = {}
    for where, device in (("card", str(dev)), ("cpu", "cpu")):
        path, run_dir = eval_copy(f"oxrc_first_{where}", start=0, end=4)
        evaluate.main(["-c", path, "--device", device])
        first[where] = json.loads((run_dir / "results_0.json").read_text())["metrics"]
    g, c = np.asarray(first["card"]["metrics"]), np.asarray(first["cpu"]["metrics"])
    rel = np.abs(g - c) / np.where(c == 0, 1.0, np.abs(c))
    log(f"{tag} first batch, card vs CPU: max relative diff {rel.max():.3e} (metrics "
        f"{', '.join(f'{v:.6f}' for v in g)} vs {', '.join(f'{v:.6f}' for v in c)})")
    if not np.isclose(g, c, rtol=EVAL_RTOL, atol=0).all() or first["card"]["valid_batches"] != 1:
        raise AssertionError(f"{tag} the card's evaluation disagrees with the CPU's")

    # The eval forward per batch, and the evaluate loop's pace and busy share.
    with open(path) as f:
        config = json.load(f)
    model_cfg, locations = config_mod.build_models(config)[0]
    net = MonoRec(model_cfg, dev)
    load_stage_checkpoints(net, locations)
    net.eval()
    loader = config_mod.build_data_loader({"type": "OxfordRobotCarDataloader",
                                           "args": dict(config["data_loader"]["args"],
                                                        start=0, end=n_samples)}, dev)
    batch = next(iter(loader))
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: net(batch), 10)
    log(f"{tag} eval forward, batch 4 at 320x640, D={D}, F=2: {fwd_ms:.3f} ms per batch (CUDA "
        f"events, 10 calls) on {card}")
    evaluator = Evaluator(net, config_mod.build_metrics(config), config, loader,
                          Path(work) / "oxrc_timing")
    torch.cuda.synchronize()
    t = time.perf_counter()
    evaluator.eval()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    window_ms, busy_ms = busy_window(evaluator.eval)
    log(f"{tag} evaluate loop from the tree: {n_samples} keyframes in {wall:.3f} s = "
        f"{n_samples / wall:.3f} keyframes/s (host clock); profiled pass: device busy "
        f"{busy_ms:.1f} of {window_ms:.1f} ms = {100 * busy_ms / window_ms:.1f}% on {card}")
    record = k1_hold(dev, card, tag, batch, 2)
    del net, batch, evaluator
    torch.cuda.empty_cache()

    # The export, mask on and off.
    points = {}
    for use_mask in (True, False):
        path = shipped_copy(work, "test/pointcloud_monorec_oxrc.json", f"oxrc_pc_{use_mask}",
                            checkpoint, data, output_dir=str(Path(work) / "pointclouds"),
                            file_name=f"oxrc_mask_{use_mask}.ply", use_mask=use_mask, max_d=400)
        run = export_run(dev, card, tag, path, n_samples)
        points[use_mask] = run["points"]
    if points[False] == 0 or points[True] > points[False]:
        raise AssertionError(f"{tag} point counts off: {points}")
    return dict(record, launches=counts["plane_sweep_cost_volume"],
                pointcloud_launches=run["launches"])


def phase_tum(dev, card: str, work, checkpoint) -> dict:
    """Phase 23: TUM mono VO through ``cli.create_pointcloud`` from phase
    19's checkpoint, on a sequence of greyscale JPEGs at TUM's native size.
    Returns K1's record at F=4, with its launches."""
    from pathlib import Path

    import numpy as np
    import torch

    from monorec_tpu_torch.data.jpeg import read_jpeg
    from monorec_tpu_torch.data.loader import DataLoader
    from monorec_tpu_torch.data.tum_mono_vo import TUMMonoVODataset

    tag = "[23 tum mono vo]"
    tree = Path(work) / "tum"
    t = time.perf_counter()
    images = write_tum_tree(tree)
    log(f"{tag} wrote a TUM mono VO sequence ({TUM_FRAMES} greyscale JPEGs at {TUM_SIZE[0]}x"
        f"{TUM_SIZE[1]}, quality 90, every third with restart markers) in "
        f"{time.perf_counter() - t:.2f} s")
    decode, diffs = [], []
    for i, path in enumerate(sorted((tree / "images").glob("*.jpg"))[:4]):
        t = time.perf_counter()
        img = read_jpeg(path)
        decode.append((time.perf_counter() - t) * 1e3)
        diffs.append(float(np.abs(img.astype(np.int64) - images[i]).mean()))
    log(f"{tag} read_jpeg per {TUM_SIZE[0]}x{TUM_SIZE[1]} image (4 images): "
        f"{', '.join(f'{v:.1f}' for v in decode)} ms, median {statistics.median(decode):.3f} ms "
        f"(host clock, the host of {card}); mean |decoded - encoded source| "
        f"{', '.join(f'{v:.3f}' for v in diffs)} levels")
    if max(diffs) > JPEG_LEVELS:
        raise AssertionError(f"{tag} the decoded images are off the encoded ones: {diffs}")

    # The main path: the shipped export config at F=4, 480x640.
    n_samples = TUM_FRAMES - 4
    path = shipped_copy(work, "test/pointcloud_monorec_tmvo.json", "tmvo_pc", checkpoint,
                        {"dataset_dir": str(tree)}, end=n_samples, use_mask=False, max_d=400,
                        output_dir=str(Path(work) / "pointclouds"))
    run = export_run(dev, card, tag, path, n_samples)
    if run["points"] == 0:
        raise AssertionError(f"{tag} the unmasked cloud is empty")
    with open(path) as f:
        args = json.load(f)["data_set"]["args"]
    batch = next(iter(DataLoader(TUMMonoVODataset(**args), 1, shuffle=False, device=dev)))
    record = k1_hold(dev, card, tag, batch, 4)
    del batch
    torch.cuda.empty_cache()
    return dict(record, launches=run["launches"])


OPT_RTOL, OPT_ATOL = 1e-6, 1e-7  # tests/test_torch_optimizers.py
# Each optimizer with its options for phase 24's card-vs-CPU check.
OPTIMIZER_ARGS = {"Adam": {"amsgrad": True}, "AdamW": {},
                  "SGD": {"momentum": 0.9, "nesterov": True},
                  "RMSprop": {"momentum": 0.5, "centered": True}, "Adagrad": {}, "Adadelta": {},
                  "Adamax": {}, "RAdam": {}, "NAdam": {}}


def torchvision_resnet(seed: int, layers: int = 18, counters: bool = True) -> dict:
    """A torchvision-keyed ResNet-``layers`` state_dict (``conv1.weight``,
    ``layer1.0.bn1.running_mean``, ..., ``fc.*``) with seeded values at
    ImageNet scale: He-initialised convs, BatchNorm near identity, and with
    ``counters`` BatchNorm's ``num_batches_tracked``."""
    import numpy as np
    import torch

    from monorec_tpu_torch.models.resnet import ResNetEncoder, encoder_channels

    rng = np.random.default_rng(seed)
    keys = ResNetEncoder(layers).encoder.state_dict()
    sd = {}
    for k, v in keys.items():
        if k.endswith("num_batches_tracked"):
            if counters:
                sd[k] = torch.tensor(int(rng.integers(1, 1000)))
            continue
        if v.dim() == 4:
            value = rng.normal(0, np.sqrt(2.0 / np.prod(v.shape[1:])), v.shape)
        elif k.endswith("running_var") or k.endswith(".weight"):
            value = rng.uniform(0.5, 1.5, v.shape)
        else:  # bias, running_mean
            value = rng.normal(0, 0.1, v.shape)
        sd[k] = torch.from_numpy(value.astype(np.float32))
    fc_in = encoder_channels(layers)[-1]
    sd["fc.weight"] = torch.from_numpy(rng.normal(0, 0.01, (1000, fc_in)).astype(np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def bits_equal(a, b) -> bool:
    """``a`` and ``b`` hold the same bits (floats compared as integers)."""
    import torch

    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def optimizers_card_vs_cpu(dev) -> dict:
    """Each optimizer of ``train/state.py`` (with weight decay, a cosine
    schedule and ``OPTIMIZER_ARGS``) on the card and on the CPU, on the same
    parameters and 5 gradients: the largest |card - cpu| / (atol + rtol
    |cpu|) over the parameters, by name (at most 1 passes)."""
    import torch

    from monorec_tpu_torch.train.state import OPTIMIZERS, make_optimizer

    gen = torch.Generator().manual_seed(24)
    params = [0.3 * torch.randn(64, 33, generator=gen), 0.3 * torch.randn(257, generator=gen)]
    grads = [[s * torch.randn(p.shape, generator=gen) for p in params]
             for s in (3.0, 0.1, 0.5, 1.0, 2.0)]
    sched = {"type": "CosineAnnealingLR", "args": {"T_max": 2}}
    ratios = {}
    for kind in OPTIMIZERS:
        cfg = {"type": kind, "args": {"lr": 1e-2, "weight_decay": 0.01, **OPTIMIZER_ARGS[kind]}}
        final = []
        for where in ("cpu", dev):
            ps = [p.clone().to(where).requires_grad_() for p in params]
            opt = make_optimizer(ps, cfg, sched, steps_per_epoch=2)
            for g in grads:
                for p, x in zip(ps, g):
                    p.grad = x.to(where)
                opt.step()
            final.append([p.detach().cpu() for p in ps])
        ratios[kind] = max(((a - b).abs() / (OPT_ATOL + OPT_RTOL * b.abs())).max().item()
                           for a, b in zip(final[1], final[0]))
    return ratios


def stage1_cli_config(work, batch_size: int, steps: int, log_step: int, **trainer) -> dict:
    """``monorec_depth.json`` with synthetic loaders at HxW, F frames
    (``steps`` batches to train on, one to validate), ``steps`` steps of one
    epoch, logs under ``work``, the exact policy, and ``trainer`` set."""
    with open("configs/train/monorec/monorec_depth.json") as f:
        config = json.load(f)
    data = {"frame_count": F, "target_image_size": [H, W], "batch_size": batch_size}
    config["data_loader"] = {"type": "SyntheticSweepDataloader",
                             "args": {**data, "length": steps * batch_size, "shuffle": True}}
    config["val_data_loader"] = {"type": "SyntheticSweepDataloader",
                                 "args": {**data, "length": batch_size, "shuffle": False,
                                          "seed": 1}}
    config["trainer"].update(epochs=1, len_epoch=steps, log_step=log_step, save_dir=str(work),
                             **trainer)
    config["precision"] = "exact"
    return config


def phase_stage1_cli(dev, card: str, run_dir) -> dict:
    """Phase 24: stage 1 through ``cli.train.main`` (the main path) with an
    ImageNet encoder file, AdamW and CosineAnnealingLR, module timing and
    TensorBoard. Returns the launch counts of the run."""
    from pathlib import Path

    import torch

    from monorec_tpu_torch.cli import train as train_cli
    from monorec_tpu_torch.precision import set_precision
    from monorec_tpu_torch.train import Trainer
    from monorec_tpu_torch.train.loggers import read_scalars

    tag = "[24 stage-1 CLI]"
    work = Path(run_dir) / "stage1_cli"
    work.mkdir()
    weights = torchvision_resnet(24)
    torch.save(weights, work / "resnet18-seeded.pth")
    encoder = {f"_feature_extractor.encoder.{k}": v.to(dev) for k, v in weights.items()
               if not k.startswith("fc.")}

    log_step = 2
    config = stage1_cli_config(work, B, TRAIN_STEPS, log_step, module_timing=True,
                               tensorboard=True)
    config["arch"]["args"]["imagenet_weights"] = str(work / "resnet18-seeded.pth")
    config["optimizer"] = {"type": "AdamW", "args": {"lr": 1e-4, "weight_decay": 0.01}}
    config["lr_scheduler"] = {"type": "CosineAnnealingLR", "args": {"T_max": 2, "eta_min": 1e-6}}
    path = write_config(work / "monorec_depth_cli.json", config)

    def encoder_is_the_file(model) -> bool:
        state = model.state_dict()
        return all(bits_equal(state[k], v) for k, v in encoder.items())

    built = []

    class Recorded(Trainer):
        """The CLI's trainer, noting itself and whether its freshly built
        model holds the file's encoder."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append((self, encoder_is_the_file(self.model)))

    set_precision("exact", expect_rebuild=True)
    reset_counts()
    train_cli.main(["-c", path, "--device", str(dev)], trainer_cls=Recorded)  # the main path
    counts = launch_counts()
    (trainer, after_build), = built
    after_steps = encoder_is_the_file(trainer.model)
    n_val = len(trainer.valid_data_loader)
    log_steps = list(range(0, TRAIN_STEPS, log_step))
    expected = only(plane_sweep_cost_volume=TRAIN_STEPS + n_val + 2 * len(log_steps),
                    grid_warp=n_val, grid_warp_jac=TRAIN_STEPS,
                    photo_error_fwd=2 * (TRAIN_STEPS + n_val), photo_error_bwd=TRAIN_STEPS)
    scalars = read_scalars(trainer.run_dir / "tb" / "metrics.jsonl")
    modules = ("cv", "resnet", "depth")  # pretrain mode 1 has no MaskModule
    times = {m: [scalars.get(s, {}).get(f"{m}_module_time", math.nan) for s in log_steps]
             for m in modules}
    timed_steps = sorted(s for s, v in scalars.items()
                         if any(k.endswith("_module_time") for k in v))
    losses = [scalars.get(s, {}).get("loss", math.nan) for s in range(TRAIN_STEPS)]
    info_log = (trainer.run_dir / "info.log").read_text()
    tb = ("event files written" if trainer.writer.tensorboard
          else "no tensorboard package: metrics.jsonl only")
    log(f"{tag} cli.train.main, monorec_depth.json with imagenet_weights (a seeded "
        f"torchvision-keyed ResNet-18 file), AdamW under CosineAnnealingLR, module_timing, "
        f"tensorboard ({tb}), "
        f"B={B}, {H}x{W}, F={F}, D={D}, {TRAIN_STEPS} steps + {n_val} validation batch(es): "
        f"encoder bit-equal to the file after the build {after_build}, after the steps "
        f"{after_steps}; loss/train {', '.join(f'{x:.5f}' for x in losses)}; module times at "
        f"steps {timed_steps}; launches { {k: v for k, v in counts.items() if v} } (expected "
        f"the same, every other kernel 0: K1 also twice per log step for the timing)")
    log(f"{tag} module times at B={B}, {H}x{W}, D={D}, F={F} (the trainer's module_timing: host "
        f"clock fenced by torch.cuda.synchronize, one run after an untimed one, at steps "
        f"{log_steps}): " + "; ".join(
            f"{m} {', '.join(f'{t:.3f}' for t in v)} ms, median {statistics.median(v):.3f} ms"
            for m, v in times.items()) + f" on {card}")
    if not (after_build and after_steps and counts == expected
            and all(math.isfinite(x) for x in losses)
            and timed_steps == log_steps and all(t > 0 for v in times.values() for t in v)
            and not any("mask_module_time" in scalars[s] for s in log_steps)
            and "cv=" in info_log and not (trainer.run_dir / "train_log.jsonl").exists()):
        raise AssertionError(f"{tag} the stage-1 CLI run failed its checks")

    ratios = optimizers_card_vs_cpu(dev)
    log(f"{tag} optimizers on the card vs the CPU, 5 steps (weight decay 0.01, "
        f"CosineAnnealingLR), largest |diff| / ({OPT_ATOL:g} + {OPT_RTOL:g} |cpu|): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
    if not all(v <= 1.0 for v in ratios.values()):
        raise AssertionError(f"{tag} an optimizer on the card disagrees with the CPU")
    del trainer, built
    return counts


# Phase 25: the model variants, each built from ``arch.args`` through
# ``config.build_model_config`` as the CLIs build it.
VARIANTS = (
    ("resnet18", {}),  # the flagship, the split's baseline
    ("resnet34", {"resnet_layers": 34}),
    ("resnet50", {"resnet_layers": 50}),
    ("resnet101", {"resnet_layers": 101}),
    ("resnet152", {"resnet_layers": 152}),
    ("resnet50 simple_mask", {"resnet_layers": 50, "simple_mask": True}),
    ("simple_mask mode 2", {"simple_mask": True, "pretrain_mode": 2}),
    ("no_cv use_stereo", {"no_cv": True, "use_stereo": True}),
    ("mask_use_cv/feats off", {"mask_use_cv": False, "mask_use_feats": False}),
)
VARIANT_TIMINGS = 5
SPLIT_REPS = 3
VARIANT_STEPS, VARIANT_B = 4, 4


def variant_split(model, batch) -> tuple:
    """Mean CUDA-event ms of each module the forward runs on ``batch``,
    each alone (``cuda_ms``: one untimed call, then ``SPLIT_REPS``):
    the cost volume (0 under ``no_cv``, whose volumes are zeros), the
    encoder, the mask module and one DepthModule pass, with the number of
    DepthModule passes the forward makes."""
    import torch

    cfg = model.config
    keyframe = batch["keyframe"]
    b, _, h, w = keyframe.shape
    ms = {}
    with torch.inference_mode():
        if cfg.no_cv:
            n_frames = batch["frames"].shape[1] + (1 if cfg.use_stereo else 0)
            sfcv = keyframe.new_zeros(b, n_frames, cfg.cv_depth_steps, h, w)
            cv = keyframe.new_zeros(b, cfg.cv_depth_steps, h, w)
            ms["cv"] = 0.0
        else:
            cv, sfcv = model.cost_volume(batch)
            ms["cv"] = cuda_ms(lambda: model.cost_volume(batch), SPLIT_REPS)
        feats = model.features(keyframe)
        ms["resnet"] = cuda_ms(lambda: model.features(keyframe), SPLIT_REPS)
        pre = model.depth(cv, keyframe, feats)[0] if cfg.has_depth_module else None
        if cfg.simple_mask:
            ms["mask"] = cuda_ms(lambda: model.mask(sfcv, feats, False, None, keyframe, pre),
                                 SPLIT_REPS)
        else:
            ms["mask"] = cuda_ms(lambda: model.mask(sfcv, feats), SPLIT_REPS)
        ms["depth"] = (cuda_ms(lambda: model.depth(cv, keyframe, feats), SPLIT_REPS)
                       if cfg.has_depth_module else 0.0)
    passes = int(cfg.simple_mask) + int(cfg.pretrain_mode != 2)
    return ms, passes


def variant_forwards(dev, card: str) -> int:
    """Phase 25 A: each variant's forward through the inference entry point
    at B=8 (the main path: K1's launches per forward), timed and split into
    its modules, and at B=1 on the card against the CPU. Returns K1's
    launches over all variants."""
    import torch

    from monorec_tpu_torch.cli.inference_example import build_model, make_requests, serve
    from monorec_tpu_torch.config import build_model_config
    from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch

    tag = "[25 variants]"
    requests = make_requests(VARIANT_TIMINGS, B, H, W, F, dev, seed=250)
    k1_total = 0
    for label, args in VARIANTS:
        cfg = build_model_config(dict(args, cv_depth_steps=D))
        model = build_model(cfg, dev, seed=0)
        serve(model, requests[:1])
        reset_counts()
        _, times = serve(model, requests)  # the main path
        counts = launch_counts()
        per_forward = 0 if cfg.no_cv else 1
        k1_total += counts["plane_sweep_cost_volume"]
        split, passes = variant_split(model, requests[0])
        unets = split["mask"] + passes * split["depth"]
        modules = split["cv"] + split["resnet"] + unets
        nb = make_batch(1, H, W, F, stereo=cfg.use_stereo, mask=False, seed=7, tz=0.5)
        with torch.inference_mode():
            out_g = model(batch_to_torch(nb, dev))
            out_c = build_model(cfg, "cpu", seed=0)(batch_to_torch(nb, "cpu"))
        diffs = {}
        for key, atol, rtol in (("cv_mask", MASK_ATOL, 0.0),
                                ("result", RESULT_ATOL, RESULT_RTOL)):
            g, c = out_g[key].cpu(), out_c[key]
            diffs[key] = (g - c).abs().max().item()
            if not (g.shape == c.shape == (1, 1, H, W) and torch.isfinite(g).all()
                    and within(g, c, rtol, atol).all()):
                raise AssertionError(f"{tag} {label}: card vs CPU {key} off by {diffs[key]:.3e}")
        log(f"{tag} {label} ({args}): median forward of {VARIANT_TIMINGS} (CUDA events) at "
            f"B={B}, {H}x{W}, D={D}, F={F}, exact: {statistics.median(times):.3f} ms "
            f"({', '.join(f'{t:.3f}' for t in times)}) on {card}; K1 launches per forward "
            f"{counts['plane_sweep_cost_volume'] / VARIANT_TIMINGS:g}; B=1 card vs CPU "
            f"max|diff| cv_mask {diffs['cv_mask']:.3e}, result {diffs['result']:.3e}")
        log(f"{tag} {label} split at B={B} (mean of {SPLIT_REPS} CUDA-event calls each, alone): "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f" ms, depth passes {passes}; modules together {modules:.3f} ms of the "
            f"{statistics.median(times):.3f} ms forward; U-Nets (mask + {passes} x depth) "
            f"{unets:.3f} ms = {100 * unets / modules:.1f}% of the modules, encoder "
            f"{100 * split['resnet'] / modules:.1f}%, cost volume "
            f"{100 * split['cv'] / modules:.1f}% on {card}")
        if not all(math.isfinite(v) and v >= 0 for v in split.values()):
            raise AssertionError(f"{tag} {label}: the module split failed: {split}")
        if counts != only(plane_sweep_cost_volume=per_forward * VARIANT_TIMINGS):
            raise AssertionError(f"{tag} {label}: the forwards launched {counts}, expected "
                                 f"plane_sweep_cost_volume {per_forward} per forward")
        del model, out_g, out_c
        torch.cuda.empty_cache()
    return k1_total


def variant_training(dev, card: str, run_dir) -> dict:
    """Phase 25 B: ``cli.train.main`` on a ResNet-50 simple-mask model in
    pretrain mode 0 with ``module_timing``; returns the launch counts of
    the run."""
    from pathlib import Path

    import torch

    from monorec_tpu_torch.cli import train as train_cli
    from monorec_tpu_torch.precision import set_precision
    from monorec_tpu_torch.train import Trainer
    from monorec_tpu_torch.train.loggers import read_scalars

    tag = "[25 variants]"
    work = Path(run_dir) / "variants"
    work.mkdir()
    log_step = 2
    config = stage1_cli_config(work, VARIANT_B, VARIANT_STEPS, log_step, module_timing=True,
                               tensorboard=False)
    config["arch"]["args"].update(resnet_layers=50, simple_mask=True, pretrain_mode=0)
    path = write_config(work / "monorec_r50_simple_mask.json", config)

    built = []

    class Recorded(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    set_precision("exact", expect_rebuild=True)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    train_cli.main(["-c", path, "--device", str(dev)], trainer_cls=Recorded)  # the main path
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    trainer, = built
    scalars = read_scalars(trainer.run_dir / "tb" / "metrics.jsonl")
    log_steps = list(range(0, VARIANT_STEPS, log_step))
    losses = [scalars.get(s, {}).get("loss", math.nan) for s in range(VARIANT_STEPS)]
    timed = {s: sorted(k for k in scalars.get(s, {}) if k.endswith("_module_time"))
             for s in log_steps}
    want_keys = ["cv_module_time", "depth_module_time", "resnet_module_time"]

    batches = [b for _, b in zip(range(2), trainer.data_loader)]
    alpha = trainer._alpha(1)
    times = [t for t, _ in step_times(trainer, batches, alpha, VARIANT_STEPS, "exact")]
    split = step_split(trainer, batches, alpha, VARIANT_STEPS)
    log(f"{tag} cli.train.main, ResNet-50 simple_mask pretrain mode 0 (monorec_depth.json's "
        f"loss), B={VARIANT_B}, {H}x{W}, D={D}, F={F}, {VARIANT_STEPS} steps: loss/train "
        f"{', '.join(f'{x:.5f}' for x in losses)}; module-time keys at steps {log_steps}: "
        f"{timed}; launches { {k: v for k, v in counts.items() if v} }; peak memory "
        f"{peak:.2f} GiB")
    log(f"{tag} step (CUDA events, {VARIANT_STEPS} steps after the run): median "
        f"{statistics.median(times):.3f} ms ({', '.join(f'{t:.2f}' for t in times)}) = "
        f"{VARIANT_B * 1e3 / statistics.median(times):.2f} keyframes/s; split, medians of "
        f"{VARIANT_STEPS}: " + ", ".join(f"{n} {t:.3f}" for n, t in zip(STEP_NAMES, split))
        + f" ms; module times " + "; ".join(
            f"{k.removesuffix('_module_time')} "
            + ", ".join(f"{scalars[s][k]:.3f}" for s in log_steps) + " ms"
            for k in want_keys) + f" on {card}")
    if not (all(math.isfinite(x) for x in losses)
            and all(keys == want_keys for keys in timed.values())
            and all(counts[k] > 0 for k in ("plane_sweep_cost_volume", "grid_warp_jac",
                                            "photo_error_fwd", "photo_error_bwd"))):
        raise AssertionError(f"{tag} the ResNet-50 simple-mask training run failed its checks")
    del trainer, built, batches
    return counts


def phase_variants(dev, card: str, run_dir) -> dict:
    """Phase 25: the model variants' forwards and a ResNet-50 simple-mask
    training run. Returns the launch counts of both main paths."""
    import torch

    t0 = time.perf_counter()
    k1 = variant_forwards(dev, card)
    torch.cuda.empty_cache()
    counts = variant_training(dev, card, run_dir)
    torch.cuda.empty_cache()
    log(f"[25 variants] phase time {time.perf_counter() - t0:.1f} s")
    return {"forward_k1": k1, "train": counts}


# ---- phase 26: the KITTI user's path -----------------------------------------

KITTI_PATH_FRAMES = 20  # stage 2's window keeps frames 1-18; the index drops 4 of them
KITTI_PATH_B = 4  # monorec_mask.json's batch_size
GOLDEN_INDEX = 4  # keyframe 9 (the annotated depth's offset of 5), sources 8 and 10
GOLDEN_LEVELS, GOLDEN_SHARE = 1, 0.999  # depth.png card vs CPU: 1 level on 99.9% of pixels
RAW_DRIVE = "2011_09_30_drive_0027"  # KITTI raw drive of odometry sequence 07


def moving(i: int) -> bool:
    """Whether frame ``i`` of phase 26's tree has a moving object."""
    return i % 4 != 3


class WaitTimed:
    """A loader whose iterator records each wait for a batch (host clock)."""

    def __init__(self, loader):
        self.loader, self.waits = loader, []

    def __iter__(self):
        it = iter(self.loader)
        try:
            while True:
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.waits.append(time.perf_counter() - t)
                yield batch
        finally:
            it.close()


def prepare_kitti(tree, work) -> None:
    """Phase 26's preparation through ``tools.preprocess_kitti``: the
    annotated depth through ``extract-depth`` from a zip in KITTI's raw
    layout (byte-equal), ``mvobj-index`` and ``dist-index``, each JSON held
    to what this function computes from the tree."""
    import shutil
    import zipfile
    from pathlib import Path

    import numpy as np

    from monorec_tpu_torch.tools import preprocess_kitti

    seq = Path(tree) / "sequences" / "07"
    zpath = Path(work) / "depth_annotated.zip"
    depth = sorted((seq / "image_depth_annotated").glob("*.png"))
    raw = f"train/{RAW_DRIVE}_sync/proj_depth/groundtruth"
    with zipfile.ZipFile(zpath, "w") as z:
        for p in depth:
            z.write(p, f"{raw}/image_02/{int(p.stem):010d}.png")
        z.write(depth[0], f"{raw}/image_03/0000000000.png")
        z.write(depth[1], "val/2011_09_26_drive_0001_sync/proj_depth/groundtruth/image_02/"
                          "0000000001.png")
    out = Path(work) / "extracted"
    t = time.perf_counter()
    preprocess_kitti.main(["extract-depth", "-i", str(zpath), "-o", str(out)])
    extract_s = time.perf_counter() - t
    got = sorted(p.relative_to(out).as_posix() for p in out.rglob("*.png"))
    same = all((out / "sequences/07/image_depth_annotated" / p.name).read_bytes() == p.read_bytes()
               for p in depth)
    if got != [f"sequences/07/image_depth_annotated/{p.name}" for p in depth] or not same:
        raise AssertionError(f"extract-depth wrote {got}")

    # The moving-object masks at the target size, a blob on the frames
    # ``moving`` names; the DSO depth the stage-2 config reads.
    (seq / "mvobj_mask").mkdir(exist_ok=True)
    (seq / "image_depth_sparse").mkdir(exist_ok=True)
    for p in depth:
        i = int(p.stem)
        mask = np.zeros((H, W), np.uint8)
        if moving(i):
            mask[H // 4 : H // 2, W // 3 : W // 2] = 1
        np.save(seq / "mvobj_mask" / f"{i:06d}.npy", mask)
        shutil.copy(p, seq / "image_depth_sparse" / p.name)
    preprocess_kitti.main(["mvobj-index", "-d", str(tree), "-s", "07"])
    index = json.loads((seq / "mvobj_index_mask.json").read_text())
    if index != {str(int(p.stem)): moving(int(p.stem)) for p in depth}:
        raise AssertionError(f"mvobj-index wrote {index}")

    # dist-index: windows of frames c-1..c+1 for c in 5..N-6 (the annotated
    # depth's offset), spread 2 x FRAME_STEP = 1.6 m and no rotation.
    poses = np.loadtxt(Path(tree) / "poses_dvso" / "07.txt").reshape(-1, 3, 4)
    dist = {}
    for threshold in (0.8, 2.0):
        t = time.perf_counter()
        preprocess_kitti.main(["dist-index", "-d", str(tree), "-s", "07", "-t", str(threshold)])
        dist[threshold] = time.perf_counter() - t
        want = {}
        for c in range(5, len(poses) - 5):
            spread = np.ptp(poses[c - 1 : c + 2, :, 3], axis=0)
            fwd = np.ptp(poses[c - 1 : c + 2, :, 2], axis=0)
            want[str(c)] = bool(np.linalg.norm(spread) > threshold
                                or np.linalg.norm(fwd) > 0.05)
        got = json.loads((seq / "index_mask_dist.json").read_text())
        if got != want or not (all(got.values()) if threshold < 1.6 else not any(got.values())):
            raise AssertionError(f"dist-index -t {threshold} wrote {got}, expected {want}")
    log(f"[26 KITTI path] extract-depth: {len(depth)} annotated depth maps from a zip in KITTI's "
        f"raw layout (drive {RAW_DRIVE}, plus a cam-3 and an unmapped drive's entry), byte-equal, "
        f"in {extract_s:.3f} s; mvobj-index: {sum(index.values())} of {len(index)} frames moving, "
        f"as written; dist-index over {len(want)} samples (reads poses, decodes no image): "
        f"{dist[0.8] * 1e3:.3f} ms at -t 0.8 (all kept), {dist[2.0] * 1e3:.3f} ms at -t 2.0 (none "
        f"kept) (host clock)")


def kitti_stage2(dev, card: str, work, tree, stage1_checkpoint, num_workers: int) -> dict:
    """Stage 2 through the trainer of ``cli/train_monorec.py`` on a copy of
    ``monorec_mask.json`` pointed at phase 26's tree (its index mask, colour
    augmentation and batch size kept; ``num_workers`` as given), one epoch.
    Its ``depth_cp_loc`` names phase 10's checkpoint, as a user's stage 2
    names stage 1's. Returns the launch counts of the run."""
    from pathlib import Path

    import torch

    from monorec_tpu_torch.cli.train_monorec import build_trainer
    from monorec_tpu_torch.precision import set_precision

    tag = f"[26 KITTI path, {num_workers} worker{'s' if num_workers > 1 else ''}]"
    with open("configs/train/monorec/monorec_mask.json") as f:
        config = json.load(f)
    config["arch"]["args"]["depth_cp_loc"] = [str(stage1_checkpoint)]
    config["data_loader"]["args"].update(dataset_dir=str(tree), sequences=["07"],
                                         target_image_size=[H, W], num_workers=num_workers)
    kept = sum(moving(i) for i in range(1, KITTI_PATH_FRAMES - 1))
    n_steps = kept // KITTI_PATH_B
    config["trainer"].update(epochs=1, len_epoch=n_steps, log_step=1, tensorboard=False,
                             save_dir=str(Path(work) / f"stage2_kitti_{num_workers}"))
    set_precision("exact", expect_rebuild=True)
    trainer = build_trainer(config, dev)
    loader = trainer.data_loader
    if not (len(loader.dataset) == kept and len(loader) == n_steps and n_steps >= 2
            and loader.num_workers == num_workers and trainer.valid_data_loader is None):
        raise AssertionError(f"{tag} the loader holds {len(loader.dataset)} samples in "
                             f"{len(loader)} batches ({loader.num_workers} workers); the index "
                             f"keeps {kept}")
    trainer.data_loader = timed = WaitTimed(loader)
    step_s = []
    train_step = trainer.train_step

    def timed_step(batch, alpha):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(batch, alpha)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    trainer.train_step = timed_step
    reset_counts()
    t = time.perf_counter()
    trainer.train()
    wall = time.perf_counter() - t
    counts = launch_counts()
    losses = [r["loss"] for r in train_log(trainer.run_dir)]
    expected = only(plane_sweep_cost_volume=n_steps, grid_warp=STAGE2_CROPS * n_steps)
    log(f"{tag} stage 2 (monorec_mask.json on the tree: use_index_mask mvobj_index_mask, "
        f"colour augmentation, B={KITTI_PATH_B}, {H}x{W} from {KITTI_SIZE[0]}x{KITTI_SIZE[1]} "
        f"PNGs, stereo and DSO depth read; depth_cp_loc phase 10's checkpoint, of which a "
        f"mode-2 model takes nothing: it has no depth module): {len(loader)} batches of "
        f"{kept} indexed samples, {n_steps} steps in {wall:.3f} s = {wall / n_steps * 1e3:.1f} ms "
        f"a step; train step (host clock, synchronized) "
        + ", ".join(f"{x * 1e3:.1f}" for x in step_s) + " ms; loader wait "
        + ", ".join(f"{x * 1e3:.1f}" for x in timed.waits)
        + f" ms (mean {statistics.mean(timed.waits) * 1e3:.1f} ms a step); losses "
        + ", ".join(f"{x:.5f}" for x in losses)
        + f"; launches { {k: v for k, v in counts.items() if v} } on {card}")
    if not (len(losses) == n_steps and all(math.isfinite(x) for x in losses)
            and counts == expected):
        raise AssertionError(f"{tag} stage 2 on the KITTI tree failed its checks "
                             f"(launches expected {expected})")
    del trainer, loader, timed
    torch.cuda.empty_cache()
    return counts


def reference_copies(checkpoint, work) -> dict:
    """Phase 19's checkpoint as the reference's trainer saves one (its
    ``base/base_trainer.py``): the keys under ``module.``, ``arch``
    ``DataParallel`` and ``config`` a ``parse_config.ConfigParser`` with
    ``PosixPath`` folders, a class the phase makes in a module of that name
    that exists only for the ``torch.save``; and a bare state dict in the
    legacy (before torch 1.6) format. Returns their paths by name."""
    import collections
    import pathlib
    import types
    from pathlib import Path

    import torch

    from monorec_tpu_torch.train.checkpoints import load_checkpoint

    payload = load_checkpoint(checkpoint, "cpu")
    module = types.ModuleType("parse_config")

    class ConfigParser:
        def __init__(self, config, save_dir):
            self._config = collections.OrderedDict(config)
            self.resume = None
            self._save_dir = pathlib.PosixPath(save_dir) / "models"
            self._log_dir = pathlib.PosixPath(save_dir) / "log"

    ConfigParser.__module__, ConfigParser.__qualname__ = "parse_config", "ConfigParser"
    module.ConfigParser = ConfigParser
    paths = {"reference": Path(work) / "reference_format.pth",
             "bare": Path(work) / "bare_state_dict.pth"}
    sys.modules["parse_config"] = module
    try:
        torch.save({"arch": "DataParallel", "epoch": payload["epoch"],
                    "state_dict": {f"module.{k}": v for k, v in payload["state_dict"].items()},
                    "optimizer": payload["optimizer"], "monitor_best": payload["monitor_best"],
                    "config": ConfigParser(payload["config"], work)}, paths["reference"])
    finally:
        del sys.modules["parse_config"]
    torch.save(payload["state_dict"], paths["bare"], _use_new_zipfile_serialization=False)
    return paths


def phase_golden_sample(dev, card: str, work, tree, checkpoint) -> int:
    """``cli.inference_example --data`` on phase 26's tree from phase 19's
    checkpoint on the card, and from its copy in the reference's save form
    (``reference_copies``); their three PNGs read back, ``depth.png`` held
    to a CPU forward of the same sample normalised the same way. The model
    loaded from each copy (and from the bare state dict) holds the same
    tensors as from the port's file. Returns K1's launches (one per
    forward: the warm-up and the timed one, per file)."""
    import contextlib
    import io
    from pathlib import Path

    import numpy as np
    import torch

    from monorec_tpu_torch.cli import inference_example as ie
    from monorec_tpu_torch.data.png import read_png
    from monorec_tpu_torch.data.synthetic import batch_to_torch

    copies = reference_copies(checkpoint, work)
    own = ie.build_model(ie.model_config(D), "cpu", checkpoint=checkpoint).state_dict()
    for name, path in copies.items():
        # Seed 1: a tensor the file did not fill would differ.
        got = ie.build_model(ie.model_config(D), "cpu", seed=1, checkpoint=path).state_dict()
        same = [k for k, v in own.items() if torch.equal(got[k], v)]
        log(f"[26 KITTI path] {name} copy of phase 19's checkpoint "
            f"({path.stat().st_size / 2**20:.1f} MiB): {len(same)} of {len(own)} tensors equal "
            f"to the port-format load")
        if len(same) != len(own):
            raise AssertionError(f"the {name} copy loads other tensors than the port's file")
    model = ie.build_model(ie.model_config(D), "cpu", checkpoint=checkpoint)
    batch = batch_to_torch(ie.kitti_sample(tree, GOLDEN_INDEX, (H, W)), "cpu")
    with torch.inference_mode():
        cpu = ie.to_grey(model(batch)["result"][0, 0])
    launches = 0
    for name, path in (("port", checkpoint), ("reference", copies["reference"])):
        out_dir = Path(work) / f"example_{name}"
        printed = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(printed):
            ie.main(["--device", str(dev), "--data", str(tree), "--index", str(GOLDEN_INDEX),
                     "--checkpoint", str(path), "--out", str(out_dir), "--height", str(H),
                     "--width", str(W), "--depth-steps", str(D)])
        counts = launch_counts()
        if counts != only(plane_sweep_cost_volume=2):
            raise AssertionError(f"the golden sample launched {counts}, expected K1 once for "
                                 f"each of its 2 forwards")
        launches += counts["plane_sweep_cost_volume"]
        pngs = {n: read_png(out_dir / f"{n}.png") for n in ("depth", "mask", "kf")}
        shapes = {n: a.shape for n, a in pngs.items()}
        if shapes != {"depth": (H, W), "mask": (H, W), "kf": (H, W, 3)}:
            raise AssertionError(f"the golden sample's PNGs are {shapes}")
        diff = np.abs(pngs["depth"].astype(int) - cpu)
        share = float((diff <= GOLDEN_LEVELS).mean())
        latency = next(line for line in printed.getvalue().splitlines()
                       if "Inference took" in line)
        log(f"[26 KITTI path] golden sample: cli.inference_example --data --index {GOLDEN_INDEX} "
            f"(keyframe {int(batch['image_id'][0, 0])}) --checkpoint <phase 19's, {name} "
            f"format>: {latency}; K1 launches {counts['plane_sweep_cost_volume']} for 2 "
            f"forwards; depth.png vs the CPU forward: max {diff.max()} levels, "
            f"{100 * share:.4f}% within {GOLDEN_LEVELS}; mask.png levels "
            f"{pngs['mask'].min()}-{pngs['mask'].max()} on {card}")
        if share < GOLDEN_SHARE:
            raise AssertionError(f"the card's depth.png ({name} format) disagrees with the CPU "
                                 "forward")
    return launches


def phase_kitti_path(dev, card: str, work, stage1_checkpoint, stage4_checkpoint) -> dict:
    """Phase 26: the KITTI user's path on a tree at KITTI's native size:
    prepare it, train stage 2 from it (8 workers, the main path, then 1),
    serve the golden sample. Returns K1's and K2's launches on the path."""
    from pathlib import Path

    t0 = time.perf_counter()
    tree = Path(work) / "kitti_path"
    write_kitti_tree(tree, n_frames=KITTI_PATH_FRAMES, stereo=True)
    log(f"[26 KITTI path] wrote a stereo KITTI tree (sequence 07, {KITTI_PATH_FRAMES} frames at "
        f"{KITTI_SIZE[0]}x{KITTI_SIZE[1]}) in {time.perf_counter() - t0:.2f} s")
    prepare_kitti(tree, work)
    stage2 = kitti_stage2(dev, card, work, tree, stage1_checkpoint, 8)
    kitti_stage2(dev, card, work, tree, stage1_checkpoint, 1)
    k1_golden = phase_golden_sample(dev, card, work, tree, stage4_checkpoint)
    log(f"[26 KITTI path] phase time {time.perf_counter() - t0:.1f} s")
    return {"plane_sweep_cost_volume": stage2["plane_sweep_cost_volume"] + k1_golden,
            "grid_warp": stage2["grid_warp"]}


TUM_DEPTH_SEQ_FRAMES = 12  # keyframes 2, 4, 6, 8 at F=4: two batches of 2
# Phase 27's depth files, on every other frame: float32 Y under ZIP, and one
# file each under NONE, RLE and ZIPS and one of HALF samples.
TUM_DEPTH_FILES = {0: {"compression": "NONE"}, 2: {"compression": "ZIP"},
                   4: {"compression": "RLE"}, 6: {"compression": "ZIP", "pixel_type": "HALF"},
                   8: {"compression": "ZIPS"},
                   10: {"compression": "ZIP", "line_order": "DECREASING_Y"}}


def tum_eval_size():
    """The shipped tmvo data arguments' target size (480x640)."""
    with open("configs/test/pointcloud_monorec_tmvo.json") as f:
        return tuple(json.load(f)["data_set"]["args"]["target_image_size"])


def tum_eval_config(work, tree, checkpoint, name: str, **extra):
    """A copy of ``eval_monorec.json`` (its metrics, batch size and workers)
    on the TUM mono VO ``tree`` through the shipped tmvo data arguments with
    ``only_keyframes``, from ``checkpoint``; returns its path and run
    directory."""
    from pathlib import Path

    with open("configs/test/pointcloud_monorec_tmvo.json") as f:
        data_args = json.load(f)["data_set"]["args"]
    with open("configs/evaluate/eval_monorec.json") as f:
        config = json.load(f)
    config["models"][0]["args"]["checkpoint_location"] = [str(checkpoint)]
    loader = config["data_loader"]["args"]
    config["data_loader"] = {"type": "TUMMonoVODataset", "args": dict(
        data_args, dataset_dir=str(tree), only_keyframes=True,
        batch_size=loader["batch_size"], shuffle=False, validation_split=0,
        num_workers=loader["num_workers"], **extra)}
    config["evaluater"].update(save_dir=str(Path(work) / name), verbosity=0)
    path = write_config(Path(work) / f"{name}.json", config)
    return path, Path(work) / name / "log" / config["name"] / config["timestamp_replacement"]


def tum_evaluate(tag: str, work, tree, checkpoint, name: str, device: str, batches: int,
                 **extra):
    """``cli.evaluate`` on ``tum_eval_config``'s copy on ``device``: 7
    finite metrics, every one of the ``batches`` batches of 2 valid.
    Returns the config's path, the results and the CLI's wall time."""
    from pathlib import Path

    from monorec_tpu_torch.cli import evaluate

    path, run_dir = tum_eval_config(work, tree, checkpoint, name, **extra)
    t = time.perf_counter()
    evaluate.main(["-c", path, "--device", device])
    wall = time.perf_counter() - t
    result = json.loads((Path(run_dir) / "results_0.json").read_text())["metrics"]
    th, tw = tum_eval_size()
    log(f"{tag} cli.evaluate on {device}: {batches} batch(es) of 2 keyframes at {th}x{tw}, "
        f"F=4, D={D} in {wall:.3f} s (host clock, the CLI whole); valid_batches "
        f"{result['valid_batches']}, num_samples {result['num_samples']}; " + ", ".join(
            f"{k} {result[k]:.6f}" for k in result if k.endswith("_metric")))
    if not (len(result["metrics"]) == 7 and all(math.isfinite(v) for v in result["metrics"])
            and result["valid_batches"] == batches and result["num_samples"] == 2 * batches):
        raise AssertionError(f"{tag} the evaluation's results are off: {result}")
    return path, result, wall


def card_vs_cpu(tag: str, card_result, cpu_result) -> None:
    """The evaluation's metrics on the card held to the CPU's within
    EVAL_RTOL."""
    import numpy as np

    g, c = np.asarray(card_result["metrics"]), np.asarray(cpu_result["metrics"])
    rel = np.abs(g - c) / np.where(c == 0, 1.0, np.abs(c))
    log(f"{tag} first batch, card vs CPU: max relative diff {rel.max():.3e} (metrics "
        f"{', '.join(f'{v:.6f}' for v in g)} vs {', '.join(f'{v:.6f}' for v in c)})")
    if not np.isclose(g, c, rtol=EVAL_RTOL, atol=0).all():
        raise AssertionError(f"{tag} the card's evaluation disagrees with the CPU's")


def phase_tum_depth(dev, card: str, work, checkpoint) -> dict:
    """Phase 27: evaluation on the card through ``cli.evaluate`` over a TUM
    mono VO sequence of colour JPEGs with depth EXRs, ``only_keyframes``,
    from phase 19's checkpoint. Returns K1's record at B=2, F=4, 480x640,
    with its launches."""
    from pathlib import Path

    import numpy as np
    import torch

    from monorec_tpu_torch import config as config_mod
    from monorec_tpu_torch.data.exr import read_exr
    from monorec_tpu_torch.data.jpeg import read_jpeg
    from monorec_tpu_torch.eval import Evaluator
    from monorec_tpu_torch.models import MonoRec
    from monorec_tpu_torch.train.checkpoints import load_stage_checkpoints

    tag = "[27 tum colour + depth]"
    tree = Path(work) / "tum_depth"
    n = TUM_DEPTH_SEQ_FRAMES
    t = time.perf_counter()
    images = write_tum_tree(tree, TUM_SIZE, n, colour=True, depth=TUM_DEPTH_FILES)
    log(f"{tag} wrote a TUM mono VO sequence ({n} colour JPEGs at {TUM_SIZE[0]}x{TUM_SIZE[1]}, "
        f"quality 90: frame 0 at 4:4:4, frame 1 at 4:2:2, the rest at 4:2:0, every third with "
        f"restart markers; {len(TUM_DEPTH_FILES)} depth EXRs) in {time.perf_counter() - t:.2f} s")

    # The host's decoders, each image held to what was written.
    names = {(1, 1): "4:4:4", (2, 1): "4:2:2", (2, 2): "4:2:0"}
    decode, diffs = [], []
    for i in range(4):
        path = tree / "images" / f"{i:05d}.jpg"
        t = time.perf_counter()
        img = read_jpeg(path)
        decode.append((time.perf_counter() - t) * 1e3)
        diffs.append(float(np.abs(img.astype(np.int64) - images[i]).mean()))
        if img.shape != images[i].shape:
            raise AssertionError(f"{tag} {path.name} decodes to {img.shape}")
    log(f"{tag} read_jpeg per {TUM_SIZE[0]}x{TUM_SIZE[1]} colour image (frames 0-3: "
        + ", ".join(f"{names[tum_sampling(i)[0]]}{' + restarts' if i % 3 == 0 else ''} "
                    f"{v:.1f} ms" for i, v in enumerate(decode))
        + f") (host clock, the host of {card}); mean |decoded - encoded source| "
        f"{', '.join(f'{v:.3f}' for v in diffs)} levels")
    if max(diffs) > JPEG_LEVELS:
        raise AssertionError(f"{tag} the decoded images are off the encoded ones: {diffs}")
    exr_ms = []
    for i, options in TUM_DEPTH_FILES.items():
        path = tree / "images_depth" / f"{i:05d}_d.exr"
        want = tum_depth(TUM_SIZE, i)
        if options.get("pixel_type") == "HALF":
            want = want.astype(np.float16).astype(np.float32)
        t = time.perf_counter()
        got = read_exr(path)
        exr_ms.append((time.perf_counter() - t) * 1e3)
        if got.dtype != np.float32 or not np.array_equal(got, want):
            raise AssertionError(f"{tag} {path.name} ({options}) does not read back as written")
    log(f"{tag} read_exr per {TUM_SIZE[0]}x{TUM_SIZE[1]} depth file: " + ", ".join(
        f"{o['compression']}{' ' + o['pixel_type'] if 'pixel_type' in o else ''}"
        f"{' decreasing y' if 'line_order' in o else ''} {v:.1f} ms "
        f"({(tree / 'images_depth' / f'{i:05d}_d.exr').stat().st_size / 2**20:.2f} MiB)"
        for (i, o), v in zip(TUM_DEPTH_FILES.items(), exr_ms))
        + f" (host clock, the host of {card}); each equal to the written array")

    # The main path: cli.evaluate with eval_monorec.json's metrics and batch
    # size over the shipped tmvo data arguments, only the keyframes.
    th, tw = tum_eval_size()
    n_samples = 4
    n_batches = n_samples // 2

    def run(name, device, batches, **extra):
        return tum_evaluate(tag, work, tree, checkpoint, name, device, batches, **extra)

    # The main path, on the card.
    reset_counts()
    path, _, _ = run("tum_depth_card", str(dev), n_batches)
    counts = launch_counts()
    if counts != only(plane_sweep_cost_volume=n_batches):
        raise AssertionError(f"{tag} the evaluation launched {counts}, expected "
                             f"plane_sweep_cost_volume once per batch ({n_batches})")
    # The first batch on the card and on the CPU (the plain versions).
    first = {where: run(f"tum_depth_first_{where}", device, 1, start=0, end=2)[1]
             for where, device in (("card", str(dev)), ("cpu", "cpu"))}
    card_vs_cpu(tag, first["card"], first["cpu"])

    # The eval forward per batch, and the evaluate loop's pace and busy share.
    with open(path) as f:
        config = json.load(f)
    model_cfg, locations = config_mod.build_models(config)[0]
    net = MonoRec(model_cfg, dev)
    load_stage_checkpoints(net, locations)
    net.eval()
    loader = config_mod.build_data_loader(config["data_loader"], dev)
    batch = next(iter(loader))
    if not (batch["target"] > 0).any():
        raise AssertionError(f"{tag} the first batch's depth targets are all zero")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: net(batch), 10)
    log(f"{tag} eval forward, batch 2 at {th}x{tw}, D={D}, F=4: {fwd_ms:.3f} ms per batch (CUDA "
        f"events, 10 calls) on {card}")
    evaluator = Evaluator(net, config_mod.build_metrics(config), config, loader,
                          Path(work) / "tum_depth_timing")
    torch.cuda.synchronize()
    t = time.perf_counter()
    evaluator.eval()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    window_ms, busy_ms = busy_window(evaluator.eval)
    log(f"{tag} evaluate loop from the tree ({loader.num_workers} workers): {n_samples} "
        f"keyframes in {wall:.3f} s = {n_samples / wall:.3f} keyframes/s (host clock); profiled "
        f"pass: device busy {busy_ms:.1f} of {window_ms:.1f} ms = "
        f"{100 * busy_ms / window_ms:.1f}% on {card}")
    record = k1_hold(dev, card, tag, batch, 4)
    del net, batch, evaluator
    torch.cuda.empty_cache()
    return dict(record, launches=counts["plane_sweep_cost_volume"])


# ---- phase 28: progressive and CMYK JPEG ---------------------------------------

PROGRESSIVE_TUM_FRAMES = 8  # keyframes 2 and 4 at F=4 read frames 0-6: one batch of 2
# Phase 28's frames: a label, the array written (the scene's RGB, its grey
# or its CMYK, ``tum_source``) and ``encode_jpeg``'s arguments at quality 90.
PROGRESSIVE_TUM_FILES = {
    0: ("progressive 4:2:0", "rgb", {"progressive": True}),
    1: ("progressive grey", "grey", {"progressive": True}),
    2: ("CMYK 4:4:4", "cmyk", {"sampling": ((1, 1),) * 4}),
    3: ("progressive 4:2:0 + restarts", "rgb", {"progressive": True, "restart_interval": 61}),
    4: ("YCCK", "cmyk", {"ycck": True}),
    5: ("CMYK, C at 2x2", "cmyk", {}),
    6: ("progressive CMYK, C at 2x2", "cmyk", {"progressive": True}),
    7: ("sequential 4:2:0", "rgb", {}),
}


def tum_source(rgb, kind: str):
    """The array phase 28 writes for a frame of the scene ``rgb``: as is,
    its grey (the mean over the channels) or its CMYK (``rgb_to_cmyk``)."""
    import numpy as np

    if kind == "grey":
        return np.round(rgb.mean(axis=2)).astype(np.uint8)
    return rgb_to_cmyk(rgb) if kind == "cmyk" else rgb


def write_progressive_frame(path, img, **_):
    """``write_tum_tree``'s writer for phase 28: frame ``path``'s kind from
    PROGRESSIVE_TUM_FILES, whatever sampling and restarts the tree asks."""
    from pathlib import Path

    _, kind, kwargs = PROGRESSIVE_TUM_FILES[int(Path(path).stem)]
    write_jpeg(path, tum_source(img, kind), quality=90, **kwargs)


def phase_progressive_tum(dev, card: str, work, checkpoint) -> int:
    """Phase 28: a TUM mono VO sequence of progressive, CMYK and YCCK JPEGs
    at TUM's native size with depth EXRs on its two keyframes, evaluated on
    the card through ``cli.evaluate`` with ``only_keyframes`` from phase
    19's checkpoint. Each file decodes to its source within JPEG_LEVELS,
    and each progressive one bit for bit equal to its baseline twin (the
    same quantized coefficients, ``encode_jpeg`` without ``progressive``).
    Returns K1's launches on the main path."""
    from pathlib import Path

    import numpy as np

    from monorec_tpu_torch.data.jpeg import read_jpeg

    tag = "[28 progressive + CMYK tum]"
    t0 = time.perf_counter()
    tree = Path(work) / "tum_progressive"
    rgbs = write_tum_tree(tree, TUM_SIZE, PROGRESSIVE_TUM_FRAMES, write=write_progressive_frame,
                          colour=True, depth={2: {"compression": "ZIP"}, 4: {"compression": "ZIP"}})
    log(f"{tag} wrote a TUM mono VO sequence ({PROGRESSIVE_TUM_FRAMES} JPEGs at {TUM_SIZE[0]}x"
        f"{TUM_SIZE[1]}, quality 90: " + ", ".join(
            f"{i} {label}" for i, (label, _, _) in PROGRESSIVE_TUM_FILES.items())
        + f"; depth EXRs on frames 2 and 4) in {time.perf_counter() - t0:.2f} s")

    decode, twins = {}, []
    for i, (label, kind, kwargs) in PROGRESSIVE_TUM_FILES.items():
        path = tree / "images" / f"{i:05d}.jpg"
        source = tum_source(rgbs[i], kind)
        t = time.perf_counter()
        img = read_jpeg(path)
        decode[label] = (time.perf_counter() - t) * 1e3
        diff = float(np.abs(img.astype(np.int64) - source).mean())
        log(f"{tag} read_jpeg {label} ({path.stat().st_size / 2**10:.0f} KiB): "
            f"{decode[label]:.1f} ms (host clock, the host of {card}); shape {img.shape}, mean "
            f"|decoded - encoded source| {diff:.3f} levels")
        if img.shape != source.shape or diff > JPEG_LEVELS:
            raise AssertionError(f"{tag} {path.name} ({label}) decodes off its source")
        if kwargs.get("progressive"):
            twin = Path(work) / f"baseline_twin_{i}.jpg"
            write_jpeg(twin, source, quality=90, **dict(kwargs, progressive=False))
            t = time.perf_counter()
            baseline = read_jpeg(twin)
            twins.append(f"{label}: baseline {(time.perf_counter() - t) * 1e3:.1f} ms")
            if not np.array_equal(baseline, img):
                raise AssertionError(f"{tag} {path.name} ({label}) decodes other than its "
                                     "baseline twin")
    log(f"{tag} each progressive file decodes bit for bit equal to its baseline twin ("
        + "; ".join(twins) + ")")

    # The main path: cli.evaluate on the card, its pace and busy share from a
    # torch.profiler window over the CLI whole; then on the CPU.
    result = {}

    def main_path():
        result["card"] = tum_evaluate(tag, work, tree, checkpoint, "tum_progressive_card",
                                      str(dev), 1)

    reset_counts()
    window_ms, busy_ms = busy_window(main_path)
    counts = launch_counts()
    if counts != only(plane_sweep_cost_volume=1):
        raise AssertionError(f"{tag} the evaluation launched {counts}, expected "
                             f"plane_sweep_cost_volume once for its batch")
    wall = result["card"][2]
    log(f"{tag} cli.evaluate on the card, the CLI whole (config, model, checkpoint, reading 10 "
        f"JPEGs and 2 EXRs, one K1 launch): 2 keyframes in {wall:.3f} s = {2 / wall:.3f} "
        f"keyframes/s (host clock, under torch.profiler); device busy {busy_ms:.1f} of "
        f"{window_ms:.1f} ms = {100 * busy_ms / window_ms:.2f}% on {card}")
    cpu = tum_evaluate(tag, work, tree, checkpoint, "tum_progressive_cpu", "cpu", 1)[1]
    card_vs_cpu(tag, result["card"][1], cpu)
    log(f"{tag} phase time {time.perf_counter() - t0:.1f} s")
    return counts["plane_sweep_cost_volume"]


def main() -> int:
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible; the port has no CPU fallback")
    from monorec_tpu_torch.cli.inference_example import build_model, make_requests, serve
    from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
    from monorec_tpu_torch.models import MonoRecConfig
    from monorec_tpu_torch.ops import plane_sweep
    from monorec_tpu_torch.ops.cost_volume import CostVolumeConfig, compute_cost_volume
    from monorec_tpu_torch.ops.cuda import build
    from monorec_tpu_torch.precision import use_exact_precision

    use_exact_precision()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (nvidia-smi name, power limit)"
    log(f"[1 device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; {card}")

    # ---- 2. build -------------------------------------------------------
    def timed_build(name):
        t = time.perf_counter()
        build.load(name)
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        build_s = dict(zip(SOURCES, pool.map(timed_build, SOURCES)))
    log(f"[2 build] {len(SOURCES)} sources built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(in parallel): " + ", ".join(f"{n}.cu {t:.2f} s" for n, t in build_s.items()))
    for source in SOURCES:
        ptxas = build.BUILD_DIR / f"{source}.ptxas.txt"
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or (
                        "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line):
                    log(f"    ptxas {source}: {line.split(':', 1)[-1].strip()}")

    # ---- 3. kernel vs plain version -------------------------------------
    max_err = 0.0
    for tz in MOTIONS:
        images, keyframes, homs = sweep_batch(dev, tz)
        for mode in MODES:
            sad, wmask, cov = plane_sweep.plane_sweep_sad(images, keyframes, homs, 2, F, mode)
            torch.cuda.synchronize()
            rsad, rwmask, _ = plane_sweep.plane_sweep_sad_reference(
                images, keyframes, homs, 2, F, mode)
            err = (sad - rsad).abs()
            err_all, err_in = err.max().item(), err[..., 2:-2, 2:-2].max().item()
            mism = ((wmask != 0) != (rwmask != 0)).sum().item()
            log(f"[3 kernel] tz={tz} use_ssim={mode}: max|sad diff| interior {err_in:.3e}, "
                f"whole image {err_all:.3e}; wmask!=0 mismatches {mism}")
            if not (torch.isfinite(sad).all() and err_all <= SAD_TOL and mism == 0
                    and (cov == 0).all()):
                raise AssertionError(f"plane_sweep_sad disagrees with its plain version "
                                     f"(tz={tz}, use_ssim={mode})")
            max_err = max(max_err, err_all)
            del sad, wmask, rsad, rwmask, err

    images, keyframes, homs = sweep_batch(dev, 0.0)
    kernel = lambda: plane_sweep.plane_sweep_sad(images, keyframes, homs, 2, F, 1)  # noqa: E731
    plain = lambda: plane_sweep.plane_sweep_sad_reference(images, keyframes, homs, 2, F, 1)  # noqa: E731
    k_ms, p_ms, _, turns, order = in_turns(kernel, plain, 20, 3)
    log(f"[3 kernel] time at N={B * F}, D={D}, {H}x{W}, use_ssim=1 ({order}): "
        f"{', '.join(f'{t:.3f}' for t in turns)} ms; kernel {k_ms:.3f} ms vs "
        f"plain {p_ms:.3f} ms on {card}")
    k1_bound = k1_raw_bound(images, keyframes, homs)
    del images, keyframes, homs
    cv_record = phase_cost_volume_kernel(dev, card, torch.float32)
    torch.cuda.empty_cache()

    # ---- 4. cost volume: kernel path vs plain path ----------------------
    for tz in MOTIONS:
        bt = batch_to_torch(make_batch(B, H, W, F, stereo=False, mask=False, tz=tz), dev)
        args = [bt[k] for k in ("keyframe", "keyframe_intrinsics", "keyframe_pose",
                                "frames", "intrinsics", "poses")]
        for mode in MODES:
            cfg = CostVolumeConfig(depth_steps=D, use_ssim=mode)
            fused, sfcv = compute_cost_volume(*args, 0.0025, 0.33, cfg)
            pf, ps = compute_cost_volume(*args, 0.0025, 0.33, cfg, plain=True)
            e32 = [(fused - pf).abs().max().item(), (sfcv - ps).abs().max().item()]
            e64, e32_64 = [0.0, 0.0], [0.0, 0.0]  # [fused, sfcv]
            for b in range(B):  # float64 one sample at a time, to bound memory
                f64, s64 = compute_cost_volume(
                    *(a[b : b + 1].double() for a in args), 0.0025, 0.33, cfg, plain=True)
                for i, (k, p, x) in enumerate(((fused, pf, f64), (sfcv, ps, s64))):
                    e64[i] = max(e64[i], (k[b : b + 1] - x).abs().max().item())
                    e32_64[i] = max(e32_64[i], (p[b : b + 1] - x).abs().max().item())
            log(f"[4 cost volume] tz={tz} use_ssim={mode}: max|diff| fused / sfcv: kernel path "
                f"vs plain float64 {e64[0]:.3e} / {e64[1]:.3e}; plain float32 vs float64 "
                f"{e32_64[0]:.3e} / {e32_64[1]:.3e}; kernel path vs plain float32 "
                f"{e32[0]:.3e} / {e32[1]:.3e}")
            # sfcv is (1 - 2 sad) per frame: the kernel's budget holds against
            # the exact answer. The fused CV's frame weights are ill-conditioned
            # at flat cost curves, so there it is held to the float32 plain
            # path's own error (ops/cost_volume.py, _score_and_fuse).
            fused_tol = max(SAD_TOL, 2.0 * e32_64[0])
            if not (torch.isfinite(fused).all() and torch.isfinite(sfcv).all()
                    and e64[1] <= SAD_TOL and e64[0] <= fused_tol):
                raise AssertionError(f"kernel-path cost volume off (tz={tz}, use_ssim={mode})")
        del fused, sfcv, pf, ps
    for warp_dtype in ("float32", "bfloat16"):
        cost_volume_split(dev, card, args, warp_dtype)
    del bt, args

    # ---- 5. forward parity: GPU (kernel) vs CPU (plain versions) --------
    cfg = MonoRecConfig(cv_depth_steps=D)
    nb = make_batch(1, H, W, F, stereo=False, mask=False, seed=7, tz=0.5)
    with torch.inference_mode():
        out_g = build_model(cfg, dev, seed=0)(batch_to_torch(nb, dev))
        out_c = build_model(cfg, "cpu", seed=0)(batch_to_torch(nb, "cpu"))
    for key in ("cost_volume", "single_frame_cvs", "cv_mask", "result", "mask", "cv_uncovered"):
        if not torch.isfinite(out_g[key]).all():
            raise AssertionError(f"GPU forward: non-finite {key}")
    diffs = {}
    # The fused cost_volume is reported, not gated: see phase 4.
    for key, atol, rtol in (("cost_volume", None, 0.0), ("single_frame_cvs", SAD_TOL, 0.0),
                            ("cv_mask", MASK_ATOL, 0.0), ("result", RESULT_ATOL, RESULT_RTOL)):
        g, c = out_g[key].cpu(), out_c[key]
        diffs[key] = (g - c).abs().max().item()
        if g.shape != c.shape or (
                atol is not None and not ((g - c).abs() <= atol + rtol * c.abs()).all()):
            raise AssertionError(f"GPU vs CPU forward: {key} off by {diffs[key]:.3e}")
    log("[5 forward] B=1 GPU vs CPU max|diff|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
        + f"; result {tuple(out_g['result'].shape)}")
    del out_g, out_c

    # ---- 6. serving through the entry point -----------------------------
    n_req = 6
    model = build_model(cfg, dev, seed=0)
    model_plain = build_model(MonoRecConfig(cv_depth_steps=D, plain_cost_volume=True), dev, seed=0)
    requests = make_requests(n_req, B, H, W, F, dev, seed=100)
    serve(model, requests[:1])
    serve(model_plain, requests[:1])
    _, plain_1 = serve(model_plain, requests)
    reset_counts()
    outs, kern_1 = serve(model, requests)  # the main path
    serve_counts = launch_counts()
    _, kern_2 = serve(model, requests)
    _, plain_2 = serve(model_plain, requests)
    if serve_counts != only(plane_sweep_cost_volume=n_req):
        raise AssertionError(f"the served forwards launched {serve_counts}, expected "
                             f"plane_sweep_cost_volume {n_req} times")
    for out in outs:
        r = out["result"]
        if r.shape != (B, 1, H, W) or not torch.isfinite(r).all() or (r <= 0).any():
            raise AssertionError("served inverse depth is not finite and positive")
    med_k = statistics.median(kern_1 + kern_2)
    med_p = statistics.median(plain_1 + plain_2)
    log(f"[6 serving] {n_req} requests x {B} keyframes, {H}x{W}, D={D}, F={F}, f32 exact; "
        f"median forward (CUDA events) kernel {med_k:.3f} ms = {B * 1e3 / med_k:.2f} keyframes/s, "
        f"plain cost volume {med_p:.3f} ms = {B * 1e3 / med_p:.2f} keyframes/s on {card}")
    log(f"    per-request ms, plain: {', '.join(f'{t:.3f}' for t in plain_1)}; kernel: "
        f"{', '.join(f'{t:.3f}' for t in kern_1)}; kernel: {', '.join(f'{t:.3f}' for t in kern_2)}; "
        f"plain: {', '.join(f'{t:.3f}' for t in plain_2)}")

    del model, model_plain, outs
    torch.cuda.empty_cache()

    # ---- 7-10. the stage-1 training path ---------------------------------
    records = {"plane_sweep_sad": {"launches": serve_counts["plane_sweep_sad"],
                                   "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
                                   "library_ms": None, **k1_bound},
               "plane_sweep_cost_volume": dict(cv_record,
                                               launches=serve_counts["plane_sweep_cost_volume"])}
    warp_records, warp_inputs = phase_loss_warp(dev, card)
    records.update(warp_records)
    records.update(phase_photo_error(dev, card, *warp_inputs))
    del warp_inputs
    torch.cuda.empty_cache()
    phase_loss(dev, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as run_dir:
        train_counts, exact_trainer = phase_training(dev, card, run_dir)
        for k in ("grid_warp", "grid_warp_jac", "grid_warp_grad", "photo_error_fwd",
                  "photo_error_bwd"):
            records[k]["launches"] = train_counts[k]
        torch.cuda.empty_cache()

        # ---- 11-13. the kernels of the serving policy and K4 -------------
        records["plane_sweep_sad_bf16"] = phase_sweep_bf16(dev, card)
        torch.cuda.empty_cache()
        records["plane_sweep_cost_volume_bf16"] = phase_cost_volume_kernel(dev, card,
                                                                           torch.bfloat16)
        torch.cuda.empty_cache()
        warp_records, _ = phase_loss_warp(dev, card, torch.bfloat16)
        records.update(warp_records)
        torch.cuda.empty_cache()
        records.update(phase_warp_sweep(dev, card))
        torch.cuda.empty_cache()

        # ---- 14-15. the serving forward and serving training -------------
        forward_counts = phase_serving_forward(dev, card, requests)
        for k in ("plane_sweep_sad_bf16", "plane_sweep_cost_volume_bf16"):
            records[k]["launches"] = forward_counts[k]
        del requests
        torch.cuda.empty_cache()
        serving_counts = phase_serving_training(dev, card, run_dir, exact_trainer)
        for k in ("grid_warp_bf16", "grid_warp_jac_bf16", "grid_warp_grad_bf16"):
            records[k]["launches"] = serving_counts[k]
        stage1_checkpoint = exact_trainer[0].run_dir / "checkpoint.pth"
        del exact_trainer
        torch.cuda.empty_cache()

        # ---- 16. the convergence check -----------------------------------
        phase_convergence(dev)
        torch.cuda.empty_cache()

        # ---- 17. stage 2 of the curriculum and the handoff into stage 3 --
        stage2_counts, records["grid_warp_crop_c32"], stage2_checkpoint = phase_stage2(
            dev, card, run_dir, stage1_checkpoint)
        torch.cuda.empty_cache()

        # ---- 18-19. stages 3 and 4 of the curriculum ----------------------
        stage3_counts, stage3_checkpoint = phase_stage3(dev, card, run_dir, stage1_checkpoint,
                                                        stage2_checkpoint)
        stage4_counts, stage4_records, stage4_checkpoint = phase_stage4(
            dev, card, run_dir, stage1_checkpoint, stage3_checkpoint)
        torch.cuda.empty_cache()

        # ---- 20-21. evaluation and the point cloud on a KITTI tree ---------
        records["plane_sweep_cost_volume"].update(
            phase_evaluate(dev, card, run_dir, stage4_checkpoint))
        torch.cuda.empty_cache()
        records["plane_sweep_cost_volume"].update(
            phase_pointcloud(dev, card, run_dir, stage4_checkpoint))
        torch.cuda.empty_cache()

        # ---- 22-23. RobotCar and TUM mono VO trees -------------------------
        records["plane_sweep_cost_volume_320x640"] = phase_robotcar(dev, card, run_dir,
                                                                    stage4_checkpoint)
        torch.cuda.empty_cache()
        records["plane_sweep_cost_volume_f4_480x640"] = phase_tum(dev, card, run_dir,
                                                                  stage4_checkpoint)
        torch.cuda.empty_cache()

        # ---- 24. the stage-1 CLI: ImageNet encoder, AdamW, module timing --
        cli_counts = phase_stage1_cli(dev, card, run_dir)
        for k in ("plane_sweep_cost_volume", "grid_warp", "grid_warp_jac", "photo_error_fwd",
                  "photo_error_bwd"):
            records[k]["stage1_cli_launches"] = cli_counts[k]
        torch.cuda.empty_cache()

        # ---- 25. the model variants ----------------------------------------
        variant_counts = phase_variants(dev, card, run_dir)
        records["plane_sweep_cost_volume"]["variants_forward_launches"] = (
            variant_counts["forward_k1"])
        for k in ("plane_sweep_cost_volume", "grid_warp", "grid_warp_jac", "photo_error_fwd",
                  "photo_error_bwd"):
            records[k]["variants_train_launches"] = variant_counts["train"][k]
        torch.cuda.empty_cache()

        # ---- 26. the KITTI user's path: prepare, stage 2, golden sample ----
        kitti_counts = phase_kitti_path(dev, card, run_dir, stage1_checkpoint,
                                        stage4_checkpoint)
        records["plane_sweep_cost_volume"]["kitti_path_launches"] = (
            kitti_counts["plane_sweep_cost_volume"])
        records["grid_warp_crop_c32"]["kitti_path_launches"] = kitti_counts["grid_warp"]
        torch.cuda.empty_cache()

        # ---- 27. TUM mono VO with colour and depth through cli.evaluate ----
        records["plane_sweep_cost_volume_tum_depth"] = phase_tum_depth(dev, card, run_dir,
                                                                       stage4_checkpoint)
        torch.cuda.empty_cache()

        # ---- 28. progressive and CMYK JPEG through cli.evaluate ------------
        records["plane_sweep_cost_volume_tum_depth"]["progressive_cmyk_launches"] = (
            phase_progressive_tum(dev, card, run_dir, stage4_checkpoint))
    records["grid_warp_crop_c32"]["launches"] = stage2_counts["grid_warp"]
    records["plane_sweep_cost_volume"]["stage2_launches"] = stage2_counts["plane_sweep_cost_volume"]
    for k in ("plane_sweep_cost_volume", "grid_warp", "grid_warp_jac", "photo_error_fwd",
              "photo_error_bwd"):
        records[k]["stage3_launches"] = stage3_counts[k]
        records[k]["stage4_launches"] = stage4_counts[k]
    records.update(stage4_records)

    replaced = {
        "plane_sweep_sad": ("plane_sweep_sad.cu", "monorec_tpu/ops/pallas/cv_kernel.py:600"),
        "plane_sweep_sad_bf16": ("plane_sweep_sad.cu",
                                 "monorec_tpu/ops/pallas/cv_kernel.py:600"),
        "plane_sweep_cost_volume": ("plane_sweep_sad.cu",
                                    "monorec_tpu/ops/pallas/cv_kernel.py:600"),
        "plane_sweep_cost_volume_bf16": ("plane_sweep_sad.cu",
                                         "monorec_tpu/ops/pallas/cv_kernel.py:600"),
        "plane_sweep_cost_volume_320x640": ("plane_sweep_sad.cu",
                                            "monorec_tpu/ops/pallas/cv_kernel.py:600"),
        "plane_sweep_cost_volume_f4_480x640": ("plane_sweep_sad.cu",
                                               "monorec_tpu/ops/pallas/cv_kernel.py:600"),
        "plane_sweep_cost_volume_tum_depth": ("plane_sweep_sad.cu",
                                              "monorec_tpu/ops/pallas/cv_kernel.py:600"),
        "grid_warp": ("grid_warp.cu", "monorec_tpu/ops/pallas/grid_warp.py:421"),
        "grid_warp_jac": ("grid_warp.cu", "monorec_tpu/ops/pallas/grid_warp.py:431"),
        "grid_warp_grad": ("grid_warp.cu", "monorec_tpu/ops/pallas/grid_warp.py:444"),
        "grid_warp_bf16": ("grid_warp.cu", "monorec_tpu/ops/pallas/grid_warp.py:421"),
        "grid_warp_jac_bf16": ("grid_warp.cu", "monorec_tpu/ops/pallas/grid_warp.py:431"),
        "grid_warp_grad_bf16": ("grid_warp.cu", "monorec_tpu/ops/pallas/grid_warp.py:444"),
        "grid_warp_crop_c32": ("grid_warp.cu", "monorec_tpu/ops/pallas/grid_warp.py:421"),
        "photo_error_fwd": ("photo_error.cu", "monorec_tpu/ops/pallas/photo_error.py:195"),
        "photo_error_bwd": ("photo_error.cu", "monorec_tpu/ops/pallas/photo_error.py:219"),
        "grid_warp_jac_n96": ("grid_warp.cu", "monorec_tpu/ops/pallas/grid_warp.py:431"),
        "photo_error_fwd_m96": ("photo_error.cu", "monorec_tpu/ops/pallas/photo_error.py:195"),
        "photo_error_bwd_m96": ("photo_error.cu", "monorec_tpu/ops/pallas/photo_error.py:219"),
        "warp_plane_sweep": ("warp_plane_sweep.cu", "monorec_tpu/ops/pallas/warp_kernel.py:291"),
        "warp_plane_sweep_bf16": ("warp_plane_sweep.cu",
                                  "monorec_tpu/ops/pallas/warp_kernel.py:291"),
    }
    log(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": f"monorec_tpu_torch/ops/cuda/{src}",
        "replaces": replaces,
        "launches": records[k]["launches"],
        "max_abs_err": records[k]["max_abs_err"],
        **{f: records[k][f] for f in ("sfcv_max_abs_err", "stage2_launches", "stage3_launches",
                                      "stage4_launches", "stage1_cli_launches", "eval_launches",
                                      "variants_forward_launches", "variants_train_launches",
                                      "kitti_path_launches", "pointcloud_launches",
                                      "progressive_cmyk_launches",
                                      "max_abs_err_vs_float64",
                                      "plain_max_abs_err_vs_float64", "planar_gather_ms",
                                      "second_launch_m",
                                      "second_launch_ms", "second_launch_plain_ms",
                                      "second_launch_bound_ms")
           if f in records[k]},
        "ms": records[k]["ms"],
        "plain_ms": records[k]["plain_ms"],
        "bound_ms": records[k]["bound_ms"],
        "bound_by": records[k]["bound_by"],
        "bytes": records[k]["bytes"],
        "flops": records[k]["flops"],
        "library_ms": records[k]["library_ms"],
    } for k, (src, replaces) in replaced.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
