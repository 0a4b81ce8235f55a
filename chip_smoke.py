#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``monorec_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA Hopper GPU and
the CUDA toolkit. It builds the port's CUDA kernels from the sources in the
checkout, then:

1. device: name, versions, ``nvidia-smi`` name and power limit;
2. build: compiles ``plane_sweep_sad.cu``, ``grid_warp.cu`` and
   ``photo_error.cu`` (nvcc, sm_90a), one nvcc each, all started together;
3. kernel vs plain: ``plane_sweep_sad`` against ``plane_sweep_sad_reference``
   on the same GPU tensors at B=8, F=2, 256x512, D=32, for every use_ssim
   mode and two motions; times both;
4. cost volume: the kernel path of ``compute_cost_volume`` against its plain
   path run in float64 (the exact answer of the reference pipeline) and in
   float32: per-frame CVs within the kernel budget of the exact answer, the
   fused CV within twice the float32 plain path's own error where that
   exceeds the budget (its frame weights are ill-conditioned at flat cost
   curves);
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
8. photometric error: ``photo_error_fwd`` / ``photo_error_bwd`` against
   their plain versions at M=64, 3x256x512; times both;
9. the loss: ``depth_loss`` and its gradient w.r.t. the 4 predicted inverse
   depths at B=8, 256x512, F=2, kernels against plain versions;
10. training: the stage-1 trainer the CLI builds, from
   ``configs/train/monorec/monorec_depth.json`` with the data loader
   swapped for ``SyntheticSweepDataloader`` at 256x512, B=8, F=2, D=32,
   takes 6 steps and a validation pass; checks finite losses, moved depth
   parameters, a fixed encoder and the kernels' launch counts per step,
   then times steps with the kernels and with the loss's plain versions
   (CUDA events), splits a step into forward, loss, backward and
   optimizer, and reads the device's busy share and largest kernels over
   5 steps from a torch.profiler trace.

Every check that fails raises. The script prints a JSON line of kernel
records, the ``nvidia-smi`` line, and last ``{"ok": true, "device": ...}``.
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
LOSS_RTOL = 5e-4  # PARITY.md row 9, full-chain reprojection
TRAIN_STEPS = 6
PROFILED_STEPS = 5
SOURCES = ("plane_sweep_sad", "grid_warp", "photo_error")


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


def in_turns(kernel, plain, k_reps: int, p_reps: int):
    """Times (plain, kernel, kernel, plain); returns (kernel ms, plain ms,
    the four times)."""
    turns = [cuda_ms(plain, p_reps), cuda_ms(kernel, k_reps), cuda_ms(kernel, k_reps),
             cuda_ms(plain, p_reps)]
    return statistics.mean(turns[1:3]), statistics.mean([turns[0], turns[3]]), turns


def loss_batch(dev, tz: float, seed: int):
    """A synthetic batch of B keyframes (target included) and 4-scale edged
    inverse depths, finest first, each (B, 1, H / 2^s, W / 2^s)."""
    import torch

    from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch

    bt = batch_to_torch(make_batch(B, H, W, F, stereo=False, mask=False, seed=seed, tz=tz), dev)
    inv = torch.from_numpy(edged_inverse_depths(B, H, W, seed)).to(dev)
    preds = [inv if s == 0 else torch.nn.functional.avg_pool2d(inv, 2**s) for s in range(SCALES)]
    return bt, preds


def phase_loss_warp(dev, card: str):
    """Phase 7: K2 against its plain version at the main path's shapes;
    returns the kernels' records and the inputs of the last motion."""
    import torch

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
        cot = torch.empty_like(images).uniform_(-1.0, 1.0, generator=torch.Generator(dev).manual_seed(1))
        out = gw.grid_warp(images, xs, ys)
        jout, jx, jy = gw.grid_warp_jac(images, xs, ys)
        gx, gy = gw.grid_warp_grad(images, xs, ys, cot)
        torch.cuda.synchronize()
        ref, rjx, rjy = gw.grid_warp_jac_reference(images, xs, ys)
        rgx, rgy = gw.grid_warp_grad_reference(images, xs, ys, cot)
        e_val = (out - ref).abs().max().item()
        e_jac = max((jx - rjx).abs().max().item(), (jy - rjy).abs().max().item(),
                    (jout - ref).abs().max().item())
        e_grad = max((gx - rgx).abs().max().item(), (gy - rgy).abs().max().item())
        zeros, rzeros = out[:, 0] == 0, ref[:, 0] == 0
        mism = (zeros != rzeros).sum().item()
        log(f"[7 loss warp] tz={tz}, N={n}, 3x{H}x{W}: max|diff| values {e_val:.3e}, Jacobian "
            f"{e_jac:.3e}, gradient {e_grad:.3e}; exact-zero (invalid) samples "
            f"{zeros.sum().item()} of {zeros.numel()}, mismatches {mism}")
        if not (torch.isfinite(out).all() and torch.isfinite(jx).all() and torch.isfinite(gx).all()
                and e_val <= WARP_TOL and e_jac <= JAC_TOL and e_grad <= JAC_TOL and mism == 0
                and zeros.any()):
            raise AssertionError(f"grid_warp disagrees with its plain version (tz={tz})")
        for k, e in zip(errs, (e_val, e_jac, e_grad)):
            errs[k] = max(errs[k], e)
        del out, jout, jx, jy, gx, gy, ref, rjx, rjy, rgx, rgy

    timing = {
        "grid_warp": in_turns(lambda: gw.grid_warp(images, xs, ys),
                              lambda: gw.grid_warp_reference(images, xs, ys), 20, 3),
        "grid_warp_jac": in_turns(lambda: gw.grid_warp_jac(images, xs, ys),
                                  lambda: gw.grid_warp_jac_reference(images, xs, ys), 20, 3),
        "grid_warp_grad": in_turns(lambda: gw.grid_warp_grad(images, xs, ys, cot),
                                   lambda: gw.grid_warp_grad_reference(images, xs, ys, cot), 20, 3),
    }
    for k, (k_ms, p_ms, turns) in timing.items():
        log(f"[7 loss warp] {k} time at N={n}, 3x{H}x{W}, tz=0.5 (plain, kernel, kernel, plain): "
            f"{', '.join(f'{t:.3f}' for t in turns)} ms; kernel {k_ms:.3f} ms vs plain "
            f"{p_ms:.3f} ms on {card}")
    return {k: {"max_abs_err": errs[k], "ms": timing[k][0], "plain_ms": timing[k][1]}
            for k in errs}, (images, xs, ys, tiled)


def phase_photo_error(dev, card: str, images, xs, ys, tiled) -> dict:
    """Phase 8: K3 against its plain version, on the warped stack of phase 7
    against its keyframes (the loss's own inputs)."""
    import torch
    import torch.nn.functional as F_

    from monorec_tpu_torch.ops import grid_warp as gw
    from monorec_tpu_torch.ops import photo_error as pe
    from monorec_tpu_torch.ops.ssim import ssim_pre_clamp

    n = images.shape[0]
    x = (gw.grid_warp(images, xs, ys) - 1.0).contiguous()
    y = (tiled["keyframe"] + 0.5)[:, None].expand(-1, F, -1, -1, -1).reshape(n, 3, H, W).contiguous()
    cot = torch.empty(n, H, W, device=dev).uniform_(-1.0, 1.0,
                                                    generator=torch.Generator(dev).manual_seed(2))
    out = pe.photo_error_fwd(x, y)
    gx = pe.photo_error_bwd(x, y, cot)
    torch.cuda.synchronize()
    ref = pe.photo_error_reference(x, y)
    xr = x.clone().requires_grad_()
    (rgx,) = torch.autograd.grad((pe.photo_error_reference(xr, y) * cot).sum(), xr)
    e_fwd = (out - ref).abs().max().item()
    fwd_ok = within(out, ref, PE_FWD_RTOL, PE_FWD_ATOL).all().item()
    # Where SSIM's pre-clamp value sits within float32 rounding of the clamp
    # bounds 0 and 1, the kernel and the plain version may take different
    # sides of the kink (both subgradients are right): the gradient there
    # is reported, and gated everywhere else. A gradient element reads the
    # clamp of its 3x3 neighbourhood.
    with torch.no_grad():
        v = ssim_pre_clamp(x, y, pad_reflection=False, gaussian_average=True)
        kink = (v.abs() < 1e-5) | ((v - 1.0).abs() < 1e-5)
        kink = F_.max_pool2d(kink.float(), 3, 1, 1) > 0
    ok = within(gx, rgx, PE_BWD_RTOL, PE_BWD_ATOL) | kink
    e_bwd = (gx - rgx).abs()[~kink].max().item()
    e_kink = (gx - rgx).abs()[kink].max().item() if kink.any() else 0.0
    log(f"[8 photo error] M={n}, 3x{H}x{W}: forward max|diff| {e_fwd:.3e} (rtol {PE_FWD_RTOL}, "
        f"atol {PE_FWD_ATOL}); backward max|diff| {e_bwd:.3e} (rtol {PE_BWD_RTOL}, atol "
        f"{PE_BWD_ATOL}) off the clamp's kink; {kink.sum().item()} of {kink.numel()} gradient "
        f"elements read a clamp within 1e-5 of its bound, max|diff| there {e_kink:.3e}")
    if not (torch.isfinite(out).all() and torch.isfinite(gx).all() and fwd_ok and ok.all()):
        raise AssertionError("photo_error disagrees with its plain version")
    del ref, xr, rgx, v, kink, ok

    def plain_bwd():
        xg = x.detach().requires_grad_()
        return torch.autograd.grad((pe.photo_error_reference(xg, y) * cot).sum(), xg)

    timing = {
        "photo_error_fwd": in_turns(lambda: pe.photo_error_fwd(x, y),
                                    lambda: pe.photo_error_reference(x, y), 20, 3),
        "photo_error_bwd": in_turns(lambda: pe.photo_error_bwd(x, y, cot), plain_bwd, 20, 3),
    }
    for k, (k_ms, p_ms, turns) in timing.items():
        log(f"[8 photo error] {k} time at M={n}, 3x{H}x{W} (plain, kernel, kernel, plain): "
            f"{', '.join(f'{t:.3f}' for t in turns)} ms; kernel {k_ms:.3f} ms vs plain "
            f"{p_ms:.3f} ms on {card}")
    errs = {"photo_error_fwd": e_fwd, "photo_error_bwd": e_bwd}
    return {k: {"max_abs_err": errs[k], "ms": timing[k][0], "plain_ms": timing[k][1]}
            for k in errs}


def phase_loss(dev, card: str) -> None:
    """Phase 9: depth_loss and its gradient, kernels against plain versions."""
    import torch

    from monorec_tpu_torch.losses import depth_loss

    bt, preds = loss_batch(dev, 0.5, seed=30)

    def run():
        ps = [p.clone().requires_grad_() for p in preds]
        loss_dict = depth_loss({**bt, "predicted_inverse_depths": ps}, 0.5, None, ())
        grads = torch.autograd.grad(loss_dict["loss"], ps)
        return loss_dict, grads

    k_dict, k_grads = run()
    with plain_loss_kernels():
        p_dict, p_grads = run()
        plain_ms = cuda_ms(run, 3)
    kernel_ms = cuda_ms(run, 3)
    rel = abs(k_dict["loss"].item() - p_dict["loss"].item()) / abs(p_dict["loss"].item())
    g_err = [(k - p).abs().max().item() for k, p in zip(k_grads, p_grads)]
    g_max = [p.abs().max().item() for p in p_grads]
    log(f"[9 loss] depth_loss at B={B}, {H}x{W}, F={F}: kernels {k_dict['loss'].item():.7f}, "
        f"plain {p_dict['loss'].item():.7f} (rel diff {rel:.2e}, gate {LOSS_RTOL}); gradient "
        f"max|diff| per scale {', '.join(f'{e:.2e}' for e in g_err)} (max|grad| "
        f"{', '.join(f'{m:.2e}' for m in g_max)}); loss + gradient {kernel_ms:.3f} ms with "
        f"kernels vs {plain_ms:.3f} ms plain on {card}")
    finite = all(torch.isfinite(g).all() for g in k_grads) and torch.isfinite(k_dict["loss"])
    if not (finite and rel <= LOSS_RTOL and k_dict["warp_uncovered"].item() == 0):
        raise AssertionError("depth_loss with the kernels disagrees with its plain versions")


def launch_counts() -> dict:
    from monorec_tpu_torch.ops import grid_warp, photo_error, plane_sweep

    return {
        "plane_sweep_sad": plane_sweep.plane_sweep_sad.launches,
        "grid_warp": grid_warp.grid_warp.launches,
        "grid_warp_jac": grid_warp.grid_warp_jac.launches,
        "grid_warp_grad": grid_warp.grid_warp_grad.launches,
        "photo_error_fwd": photo_error.photo_error_fwd.launches,
        "photo_error_bwd": photo_error.photo_error_bwd.launches,
    }


def reset_counts() -> None:
    from monorec_tpu_torch.ops import grid_warp, photo_error, plane_sweep

    for fn in (plane_sweep.plane_sweep_sad, grid_warp.grid_warp, grid_warp.grid_warp_jac,
               grid_warp.grid_warp_grad, photo_error.photo_error_fwd,
               photo_error.photo_error_bwd):
        fn.launches = 0


def phase_training(dev, card: str, run_dir) -> dict:
    """Phase 10: the stage-1 trainer of the CLI, on monorec_depth.json with
    synthetic data; returns the launch counts of its run."""
    import torch

    from monorec_tpu_torch.cli.train import build_trainer

    with open("configs/train/monorec/monorec_depth.json") as f:
        config = json.load(f)
    data = {"frame_count": F, "target_image_size": [H, W], "batch_size": B}
    config["data_loader"] = {"type": "SyntheticSweepDataloader",
                             "args": {**data, "length": TRAIN_STEPS * B, "shuffle": True}}
    config["val_data_loader"] = {"type": "SyntheticSweepDataloader",
                                 "args": {**data, "length": B, "shuffle": False, "seed": 1}}
    config["trainer"].update(epochs=1, len_epoch=TRAIN_STEPS, log_step=1, save_dir=str(run_dir),
                             tensorboard=False)
    trainer = build_trainer(config, dev)
    model = trainer.model
    depth0 = {k: p.detach().clone() for k, p in model.depth_module.named_parameters()}
    enc0 = {k: p.detach().clone() for k, p in model._feature_extractor.named_parameters()}
    n_val = len(trainer.valid_data_loader)

    reset_counts()
    log_ = trainer.train()  # the main path
    counts = launch_counts()
    expected = {"plane_sweep_sad": TRAIN_STEPS + n_val, "grid_warp": n_val,
                "grid_warp_jac": TRAIN_STEPS, "grid_warp_grad": 0,
                "photo_error_fwd": 2 * (TRAIN_STEPS + n_val), "photo_error_bwd": TRAIN_STEPS}
    lines = [json.loads(s) for s in trainer.log_path.read_text().splitlines()]
    losses = [r["loss"] for r in lines]
    moved = sum(not torch.equal(p, depth0[k]) for k, p in model.depth_module.named_parameters())
    enc_same = all(torch.equal(p, enc0[k]) for k, p in model._feature_extractor.named_parameters())
    log(f"[10 training] {TRAIN_STEPS} steps + {n_val} validation batch(es) through the CLI's "
        f"trainer (monorec_depth.json: pretrain_mode 1, depth flip, frozen encoder, amsgrad, "
        f"StepLR), B={B}, {H}x{W}, F={F}, D={D}: losses {', '.join(f'{x:.5f}' for x in losses)}; "
        f"val_loss {log_.get('val_loss', float('nan')):.5f}; depth-module tensors moved {moved} of "
        f"{len(depth0)}, encoder unchanged {enc_same}; launches {counts} (expected {expected})")
    if not (len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses)
            and moved == len(depth0) and enc_same and counts == expected):
        raise AssertionError("stage-1 training through the entry point failed its checks")

    # Per-step launch counts, step times with the kernels and with the loss's
    # plain versions, in turns.
    batches = [b for _, b in zip(range(3), trainer.data_loader)]
    alpha = trainer._alpha(1)

    def step_ms(n_steps: int):
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

    step_ms(1)
    turns = []
    for path in ("plain", "kernel", "kernel", "plain"):
        with plain_loss_kernels() if path == "plain" else contextlib.nullcontext():
            turns.append((path, step_ms(5)))
    want = {"plane_sweep_sad": 1, "grid_warp": 0, "grid_warp_jac": 1, "grid_warp_grad": 0,
            "photo_error_fwd": 2, "photo_error_bwd": 1}
    for path, times in turns:
        for _, delta in times:
            if delta != (want if path == "kernel" else dict(want, grid_warp_jac=0,
                                                            photo_error_fwd=0,
                                                            photo_error_bwd=0)):
                raise AssertionError(f"a {path} step launched {delta}")
    med = {p: statistics.median(t for path, ts in turns if path == p for t, _ in ts)
           for p in ("kernel", "plain")}
    log(f"[10 training] median step (CUDA events, 10 steps each, in turns plain, kernel, kernel, "
        f"plain) with the kernels {med['kernel']:.3f} ms = {B * 1e3 / med['kernel']:.2f} "
        f"keyframes/s; with the loss's plain versions {med['plain']:.3f} ms = "
        f"{B * 1e3 / med['plain']:.2f} keyframes/s on {card}; per-step launches {want}")
    log("    per-step ms: " + "; ".join(
        f"{path} " + ", ".join(f"{t:.2f}" for t, _ in ts) for path, ts in turns))

    # Layer split of a step: forward, loss, backward, optimizer.
    def split(n_steps: int):
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

    torch.cuda.reset_peak_memory_stats(dev)
    k_split = split(5)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    with plain_loss_kernels():
        p_split = split(5)
    names = ("forward", "loss", "backward", "optimizer")
    log(f"[10 training] step split, medians of 5 (CUDA events), kernels: " + ", ".join(
        f"{n} {t:.3f}" for n, t in zip(names, k_split)) + " ms; plain versions: " + ", ".join(
        f"{n} {t:.3f}" for n, t in zip(names, p_split)) + f" ms; peak memory {peak:.2f} GiB")

    # Device busy share and the largest kernels, from one torch.profiler
    # trace of PROFILED_STEPS steps after an untimed profiled one: the window
    # runs from the host's start of the first timed step to the end of the
    # last device activity, and the busy time is the union of the device
    # activities (kernels, copies, fills) in it.
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
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CUDA and e.time_range.end > t0
                   and not e.name.startswith("chip_smoke_step_"))
    t1 = max(end for _, end, _ in spans)
    busy, reach, per_name = 0.0, t0, {}
    for start, end, kname in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        per_name[kname] = per_name.get(kname, 0.0) + (end - start)
    busy_ms = busy / 1e3 / PROFILED_STEPS
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[10 training] torch.profiler, {PROFILED_STEPS} steps with the kernels: device busy "
        f"{busy_ms:.3f} ms per step = {100.0 * busy / (t1 - t0):.1f}% of the profiled window "
        f"({(t1 - t0) / 1e3 / PROFILED_STEPS:.3f} ms per step) and "
        f"{100.0 * busy_ms / med['kernel']:.1f}% of the unprofiled median step above; largest, "
        f"ms per step: " + "; ".join(f"{k[:60]} {v / 1e3 / PROFILED_STEPS:.3f}" for k, v in top))
    return counts


def main() -> int:
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible; the port has no CPU fallback")
    from monorec_tpu_torch.cli.inference_example import build_model, make_requests, serve
    from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
    from monorec_tpu_torch.models import MonoRecConfig
    from monorec_tpu_torch.ops import plane_sweep
    from monorec_tpu_torch.ops.cost_volume import (
        CostVolumeConfig,
        compute_cost_volume,
        plane_sweep_homographies,
    )
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
                if "registers" in line or "spill" in line and "0 bytes spill stores" not in line:
                    log(f"    ptxas {source}: {line.split(':', 1)[-1].strip()}")

    # ---- 3. kernel vs plain version -------------------------------------
    inv_depths = torch.linspace(0.0025, 0.33, D, dtype=torch.float64, device=dev)
    max_err = 0.0
    sweep_inputs = {}
    for tz in MOTIONS:
        bt = batch_to_torch(make_batch(B, H, W, F, stereo=False, mask=False, tz=tz), dev)
        homs = plane_sweep_homographies(
            bt["keyframe_intrinsics"], bt["keyframe_pose"], bt["intrinsics"], bt["poses"],
            inv_depths, H, W,
        ).reshape(B * F, D, 3, 3).contiguous()
        images = bt["frames"].reshape(B * F, 3, H, W).contiguous()
        sweep_inputs[tz] = (images, bt["keyframe"], homs)
        for mode in MODES:
            sad, wmask, cov = plane_sweep.plane_sweep_sad(images, bt["keyframe"], homs, 2, F, mode)
            torch.cuda.synchronize()
            rsad, rwmask, _ = plane_sweep.plane_sweep_sad_reference(
                images, bt["keyframe"], homs, 2, F, mode)
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

    images, keyframes, homs = sweep_inputs[0.0]
    kernel = lambda: plane_sweep.plane_sweep_sad(images, keyframes, homs, 2, F, 1)  # noqa: E731
    plain = lambda: plane_sweep.plane_sweep_sad_reference(images, keyframes, homs, 2, F, 1)  # noqa: E731
    turns = [("plain", cuda_ms(plain, 3)), ("kernel", cuda_ms(kernel, 20)),
             ("kernel", cuda_ms(kernel, 20)), ("plain", cuda_ms(plain, 3))]
    k_ms = statistics.mean(t for n, t in turns if n == "kernel")
    p_ms = statistics.mean(t for n, t in turns if n == "plain")
    log(f"[3 kernel] time at N={B * F}, D={D}, {H}x{W}, use_ssim=1 (plain, kernel, kernel, "
        f"plain): {', '.join(f'{t:.3f}' for _, t in turns)} ms; kernel {k_ms:.3f} ms vs "
        f"plain {p_ms:.3f} ms on {card}")
    del sweep_inputs, images, keyframes, homs

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
        del bt, args, fused, sfcv, pf, ps

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
    plane_sweep.plane_sweep_sad.launches = 0
    outs, kern_1 = serve(model, requests)  # the main path
    launches = plane_sweep.plane_sweep_sad.launches
    _, kern_2 = serve(model, requests)
    _, plain_2 = serve(model_plain, requests)
    if launches != n_req:
        raise AssertionError(f"the served forwards launched plane_sweep_sad {launches} times, "
                             f"expected {n_req}")
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

    del model, model_plain, requests, outs
    torch.cuda.empty_cache()

    # ---- 7-10. the stage-1 training path ---------------------------------
    records = {"plane_sweep_sad": {"launches": launches, "max_abs_err": max_err, "ms": k_ms,
                                   "plain_ms": p_ms}}
    warp_records, warp_inputs = phase_loss_warp(dev, card)
    records.update(warp_records)
    records.update(phase_photo_error(dev, card, *warp_inputs))
    del warp_inputs
    torch.cuda.empty_cache()
    phase_loss(dev, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as run_dir:
        train_counts = phase_training(dev, card, run_dir)
    for k in ("grid_warp", "grid_warp_jac", "grid_warp_grad", "photo_error_fwd",
              "photo_error_bwd"):
        records[k]["launches"] = train_counts[k]

    sources = {"plane_sweep_sad": ("plane_sweep_sad.cu", "monorec_tpu/ops/pallas/cv_kernel.py:600"),
               "grid_warp": ("grid_warp.cu", "monorec_tpu/ops/pallas/grid_warp.py:421"),
               "grid_warp_jac": ("grid_warp.cu", "monorec_tpu/ops/pallas/grid_warp.py:431"),
               "grid_warp_grad": ("grid_warp.cu", "monorec_tpu/ops/pallas/grid_warp.py:444"),
               "photo_error_fwd": ("photo_error.cu",
                                   "monorec_tpu/ops/pallas/photo_error.py:195"),
               "photo_error_bwd": ("photo_error.cu",
                                   "monorec_tpu/ops/pallas/photo_error.py:219")}
    log(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": f"monorec_tpu_torch/ops/cuda/{src}",
        "replaces": replaces,
        "launches": records[k]["launches"],
        "max_abs_err": records[k]["max_abs_err"],
        "ms": records[k]["ms"],
        "plain_ms": records[k]["plain_ms"],
    } for k, (src, replaces) in sources.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
