"""The plain reference of the training steps: MonoRec's stage-1 and stage-4
losses, AMSGrad as the configuration's optimizer block runs it, and the
steps that drive them, in plain PyTorch.

Written from MonoRec's ``monorec_loss.py`` (``depth_loss``,
``depth_refinement_loss``) and ``common_losses.py``, with the quirks that
MonoRec's trainer keeps (the scales stacked into one reprojection, the
automasking by the un-warped frames, the detached sparse-depth terms of
stage 4, ``mask_mean`` dividing by the count of valid entries). The loss
warp is ``grid_sample`` (bilinear, zero padding, ``align_corners=False``)
of the frames shifted by +1.5, so that a sample with no tap inside the
image reads exactly 0. The photometric error is 0.85 SSIM (3x3 Gaussian
window, zero padding, ``clamp(1 - n/d, 0, 1) / 2``) + 0.15 L1, each
averaged over the channels.

The optimizer is AMSGrad with optax's rule, which the configuration's
``{"type": "Adam", "args": {"amsgrad": true}}`` block selects in this
system (it keeps the maximum of the bias-corrected second moment). The
random draws of a step (the per-sample flip, mode 1's CV-mask dropout, the
MaskModule's dropout) are made with the same calls, in the same order, on
generators seeded as the benchmark seeds the program's.

It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from bench_h100.reference.monorec import PRECISION, MonoRecReference

Tensor = torch.Tensor
INF = float("inf")
_GAUSS = ((0.0947, 0.1183, 0.0947), (0.1183, 0.1478, 0.1183), (0.0947, 0.1183, 0.0947))


# ----- photometric error and warps -------------------------------------------


def photo_error(x: Tensor, y: Tensor) -> Tensor:
    """(N, C, H, W) pair -> (N, H, W): 0.85 mean_c SSIM + 0.15 mean_c |x - y|."""
    c = x.shape[1]
    k = torch.tensor(_GAUSS, dtype=x.dtype, device=x.device).expand(c, 1, 3, 3)

    def win(t):
        return F.conv2d(F.pad(t, (1, 1, 1, 1)), k, groups=c)

    mu_x, mu_y = win(x), win(y)
    s_x = win(x * x) - mu_x * mu_x
    s_y = win(y * y) - mu_y * mu_y
    s_xy = win(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + 0.01**2) * (2 * s_xy + 0.03**2)
    d = (mu_x * mu_x + mu_y * mu_y + 0.01**2) * (s_x + s_y + 0.03**2)
    ssim = torch.clamp(1 - n / d, 0, 1) / 2
    return 0.85 * ssim.mean(1) + 0.15 * (x - y).abs().mean(1)


def _invert_pose(p: Tensor) -> Tensor:
    r_t = p[..., :3, :3].transpose(-1, -2)
    t = -(r_t @ p[..., :3, 3:])
    out = torch.zeros_like(p)
    out[..., :3, :3] = r_t
    out[..., :3, 3:] = t
    out[..., 3, 3] = 1
    return out


def _invert_k(k: Tensor) -> Tensor:
    inv = torch.zeros_like(k)
    inv[..., 0, 0] = 1 / k[..., 0, 0]
    inv[..., 0, 2] = -k[..., 0, 2] / k[..., 0, 0]
    inv[..., 1, 1] = 1 / k[..., 1, 1]
    inv[..., 1, 2] = -k[..., 1, 2] / k[..., 1, 1]
    inv[..., 2, 2] = inv[..., 3, 3] = 1
    return inv


def warp_grids(depth: Tensor, poses: Tensor, intrinsics: Tensor, kf_pose: Tensor,
               kf_intrinsics: Tensor) -> Tensor:
    """Sampling grids (B, F, H, W, 2) that warp each frame onto the keyframe
    by the metric ``depth`` (B, H, W), in MonoRec's normalization."""
    b, h, w = depth.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=depth.dtype, device=depth.device),
                            torch.arange(w, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, h * w)
    rays = _invert_k(kf_intrinsics)[:, :3, :3] @ pix  # (B, 3, HW)
    pts = torch.cat([depth.reshape(b, 1, h * w) * rays, torch.ones_like(rays[:, :1])], 1)
    rel = _invert_pose(poses) @ kf_pose[:, None]  # (B, F, 4, 4)
    cam = (intrinsics @ rel)[:, :, :3] @ pts[:, None]  # (B, F, 3, HW)
    xy = cam[:, :, :2] / (cam[:, :, 2:3] + 1e-7)
    denom = torch.tensor([w - 1, h - 1], dtype=xy.dtype, device=xy.device)[:, None]
    xy = (xy / denom - 0.5) * 2
    return xy.reshape(b, -1, 2, h, w).movedim(2, -1)


def _frames(data: Dict, mono: bool, stereo: bool):
    fr, po, kk = [], [], []
    if mono:
        fr.append(data["frames"])
        po.append(data["poses"])
        kk.append(data["intrinsics"])
    if stereo:
        fr.append(data["stereoframe"][:, None])
        po.append(data["stereoframe_pose"][:, None])
        kk.append(data["stereoframe_intrinsics"][:, None])
    return torch.cat(fr, 1), torch.cat(po, 1), torch.cat(kk, 1)


def _sample(images: Tensor, grids: Tensor) -> Tensor:
    """(N, C, H, W) sampled at (N, H, W, 2) grids; the grids carry the
    gradient, the images are data."""
    return F.grid_sample(images, grids, "bilinear", "zeros", align_corners=False)


def reprojection(inv_depth: Tensor, data: Dict, mono: bool, stereo: bool,
                 automask: Optional[Tensor] = None, border: int = 0) -> Tensor:
    """Per-pixel photometric error (B, H, W) of the best frame, +inf where no
    frame is valid (or, with ``automask`` (B, F, H, W), where the un-warped
    frame scores better)."""
    kf = data["keyframe"]
    b, c, h, w = kf.shape
    frames, poses, intr = _frames(data, mono, stereo)
    f = frames.shape[1]
    depth = 1.0 / inv_depth[:, 0]
    grids = warp_grids(depth, poses, intr, data["keyframe_pose"], data["keyframe_intrinsics"])
    flat_g = grids.reshape(b * f, h, w, 2)
    warped = _sample((frames + 1.5).reshape(b * f, c, h, w), flat_g).reshape(b, f, c, h, w)
    invalid = warped[:, :, 0] == 0
    if border > 0:
        bm = torch.zeros(h, w, device=kf.device)
        bm[border:h - border, border:w - border] = 1
        with torch.no_grad():
            wbm = _sample(bm.expand(b * f, 1, h, w), flat_g.detach()).reshape(b, f, h, w)
        invalid = ~(wbm > 0.5)
    key = (kf + 0.5)[:, None].expand(b, f, c, h, w).reshape(b * f, c, h, w)
    err = photo_error((warped - 1.0).reshape(b * f, c, h, w), key).reshape(b, f, h, w)
    err = torch.where(invalid, INF, err)
    if automask is not None:
        err = torch.where(automask < err, INF, err)
    return err.amin(1)


def identity_errors(data: Dict, mono: bool, stereo: bool) -> Tensor:
    kf = data["keyframe"]
    b, c, h, w = kf.shape
    frames, _, _ = _frames(data, mono, stereo)
    f = frames.shape[1]
    key = (kf + 0.5)[:, None].expand(b, f, c, h, w).reshape(b * f, c, h, w)
    return photo_error((frames + 0.5).reshape(b * f, c, h, w), key).reshape(b, f, h, w)


def mask_mean(t: Tensor, invalid: Tensor) -> Tensor:
    invalid = torch.broadcast_to(invalid, t.shape)
    return torch.where(invalid, 0.0, t).sum() / (t.numel() - invalid.sum())


def smoothness(inv_depth: Tensor, keyframe: Tensor, reduce: bool = True):
    d = inv_depth / inv_depth.mean(dim=(2, 3), keepdim=True)
    d_dx = (d[..., :, :-1] - d[..., :, 1:]).abs() * torch.exp(
        -(keyframe[..., :, :-1] - keyframe[..., :, 1:]).abs().mean(1, keepdim=True))
    d_dy = (d[..., :-1, :] - d[..., 1:, :]).abs() * torch.exp(
        -(keyframe[..., :-1, :] - keyframe[..., 1:, :]).abs().mean(1, keepdim=True))
    if reduce:
        return d_dx.mean() + d_dy.mean()
    return F.pad(d_dx, (0, 1)) + F.pad(d_dy, (0, 0, 0, 1))


def sparse_l1(pred: Tensor, gt: Tensor):
    return (pred - gt).abs(), gt == 0


def upsample_to(x: Tensor, h: int, w: int) -> Tensor:
    """Nearest resize: source index i * h_in // h."""
    hi, wi = x.shape[-2:]
    if (hi, wi) == (h, w):
        return x
    ys = torch.arange(h, device=x.device) * hi // h
    xs = torch.arange(w, device=x.device) * wi // w
    return x[..., ys, :][..., xs]


def _tile(data: Dict, n: int) -> Dict:
    keys = ("keyframe", "keyframe_pose", "keyframe_intrinsics", "frames", "poses", "intrinsics",
            "stereoframe", "stereoframe_pose", "stereoframe_intrinsics")
    return {k: data[k].repeat(n, *([1] * (data[k].dim() - 1))) for k in keys if k in data}


def _nan0(t: Tensor) -> Tensor:
    return torch.where(torch.isnan(t), 0.0, t)


# ----- the stage losses ------------------------------------------------------


def depth_loss(data: Dict, alpha: float, stereo: bool = False) -> Tensor:
    """Stage 1: 8 alpha sum_s sdl_s + 2 (1 - alpha) sum_s md2l_s."""
    gt = torch.clamp(data["target"], 0, 100)
    b, _, h, w = gt.shape
    preds = [upsample_to(torch.clamp_min(p, 0), h, w) for p in data["predicted_inverse_depths"]]
    s = len(preds)
    sdl = 0.0
    for p in preds:
        err, inv = sparse_l1(p, gt)
        sdl = sdl + _nan0(mask_mean(err, inv))
    am = identity_errors(data, True, stereo).repeat(s, 1, 1, 1)
    r = reprojection(torch.cat(preds), _tile(data, s), True, stereo, automask=am)
    invalid = torch.isinf(r).reshape(s, b, h, w)
    r = torch.where(invalid, 0.0, r.reshape(s, b, h, w))
    md2l = 0.0
    for i, p in enumerate(preds):
        md2l = md2l + _nan0(mask_mean(r[i], invalid[i])) + _nan0(
            smoothness(p, data["keyframe"])) * 1e-3 / 2**i
    return 2 * alpha * 4 * sdl + 2 * (1 - alpha) * md2l


def depth_refinement_loss(data: Dict, alpha: float, options: Sequence[str]) -> Tensor:
    """Stage 4: static pixels by the sparse GT and the mono reprojection,
    moving ones (cv_mask > 0.5) by the stereo prediction and the stereo
    reprojection; the sparse terms detached."""
    stereo = "stereo" in options
    stereo_repr = "stereo_repr" in options
    gt = torch.clamp(data["target"], 0, 100)
    b, _, h, w = gt.shape
    disc = (data["cv_mask"] > 0.5).float()
    ratio = disc.mean()
    mono = [upsample_to(p, h, w) for p in data["mono_pred"]]
    s = len(mono)
    stacked, tiled = torch.cat(mono), _tile(data, s)
    am = identity_errors(data, True, stereo).repeat(s, 1, 1, 1)
    mono_all = reprojection(stacked, tiled, True, stereo, automask=am).reshape(s, b, 1, h, w)
    if stereo_repr:
        st_all = reprojection(stacked, tiled, False, True, border=3).reshape(s, b, 1, h, w)
    sdl_sum = md2l_sum = 0.0
    for i, (mp, sp) in enumerate(zip(mono, data["stereo_pred"])):
        err, inv = sparse_l1(mp, gt * (1 - disc))
        mono_sdl = mask_mean(err.detach(), inv)
        sp = upsample_to(sp, h, w).detach()
        err, inv = sparse_l1(mp, sp * disc)
        stereo_sdl = mask_mean(err, inv).detach()
        sdl_sum = sdl_sum + mono_sdl * (1 - ratio) + stereo_sdl * ratio * 4
        smooth = smoothness(mp, data["keyframe"], reduce=False).mean()
        m_inf = torch.isinf(mono_all[i]) | (disc > 0.5)
        m_rep = mask_mean(torch.where(m_inf, 0.0, mono_all[i]), m_inf)
        if stereo_repr:
            s_inf = torch.isinf(st_all[i]) | (disc <= 0.5)
            s_rep = mask_mean(torch.where(s_inf, 0.0, st_all[i]), s_inf)
        else:
            s_rep = torch.zeros_like(m_rep)
        md2l_sum = md2l_sum + m_rep * (1 - ratio) + s_rep * ratio + smooth * 1e-3 / 2**i
    return 2 * alpha * 4 * sdl_sum + 2 * (1 - alpha) * md2l_sum


# ----- the optimizer ---------------------------------------------------------


class AMSGrad:
    """optax's AMSGrad at a constant learning rate:

        mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2
        nu_max = max(nu_max, nu / (1 - b2^t))
        p -= lr (mu / (1 - b1^t)) / (sqrt(nu_max) + eps)

    with the bias corrections in float32, as optax computes them."""

    def __init__(self, params: Dict[str, Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.state: Dict[str, Dict] = {}

    @staticmethod
    def _correction(decay: float, t: int) -> float:
        import numpy as np

        return float(np.float32(1) - np.float32(decay) ** t)

    @torch.no_grad()
    def step(self) -> None:
        b1, b2 = self.betas
        for name, p in self.params.items():
            if p.grad is None:
                continue
            st = self.state.setdefault(name, {"t": 0, "mu": torch.zeros_like(p),
                                              "nu": torch.zeros_like(p),
                                              "nu_max": torch.zeros_like(p)})
            st["t"] += 1
            t, g = st["t"], p.grad
            st["mu"].mul_(b1).add_(g * (1 - b1))
            st["nu"].mul_(b2).add_(g * g * (1 - b2))
            torch.maximum(st["nu_max"], st["nu"] / self._correction(b2, t), out=st["nu_max"])
            u = (st["mu"] / self._correction(b1, t)) / (st["nu_max"].sqrt() + self.eps)
            p.add_(u * -self.lr)


# ----- the steps -------------------------------------------------------------


def hflip(x: Tensor, flip: Tensor) -> Tensor:
    cond = flip.to(x.device).reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return torch.where(cond, x.flip(-1), x)


class ReferenceTrainer:
    """Replays the first steps of a stage's training from the benchmark's
    weights, batches and seeds.

    ``stage``: 4 (``monorec_depth_ref.json``: mode 0, the mask frozen, the
    stereo cost volume and decode, ``mult_mask_on_cv``) or 1
    (``monorec_depth.json``: mode 1, CV-mask dropout at rate
    ``pretrain_dropout``). ``fault`` plants one of the faults that the
    comparison has to catch, for the calibration: ``"half_batch"`` (the
    loss over the first half of the rows) or ``"no_exchange"`` (the gradient
    through the rows of the first of ``ranks`` ranks only, as a rank whose
    gradients are not all-reduced applies it)."""

    def __init__(self, stage: int, state_dict: Dict[str, Tensor], depth_steps: int,
                 inv_depth_min_max, lr: float, draw_seed: int, device, options=(),
                 alpha: float = 0.5, pretrain_dropout: float = 0.0, fault: Optional[str] = None,
                 ranks: int = 1):
        self.stage, self.options, self.alpha = stage, tuple(options), alpha
        self.pretrain_dropout, self.fault, self.ranks = pretrain_dropout, fault, ranks
        self.model = MonoRecReference(depth_steps, inv_depth_min_max, mask=stage == 4).to(device)
        self.model.load_state_dict(state_dict, strict=stage == 4)
        self.model.requires_grad_(False)
        self.params = {k: p for k, p in self.model.named_parameters()
                       if k.startswith("depth_module.")}
        for p in self.params.values():
            p.requires_grad_(True)
        self.optimizer = AMSGrad(self.params, lr)
        self.cpu_gen = torch.Generator().manual_seed(draw_seed)
        self.dev_gen = torch.Generator(device=device).manual_seed(draw_seed)

    def _rows(self, t: Tensor) -> Tensor:
        """Predictions as a planted fault sees them."""
        if self.fault == "no_exchange":
            n = t.shape[0] // self.ranks
            return torch.cat([t[:n], t[n:].detach()])
        return t

    def _stage4(self, batch: Dict) -> Tensor:
        m = self.model
        b = batch["keyframe"].shape[0]
        flip = torch.rand(b, generator=self.cpu_gen) < 0.5
        kf_aug = hflip(batch["keyframe"], flip)
        feats = m.features(kf_aug)
        with torch.no_grad():
            cv_s, _ = m.cost_volume(batch, stereo=True)
            cv_m, sfcv_m = m.cost_volume(batch)
            cv_s, cv_m, sfcv_m = (hflip(t, flip) for t in (cv_s, cv_m, sfcv_m))
            h, w = kf_aug.shape[-2:]
            widths = (m.depth_steps, 48, 64, 96, 96)
            keep = [torch.rand((b, c, h >> i, w >> i), generator=self.dev_gen,
                               device=kf_aug.device) < 0.5 for i, c in enumerate(widths)]
            cv_mask = m.att_module(sfcv_m, feats, keep)
            cv_m = cv_m * (1 - cv_mask)
            stereo_pred = m.depth(cv_s, kf_aug, feats)
        mono_pred = [self._rows(p) for p in m.depth(cv_m, kf_aug, feats)]
        data = {**batch, "cv_mask": hflip(cv_mask, flip),
                "mono_pred": [hflip(p, flip) for p in mono_pred],
                "stereo_pred": [hflip(p, flip) for p in stereo_pred]}
        return depth_refinement_loss(data, self.alpha, self.options), data["mono_pred"][0]

    def _stage1(self, batch: Dict) -> Tensor:
        m = self.model
        b, _, h, w = batch["keyframe"].shape
        with torch.no_grad():
            cv, _ = m.cost_volume(batch)
        flip = torch.rand(b, generator=self.cpu_gen) < 0.5
        kf_aug, cv = hflip(batch["keyframe"], flip), hflip(cv, flip)
        feats = m.features(kf_aug)
        keep_p = self.pretrain_dropout
        draw = torch.bernoulli(torch.full((b, 1, h // 8, w // 8), keep_p), generator=self.cpu_gen)
        cv_mask = (draw / max(keep_p, 1e-8)).to(cv.device)
        cv_mask = cv_mask.repeat_interleave(8, 2).repeat_interleave(8, 3)
        preds = [self._rows(p) for p in m.depth((1 - cv_mask) * cv, kf_aug, feats)]
        data = {**batch, "predicted_inverse_depths": [hflip(p, flip) for p in preds]}
        return (depth_loss(data, self.alpha, "stereo" in self.options),
                data["predicted_inverse_depths"][0])

    def step(self, batch: Dict) -> Dict:
        """One step on ``batch``; returns its loss, its inverse depth
        (``result``) and, per trained leaf, the gradient norm the optimizer
        got."""
        if self.fault == "half_batch":
            n = batch["keyframe"].shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
        for p in self.params.values():
            p.grad = None
        loss, result = self._stage4(batch) if self.stage == 4 else self._stage1(batch)
        loss.backward()
        grads = {k: float(p.grad.double().norm()) for k, p in self.params.items()
                 if p.grad is not None}
        finite = all(math.isfinite(g) for g in grads.values())
        if finite:
            self.optimizer.step()
        return {"loss": float(loss.detach()), "grad_norms": grads,
                "result": result.detach().float().cpu()}

    def updates(self, start: Dict[str, Tensor]) -> Dict[str, float]:
        """Per trained leaf, the norm of its change since ``start``."""
        return {k: float((p.detach() - start[k].to(p.device)).double().norm())
                for k, p in self.params.items()}


def replay(stage: int, state_dict: Dict[str, Tensor], batches: List[Dict], exact: bool = True,
           **kwargs) -> Dict:
    """The reference's losses of ``len(batches)`` steps, the gradient norms
    and inverse depth of the first, and the update norms after the last; ``exact=False`` is
    the control (convolutions on TF32 operands)."""
    start = {k: v.detach().clone() for k, v in state_dict.items()}
    PRECISION.exact = exact
    with PRECISION:
        trainer = ReferenceTrainer(stage, state_dict, **kwargs)
        out = {"losses": [], "grad_norms": None}
        for batch in batches:
            r = trainer.step(batch)
            out["losses"].append(r["loss"])
            if out["grad_norms"] is None:
                out["grad_norms"], out["first_result"] = r["grad_norms"], r["result"]
        out["update_norms"] = trainer.updates(start)
        return out
