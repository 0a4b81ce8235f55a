"""Optimizer and learning-rate schedule from the reference's JSON config
blocks (``monorec_tpu/train/state.py``).

The JAX package maps ``{"type": "Adam", "args": {...}}`` onto optax, and the
port is held to it, so ``Adam`` here follows optax's rules, not
``torch.optim.Adam``'s. The two differ with ``amsgrad``: optax keeps the
running maximum of the bias-corrected second moment, ``torch.optim.Adam``
the maximum of the raw moment, corrected afterwards; they agree on the first
step only. The learning rate is a per-step schedule evaluated at the
optimizer's own step count, as in optax, so a skipped update also holds the
schedule. Ported: Adam (plain and amsgrad, with L2 weight decay added to the
gradient) and the schedules StepLR and none (constant); every other name
raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]


def make_schedule(lr: float, scheduler_cfg: Optional[Dict], steps_per_epoch: int) -> Schedule:
    """Per-step learning rate. StepLR becomes a staircase with
    ``transition_steps = step_size * steps_per_epoch``
    (``optax.exponential_decay(staircase=True)``)."""
    if not scheduler_cfg:
        return lambda step: lr
    kind = scheduler_cfg.get("type", "StepLR")
    args = scheduler_cfg.get("args", {})
    if kind != "StepLR":
        raise NotImplementedError(f"lr scheduler '{kind}' is not ported yet (ported: StepLR)")
    transition = args.get("step_size", 30) * steps_per_epoch
    gamma = args.get("gamma", 0.1)
    return lambda step: lr * gamma ** (step // transition)


class Adam(torch.optim.Optimizer):
    """Adam and AMSGrad with optax's update rule
    (``optax.scale_by_adam`` / ``optax.scale_by_amsgrad``, then
    ``-schedule(count)``):

        mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2
        mu_hat = mu / (1 - b1^t),  nu_hat = nu / (1 - b2^t)
        amsgrad: nu_hat = nu_max = max(nu_max, nu_hat)
        p -= lr(t - 1) * mu_hat / (sqrt(nu_hat) + eps)

    with t the 1-based step count, kept per parameter. ``weight_decay``
    adds ``wd * p`` to the gradient first (``optax.add_decayed_weights``).
    """

    def __init__(self, params: Iterable, schedule: Schedule, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, amsgrad: bool = False):
        super().__init__(params, dict(betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                                      amsgrad=amsgrad))
        self.schedule = schedule

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                    if group["amsgrad"]:
                        state["nu_max"] = torch.zeros_like(p)
                lr = self.schedule(state["step"])
                state["step"] += 1
                t = state["step"]
                mu, nu = state["mu"], state["nu"]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                # The corrections in float32, as optax computes them; a
                # float32 value as a Python scalar stays exact in the ops.
                c1 = float(np.float32(1) - np.float32(b1) ** t)
                c2 = float(np.float32(1) - np.float32(b2) ** t)
                nu_hat = nu / c2
                if group["amsgrad"]:
                    torch.maximum(state["nu_max"], nu_hat, out=state["nu_max"])
                    nu_hat = state["nu_max"]
                p.sub_(lr * ((mu / c1) / (nu_hat.sqrt() + group["eps"])))


def make_optimizer(params: Iterable, optimizer_cfg: Optional[Dict] = None,
                   scheduler_cfg: Optional[Dict] = None,
                   steps_per_epoch: int = 1000) -> Adam:
    """The optimizer of a config's ``optimizer`` and ``lr_scheduler`` blocks."""
    cfg = optimizer_cfg or {"type": "Adam", "args": {"lr": 1e-4}}
    kind = cfg.get("type", "Adam")
    if kind != "Adam":
        raise NotImplementedError(f"optimizer '{kind}' is not ported yet (ported: Adam)")
    args = dict(cfg.get("args", {}))
    schedule = make_schedule(args.pop("lr", 1e-4), scheduler_cfg, steps_per_epoch)
    opt = Adam(params, schedule, betas=args.pop("betas", (0.9, 0.999)),
               eps=args.pop("eps", 1e-8), weight_decay=args.pop("weight_decay", 0.0) or 0.0,
               amsgrad=args.pop("amsgrad", False))
    if args:
        raise ValueError(f"unknown Adam arguments {sorted(args)}")
    return opt
