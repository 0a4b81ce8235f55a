"""Optimizers and learning-rate schedules from the reference's JSON config
blocks (``monorec_tpu/train/state.py``).

The JAX package maps ``{"type": ..., "args": {...}}`` onto optax, and the
port is held to it, so every optimizer here follows optax's rule, not
``torch.optim``'s: RMSprop scales by ``rsqrt(nu + eps)``, NAdam is optax's
Nesterov Adam, Adadelta is scaled by the configured learning rate, Adam's
``amsgrad`` keeps the maximum of the bias-corrected second moment. Each is a
``torch.optim.Optimizer`` (so ``state_dict`` round-trips through the
trainer's ``resume``) that keeps a step count per parameter and evaluates
the schedule at the count before its increment, as optax does; a skipped
update also holds the schedule. A ``weight_decay`` adds ``wd * p`` to the
gradient before the optimizer (``optax.add_decayed_weights`` chained in
front), except AdamW's, which is decoupled (added to the Adam direction)
and defaults to 0.01 when absent.

Schedules are per step; the epoch-based torch schedulers change at
multiples of ``steps_per_epoch``. CosineAnnealingLR holds at ``eta_min``
after ``T_max`` epochs (optax's cosine decay, not periodic); ConstantLR is a
constant learning rate (the JAX package ignores torch's ``factor`` and
``total_iters``); OneCycleLR's ``total_steps`` counts steps. Every
schedule is computed in float32 in optax's order of operations (a float32
``gamma`` raised to a large power, and the cosine and linear shapes near
their ends, where they cancel, differ from float64); ``np.cos`` and XLA's
float32 cosine can still part in the last bit.
Arguments a factory does not know raise, where the JAX package ignores them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]
_F32 = np.float32


# ----- schedules -------------------------------------------------------------


def _exponential_decay(lr: float, transition_steps: int, rate: float) -> Schedule:
    """``optax.exponential_decay(staircase=True)`` in float32, constant where
    optax's is."""
    if transition_steps <= 0 or rate == 0:
        return lambda step: lr

    def schedule(step: int) -> float:
        if step <= 0:
            return lr
        return float(_F32(lr) * np.power(_F32(rate), np.floor(_F32(step) / _F32(transition_steps))))

    return schedule


def _piecewise_constant(lr: float, boundaries, scale: float) -> Schedule:
    """``optax.piecewise_constant_schedule`` in float32 with one ``scale``
    at every boundary: the rate is multiplied by it from that step on."""
    bounds = sorted(set(boundaries))

    def schedule(step: int) -> float:
        value = _F32(lr)
        for b in bounds:
            if step >= b:
                value = _F32(scale) * value
        return float(value)

    return schedule


def _linear(init: float, end: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule`` in float32."""
    if transition_steps <= 0:
        return lambda step: init

    def schedule(step: int) -> float:
        frac = _F32(1) - _F32(min(max(step, 0), transition_steps)) / _F32(transition_steps)
        return float(_F32(init - end) * frac + _F32(end))

    return schedule


def _cosine_decay(lr: float, decay_steps: int, alpha: float) -> Schedule:
    """``optax.cosine_decay_schedule`` in float32."""
    if not decay_steps > 0:
        raise ValueError(f"CosineAnnealingLR needs a positive T_max, got {decay_steps} steps")

    def schedule(step: int) -> float:
        count = _F32(min(step, decay_steps))
        decay = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * count / _F32(decay_steps)))
        return float(_F32(lr) * (_F32(1 - alpha) * decay + _F32(alpha)))

    return schedule


def _cosine_onecycle(total: int, peak: float, pct_start: float, div: float,
                     final_div: float) -> Schedule:
    """``optax.cosine_onecycle_schedule`` in float32: cosine from
    ``peak / div`` up to ``peak`` over the first ``pct_start`` of ``total``
    steps, then down to ``peak / (div * final_div)``, held after."""
    if total <= 0:
        raise ValueError(f"OneCycleLR needs a positive total_steps, got {total}")
    bounds = (0, int(pct_start * total), int(total))
    values = np.cumprod([peak / div, div, 1.0 / (div * final_div)])

    def schedule(step: int) -> float:
        if step >= bounds[2]:
            return float(_F32(values[2]))
        i = 0 if step < bounds[1] else 1
        pct = _F32(step - bounds[i]) / _F32(bounds[i + 1] - bounds[i])
        start, end = values[i], values[i + 1]
        return float(_F32(end) + _F32((start - end) / 2.0)
                     * (np.cos(_F32(np.pi) * pct) + _F32(1)))

    return schedule


SCHEDULES = ("StepLR", "ExponentialLR", "MultiStepLR", "CosineAnnealingLR", "LinearLR",
             "ConstantLR", "OneCycleLR")


def make_schedule(lr: float, scheduler_cfg: Optional[Dict], steps_per_epoch: int) -> Schedule:
    """The per-step learning rate of an ``lr_scheduler`` block (none: the
    constant ``lr``); the block's type defaults to StepLR."""
    if not scheduler_cfg:
        return lambda step: lr
    kind = scheduler_cfg.get("type", "StepLR")
    args = scheduler_cfg.get("args", {})
    if kind == "StepLR":
        return _exponential_decay(lr, args.get("step_size", 30) * steps_per_epoch,
                                  args.get("gamma", 0.1))
    if kind == "ExponentialLR":
        return _exponential_decay(lr, steps_per_epoch, args.get("gamma", 0.95))
    if kind == "MultiStepLR":
        milestones = [int(m) * steps_per_epoch for m in args.get("milestones", [])]
        return _piecewise_constant(lr, milestones, args.get("gamma", 0.1))
    if kind == "CosineAnnealingLR":
        eta_min = args.get("eta_min", 0.0)
        return _cosine_decay(lr, int(args.get("T_max", 50)) * steps_per_epoch,
                             eta_min / lr if lr else 0.0)
    if kind == "LinearLR":
        return _linear(lr * args.get("start_factor", 1.0 / 3.0), lr * args.get("end_factor", 1.0),
                       int(args.get("total_iters", 5)) * steps_per_epoch)
    if kind == "ConstantLR":
        return lambda step: lr
    if kind == "OneCycleLR":
        return _cosine_onecycle(int(args.get("total_steps", steps_per_epoch * 10)),
                                args.get("max_lr", lr), args.get("pct_start", 0.3),
                                args.get("div_factor", 25.0), args.get("final_div_factor", 1e4))
    raise ValueError(f"unsupported lr scheduler '{kind}' (supported: {', '.join(SCHEDULES)})")


# ----- optimizers ------------------------------------------------------------


def _ema(buf: torch.Tensor, x: torch.Tensor, decay: float) -> torch.Tensor:
    """``buf = (1 - decay) x + decay buf`` in place (``optax.tree.update_moment``)."""
    return buf.mul_(decay).add_(x * (1 - decay))


def _correction(decay: float, t: int) -> float:
    """``1 - decay^t`` in float32, as optax's bias correction computes it; a
    float32 value as a Python scalar stays exact in the tensor ops."""
    return float(_F32(1) - _F32(decay) ** t)


def _trace(state: Dict, x: torch.Tensor, decay: float, nesterov: bool) -> torch.Tensor:
    """``optax.trace``: ``trace = x + decay trace``; returns the trace, or
    with ``nesterov`` ``x + decay trace``."""
    tr = state["trace"]
    tr.copy_(x + tr * decay)
    return x + tr * decay if nesterov else tr


class OptaxRule(torch.optim.Optimizer):
    """An optimizer with optax's per-step protocol. A subclass names its
    config arguments (``CONFIG_ARGS``), starts its state (``_init``) and
    gives the update direction (``_direction``); the step does the rest:

        g = grad (+ wd * p unless DECOUPLED)
        u = direction(g) (+ wd * p if DECOUPLED)
        p += -schedule(t - 1) * u

    with t the parameter's 1-based step count."""

    CONFIG_ARGS: tuple = ()
    DECOUPLED = False

    def __init__(self, params: Iterable, schedule: Schedule, weight_decay: float = 0.0,
                 **hyper):
        super().__init__(params, dict(weight_decay=weight_decay or 0.0, **hyper))
        self.schedule = schedule

    def _init(self, p: torch.Tensor, state: Dict, group: Dict) -> None:
        raise NotImplementedError

    def _direction(self, g: torch.Tensor, state: Dict, group: Dict, t: int) -> torch.Tensor:
        raise NotImplementedError

    def _apply(self, p: torch.Tensor, update: torch.Tensor, state: Dict, group: Dict) -> None:
        """``p += update``, the learning-rate-scaled direction."""
        p.add_(update)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__}.step takes no closure")
        rates: Dict[int, float] = {}
        for group in self.param_groups:
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd and not self.DECOUPLED:
                    g = g + wd * p
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    self._init(p, state, group)
                t = state["step"]
                if t not in rates:
                    rates[t] = self.schedule(t)
                lr = rates[t]
                state["step"] = t = t + 1
                u = self._direction(g, state, group, t)
                if wd and self.DECOUPLED:
                    u = u + wd * p
                self._apply(p, u * -lr, state, group)


class Adam(OptaxRule):
    """Adam (``optax.adam``) and, with ``amsgrad``, AMSGrad
    (``optax.amsgrad``):

        mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2
        mu_hat = mu / (1 - b1^t),  nu_hat = nu / (1 - b2^t)
        amsgrad: nu_hat = nu_max = max(nu_max, nu_hat)
        u = mu_hat / (sqrt(nu_hat) + eps)

    optax's AMSGrad maxes the bias-corrected moment, ``torch.optim.Adam``
    the raw one, corrected afterwards; they agree on the first step only."""

    CONFIG_ARGS = ("betas", "eps", "amsgrad")

    def __init__(self, params, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, amsgrad: bool = False):
        super().__init__(params, schedule, weight_decay, betas=tuple(betas), eps=eps,
                         amsgrad=amsgrad)

    def _init(self, p, state, group):
        state["mu"] = torch.zeros_like(p)
        state["nu"] = torch.zeros_like(p)
        if group["amsgrad"]:
            state["nu_max"] = torch.zeros_like(p)

    def _direction(self, g, state, group, t):
        b1, b2 = group["betas"]
        mu = _ema(state["mu"], g, b1)
        nu = _ema(state["nu"], g * g, b2)
        nu_hat = nu / _correction(b2, t)
        if group["amsgrad"]:
            torch.maximum(state["nu_max"], nu_hat, out=state["nu_max"])
            nu_hat = state["nu_max"]
        return (mu / _correction(b1, t)) / (nu_hat.sqrt() + group["eps"])


class AdamW(Adam):
    """``optax.adamw``: Adam's direction plus the decoupled ``wd * p``
    (0.01 when the config gives no weight_decay; an explicit 0 holds).
    ``amsgrad`` is accepted and ignored, as in the JAX package."""

    DECOUPLED = True

    def __init__(self, params, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: Optional[float] = None, amsgrad: bool = False):
        super().__init__(params, schedule, betas, eps,
                         0.01 if weight_decay is None else weight_decay, amsgrad=False)


class NAdam(Adam):
    """optax's NAdam (``optax.nadam``, Adam with Nesterov momentum), not
    ``torch.optim.NAdam``'s momentum-decay schedule:

        mu_hat = b1 mu / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)"""

    CONFIG_ARGS = ("betas", "eps")

    def __init__(self, params, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, schedule, betas, eps, weight_decay)

    def _direction(self, g, state, group, t):
        b1, b2 = group["betas"]
        mu = _ema(state["mu"], g, b1)
        nu = _ema(state["nu"], g * g, b2)
        mu_hat = (mu / _correction(b1, t + 1)).mul_(b1).add_((g / _correction(b1, t)) * (1 - b1))
        return mu_hat / ((nu / _correction(b2, t)).sqrt() + group["eps"])


class RAdam(Adam):
    """``optax.radam``: the rectified Adam direction ``r mu_hat / (sqrt(nu_hat)
    + eps)`` where the length of the approximated SMA, ``rho``, reaches 5,
    else ``mu_hat``; the scalars in float32 in optax's order."""

    CONFIG_ARGS = ("betas", "eps")
    THRESHOLD = 5.0

    def __init__(self, params, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, schedule, betas, eps, weight_decay)

    def _direction(self, g, state, group, t):
        b1, b2 = group["betas"]
        mu = _ema(state["mu"], g, b1)
        nu = _ema(state["nu"], g * g, b2)
        mu_hat = mu / _correction(b1, t)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = _F32(b2) ** t
        ro = _F32(ro_inf) - _F32(2 * t) * b2t / (_F32(1) - b2t)
        if ro < self.THRESHOLD:
            return mu_hat
        r = np.sqrt((ro - _F32(4)) * (ro - _F32(2)) * _F32(ro_inf)
                    / (_F32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        return (mu_hat * float(r)) / ((nu / _correction(b2, t)).sqrt() + group["eps"])


class Adamax(OptaxRule):
    """``optax.adamax``: ``nu = max(b2 nu, |g| + eps)`` with no bias
    correction, ``u = mu / (1 - b1^t) / nu``."""

    CONFIG_ARGS = ("betas", "eps")

    def __init__(self, params, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, schedule, weight_decay, betas=tuple(betas), eps=eps)

    def _init(self, p, state, group):
        state["mu"] = torch.zeros_like(p)
        state["nu"] = torch.zeros_like(p)

    def _direction(self, g, state, group, t):
        b1, b2 = group["betas"]
        mu = _ema(state["mu"], g, b1)
        nu = state["nu"]
        nu.copy_(torch.maximum(g.abs() + group["eps"], nu * b2))
        return (mu / _correction(b1, t)) / nu


class SGD(OptaxRule):
    """``optax.sgd``: ``u = g``, or with a non-zero ``momentum`` the trace
    ``tr = g + m tr`` (``u = tr``, with ``nesterov`` ``g + m tr``)."""

    CONFIG_ARGS = ("momentum", "nesterov")

    def __init__(self, params, schedule, momentum: Optional[float] = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        super().__init__(params, schedule, weight_decay, momentum=momentum or None,
                         nesterov=nesterov)

    def _init(self, p, state, group):
        if group["momentum"] is not None:
            state["trace"] = torch.zeros_like(p)

    def _direction(self, g, state, group, t):
        if group["momentum"] is None:
            return g
        return _trace(state, g, group["momentum"], group["nesterov"])


class RMSprop(OptaxRule):
    """``optax.rmsprop`` with eps inside the root:
    ``u = g rsqrt(nu + eps)``, centered ``g rsqrt(nu - mu^2 + eps)``; then a
    trace of the learning-rate-scaled update with decay ``momentum``
    (present at 0, as the JAX package passes 0.0)."""

    CONFIG_ARGS = ("alpha", "eps", "momentum", "centered")

    def __init__(self, params, schedule, alpha: float = 0.99, eps: float = 1e-8,
                 momentum: Optional[float] = 0.0, centered: bool = False,
                 weight_decay: float = 0.0):
        super().__init__(params, schedule, weight_decay, alpha=alpha, eps=eps,
                         momentum=momentum, centered=centered)

    def _init(self, p, state, group):
        state["nu"] = torch.zeros_like(p)
        if group["centered"]:
            state["mu"] = torch.zeros_like(p)
        if group["momentum"] is not None:
            state["trace"] = torch.zeros_like(p)

    def _direction(self, g, state, group, t):
        nu = _ema(state["nu"], g * g, group["alpha"])
        if group["centered"]:
            mu = _ema(state["mu"], g, group["alpha"])
            nu = nu - mu * mu
        return torch.rsqrt(nu + group["eps"]) * g

    def _apply(self, p, update, state, group):
        if group["momentum"] is not None:
            update = _trace(state, update, group["momentum"], False)
        p.add_(update)


class Adagrad(OptaxRule):
    """``optax.adagrad``: ``sum += g^2``, ``u = g rsqrt(sum + eps)`` where
    ``sum > 0``, else 0; the JAX package's defaults (accumulator 0, eps
    1e-10), not optax's."""

    CONFIG_ARGS = ("initial_accumulator_value", "eps")

    def __init__(self, params, schedule, initial_accumulator_value: float = 0.0,
                 eps: float = 1e-10, weight_decay: float = 0.0):
        super().__init__(params, schedule, weight_decay,
                         initial_accumulator_value=initial_accumulator_value, eps=eps)

    def _init(self, p, state, group):
        state["sum"] = torch.full_like(p, group["initial_accumulator_value"])

    def _direction(self, g, state, group, t):
        total = state["sum"].add_(g * g)
        return torch.where(total > 0, torch.rsqrt(total + group["eps"]), 0.0) * g


class Adadelta(OptaxRule):
    """``optax.adadelta``, scaled by the configured learning rate (1e-4 when
    absent, not torch's 1.0):
    ``u = sqrt(e_x + eps) / sqrt(e_g + eps) g`` with ``e_g``, ``e_x`` the
    running means of ``g^2`` and ``u^2``."""

    CONFIG_ARGS = ("rho", "eps")

    def __init__(self, params, schedule, rho: float = 0.9, eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, schedule, weight_decay, rho=rho, eps=eps)

    def _init(self, p, state, group):
        state["e_g"] = torch.zeros_like(p)
        state["e_x"] = torch.zeros_like(p)

    def _direction(self, g, state, group, t):
        rho, eps = group["rho"], group["eps"]
        e_g = _ema(state["e_g"], g * g, rho)
        u = (torch.sqrt(state["e_x"] + eps) / torch.sqrt(e_g + eps)) * g
        _ema(state["e_x"], u * u, rho)
        return u


OPTIMIZERS = {cls.__name__: cls for cls in (Adam, AdamW, SGD, RMSprop, Adagrad, Adadelta,
                                           Adamax, RAdam, NAdam)}


def make_optimizer(params: Iterable, optimizer_cfg: Optional[Dict] = None,
                   scheduler_cfg: Optional[Dict] = None,
                   steps_per_epoch: int = 1000) -> OptaxRule:
    """The optimizer of a config's ``optimizer`` and ``lr_scheduler`` blocks
    (none: Adam at lr 1e-4)."""
    cfg = optimizer_cfg or {"type": "Adam", "args": {"lr": 1e-4}}
    kind = cfg.get("type", "Adam")
    if kind not in OPTIMIZERS:
        raise ValueError(f"unsupported optimizer '{kind}' (supported: {', '.join(OPTIMIZERS)})")
    cls = OPTIMIZERS[kind]
    args = dict(cfg.get("args", {}))
    schedule = make_schedule(args.pop("lr", 1e-4), scheduler_cfg, steps_per_epoch)
    weight_decay = args.pop("weight_decay", None)
    unknown = set(args) - set(cls.CONFIG_ARGS)
    if unknown:
        raise ValueError(f"unknown {kind} arguments {sorted(unknown)}")
    if weight_decay is not None or kind != "AdamW":
        args["weight_decay"] = weight_decay
    return cls(params, schedule, **args)
