"""Every optimizer and schedule of the port (``monorec_tpu_torch/train/
state.py``) against the JAX package's optax mapping
(``monorec_tpu/train/state.py``) on the CPU.

Optimizers: ten steps on seeded float32 parameters and gradients (some
gradient entries exactly 0), under a StepLR schedule, each optimizer with
and without ``weight_decay`` and with its options; parameters within
rtol 1e-6, atol 1e-7 after every step. The optax update runs under
``jax.jit``, as in the JAX trainer's compiled step: there ``b2 ** count``
is XLA's float32 power, where an eager call takes binary exponentiation,
whose last bit moves RAdam's ill-conditioned rho (``1999 - 1996`` at the
third step) by ~1e-2. Schedules: ``schedule(step)``
against the optax schedule at every step from 0 past the last boundary
(every boundary crossed, at 1, 3 and 7 steps per epoch), within rtol 1e-6;
the cosine shapes also within 4 float32 units in the last place of their
cosine term's amplitude, since ``np.cos`` and XLA's float32 cosine differ in
the last bit at some arguments (where the cosine cancels, near the end of a
decay, that bit is a large share of the value).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monorec_tpu.train.state import make_optimizer as j_make_optimizer
from monorec_tpu.train.state import make_schedule as j_make_schedule
from monorec_tpu_torch.cli import train as train_cli
from monorec_tpu_torch.train import make_optimizer, make_schedule
from monorec_tpu_torch.train.state import OPTIMIZERS, SCHEDULES

RTOL, ATOL = 1e-6, 1e-7
STEPS = 10
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
SCHED = {"type": "StepLR", "args": {"step_size": 2, "gamma": 0.5}}

OPTIONS = {  # beyond lr and weight_decay
    "Adam": [{"amsgrad": True, "betas": [0.8, 0.99]}],
    "AdamW": [{"weight_decay": 0.0}, {"amsgrad": True, "eps": 1e-6}],
    "SGD": [{"momentum": 0.9}, {"momentum": 0.9, "nesterov": True}, {"momentum": 0}],
    "RMSprop": [{"momentum": 0.5}, {"centered": True, "alpha": 0.9},
                {"centered": True, "momentum": 0.3, "eps": 1e-6}],
    "Adagrad": [{"initial_accumulator_value": 0.1, "eps": 1e-8}],
    "Adadelta": [{"rho": 0.95, "eps": 1e-5}],
    "Adamax": [{"betas": [0.85, 0.98]}],
    "RAdam": [{"betas": [0.9, 0.99]}],
    "NAdam": [{"betas": [0.95, 0.9]}],
}
CASES = ([(kind, {}) for kind in OPTIMIZERS]
         + [(kind, {"weight_decay": 0.05}) for kind in OPTIMIZERS]
         + [(kind, o) for kind, opts in OPTIONS.items() for o in opts])


@pytest.mark.parametrize("kind,args", CASES, ids=[
    f"{k}-{'-'.join(f'{a}={v}' for a, v in o.items()) or 'plain'}" for k, o in CASES])
def test_optimizer_matches_optax(kind, args):
    cfg = {"type": kind, "args": {"lr": 0.01, **args}}
    rng = np.random.default_rng(len(kind))
    params = [(0.3 * rng.normal(size=s)).astype(np.float32) for s in ((6, 5), (7,))]
    grads = []
    for scale in (3.0, 0.1, 0.5, 1.0, 2.0, 0.3, 1.0, 0.05, 1.0, 2.0)[:STEPS]:
        g = [(scale * rng.normal(size=p.shape)).astype(np.float32) for p in params]
        g[0][0, :2] = 0.0  # Adagrad's where(sum > 0) and zero moments
        grads.append(g)
    tx = j_make_optimizer(cfg, SCHED, steps_per_epoch=3)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = make_optimizer(tp, cfg, SCHED, steps_per_epoch=3)
    assert type(opt).__name__ == kind
    for step, g in enumerate(grads):
        updates, state = update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        opt.step()
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {step}")
    assert all(s["step"] == STEPS for s in opt.state.values())


# (config, boundaries in epochs, cosine amplitude as a share of lr or None)
SCHEDULE_CASES = {
    "StepLR": [({"step_size": 3, "gamma": 0.1}, [3, 6, 9, 12]),
               ({"step_size": 2, "gamma": 0.9}, [2 * i for i in range(1, 40)])],
    "ExponentialLR": [({"gamma": 0.9}, list(range(1, 60))), ({}, [1, 2, 3])],
    "MultiStepLR": [({"milestones": [2, 5, 5, 9], "gamma": 0.3}, [2, 5, 9])],
    "CosineAnnealingLR": [({"T_max": 7}, [7]), ({"T_max": 4, "eta_min": 1e-5}, [4])],
    "LinearLR": [({"start_factor": 0.25, "end_factor": 0.0, "total_iters": 4}, [4]), ({}, [5])],
    "ConstantLR": [({"factor": 0.5, "total_iters": 3}, [3])],
    "OneCycleLR": [({"total_steps": 97}, []), ({"total_steps": 40, "max_lr": 0.01,
                                               "pct_start": 0.25}, [])],
}


def _amplitude(kind: str, args: dict, lr: float) -> float:
    if kind == "CosineAnnealingLR":
        return (lr - args.get("eta_min", 0.0)) / 2
    if kind == "OneCycleLR":
        return args.get("max_lr", lr) / 2
    return 0.0


@pytest.mark.parametrize("kind", SCHEDULES)
def test_schedule_matches_optax(kind):
    lr = 1e-3
    for args, epochs in SCHEDULE_CASES[kind]:
        cfg = {"type": kind, "args": args}
        for spe in (1, 3, 7):
            ours, ref = make_schedule(lr, cfg, spe), j_make_schedule(lr, cfg, spe)
            last = max([e * spe for e in epochs] + [args.get("total_steps", 0)])
            slack = 4 * _amplitude(kind, args, lr) * 2.0**-24
            for step in range(0, last + 3 * spe + 2):
                want = float(ref(jnp.int32(step)))
                got = ours(step)
                assert abs(got - want) <= RTOL * abs(want) + slack, (args, spe, step, got, want)
    assert make_schedule(0.5, None, 5)(1000) == 0.5


def test_no_name_the_jax_factory_maps_raises():
    p = [torch.zeros(3, requires_grad=True)]
    for kind in OPTIMIZERS:
        for sched in SCHEDULES:
            j_make_optimizer({"type": kind, "args": {"lr": 0.1}}, {"type": sched, "args": {}}, 4)
            make_optimizer(p, {"type": kind, "args": {"lr": 0.1}}, {"type": sched, "args": {}}, 4)
    # The port refuses arguments the JAX factory would ignore.
    with pytest.raises(ValueError, match="unknown SGD arguments"):
        make_optimizer(p, {"type": "SGD", "args": {"lr": 0.1, "dampening": 0.1}})
    with pytest.raises(ValueError, match="unsupported optimizer"):
        make_optimizer(p, {"type": "LBFGS", "args": {}})


@pytest.fixture
def one_thread():
    """One intra-op thread: torch's default of one per core oversubscribes
    the cores beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_non_adam_state_round_trips_through_resume(tmp_path, one_thread):
    """RMSprop with its momentum trace, through a checkpoint and the
    trainer's ``resume``: the resumed optimizer state equals the saved one,
    and the next step of both trainers (the same batch and draws) gives the
    same parameters."""
    with open(CONFIGS / "smoke" / "train_synthetic.json") as f:
        config = json.load(f)
    config["arch"]["args"].update(cv_depth_steps=4)
    config["data_loader"]["args"].update(length=4, batch_size=2, target_image_size=[32, 64])
    config["trainer"].update(save_dir=str(tmp_path), log_step=1, len_epoch=2, epochs=1,
                             module_timing=False, tensorboard=False)
    config["optimizer"] = {"type": "RMSprop", "args": {"lr": 1e-3, "momentum": 0.5,
                                                       "centered": True}}
    config["lr_scheduler"] = {"type": "CosineAnnealingLR", "args": {"T_max": 3}}
    trainer = train_cli.build_trainer(config, "cpu")
    trainer.train()
    again = train_cli.build_trainer(config, "cpu", run_dir=tmp_path / "again")
    again.resume(trainer.run_dir / "checkpoint.pth")
    saved, loaded = trainer.optimizer.state_dict(), again.optimizer.state_dict()
    assert saved["param_groups"] == loaded["param_groups"]
    assert set(saved["state"]) == set(loaded["state"]) and saved["state"]
    for i, s in saved["state"].items():
        assert set(s) == {"step", "nu", "mu", "trace"} and s["step"] == 2
        assert all(torch.equal(v, loaded["state"][i][k]) if torch.is_tensor(v)
                   else v == loaded["state"][i][k] for k, v in s.items())
    batch = next(iter(trainer.data_loader))
    for t in (trainer, again):
        t.generator.manual_seed(5)
        t.device_generator.manual_seed(5)
        t.train_step(batch, 0.5)
    for (k, p), q in zip(trainer.model.state_dict().items(), again.model.state_dict().values()):
        assert torch.equal(p, q), k
