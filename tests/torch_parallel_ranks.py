"""Rank bodies of ``tests/test_torch_parallel.py``: what each rank of a
data-parallel run (or one process, the W=1 side) computes and returns.
They live in a module of their own so that ``torch.multiprocessing.spawn``
can pickle them, and import no JAX: the test computes the JAX reference in
its own process. Not a test module."""

import logging
import types
from pathlib import Path

import numpy as np
import torch

import chip_smoke
import monorec_tpu_torch.models.monorec as monorec_mod
from monorec_tpu_torch import parallel
from monorec_tpu_torch.cli import train_monorec
from monorec_tpu_torch.data.loader import DataLoader, collate
from monorec_tpu_torch.data.synthetic import SyntheticSweepDataset, batch_to_torch
from monorec_tpu_torch.eval import Evaluator
from monorec_tpu_torch.losses import depth_loss
from monorec_tpu_torch.metrics import get_metric
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from monorec_tpu_torch.parallel import mesh
from monorec_tpu_torch.train import Trainer, make_optimizer

H, W, D, F = 32, 64, 4, 2
LR = 1e-2
STAGE1 = MonoRecConfig(cv_depth_steps=D, pretrain_mode=1, augmentation="depth",
                       pretrain_dropout=0.0)
EVAL_METRICS = ("abs_rel_sparse_metric", "rmse_sparse_metric", "a1_sparse_metric",
                "abs_rel_sparse_onlydynamic_metric")


def run_cases(device, spec: dict, work: str) -> dict:
    """Every case of ``spec`` on this rank; each result on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {
            "stage1": {name: stage1_step(device, spec["state"], batch, spec["flip"],
                                         f"{work}/stage1_{name}")
                       for name, batch in spec["stage1_batches"].items()},
            "stage2": monorec_step(device, spec["stage2"], (), f"{work}/stage2"),
            "stage4": monorec_step(device, spec["stage4"], ("stereo", "stereo_repr"),
                                   f"{work}/stage4", mixed=True),
            "stage4_joint": monorec_step(device, spec["stage4_joint"], ("stereo", "stereo_repr"),
                                         f"{work}/stage4_joint", mixed=True),
            "skip": skip_step(device, spec["state"], spec["nan_batch"], spec["flip"],
                              f"{work}/skip"),
            "eval": evaluate(device, f"{work}/eval"),
            "loader": loader_rows(),
            "shard": shard_warnings(),
        }
    finally:
        torch.set_num_threads(threads)


def _params(model, prefix: str) -> dict:
    return {k: p.detach().cpu().numpy().copy() for k, p in model.named_parameters()
            if k.startswith(prefix)}


def _stage1_trainer(device, state_path: str, run_dir: str, **trainer) -> Trainer:
    model = MonoRec(STAGE1, device)
    model.load_state_dict(torch.load(state_path, weights_only=True))
    params = [p for p in model.parameters() if p.requires_grad]
    config = {"trainer": {"len_epoch": 1, "log_step": 100, "tensorboard": False, **trainer}}
    return Trainer(model, depth_loss, [get_metric("abs_rel_sparse_metric")],
                   make_optimizer(params, {"type": "SGD", "args": {"lr": LR}}), config,
                   types.SimpleNamespace(batch_size=4), run_dir=run_dir)


class _Flip:
    """``sample_flip_conditions`` drawing the given global conditions; a
    forward outside the sharded scope gets this rank's rows of them."""

    def __init__(self, cond):
        self.cond = torch.as_tensor(np.asarray(cond))

    def __call__(self, generator, n):
        if n == len(self.cond):
            return self.cond
        return self.cond[parallel.shard_rows(len(self.cond))[0]]


def stage1_step(device, state_path: str, batch_np: dict, flip, run_dir: str) -> dict:
    """One stage-1 SGD step of the trainer on this rank's rows of
    ``batch_np``; with a group also the loss of those rows alone (what the
    mean of per-rank losses would average)."""
    saved = monorec_mod.sample_flip_conditions
    monorec_mod.sample_flip_conditions = _Flip(flip)
    try:
        trainer = _stage1_trainer(device, state_path, run_dir)
        batch, sharded = parallel.shard_batch(batch_to_torch(batch_np, device))
        shard_loss = None
        if parallel.is_active():
            with torch.no_grad():
                out = trainer.model(batch, train=True, generator=torch.Generator().manual_seed(0))
                shard_loss = depth_loss({**batch, **out}, 0.5)["loss"].item()
        floats, metrics, _ = trainer.train_step(batch, 0.5, sharded)
    finally:
        monorec_mod.sample_flip_conditions = saved
    return {"loss": floats, "metrics": metrics, "shard_loss": shard_loss,
            "params": _params(trainer.model, "depth_module.")}


def skip_step(device, state_path: str, batch_np: dict, flip, run_dir: str) -> dict:
    """A step whose last sample is NaN under ``skip_nonfinite_updates``:
    whether this rank's own gradients were finite before the all-reduce,
    the step's skip flag, and whether the parameters stayed."""
    saved = monorec_mod.sample_flip_conditions, parallel.reduce_gradients
    local = {}

    def reduce_gradients(params, was_sharded):
        local["finite"] = all(bool(torch.isfinite(p.grad).all()) for p in params
                              if p.grad is not None)
        saved[1](params, was_sharded)

    monorec_mod.sample_flip_conditions = _Flip(flip)
    parallel.reduce_gradients = reduce_gradients
    try:
        trainer = _stage1_trainer(device, state_path, run_dir, skip_nonfinite_updates=True)
        before = _params(trainer.model, "depth_module.")
        batch, sharded = parallel.shard_batch(batch_to_torch(batch_np, device))
        floats, _, _ = trainer.train_step(batch, 0.5, sharded)
    finally:
        monorec_mod.sample_flip_conditions, parallel.reduce_gradients = saved
    after = _params(trainer.model, "depth_module.")
    return {"local_finite": local["finite"], "skipped": floats["skipped_nonfinite"],
            "unchanged": all(np.array_equal(before[k], after[k]) for k in before)}


def monorec_step(device, config: dict, options, run_dir: str, mixed: bool = False) -> dict:
    """One step of the stage 2-4 trainer the CLI builds from ``config`` on
    this rank's rows of the loader's first 4 samples; ``mixed`` shifts the
    mask to about half moving pixels first (``chip_smoke.mixed_mask``, on
    the whole batch on every rank), so stage 4's losses are finite."""
    trainer = train_monorec.build_trainer(config, device, options, run_dir=run_dir)
    ds = trainer.data_loader.dataset
    whole = batch_to_torch(collate([ds[i] for i in range(4)]), device)
    if mixed:
        chip_smoke.mixed_mask(trainer, whole)
    batch, sharded = parallel.shard_batch(whole)
    floats, metrics, _ = trainer.train_step(batch, 0.5, sharded)
    trained = {k for k, p in trainer.model.named_parameters() if p.requires_grad}
    return {"loss": floats, "metrics": metrics,
            "params": {k: v for k, v in _params(trainer.model, "").items() if k in trained}}


def evaluate(device, run_dir: str) -> dict:
    """The evaluator's log over 7 samples in batches of 2 (the last one
    odd, so replicated at W=2), median-scaled."""
    ds = SyntheticSweepDataset(length=7, target_image_size=(H, W), frame_count=F,
                               return_mvobj_mask=1)
    loader = DataLoader(ds, batch_size=2, shuffle=False, drop_last=False, num_workers=1,
                        device=device)
    model = MonoRec(MonoRecConfig(cv_depth_steps=D), device,
                    generator=torch.Generator().manual_seed(0))
    config = {"evaluater": {"median_scaling": True, "max_distance": 80}}
    return Evaluator(model, [get_metric(m) for m in EVAL_METRICS], config, loader,
                     run_dir).eval()


class _Counting:
    """A dataset that notes every index read."""

    def __init__(self, dataset):
        self.dataset, self.reads = dataset, []

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        self.reads.append(i)
        return self.dataset[i]


def loader_rows() -> dict:
    """One shuffled epoch of 10 samples in batches of 4 (the last of 2):
    the sample ids of each batch this rank was handed, its ``sharded``
    flags, the indices it read, and its validation split."""
    ds = _Counting(SyntheticSweepDataset(length=12, target_image_size=(8, 16), frame_count=1))
    loader = DataLoader(ds, batch_size=4, validation_split=2, drop_last=False, num_workers=2,
                        seed=5)
    batches, flags = [], []
    for batch in loader:
        batches.append(batch["image_id"][:, 0].tolist())
        flags.append(loader.sharded)
    return {"batches": batches, "sharded": flags, "reads": sorted(ds.reads),
            "validation": loader.split_validation().indices.tolist()}


def shard_warnings() -> dict:
    """``shard_batch`` on a batch of 3 twice and of 4 once: the rows kept,
    the ``sharded`` flags and the warnings logged."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger(mesh.__name__)
    log.addHandler(handler)
    mesh._warned_replicated = False
    try:
        out = []
        for n in (3, 3, 4):
            batch, sharded = parallel.shard_batch({"x": torch.arange(n)[:, None],
                                                   "scale": torch.tensor(2.0)})
            out.append((batch["x"][:, 0].tolist(), sharded, batch["scale"].item()))
    finally:
        log.removeHandler(handler)
    return {"rows": out, "warnings": [r.getMessage() for r in records]}


def stage_config(name: str, configs: Path, **trainer) -> dict:
    """A shipped stage config at 32x64, D=4, on 8 synthetic samples in
    batches of 4, trained by SGD from seed-0 weights."""
    import json

    with open(configs / "train" / "monorec" / name) as f:
        config = json.load(f)
    config["arch"]["args"].update(cv_depth_steps=D, depth_cp_loc=[], mask_cp_loc=[])
    config["data_loader"] = {"type": "SyntheticSweepDataloader", "args": {
        "length": 8, "batch_size": 4, "frame_count": F, "target_image_size": [H, W],
        "return_stereo": True, "return_mvobj_mask": 2 if "mask" in config["loss"] else 1,
        "num_workers": 1}}
    config.pop("val_data_loader", None)
    config["optimizer"] = {"type": "SGD", "args": {"lr": LR}}
    config.pop("lr_scheduler", None)
    config["trainer"].update(epochs=1, len_epoch=2, log_step=1, tensorboard=False, **trainer)
    return config


def group_state(device, spec: dict, work: str) -> dict:
    """What a rank sees of its group; within one, whether a loader that
    does not say if its batch is a shard is refused; and the stage-1 step
    on the unequal batch and the evaluation, as ``run_cases`` runs them."""
    refused = None
    if parallel.is_active():
        try:
            parallel.loader_batch([], {"x": torch.zeros(2)})
            refused = False
        except TypeError:
            refused = True
    return {"active": parallel.is_active(), "world": parallel.world_size(),
            "device": str(device), "refused": refused,
            "stage1": stage1_step(device, spec["state"], spec["stage1_batches"]["unequal"],
                                  spec["flip"], f"{work}/stage1"),
            "eval": evaluate(device, f"{work}/eval")}


def fail_on_rank_1(device) -> None:
    """Raise on rank 1, after rank 0 has entered a collective."""
    if parallel.rank() == 1:
        raise RuntimeError("rank 1 fails")
    parallel.barrier()
