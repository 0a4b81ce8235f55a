"""Serving-policy convergence evidence: exact-f32 vs bf16-serving training
(``tools/convergence_check.py``).

The "serving" precision policy changes three dtypes (CV warp sources, U-Net
convolutions, loss-warp sources). This tool trains N steps on the synthetic
sweep pipeline, once under each policy, with the same initial weights, the
same batch order and the same random draws (dropout and depth flip), then
evaluates abs_rel on 16 held-out synthetic samples with the final weights,
the model in eval mode under its training policy. The result is one JSON
line on stdout, with the JAX tool's keys.

* ``--stage 1`` (the default): the depth bootstrap (pretrain mode 1,
  ``depth_loss -o stereo``, lr 1e-4) through the CLI trainer's step
  (``train/trainer.py::Trainer.train_step``).
* ``--stage 4``: the depth refinement of ``monorec_depth_ref.json``
  (pretrain mode 0, the depth flip, the MaskModule frozen, the mask on the
  cost volume, ``depth_refinement_loss -o stereo stereo_repr``, lr 1e-5)
  through ``train/monorec_trainer.py::MonoRecTrainer``: the stereo branch is
  the detached pseudo-GT of the moving pixels, where bf16 drift becomes
  label noise.

Both use amsgrad.

    python -m monorec_tpu_torch.tools.convergence_check                 # on the card
    python -m monorec_tpu_torch.tools.convergence_check --stage 4
    python -m monorec_tpu_torch.tools.convergence_check --device cpu --steps 2
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Dict, Sequence, Tuple

import torch

from monorec_tpu_torch.data.loader import DataLoader
from monorec_tpu_torch.data.synthetic import SyntheticSweepDataset
from monorec_tpu_torch.losses import depth_loss, depth_refinement_loss
from monorec_tpu_torch.metrics import get_metric
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from monorec_tpu_torch.precision import apply_to_model_kwargs, set_precision
from monorec_tpu_torch.train import MonoRecTrainer, Trainer, make_optimizer

POLICIES = ("exact", "serving")


def _note(msg: str) -> None:
    print(f"[conv {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def run_policy(policy: str, steps: int, batch_size: int, log_every: int, stage: int = 1, *,
               device="cuda", image_size: Tuple[int, int] = (256, 512),
               depth_steps: int = 32) -> Dict:
    """Train ``steps`` steps of ``stage`` (1 or 4) under ``policy`` and
    evaluate abs_rel; returns the logged loss curve [(step, loss), ...], the
    final loss and the held-out abs_rel. Selects ``policy`` process-wide."""
    if stage not in (1, 4):
        raise ValueError(f"stage must be 1 or 4, got {stage}")
    # Everything is built anew under the policy, so the warning about
    # models built under the previous one does not apply.
    set_precision(policy, expect_rebuild=True)
    device = torch.device(device)
    if stage == 4:
        cfg = MonoRecConfig(cv_depth_steps=depth_steps, pretrain_mode=0, augmentation="depth",
                            freeze_module=("att",), **apply_to_model_kwargs({}))
    else:
        cfg = MonoRecConfig(cv_depth_steps=depth_steps, pretrain_mode=1, pretrain_dropout=0.5,
                            augmentation="depth", **apply_to_model_kwargs({}))
    model = MonoRec(cfg, device, generator=torch.Generator().manual_seed(0))
    ds = SyntheticSweepDataset(length=64, target_image_size=image_size, frame_count=2,
                               return_stereo=True, seed=0)
    dl = DataLoader(ds, batch_size=batch_size, shuffle=True, seed=7, device=device)
    lr = 1e-5 if stage == 4 else 1e-4
    optimizer = make_optimizer([p for p in model.parameters() if p.requires_grad],
                               {"type": "Adam", "args": {"lr": lr, "amsgrad": True}})

    curve = []
    with tempfile.TemporaryDirectory() as run_dir:
        if stage == 4:  # mono and stereo predictions and the mask are MonoRecTrainer's defaults
            trainer_cls, loss, config = (MonoRecTrainer, depth_refinement_loss, {"trainer": {
                "mult_mask_on_cv": True, "tensorboard": False}})
            options = ("stereo", "stereo_repr")
        else:
            trainer_cls, loss, config, options = (Trainer, depth_loss,
                                                  {"trainer": {"tensorboard": False}}, ("stereo",))
        trainer = trainer_cls(model, loss, [], optimizer, config, dl, run_dir=run_dir,
                              options=options, generator=torch.Generator().manual_seed(1))
        it = iter(dl)
        t0 = time.time()
        for i in range(steps):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(dl)
                batch = next(it)
            loss = trainer.train_step(batch, 0.5)[0]["loss"]
            if i % log_every == 0 or i == steps - 1:
                curve.append((i, loss))
                _note(f"{policy} step {i}: loss {loss:.6f}")
        _note(f"{policy}: {steps} steps in {time.time() - t0:.1f}s")

    abs_rel = get_metric("abs_rel_sparse_metric")
    eval_ds = SyntheticSweepDataset(length=16, target_image_size=image_size, frame_count=2,
                                    return_stereo=True, seed=99)
    eval_dl = DataLoader(eval_ds, batch_size=batch_size, shuffle=False, device=device)
    model.eval()
    with torch.no_grad():
        vals = [abs_rel({**b, **model(b)}, None, 80.0).item() for b in eval_dl]
    return {"curve": curve, "final_loss": curve[-1][1], "abs_rel": sum(vals) / len(vals)}


def summarize(stage: int, steps: int, batch: int, exact: Dict, serving: Dict) -> Dict:
    """The JAX tool's JSON record of the two runs."""
    e, s = exact, serving
    return {
        "stage": stage,
        "steps": steps,
        "batch": batch,
        "final_loss_exact": round(e["final_loss"], 6),
        "final_loss_serving": round(s["final_loss"], 6),
        "final_loss_rel_gap": round(
            abs(e["final_loss"] - s["final_loss"]) / max(abs(e["final_loss"]), 1e-12), 6),
        "abs_rel_exact": round(e["abs_rel"], 6),
        "abs_rel_serving": round(s["abs_rel"], 6),
        "abs_rel_rel_delta": round(
            abs(e["abs_rel"] - s["abs_rel"]) / max(abs(e["abs_rel"]), 1e-12), 6),
        "curve_exact": e["curve"],
        "curve_serving": s["curve"],
    }


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--stage", type=int, default=1, choices=(1, 4))
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    args = ap.parse_args(argv)

    res = {}
    for policy in POLICIES:
        _note(f"=== policy {policy} (stage {args.stage}) ===")
        res[policy] = run_policy(policy, args.steps, args.batch, args.log_every, args.stage,
                                 device=args.device)
    print(json.dumps(summarize(args.stage, args.steps, args.batch, res["exact"],
                               res["serving"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
