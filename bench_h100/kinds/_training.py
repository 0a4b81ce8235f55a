"""What the training kinds share: one rank's trainer, its steps and its
window, and the comparison of the first steps with the reference.

The trainer is the program's own (``Trainer`` or ``MonoRecTrainer``),
built as ``cli/train.py::build_trainer`` builds it from the stage's
shipped config blocks (model arguments, loss, metrics, optimizer, the
``trainer`` block), on the benchmark's seeded weights and a loader that
only says how big its batches are. Set-up drives that trainer from the
seed through its first ``warmup_steps`` steps, through the window's own
call (``train_step``) and feed (the pinned host batch copied to the card,
as ``Trainer._train_epoch`` takes it from the loader), on batches whose
rows all differ; the window then continues with the same object. The
first three steps are the ones compared: their losses, the gradient of
the first as the optimizer got it (from AMSGrad's first moment after one
step), and each trained leaf's change after the third.

A mix names its ``stage``, one of ``STAGES``: that sets the program's
trainer, the reference's stage and the step whose operations
``flops.step_flops`` counts (the stage's own name).
"""

from __future__ import annotations

import math
import shutil
import statistics
import tempfile
import time
from typing import Dict, List

from bench_h100 import flops, harness, scenes
from bench_h100.reference.monorec import seeded_state_dict

STEPS_PER_EPOCH = 10**6  # the epoch-based schedule stays in its first epoch
COMPARED_STEPS = 3
# Steps between rank 0's decisions to close the window, on several ranks:
# one broadcast and one sync every so many steps, not every step.
STOP_EVERY = 8
# The keys of a training mix (``traffic/<name>.json``) that the kinds read.
TRAFFIC_KEYS = ("stage", "options", "global_batch", "pool", "warmup_steps", "trace_items")
# A stage's name -> the program's trainer class and the reference's stage.
STAGES = {"stage1": ("Trainer", 1), "stage4": ("MonoRecTrainer", 4)}


class Loader:
    """What ``Trainer`` reads of its loader: the global batch size, the
    number of batches an epoch, and whether a rank's batches are its shard."""

    def __init__(self, batch_size: int, sharded: bool):
        self.batch_size = batch_size
        self.sharded = sharded

    def __len__(self) -> int:
        return STEPS_PER_EPOCH


def stage_config(cfg: Dict, tr: Dict) -> Dict:
    """The stage's shipped config blocks, the model arguments merged over
    the configuration's."""
    stage = dict(cfg["trainers"][tr["stage"]])
    stage["arch"] = {"type": "MonoRecModel", "args": dict(cfg["arch"], **stage["arch"])}
    stage["precision"] = cfg["precision"]
    return stage


def global_batches(cfg: Dict, tr: Dict, seed: int, device, n: int, first_row: int = 0,
                   rows: int = None):
    shape = cfg["shape"]
    return scenes.make_batches(cfg["scene"], n, tr["global_batch"], shape["height"],
                               shape["width"], shape["frames"], True, seed, device,
                               first_row=first_row, rows=rows)


def rank_run(device, cell: harness.Cell, seed: int, seconds: float, trace_on: bool,
             t_start: float, faults=(), rank: int = 0, world: int = 1) -> Dict:
    """One rank's set-up, compared steps and window; returns what the
    parent needs, on the host."""
    import torch

    from monorec_tpu_torch import config as config_mod
    from monorec_tpu_torch import train as train_mod
    from monorec_tpu_torch.models import MonoRec
    from monorec_tpu_torch.ops import photo_error as pe
    from monorec_tpu_torch.precision import set_precision

    cfg, tr = cell.config, cell.traffic
    cuda = device.type == "cuda"
    if cuda:
        torch.set_num_threads(harness.HOST_THREADS)  # a rank's own process, too
    stage = stage_config(cfg, tr)
    set_precision(stage["precision"])
    with torch.device(device):
        model = MonoRec(config_mod.build_model_config(stage["arch"]["args"]), device=device)
    own = model.state_dict()
    state = seeded_state_dict(cfg["shape"]["depth_steps"], scenes.sub_seed(seed, 0), device)
    model.load_state_dict({k: v for k, v in state.items() if k in own})
    del state
    names = {p: k for k, p in model.named_parameters()}
    params = [p for p in model.parameters() if p.requires_grad]
    start = {names[p]: p.detach().clone() for p in params}
    optimizer = config_mod.build_optimizer(stage, params, STEPS_PER_EPOCH)
    trainer_cls = getattr(train_mod, STAGES[tr["stage"]][0])
    run_dir = tempfile.mkdtemp(prefix="bench-h100-run-")
    trainer = trainer_cls(
        model, config_mod.build_loss(stage), config_mod.build_metrics(stage), optimizer, stage,
        Loader(tr["global_batch"], world > 1), run_dir=run_dir, options=tr["options"],
        generator=torch.Generator().manual_seed(scenes.sub_seed(seed, 3)))
    alpha = trainer._alpha(1)
    rows = tr["global_batch"] // world
    pool = [scenes.to_host(b, cuda) for b in global_batches(
        cfg, tr, seed, device, tr["pool"], first_row=rank * rows, rows=rows)]
    if cuda:
        torch.cuda.synchronize(device)

    spans = harness.Spans(cuda)
    if trace_on:
        spans.wrap(trainer, "loss_fn", "loss")
        zero_grad, step = optimizer.zero_grad, optimizer.step

        def zero_grad_marked(*a, **k):
            zero_grad(*a, **k)
            spans.mark("backward")

        def step_marked(*a, **k):
            out = step(*a, **k)
            spans.close("backward")
            return out

        optimizer.zero_grad, optimizer.step = zero_grad_marked, step_marked

    if "state_unchanged" in faults:
        optimizer.step = lambda *a, **k: None

    def train_step(i: int) -> Dict:
        host = pool[i % len(pool)]
        batch = {k: v.to(device, non_blocking=True) for k, v in host.items()}
        if "half_batch" in faults:
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        if "no_exchange" in faults:
            from monorec_tpu_torch import parallel

            parallel.reduce_gradients = lambda *a, **k: None
        floats, _, viz = trainer.train_step(batch, alpha, sharded=world > 1)
        return floats, viz["result"]

    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    b1 = optimizer.param_groups[0]["betas"][0]
    for i in range(tr["warmup_steps"]):
        floats, result = train_step(i)
        if i < COMPARED_STEPS:
            losses.append(floats["loss"])
        if i == 0:
            first_result = result.float().cpu()
            for p in params:
                st = optimizer.state.get(p)
                if st and "mu" in st:
                    grad_norms[names[p]] = float((st["mu"].double() / (1 - b1)).norm())
        if i == COMPARED_STEPS - 1:
            update_norms = {names[p]: float((p.detach() - start[names[p]]).double().norm())
                            for p in params}
    del start

    stop = torch.zeros(1, device=device)

    def stopping(steps: int, done: bool) -> bool:
        """Rank 0's clock decides for every rank, every ``STOP_EVERY`` steps."""
        if world == 1:
            return done
        if steps % STOP_EVERY:
            return False
        import torch.distributed as dist

        stop.fill_(1.0 if done else 0.0)
        dist.broadcast(stop, 0)
        return bool(stop.item())

    spans.events = {}  # the window's steps only
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    t_end, steps = t0, 0
    first = tr["warmup_steps"]
    while True:
        spans.item = steps
        train_step(first + steps)
        steps += 1
        t_end = time.perf_counter()
        if stopping(steps, t_end - t0 >= seconds):
            break
    summary = None
    if trace_on:
        # The profiled steps follow the window (the profiler slows the host,
        # during its run and after it), the same number on every rank.
        trace = harness.Trace(cuda)
        items = tr["trace_items"]

        def traced_step(j: int) -> None:
            spans.item = steps + j
            train_step(first + steps + j)

        before = (dict(pe.photo_error_fwd.launches_by_batch),
                  dict(pe.photo_error_bwd.launches_by_batch))
        trace.device_pass(traced_step, items)
        counters = {"k3_fwd": _delta(before[0], pe.photo_error_fwd.launches_by_batch),
                    "k3_bwd": _delta(before[1], pe.photo_error_bwd.launches_by_batch)}
        trace.label_pass(lambda j: traced_step(items + j), harness.label_items(items))
        summary = dict(trace.summary(), counters=counters)
    if cuda:
        torch.cuda.synchronize(device)
    out = {
        "steps": steps, "window_s": t_end - t0, "setup_s": setup_s, "losses": losses,
        "grad_norms": grad_norms, "update_norms": update_norms, "first_result": first_result,
        "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0,
        "spans": spans.per_item(below=steps), "trace": summary,
    }
    del trainer, model, optimizer, pool
    shutil.rmtree(run_dir, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    return out


def _delta(before: Dict, after) -> Dict[int, int]:
    return {m: n - before.get(m, 0) for m, n in after.items() if n - before.get(m, 0)}


# ----- the comparison --------------------------------------------------------


def reference_steps(cell: harness.Cell, seed: int, device, exact: bool = True,
                    fault: str = None, ranks: int = 1) -> Dict:
    """The reference's first three steps from the same weights, batches and
    seeds (``exact=False``: the control)."""
    from bench_h100.reference.training import replay

    cfg, tr = cell.config, cell.traffic
    stage = stage_config(cfg, tr)
    args = stage["arch"]["args"]
    state = seeded_state_dict(cfg["shape"]["depth_steps"], scenes.sub_seed(seed, 0), device)
    batches = global_batches(cfg, tr, seed, device, COMPARED_STEPS)
    return replay(
        STAGES[tr["stage"]][1], state, batches, exact=exact,
        depth_steps=cfg["shape"]["depth_steps"], inv_depth_min_max=args["inv_depth_min_max"],
        lr=stage["optimizer"]["args"]["lr"], draw_seed=scenes.sub_seed(seed, 3), device=device,
        options=tr["options"], alpha=stage["trainer"].get("alpha", 0.5),
        pretrain_dropout=args.get("pretrain_dropout", 0.0), fault=fault, ranks=ranks)


def _loss_gap(got: float, ref: float) -> float:
    """A step whose masked means run over no pixel has the loss NaN on both
    sides (stage 4 with no moving pixel, as MonoRec's loss has it): equal."""
    if math.isnan(got) and math.isnan(ref):
        return 0.0
    return harness.gap(abs(got - ref) / abs(ref))


def gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers of ``got`` (the program's, or a control's)
    against the reference's ``ref``:

    * ``loss_gap``: the relative gap of the first step's loss;
    * ``result_gap``: the widest gap of the first step's inverse depth
      (``result``, the mono decode's finest scale), over the rows ``got``
      holds (rank 0's on several ranks);
    * ``grad_gap``: the median leaf's gap between the norms of the first
      gradient, each leaf's over the larger of the reference's norm of that
      leaf and of the median leaf; ``grad_gap_p90`` the 90th percentile of
      the same leaves' gaps;
    * ``update_gap``, ``update_gap_p90``: the same of each leaf's change
      after the three steps; a leaf that the reference leaves unmoved
      counts by the program's change over the median leaf's, and the worst
      such leaf is taken.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of all four. The
    median and the 90th percentile stand where the worst leaf would read
    the noise of the step's nondeterministic sums (PERF.md)."""
    rg, ru = ref["grad_norms"], ref["update_norms"]
    med = statistics.median(rg.values())
    counted = [k for k, v in rg.items() if v >= 1e-3 * med]
    med_u = statistics.median(ru[k] for k in counted)

    def leaf_gaps(key: str, scale: float) -> List[float]:
        return [harness.gap(abs(got[key].get(k, 0.0) - ref[key][k]) / max(ref[key][k], scale))
                for k in counted]

    grads, updates = leaf_gaps("grad_norms", med), leaf_gaps("update_norms", med_u)
    unmoved = [harness.gap(v / med_u) for k, v in got["update_norms"].items() if k not in rg]
    rows = got["first_result"].shape[0]
    result_gap = harness.gap((got["first_result"] - ref["first_result"][:rows]).abs().max())
    return {"loss_gap": _loss_gap(got["losses"][0], ref["losses"][0]), "result_gap": result_gap,
            "grad_gap": statistics.median(grads), "grad_gap_p90": _p90(grads),
            "update_gap": max([statistics.median(updates)] + unmoved),
            "update_gap_p90": max([_p90(updates)] + unmoved)}


def _p90(values: List[float]) -> float:
    return statistics.quantiles(values, n=10)[-1]


def worst_leaves(got: Dict, ref: Dict) -> Dict[str, float]:
    """The widest gaps of the three steps' losses and of any one leaf, for
    the calibration's record beside the compared numbers."""
    rg, ru = ref["grad_norms"], ref["update_norms"]
    med, med_u = statistics.median(rg.values()), statistics.median(ru.values())
    def total(norms):
        return math.sqrt(sum(norms.get(k, 0.0) ** 2 for k in rg))

    return {
        "leaves_counted": sum(v >= 1e-3 * med for v in rg.values()), "leaves": len(rg),
        "loss_gap_3_steps": max(_loss_gap(a, b) for a, b in zip(got["losses"], ref["losses"])),
        "grad_gap_all_leaves": harness.gap(abs(total(got["grad_norms"]) - total(rg)) / total(rg)),
        "update_gap_all_leaves": harness.gap(abs(total(got["update_norms"]) - total(ru))
                                             / total(ru)),
        "grad_gap_worst_leaf": max(harness.gap(abs(got["grad_norms"].get(k, 0.0) - v)
                                               / max(v, med)) for k, v in rg.items()),
        "update_gap_worst_leaf": max(harness.gap(abs(got["update_norms"].get(k, 0.0) - v)
                                                 / max(v, med_u)) for k, v in ru.items()),
    }


def finish(cell: harness.Cell, seed: int, device, ranks: List[Dict], compared_rank: Dict,
           trace_on: bool, world: int) -> harness.Run:
    """The run's metrics and record from the ranks' results, and the
    comparison of rank 0's first steps with the reference."""
    shape = cell.config["shape"]
    tr = cell.traffic
    r0 = ranks[0]
    g = tr["global_batch"]
    record = {"kind": "train", "items": r0["steps"] * g, "steps": r0["steps"],
              "window_s": r0["window_s"],
              "chips": world, "flops_per_item": flops.step_flops(shape, tr["stage"]),
              "spans": r0["spans"], "shape": dict(shape, batch=g // world)}
    if trace_on:
        tr0 = dict(r0["trace"])
        tr0["busy_s"] = statistics.fmean(r["trace"]["busy_s"] for r in ranks)
        tr0["window_s"] = statistics.fmean(r["trace"]["window_s"] for r in ranks)
        record["trace"] = tr0
        record["traced_keyframes"] = tr["trace_items"] * g
    ref = reference_steps(cell, seed, device)
    values = gaps(compared_rank, ref)
    compared = [{"name": k, "value": values[k], "limit": limit}
                for k, limit in cell.limits.items()]
    return harness.Run(
        attempted=r0["steps"], failed=0,
        metrics={"train_keyframes_per_s": r0["steps"] * g / r0["window_s"],
                 "setup_s": r0["setup_s"]},
        units={"train_keyframes_per_s": "keyframes/s", "setup_s": "s"},
        record=record, memory_peak_bytes=max(r["memory_peak_bytes"] for r in ranks),
        compared=compared, device_count=world)
