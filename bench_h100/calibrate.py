"""Readings that set a cell's limits (PERF.md, "How correct is decided").

    python3 bench_h100/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--faults half_batch,no_exchange] [--seconds 2]

In one process (one per card for a cell on several cards), for each of
``--seeds``: a short run of the cell as the benchmark runs it, and its
compared numbers against the plain reference (the lower readings). For each
of ``--control-seeds``: the reference computed one precision step below
the configuration (TF32 operands) against the reference, and, for a
training cell, the reference with each of ``--faults`` planted, against
the reference (the upper readings). Each reading is a JSON line on
standard output. The benchmark's own runs never run this.
"""

import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402

from bench_h100 import harness  # noqa: E402


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def _program_training(device, cell, seeds, seconds, world):
    from bench_h100.kinds import _training
    from monorec_tpu_torch import parallel

    out = []
    for seed in seeds:
        r = _training.rank_run(device, cell, seed, seconds, False, time.perf_counter(),
                               rank=parallel.rank(), world=world)
        out.append({k: r[k] for k in ("losses", "grad_norms", "update_norms", "first_result",
                                       "steps")})
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.Cell.load(args.workload)
    cell.limits = {k: float("inf") for k in cell.limits}
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    def emit(rec):
        rec["cell"] = cell.name
        print(json.dumps(rec), flush=True)

    kind = cell.traffic["kind"]
    if kind == "infer_closed_loop":
        from bench_h100.kinds import infer_closed_loop as ic

        for seed in args.seeds:
            ctx = harness.Context(cell, seed, args.seconds, False, device, time.perf_counter())
            run = harness.run_cell(ctx)
            emit({"reading": "program", "seed": seed,
                  **{c["name"]: c["value"] for c in run.compared},
                  "requests": run.attempted, "compared": run.record["compared_positions"]})
        for seed in args.control_seeds:
            ctx = harness.Context(cell, seed, args.seconds, False, device, time.perf_counter())
            order, points = ic.plan(seed, cell.traffic)
            requests = range(len(points))  # as many of the pool's batches as a run compares
            exact = ic.reference_answers(ctx, order, requests, exact=True)
            control = ic.reference_answers(ctx, order, requests, exact=False)
            emit({"reading": "control_tf32", "seed": seed, **ic.gaps(control, exact)})
    else:
        from bench_h100.kinds import _training
        from monorec_tpu_torch import parallel

        world = cell.chips
        if args.seeds:
            if world > 1:
                runs = parallel.launch(_program_training, world, device.type,
                                       (cell, args.seeds, args.seconds, world))[0]
            else:
                runs = _program_training(device, cell, args.seeds, args.seconds, 1)
            for seed, r in zip(args.seeds, runs):
                ref = _training.reference_steps(cell, seed, device)
                emit({"reading": "program", "seed": seed, **_training.gaps(r, ref),
                      **_training.worst_leaves(r, ref), "steps": r["steps"], "losses": r["losses"],
                      "ref_losses": ref["losses"]})
        for seed in args.control_seeds:
            ref = _training.reference_steps(cell, seed, device)
            ctl = _training.reference_steps(cell, seed, device, exact=False)
            emit({"reading": "control_tf32", "seed": seed, **_training.gaps(ctl, ref),
                  **_training.worst_leaves(ctl, ref)})
            for fault in [f for f in args.faults.split(",") if f]:
                bad = _training.reference_steps(cell, seed, device, fault=fault, ranks=world)
                emit({"reading": f"fault_{fault}", "seed": seed, **_training.gaps(bad, ref),
                      **_training.worst_leaves(bad, ref)})
    emit({"reading": "done", "seconds": time.perf_counter() - T_START,
          "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
