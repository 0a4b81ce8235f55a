"""Serve MonoRec depth requests with the port (``monorec_tpu/cli/inference_example.py``).

Builds ``MonoRec`` on an explicit device, with weights drawn from ``--seed``
or carried from the JAX package (``--params``, an npz of '/'-joined flax
paths), then answers ``--requests`` synthetic requests of ``--batch``
keyframes each and prints the latency of each forward. On CUDA the latency
is taken with CUDA events; the first request is answered once untimed, to
build the CUDA kernel and warm the allocator.

    python -m monorec_tpu_torch.cli.inference_example            # 4 x 1 keyframe, 256x512
    python -m monorec_tpu_torch.cli.inference_example --batch 8 --requests 8
    python -m monorec_tpu_torch.cli.inference_example --precision serving

``--precision`` selects the precision policy (``monorec_tpu_torch.precision``):
"exact" (float32 everywhere, the default) or "serving" (bf16 cost-volume
sources and bf16 U-Net convolutions).

Requests are synthetic: this entry point has no KITTI mode yet (the
port's KITTI reader serves ``cli/evaluate.py`` and
``cli/create_pointcloud.py``).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Dict, List, Sequence, Tuple

import torch

from monorec_tpu_torch.convert import load_flax_npz, state_dict_from_flax
from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from monorec_tpu_torch.precision import POLICIES, apply_to_model_kwargs, set_precision


def model_config(depth_steps: int, precision: str = "exact") -> MonoRecConfig:
    """The served model's config under the ``precision`` policy, which this
    selects process-wide (``--precision``)."""
    set_precision(precision)
    return MonoRecConfig(**apply_to_model_kwargs({"cv_depth_steps": depth_steps}))


def build_model(config: MonoRecConfig, device, seed: int = 0, params_path=None) -> MonoRec:
    """MonoRec with seeded weights, or weights from a flax npz, on ``device``."""
    model = MonoRec(config, device, generator=torch.Generator().manual_seed(seed))
    if params_path is not None:
        model.load_state_dict(state_dict_from_flax(*load_flax_npz(params_path)))
    return model.eval()


def make_requests(n: int, batch_size: int, height: int, width: int, frames: int,
                  device, seed: int = 0) -> List[Dict[str, torch.Tensor]]:
    return [
        batch_to_torch(
            make_batch(batch_size, height, width, frames, stereo=False, mask=False, seed=seed + i),
            device,
        )
        for i in range(n)
    ]


def serve(model: MonoRec, requests: Sequence[Dict[str, torch.Tensor]]
          ) -> Tuple[List[Dict[str, torch.Tensor]], List[float]]:
    """Answer each request with one forward; returns outputs and per-request ms."""
    outputs, latencies = [], []
    with torch.inference_mode():
        for batch in requests:
            if batch["keyframe"].is_cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = model(batch)
                end.record()
                end.synchronize()
                latencies.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                out = model(batch)
                latencies.append((time.perf_counter() - t0) * 1e3)
            outputs.append(out)
    return outputs, latencies


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=1, help="keyframes per request")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--depth-steps", type=int, default=32)
    p.add_argument("--frames", type=int, default=2, help="source frames per keyframe")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--params", default=None, help="npz of flattened flax variables")
    p.add_argument("--precision", choices=sorted(POLICIES), default="exact",
                   help="precision policy (default: exact)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if args.params is None:
        print("note: no --params given, the weights are random (seed "
              f"{args.seed}); depths only demonstrate the pipeline", file=sys.stderr)
    model = build_model(model_config(args.depth_steps, args.precision), device, args.seed,
                        args.params)
    requests = make_requests(args.requests, args.batch, args.height, args.width,
                             args.frames, device, args.seed)
    serve(model, requests[:1])  # untimed warm-up: kernel build, allocator
    outputs, latencies = serve(model, requests)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    for i, (out, ms) in enumerate(zip(outputs, latencies)):
        result = out["result"]
        if not torch.isfinite(result).all():
            raise RuntimeError(f"request {i}: non-finite inverse depth")
        print(f"request {i}: {ms:.3f} ms for {args.batch} keyframe(s), "
              f"result {tuple(result.shape)} in [{result.min().item():.4f}, "
              f"{result.max().item():.4f}]")
    med = statistics.median(latencies)
    print(f"median {med:.3f} ms/request, {args.batch * 1e3 / med:.2f} keyframes/s "
          f"({clock}, {name}, {args.height}x{args.width}, D={args.depth_steps}, "
          f"F={args.frames}, {args.precision} precision)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
