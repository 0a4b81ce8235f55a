"""Serve MonoRec depth requests with the port (``monorec_tpu/cli/inference_example.py``,
the reference's ``example/test_monorec.py``).

Builds ``MonoRec`` on an explicit device, with weights drawn from ``--seed``,
carried from the JAX package (``--params``, an npz of '/'-joined flax
paths) or read from a ``.pth`` of the port or the reference
(``--checkpoint``, the same keys). On CUDA each latency is taken with CUDA
events, after one untimed forward that builds the CUDA kernel and warms the
allocator.

Without ``--data`` it answers ``--requests`` synthetic requests of
``--batch`` keyframes each and prints the latency of each forward::

    python -m monorec_tpu_torch.cli.inference_example            # 4 x 1 keyframe, 256x512
    python -m monorec_tpu_torch.cli.inference_example --batch 8 --requests 8
    python -m monorec_tpu_torch.cli.inference_example --precision serving

With ``--data`` (a KITTI Odometry root) it runs the golden sample: sample
``--index`` of sequence 07 (164: keyframe 169 with sources 168 and 170),
read as the JAX example reads it, times one forward, and writes
``depth.png``, ``mask.png`` and ``kf.png`` to ``--out``, each min-max
normalised to 8-bit greyscale (the JAX example's form without
matplotlib)::

    python -m monorec_tpu_torch.cli.inference_example --data data/kitti \
        --checkpoint saved/checkpoints/monorec_depth_ref.pth

``--precision`` selects the precision policy (``monorec_tpu_torch.precision``):
"exact" (float32 everywhere, the default) or "serving" (bf16 cost-volume
sources and bf16 U-Net convolutions).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from monorec_tpu_torch.convert import load_flax_npz, state_dict_from_flax
from monorec_tpu_torch.data.kitti import KittiOdometryDataset
from monorec_tpu_torch.data.loader import collate
from monorec_tpu_torch.data.png import write_png
from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from monorec_tpu_torch.precision import POLICIES, apply_to_model_kwargs, set_precision
from monorec_tpu_torch.train.checkpoints import load_submodule_state


def model_config(depth_steps: int, precision: str = "exact") -> MonoRecConfig:
    """The served model's config under the ``precision`` policy, which this
    selects process-wide (``--precision``)."""
    set_precision(precision)
    return MonoRecConfig(**apply_to_model_kwargs({"cv_depth_steps": depth_steps}))


def build_model(config: MonoRecConfig, device, seed: int = 0, params_path=None,
                checkpoint=None) -> MonoRec:
    """MonoRec on ``device`` with seeded weights, overwritten by those of a
    flax npz (``params_path``) and of a ``.pth`` (``checkpoint``)."""
    model = MonoRec(config, device, generator=torch.Generator().manual_seed(seed))
    if params_path is not None:
        model.load_state_dict(state_dict_from_flax(*load_flax_npz(params_path)))
    if checkpoint is not None:
        load_submodule_state(model, [checkpoint])
    return model.eval()


def kitti_sample(data, index: int, size: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """Sample ``index`` of sequence 07 under ``data`` as a batch of one, read
    with the JAX example's arguments (annotated LiDAR depth, DSO poses)."""
    dataset = KittiOdometryDataset(
        str(data), sequences=["07"], target_image_size=size, frame_count=2,
        depth_folder="image_depth_annotated", lidar_depth=True, dso_depth=False,
        use_dso_poses=True, custom_length=1000)
    return collate([dataset[index]])


def to_grey(a) -> np.ndarray:
    """``a`` min-max normalised to uint8, as the JAX example's PIL fallback."""
    a = np.asarray(a, dtype=np.float64)
    a = (a - a.min()) / max(a.max() - a.min(), 1e-9)
    return (a * 255).astype(np.uint8)


def write_outputs(out_dir, batch: Dict[str, torch.Tensor], out: Dict[str, torch.Tensor]) -> Path:
    """``depth.png``, ``mask.png`` and ``kf.png`` of the first keyframe."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_png(out_dir / "depth.png", to_grey(out["result"][0, 0].cpu()))
    write_png(out_dir / "mask.png", to_grey(out["cv_mask"][0, 0].cpu()))
    write_png(out_dir / "kf.png", to_grey((batch["keyframe"][0] + 0.5).permute(1, 2, 0).cpu()))
    return out_dir


RANDOM_WEIGHTS = ("=" * 70 + "\nWARNING: no --checkpoint given: the model weights are RANDOM.\n"
                  "The saved depth/mask PNGs are NOT the MonoRec golden sample; they\n"
                  "only demonstrate the pipeline. Pass --checkpoint with the reference's\n"
                  "monorec_depth_ref.pth (or a .pth of the port) for real results.\n" + "=" * 70)


def golden_sample(args, device) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], float]:
    """(batch, outputs, ms of the timed forward) of the KITTI mode."""
    if args.checkpoint is None and args.params is None:
        print(RANDOM_WEIGHTS, file=sys.stderr)
    model = build_model(model_config(args.depth_steps, args.precision), device, args.seed,
                        args.params, args.checkpoint)
    batch = batch_to_torch(kitti_sample(args.data, args.index, (args.height, args.width)),
                           device)
    serve(model, [batch])  # untimed warm-up: kernel build, allocator
    (out,), (ms,) = serve(model, [batch])
    return batch, out, ms


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
    p.add_argument("--checkpoint", default=None,
                   help=".pth of the port or the reference (its state_dict's keys)")
    p.add_argument("--precision", choices=sorted(POLICIES), default="exact",
                   help="precision policy (default: exact)")
    p.add_argument("--data", default=None,
                   help="KITTI Odometry root: run the golden sample of its sequence 07")
    p.add_argument("--index", type=int, default=164, help="sample of sequence 07 (169 - 5)")
    p.add_argument("--out", default="saved/example", help="where --data writes its PNGs")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    if args.data is not None:
        batch, out, ms = golden_sample(args, device)
        print(f"Inference took {ms / 1e3:.4f}s ({clock}, after a warm-up; {name}, "
              f"{args.height}x{args.width}, D={args.depth_steps}, {args.precision} precision)")
        out_dir = write_outputs(args.out, batch, out)
        print(f"wrote depth.png / mask.png / kf.png to {out_dir}")
        return 0
    if args.params is None and args.checkpoint is None:
        print("note: no --params given, the weights are random (seed "
              f"{args.seed}); depths only demonstrate the pipeline", file=sys.stderr)
    model = build_model(model_config(args.depth_steps, args.precision), device, args.seed,
                        args.params, args.checkpoint)
    requests = make_requests(args.requests, args.batch, args.height, args.width,
                             args.frames, device, args.seed)
    serve(model, requests[:1])  # untimed warm-up: kernel build, allocator
    outputs, latencies = serve(model, requests)
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
