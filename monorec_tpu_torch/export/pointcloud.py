"""Point-cloud export (``monorec_tpu/export/pointcloud.py``).

Inference over the frames in order. Per frame the moving-object mask is
thresholded (``cv_mask >= .1``) and vetoed by a 33x33 neighbourhood: a
pixel is kept only if NO thresholded pixel lies in its window, padded 16
before and 17 after (the asymmetric pad of an even-sized torch
convolution). A window of 5 frames votes a temporal mask for its middle
frame (kept where every frame keeps it), and that frame's masked inverse
depth goes into a world-frame PLY with random dropout.
"""

from __future__ import annotations

from collections import deque
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from monorec_tpu_torch.export.ply import PLYWriter

MASK_FILL = 32
BUFFER_LENGTH = 5
MIN_HITS = 1


def pointcloud_masks(cv_mask: torch.Tensor, mask_fill: int = MASK_FILL) -> torch.Tensor:
    """(B, 1, H, W) cv_mask -> float keep-mask: 1 where the (mask_fill + 1)^2
    window holds no pixel with cv_mask >= .1."""
    hit = (cv_mask >= 0.1).to(torch.float32)
    pad = mask_fill // 2
    hit = F.pad(hit, (pad, mask_fill - pad, pad, mask_fill - pad))
    return (F.max_pool2d(hit, mask_fill + 1, stride=1) == 0).to(torch.float32)


def export_pointcloud(model: torch.nn.Module, data_loader, output_path, use_mask: bool = True,
                      roi: Optional[Sequence[int]] = None, min_d: float = 3.0,
                      max_d: float = 30.0, dropout: float = 0.75, progress: bool = True) -> Path:
    """Run ``model`` over ``data_loader`` (batch size 1, in order) and write
    the world-frame PLY to ``output_path``."""
    writer = PLYWriter(min_d=min_d, max_d=max_d, roi=roi, dropout=dropout)
    buf: deque = deque()
    key_index = BUFFER_LENGTH // 2
    model.eval()
    for i, batch in enumerate(data_loader):
        with torch.no_grad():
            out = model(batch)
            cv_mask = out.get("cv_mask")
            keep = pointcloud_masks(torch.zeros_like(out["result"]) if cv_mask is None
                                    else cv_mask)
        buf.append(dict(
            pose=batch["keyframe_pose"][0].cpu().numpy(),
            intrinsics=batch["keyframe_intrinsics"][0].cpu().numpy(),
            keyframe=batch["keyframe"][0].permute(1, 2, 0).cpu().numpy(),
            depth=out["result"][0, 0].cpu().numpy(),
            mask=keep[0, 0].cpu().numpy(),
        ))
        if len(buf) >= BUFFER_LENGTH:
            entry = buf[key_index]
            votes = np.sum([e["mask"] for e in buf], axis=0)
            temporal = (votes > BUFFER_LENGTH - MIN_HITS).astype(np.float32)
            depth = entry["depth"] * (temporal if use_mask else 1.0)
            writer.add_depthmap(depth, entry["keyframe"], entry["intrinsics"], entry["pose"])
            buf.popleft()
        if progress and i % 50 == 0:
            print(f"pointcloud: processed {i} frames", flush=True)
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "wb") as f:
        writer.save(f)
    return output_path
