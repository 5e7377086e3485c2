"""Multi-view video test aggregation.

Port of ``metatransformer_tpu/models/video_eval.py``: VideoMAE's
``final_test`` protocol, 5 temporal x 3 spatial crops per video, logits
averaged over the views. Views are cut on the host with numpy; the 15
clips go through ``forward`` as one batch.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def temporal_segments(
    frames: np.ndarray, num_frames: int, num_segments: int
) -> np.ndarray:
    """[T, H, W, C] full video -> [num_segments, num_frames, H, W, C]
    evenly spaced clips."""
    t = frames.shape[0]
    views = []
    for s in range(num_segments):
        if t <= num_frames:
            idx = np.minimum(np.arange(num_frames), t - 1)
        else:
            start = int(round(s * (t - num_frames) / max(num_segments - 1, 1)))
            idx = np.arange(start, start + num_frames)
        views.append(frames[idx])
    return np.stack(views)


def spatial_crops(clip: np.ndarray, crop: int, num_crops: int = 3) -> np.ndarray:
    """[T, H, W, C] -> [num_crops, T, crop, crop, C] (left/center/right or
    top/center/bottom along the longer side)."""
    t, h, w, c = clip.shape
    outs = []
    if w >= h:
        positions = np.linspace(0, w - crop, num_crops).astype(int)
        y0 = (h - crop) // 2
        for x0 in positions:
            outs.append(clip[:, y0 : y0 + crop, x0 : x0 + crop])
    else:
        positions = np.linspace(0, h - crop, num_crops).astype(int)
        x0 = (w - crop) // 2
        for y0 in positions:
            outs.append(clip[:, y0 : y0 + crop, x0 : x0 + crop])
    return np.stack(outs)


def multiview_logits(
    forward: Callable[[torch.Tensor], torch.Tensor],
    video: np.ndarray,  # [T, H, W, C] full-length decoded video
    num_frames: int = 16,
    crop: int = 224,
    num_segments: int = 5,
    num_crops: int = 3,
) -> Tuple[torch.Tensor, int]:
    """Aggregate logits over num_segments x num_crops views (mean).

    ``forward`` takes the [S*C, T, h, w, 3] batch as a CPU tensor (uint8
    stays uint8) and moves it where it computes."""
    clips = []
    for seg in temporal_segments(video, num_frames, num_segments):
        clips.append(spatial_crops(seg, crop, num_crops))
    batch = torch.from_numpy(np.concatenate(clips, axis=0))  # [S*C, T, h, w, 3]
    logits = forward(batch)
    return logits.mean(dim=0), batch.shape[0]
