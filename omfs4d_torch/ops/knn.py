"""Blocked brute-force k-nearest-neighbour distances in PyTorch.

Port of `omfs4d.ops.knn`, which replaces the CUDA `simple-knn` extension
GaussianAvatars uses for initial gaussian scales (mean distance of the 3
nearest points).  Each block of rows is one (chunk, N) distance matrix,
|x - y|^2 = |x|^2 + |y|^2 - 2 x.y in full f32 (TF32 is off package-wide),
then a top-k over the row.
"""

from __future__ import annotations

import numpy as np
import torch


def knn_mean_distance(points, k: int = 3, chunk: int = 2048) -> torch.Tensor:
    """Mean distance to the k nearest neighbours (excluding self).

    points : (N, 3) float32 tensor or array; returns (N,) float32 on the
    points' device.
    """
    points = torch.as_tensor(points, dtype=torch.float32)
    n = points.shape[0]
    sq = torch.sum(points * points, dim=1)
    out = []
    for s in range(0, n, chunk):
        block = points[s:s + chunk]
        d2 = sq[s:s + chunk, None] + sq[None, :] - 2.0 * (block @ points.T)
        rows = torch.arange(block.shape[0], device=points.device)
        d2[rows, rows + s] = float("inf")          # mask self-distance
        nearest = torch.topk(d2, k, dim=1, largest=False).values
        out.append(torch.sqrt(torch.clamp_min(nearest, 0.0)).mean(dim=1))
    return torch.cat(out)


def knn_mean_distance_np(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Host reference implementation (tests)."""
    points = np.asarray(points, dtype=np.float64)
    d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1)[:, :k]
    return np.sqrt(np.take_along_axis(d2, idx, axis=1)).mean(axis=1).astype(np.float32)
