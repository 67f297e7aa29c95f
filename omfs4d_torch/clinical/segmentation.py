"""Pluggable AI segmentation hook.

Port of `omfs4d.clinical.segmentation`.  The reference ships an optional
nnU-Net v2 wrapper that is not wired into the live UI path (ref:
run_segmentation.py:25-90; app.py:544-546 uses HU thresholding instead).
Parity here is a registry: any callable (volume tensor, spacing) -> label
volume can be registered as a segmenter; the default is HU thresholding,
which is also what the reference actually runs.  The volume is handed to the
segmenter on `device` (the CUDA card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from omfs4d_torch.core.device import resolve_device

_SEGMENTERS: dict[str, Callable] = {}


def register_segmenter(name: str):
    def deco(fn: Callable):
        _SEGMENTERS[name] = fn
        return fn
    return deco


@register_segmenter("hu_threshold")
def _hu_threshold(volume: torch.Tensor, spacing, hu_threshold: float = 300.0,
                  **_) -> torch.Tensor:
    return (volume >= float(np.float32(hu_threshold))).to(torch.uint8)


def segment_volume(volume, spacing, method: str = "hu_threshold", device=None,
                   **kwargs) -> torch.Tensor:
    """Run a registered segmenter on `device`; returns an integer label
    volume there."""
    if method not in _SEGMENTERS:
        raise KeyError(
            f"segmenter {method!r} not registered; available: {sorted(_SEGMENTERS)}"
        )
    dev = resolve_device(device, "segment_volume")
    return _SEGMENTERS[method](torch.as_tensor(volume).to(dev, torch.float32), spacing, **kwargs)
