"""Which device an entry point runs on.

Every entry point of the port takes the CUDA card unless the caller asks for
the CPU, and raises when there is no card: nothing falls back to the CPU on
its own.
"""

from __future__ import annotations

import copy

import torch


def resolve_device(device, who: str) -> torch.device:
    """`device=None` is the CUDA card.  Raises when a card is wanted and there
    is none; a bare "cuda" becomes the current card, with its index."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def model_on(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """`model` itself when its buffers are on `device`, else a copy there."""
    if next(model.buffers()).device == device:
        return model
    return copy.deepcopy(model).to(device)
