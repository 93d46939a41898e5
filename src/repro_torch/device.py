"""Where the port's tensors are created.

Every function that creates tensors from nothing (configs, design
spaces, workloads, PPA fits, weight draws) takes a ``device=`` keyword
resolved here.  ``None`` means the CUDA card; without one it raises, so
the port never drops to the CPU unasked.  Everything downstream follows
the device of its inputs.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device to create tensors on: CUDA unless ``device`` says otherwise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def host(x):
    """A tensor (or array-like) as a host numpy array."""
    import numpy as np
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices name the same place (``cuda`` without an index
    is the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def stage(x, device: torch.device):
    """A host array or CPU tensor on ``device``, copied without blocking
    the host: a copy to a card reads from a pinned buffer and is queued
    on the current stream (a copy from pageable memory would first wait
    for the stream to drain).  Returns ``(tensor, pinned)``: keep
    ``pinned`` alive until the stream has passed the copy."""
    t = torch.as_tensor(x)
    if same_device(t.device, device):
        return t, None
    if torch.device(device).type != "cuda" or t.device.type != "cpu":
        return t.to(device), None
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t)
    return pinned.to(device, non_blocking=True), pinned
