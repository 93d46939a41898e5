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
