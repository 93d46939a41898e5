"""Template-free state checkpoints (port of the state half of
``repro.checkpoint.manager``).

Long-running DSE sweeps checkpoint state that has no template: archive
fronts, walk cursors, pruner buffers and driver state are ragged,
dtype-mixed and absent until the walk produces them.  ``save_state`` /
``load_state`` self-describe: arrays are stored one ``.npy`` per leaf
(dtype and shape travel in the file, never through pickle) and a JSON
manifest records the nesting plus every scalar/string leaf.

The on-disk layout is the reference's: ``<dir>/step_<n>/state.json``
beside ``a<k>.npy``, written under ``<dir>/tmp.<n>`` and renamed into
place only when complete (a crash mid-save never corrupts the latest
checkpoint), with keep-k garbage collection of older steps.  So each
package reads the other's checkpoints.  A torch tensor is stored as its
host numpy array (``repro_torch.device.host``); a load returns numpy.

The training ``save`` / ``restore`` (params and optimizer state) are not
ported yet: they wait for the port's trainer.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.device import host
from repro_torch.obs import as_tracer

_STEP_RE = re.compile(r"^step_(\d+)$")
_ARRAY_REF = "__npy__"


def _dir_bytes(path: str) -> int:
    """Total on-disk size of a checkpoint directory (telemetry arg)."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for fn in files:
            try:
                total += os.path.getsize(os.path.join(root, fn))
            except OSError:
                pass
    return total


def _gc(ckpt_dir: str, keep: int, telemetry=None) -> None:
    tr = as_tracer(telemetry)
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
        tr.instant("gc_removed", cat="checkpoint", level="warning",
                   step=s, keep=keep, dir=ckpt_dir)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _encode_state(node, arrays: dict, path: str):
    if isinstance(node, (np.ndarray, torch.Tensor)):
        key = f"a{len(arrays)}"
        arrays[key] = host(node)
        return {_ARRAY_REF: key}
    if isinstance(node, dict):
        for k in node:
            if not isinstance(k, str):
                raise TypeError(f"state dict keys must be str at {path!r}, "
                                f"got {type(k).__name__}")
            if k == _ARRAY_REF:
                raise ValueError(f"state dict key {_ARRAY_REF!r} is "
                                 f"reserved (at {path!r})")
        return {k: _encode_state(v, arrays, f"{path}/{k}")
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_encode_state(v, arrays, f"{path}/{i}")
                for i, v in enumerate(node)]
    if isinstance(node, (np.integer,)):
        return int(node)
    if isinstance(node, (np.floating,)):
        return float(node)
    if isinstance(node, (np.bool_,)):
        return bool(node)
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    raise TypeError(f"state leaf at {path!r} is not checkpointable: "
                    f"{type(node).__name__}")


def _decode_state(node, path: str):
    if isinstance(node, dict):
        if set(node) == {_ARRAY_REF}:
            return np.load(os.path.join(path, node[_ARRAY_REF] + ".npy"))
        return {k: _decode_state(v, path) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode_state(v, path) for v in node]
    return node


def save_state(ckpt_dir: str, step: int, state, keep: int = 3,
               telemetry=None) -> str:
    """Atomically write a self-describing state checkpoint.

    ``state`` is any nesting of dicts (str keys), lists/tuples, numpy
    arrays or torch tensors, and JSON scalars.  Tuples come back as lists
    and tensors as numpy arrays.  Returns the published ``step_<n>`` path.

    ``telemetry=`` (a ``repro_torch.obs.Tracer``) records the save
    duration (span ``checkpoint.save``, histogram ``checkpoint.bytes``)
    and a warning event for every snapshot the keep-k GC removes.
    """
    tr = as_tracer(telemetry)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays: dict[str, np.ndarray] = {}
    with tr.span("save", cat="checkpoint", step=step):
        tree = _encode_state(state, arrays, "")
        for key, arr in arrays.items():
            np.save(os.path.join(tmp, key + ".npy"), arr)
        with open(os.path.join(tmp, "state.json"), "w") as f:
            json.dump({"step": step, "state": tree}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
    if tr.enabled:
        tr.observe("checkpoint.bytes", _dir_bytes(final))
    _gc(ckpt_dir, keep, telemetry=telemetry)
    return final


def load_state(ckpt_dir: str, step: Optional[int] = None, telemetry=None):
    """Load a ``save_state`` checkpoint (default: the latest step).

    Returns ``(step, state)``; ``(None, None)`` if the directory holds no
    checkpoint.  ``telemetry=`` records the load duration and size (span
    ``checkpoint.load``).
    """
    tr = as_tracer(telemetry)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    path = os.path.join(ckpt_dir, f"step_{step}")
    with tr.span("load", cat="checkpoint", step=step):
        with open(os.path.join(path, "state.json")) as f:
            payload = json.load(f)
        state = _decode_state(payload["state"], path)
    if tr.enabled:
        tr.observe("checkpoint.bytes", _dir_bytes(path))
    return payload["step"], state
