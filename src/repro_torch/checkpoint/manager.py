"""Checkpoints: atomic, keep-k, restartable (port of
``repro.checkpoint.manager``).

Two kinds, in the reference's on-disk layouts, so each package restores
the other's checkpoints:

  * training checkpoints (``save`` / ``restore``): a step directory
    ``<dir>/step_<n>/`` holds ``manifest.json`` (the step, the caller's
    ``extra`` state such as the data pipeline's, and the leaf keys of each
    group) beside ``params/`` and ``opt/``, one ``.npy`` a leaf of the
    params and optimizer-state trees, named by the leaf's path
    (``layers__attn__wq.npy``, ``mu__blocks__0__c1.npy``, ``step.npy``).
    ``restore`` needs templates of the trees (the trainer holds them):
    each leaf comes back with its template's dtype, on ``device``.
    Under a mesh (``shardings=``, trees of ``launch.sharding.Sharding``)
    ``save`` gathers each leaf to its global array and rank 0 writes it,
    in the same format; ``restore(..., shardings=)`` gives each rank its
    slice of every leaf, whatever the mesh the checkpoint was saved on
    (the elastic restore: a node lost, or a larger pod).
  * template-free state checkpoints (``save_state`` / ``load_state``) for
    the sweeps: archive fronts, walk cursors, pruner buffers and driver
    state are ragged, dtype-mixed and absent until the walk produces
    them, so they self-describe: arrays one ``.npy`` a leaf (dtype and
    shape travel in the file, never through pickle) and a JSON manifest
    of the nesting plus every scalar/string leaf (``state.json``).

Both are written under ``<dir>/tmp.<n>`` and renamed into place only when
complete (a crash mid-save never corrupts the latest checkpoint), with
keep-k garbage collection of older steps; ``all_steps`` / ``latest_step``
see both.  A torch tensor is stored as its host numpy array
(``repro_torch.device.host``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.device import host, resolve_device
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


# ---------------------------------------------------------------------------
# training checkpoints
# ---------------------------------------------------------------------------

def _paths(tree, prefix=()):
    """(path, leaf) of every leaf of a tree of dicts and lists, in the
    reference's order (``jax.tree_util.tree_flatten_with_path``: dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _flatten(tree) -> dict:
    """{"a/b/0/c": leaf} in the reference's key format and order."""
    return {"/".join(path): leaf for path, leaf in _paths(tree)}


def _publish(ckpt_dir: str, step: int, keep: int, telemetry, write) -> str:
    """``write(tmp)`` fills ``<dir>/tmp.<step>``, which is then renamed to
    ``step_<step>`` (atomic publish) and older steps garbage collected
    past ``keep``; returns the final path."""
    tr = as_tracer(telemetry)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with tr.span("save", cat="checkpoint", step=step):
        write(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
    if tr.enabled:
        tr.observe("checkpoint.bytes", _dir_bytes(final))
    _gc(ckpt_dir, keep, telemetry=telemetry)
    return final


def _gathered(tree, shardings):
    """The global tensors of a tree of local shards (a collective: every
    rank calls it); the tree itself without shardings."""
    if shardings is None:
        return tree
    from repro_torch.optim.optimizers import tree_map
    return tree_map(lambda x, sh: x if sh is None else sh.gather(x), tree,
                    shardings)


def save(ckpt_dir: str, step: int, params, opt_state=None,
         extra: Optional[dict] = None, keep: int = 3,
         telemetry=None, shardings=None, opt_shardings=None) -> str:
    """Write one training checkpoint atomically; returns the final path.
    With ``shardings`` / ``opt_shardings`` the trees hold this rank's
    shards: every rank gathers, rank 0 writes, and all wait for it."""
    if shardings is not None or opt_shardings is not None:
        import torch.distributed as dist
        params = _gathered(params, shardings)
        opt_state = _gathered(opt_state, opt_shardings)
        final = os.path.join(ckpt_dir, f"step_{step}")
        if dist.get_rank() == 0:
            final = save(ckpt_dir, step, params, opt_state, extra, keep,
                         telemetry)
        dist.barrier()
        return final

    def write(tmp):
        manifest = {"step": step, "extra": extra or {}, "arrays": {}}
        for group, tree in (("params", params), ("opt", opt_state)):
            if tree is None:
                continue
            os.makedirs(os.path.join(tmp, group), exist_ok=True)
            for key, leaf in _flatten(tree).items():
                fn = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, group, fn), host(leaf))
                manifest["arrays"].setdefault(group, []).append(key)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    return _publish(ckpt_dir, step, keep, telemetry, write)


def _dtype_of(leaf):
    """The torch dtype of a template leaf (a tensor or a numpy array)."""
    if torch.is_tensor(leaf):
        return leaf.dtype
    return torch.from_numpy(np.zeros((), np.asarray(leaf).dtype)).dtype


def _restore_tree(path: str, template, device, shardings=None):
    def load(prefix, leaf, sharding):
        key = "/".join(prefix)
        arr = np.load(os.path.join(path, key.replace("/", "__") + ".npy"),
                      mmap_mode="r")
        if sharding is not None:          # elastic: this rank's slice only
            arr = arr[sharding.local_slices(arr.shape)]
        return torch.from_numpy(np.array(arr)).to(device=device,
                                                  dtype=_dtype_of(leaf))

    def build(tree, sh, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, None if sh is None else sh[k],
                             prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, None if sh is None else sh[i],
                                    prefix + (str(i),))
                              for i, v in enumerate(tree))
        return load(prefix, tree, sh)

    return build(template, shardings)


def restore(ckpt_dir: str, step: int, params_template, opt_template=None,
            device=None, shardings=None, opt_shardings=None):
    """Load checkpoint ``step`` shaped like the templates (trees whose
    leaves are tensors or numpy arrays: each restored leaf takes its
    template's dtype), on ``device`` (default: the CUDA card).  With
    ``shardings`` / ``opt_shardings`` (trees of ``Sharding`` on any mesh)
    each leaf is this rank's slice of it.
    Returns (params, opt_state, extra_dict)."""
    device = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    params = _restore_tree(os.path.join(path, "params"), params_template,
                           device, shardings)
    opt_state = None
    if opt_template is not None and "opt" in manifest["arrays"]:
        opt_state = _restore_tree(os.path.join(path, "opt"), opt_template,
                                  device, opt_shardings)
    return params, opt_state, manifest["extra"]


# ---------------------------------------------------------------------------
# template-free state checkpoints
# ---------------------------------------------------------------------------

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
    def write(tmp):
        arrays: dict[str, np.ndarray] = {}
        tree = _encode_state(state, arrays, "")
        for key, arr in arrays.items():
            np.save(os.path.join(tmp, key + ".npy"), arr)
        with open(os.path.join(tmp, "state.json"), "w") as f:
            json.dump({"step": step, "state": tree}, f)

    return _publish(ckpt_dir, step, keep, telemetry, write)


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
