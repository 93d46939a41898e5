"""Carry the JAX package's state into the port's types.

The state arrives as numpy arrays (the caller does the ``np.asarray`` of
each JAX array), so this module imports neither ``jax`` nor ``repro``.
It lets both packages work on the same configs, the same workloads, the
same fitted surrogate coefficients and the same model weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.arch import AcceleratorConfig
from repro_torch.core.ppa import PolyModel, PPAModels
from repro_torch.core.workloads import (LayerSpec, StackedWorkload, Workload,
                                        _IR_DEFAULTS)
from repro_torch.device import resolve_device


def config_from_numpy(arrays: dict, device=None) -> AcceleratorConfig:
    """``{field: array}`` -> AcceleratorConfig (float32 knobs, int32
    ``pe_type``; a missing ``mapping`` is the legacy code 0)."""
    device = resolve_device(device)
    arrays = dict(arrays)
    arrays.setdefault("mapping", np.zeros_like(
        np.asarray(arrays["pe_rows"]), np.float32))
    return AcceleratorConfig(**{
        f: torch.tensor(np.array(arrays[f]),
                           dtype=torch.int32 if f == "pe_type"
                           else torch.float32, device=device)
        for f in AcceleratorConfig._fields})


def workload_from_numpy(name: str, arrays: dict, layer_names,
                        device=None) -> Workload:
    """``{LayerSpec field: (L,) array}`` -> Workload; IR fields missing
    from ``arrays`` take their neutral defaults."""
    device = resolve_device(device)
    n = len(np.asarray(arrays["H"]))
    cols = {f: np.array(arrays[f]) if f in arrays
            else np.full(n, _IR_DEFAULTS[f]) for f in LayerSpec._fields}
    layers = LayerSpec(**{f: torch.as_tensor(c, dtype=torch.float32,
                                             device=device)
                          for f, c in cols.items()})
    return Workload(name=name, layers=layers, layer_names=tuple(layer_names))


def stacked_workload_from_numpy(names, arrays: dict, n_layers,
                                device=None) -> StackedWorkload:
    """``{LayerSpec field: (M, L) array}`` -> StackedWorkload (the JAX
    package's ``stack_workloads`` result, field for field)."""
    device = resolve_device(device)
    layers = LayerSpec(**{f: torch.as_tensor(np.array(arrays[f]),
                                             dtype=torch.float32,
                                             device=device)
                          for f in LayerSpec._fields})
    return StackedWorkload(names=tuple(names), layers=layers,
                           n_layers=tuple(int(n) for n in n_layers))


def ppa_models_from_numpy(models: dict, device=None) -> PPAModels:
    """``{pe_type: {target: {degree, exps, mu, sigma, coef, log_target}}}``
    with numpy leaves -> PPAModels predicting from the same coefficients."""
    device = resolve_device(device)
    f32 = lambda a: torch.tensor(np.array(a), dtype=torch.float32,  # noqa: E731
                                    device=device)
    return PPAModels(models={
        pe: {t: PolyModel(degree=int(m["degree"]),
                          exps=np.asarray(m["exps"], np.int32),
                          mu=f32(m["mu"]), sigma=f32(m["sigma"]),
                          coef=f32(m["coef"]),
                          log_target=bool(m["log_target"]))
             for t, m in targets.items()}
        for pe, targets in models.items()})


# numpy has no float8 dtype: JAX's float8 arrays come back as
# ml_dtypes' (by name), which torch.from_numpy refuses
_FLOAT8 = {"float8_e4m3fn": torch.float8_e4m3fn}


def tensor_from_numpy(x, device=None) -> torch.Tensor:
    """A numpy array (``np.asarray`` of a JAX array) as a tensor of its
    dtype.  A float8_e4m3fn array moves as its uint8 bit patterns, viewed
    as ``torch.float8_e4m3fn`` on arrival: exact."""
    device = resolve_device(device)
    x = np.asarray(x)
    fp8 = _FLOAT8.get(x.dtype.name)
    if fp8 is not None:
        bits = np.ascontiguousarray(x).view(np.uint8)
        return torch.from_numpy(bits.copy()).view(fp8).to(device)
    return torch.tensor(np.array(x), device=device)


def bits_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; a float8 one as its uint8 bit patterns
    (view them as ``ml_dtypes.float8_e4m3fn`` on the JAX side)."""
    t = t.detach().cpu()
    if t.dtype in _FLOAT8.values():
        t = t.view(torch.uint8)
    return t.numpy()


def params_from_numpy(tree, device=None):
    """A model's parameter pytree with numpy leaves (the JAX package's
    layout of any family: the decoders' stacked ``layers``, Whisper's
    ``enc_layers`` / ``dec_layers`` and LayerNorm ``{"scale", "bias"}``
    leaves, packed ``{"codes__<mode>": ..., "scale": ...}`` leaves) ->
    the same nested dicts and lists of tensors, each leaf keeping its
    dtype (float32 weights, uint8/int8 codes; a float8 cache by its bits,
    ``tensor_from_numpy``)."""
    device = resolve_device(device)

    def f(x):
        if isinstance(x, dict):
            return {k: f(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(f(v) for v in x)
        return tensor_from_numpy(x, device)

    return f(tree)


def train_state_from_numpy(params, opt_state, step, device=None):
    """The JAX package's training state (params and optimizer state as
    trees of numpy arrays, the step as an int) -> the port's
    ``TrainState``: the CNN's ``blocks`` lists and the optimizer's
    ``{"mu", "nu", "step"}`` keep their layout, each leaf its dtype."""
    from repro_torch.train.trainer import TrainState
    device = resolve_device(device)
    return TrainState(params=params_from_numpy(params, device),
                      opt_state=params_from_numpy(opt_state, device),
                      step=torch.tensor(int(step), dtype=torch.int32,
                                        device=device))
