"""Writes ``tests/data/torch_seqshard_ref.json``: the JAX package's serving
runs on a KV cache split over its sequence, on meshes of 4 host devices,
that ``tests/test_torch_seqshard.py`` holds the port's sequence-sharded
cache to.

  PYTHONPATH=src:tests python tests/_torch_seqshard_ref.py

It sets ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (and XLA's
excess precision off, so that P's rounding to a bfloat16 or e4m3 V stays
where the reference writes it) before JAX is imported and builds its
meshes as ``tests/_torch_tp_ref.py`` does (Auto axes under
``jax.set_mesh``, the reference's ``activation_sharding``), the params
in the "serve" shardings and the cache by ``make_cache_shardings(...,
seq_shard=True)``, as ``repro.launch.perf.build_variant`` sets it where the
KV heads do not divide ``model``: GSPMD then runs the softmax of
``_attention_dynwin`` as a max and a sum across the sequence shards.  Two
parts (~1 min):

  * ``serve``: each ``CASES`` case (a reduced config in float32) on each
    cache type of ``CACHE_DTYPES``: a prefill of ``PROMPT`` tokens into a
    ``CACHE``-row cache, then ``DECODE`` teacher-forced decode steps (the
    writes cross the slices' boundaries, and the last step runs past the
    cache's end, where the write's start is clamped): each step's last
    logits and the final cache (K and V of every layer, as float32); and
    the same run on one device (``one``), with its attention
    probabilities before they are rounded to a bfloat16 or e4m3 V, one
    array a call (``probs``, ``_torch_act_pins.jax_probs_log``: the port
    pins its P codes to them at rounding ties).  The two part at the last step:
    there the partitioned ``dynamic_update_slice`` drops the write whose
    start the one-device op clamps (row ``CACHE - 1`` keeps the previous
    position's K and V), so the port, which clamps on the whole cache as
    the op is defined, is held to the one-device run at that step;
  * ``dryrun``: ``DRYRUN_CELLS`` on a 2 x 2 mesh, built by the reference's
    ``repro.launch.dryrun.build_cell`` (which splits such a cache's
    sequence itself) and compiled as ``tests/_torch_dryrun_ref.py``
    compiles a cell: ``memory_analysis()``'s argument bytes a device.

The JAX package is not edited.
"""

import base64
import json
import os
import sys
from pathlib import Path

import numpy as np

REF_PATH = (Path(__file__).resolve().parent / "data"
            / "torch_seqshard_ref.json")
N_DEV = 4
PARAM_SEED = 0
TOKEN_SEED = 11
PROMPT, DECODE, CACHE = 8, 9, 16
# (key, arch, mesh, batch): one KV head over 2 with the q heads split and
# sliding windows (Gemma-3), the attention whole (SmolLM's 3 query heads
# at 2), 2 KV heads over 4 (Qwen3: each rank 4 rows of the cache), and a
# batch of 1 on (2, 2), where the cache's sequence splits over ("data",
# "model")
CASES = (
    ("gemma3_1x2", "gemma3-1b", (1, 2), 2),
    ("smollm_1x2", "smollm-135m", (1, 2), 2),
    ("qwen3_1x4", "qwen3-32b", (1, 4), 2),
    ("gemma3_2x2_b1", "gemma3-1b", (2, 2), 1),
)
CACHE_DTYPES = ("float32", "bfloat16", "float8_e4m3fn")
# (arch, (name, seq, batch, kind)) serving cells of the reduced configs on
# a 2 x 2 mesh: the sequence over "model", and over ("data", "model") at
# batch 1
DRYRUN_MESH = (2, 2)
DRYRUN_CELLS = (("smollm-135m", ("decode_m", 64, 4, "decode")),
                ("gemma3-1b", ("decode_m1", 64, 1, "decode")))


def _b64(a) -> str:
    return base64.b64encode(np.ascontiguousarray(a, np.float32)
                            .tobytes()).decode()


def unb64(s: str, shape) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), np.float32).reshape(shape)


def config(arch: str):
    """The port's reduced config of a case, in float32."""
    from repro_torch.configs import reduced
    return reduced(arch).replace(dtype="float32")


def serve_tokens(cfg, batch: int) -> np.ndarray:
    return np.random.default_rng(TOKEN_SEED).integers(
        0, cfg.vocab, (batch, PROMPT + DECODE)).astype(np.int32)


def _mesh(shape):
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:int(np.prod(shape))])


def run_serve(arch, shape, batch, cache_dtype) -> dict:
    """The case on ``shape`` (the cache's sequence split), or on one
    device (``shape`` None; with its P log on a bfloat16 or e4m3
    cache)."""
    import contextlib
    from _torch_act_pins import jax_probs_log
    log = (jax_probs_log() if shape is None and cache_dtype != "float32"
           else contextlib.nullcontext())
    with log as calls:
        out = _serve(arch, shape, batch, cache_dtype)
    if calls is not None:
        out["probs"] = {"shapes": [list(c.shape) for c in calls.calls],
                        "data": _b64(np.concatenate(
                            [c.reshape(-1) for c in calls.calls]))}
    return out


def unpack_probs(probs: dict) -> list:
    """The P log of ``run_serve``: one float32 array a call."""
    flat = np.frombuffer(base64.b64decode(probs["data"]), np.float32)
    out, at = [], 0
    for shape in probs["shapes"]:
        n = int(np.prod(shape))
        out.append(flat[at:at + n].reshape(shape))
        at += n
    return out


def _serve(arch, shape, batch, cache_dtype) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced
    from repro.launch.sharding import (make_cache_shardings,
                                       make_param_shardings)
    from repro.models import transformer as JT
    from repro.models.layers import activation_sharding
    from repro_torch.models import transformer as T

    cfg = config(arch)
    jcfg = reduced(arch).replace(dtype="float32")
    params = jax.tree.map(jnp.asarray, T.numpy_params(cfg, PARAM_SEED))
    toks = jnp.asarray(serve_tokens(cfg, batch))
    mesh = _mesh(shape or (1, 1))
    logits_all = []
    with jax.set_mesh(mesh), activation_sharding(("data",), mesh.shape[
            "data"], mesh=mesh):
        cache = JT.init_cache(jcfg, batch, CACHE, jnp.dtype(cache_dtype))
        if shape is not None:
            params = jax.device_put(params, make_param_shardings(
                jcfg, params, mesh, "serve"))
            cache = jax.device_put(cache, make_cache_shardings(
                jcfg, cache, mesh, seq_shard=True))
        prefill = jax.jit(lambda p, t, c: JT.prefill(p, t, jcfg, c))
        decode = jax.jit(lambda p, t, c: JT.decode_step(p, t, jcfg, c))
        logits, cache = prefill(params, toks[:, :PROMPT], cache)
        logits_all.append(np.asarray(logits[:, -1], np.float32))
        for i in range(DECODE):
            at = PROMPT + i
            logits, cache = decode(params, toks[:, at:at + 1], cache)
            logits_all.append(np.asarray(logits[:, -1], np.float32))
            if at == CACHE - 1:     # the last row before the clamped write
                last_row = {name: np.asarray(cache["scan"][name][:, :, -1]
                                             .astype(jnp.float32))
                            for name in ("k", "v")}
    steps = np.stack(logits_all)
    kv = {name: np.asarray(cache["scan"][name].astype(jnp.float32))
          for name in ("k", "v")}
    return {"arch": arch, "mesh": list(shape or (1, 1)), "batch": batch,
            "cache_dtype": cache_dtype, "shape": list(steps.shape),
            "logits": _b64(steps), "cache_shape": list(kv["k"].shape),
            "cache": {name: _b64(a) for name, a in kv.items()},
            "last_row": {name: _b64(a) for name, a in last_row.items()}}


def cache_writes(run: dict) -> list:
    """The K and V rows each step of ``run_serve``'s run wrote, in the
    cache's values (float32): [(k, v) a step], each (L, B, rows, H, D):
    the prompt's rows, then a row a step, the last one at the cache's end
    (its start clamped) after the row it overwrote."""
    shape = run["cache_shape"]
    kv = [unb64(run["cache"][n], shape) for n in ("k", "v")]
    last = [unb64(run["last_row"][n], shape[:2] + shape[3:])[:, :, None]
            for n in ("k", "v")]
    out = [tuple(a[:, :, :PROMPT] for a in kv)]
    for i in range(DECODE):
        at = min(PROMPT + i, CACHE - 1)
        before_clamp = PROMPT + i == CACHE - 1
        out.append(tuple(l if before_clamp else a[:, :, at:at + 1]
                         for a, l in zip(kv, last)))
    return out


def run_dryrun() -> dict:
    from _torch_dryrun_ref import _run
    return _run(list(DRYRUN_CELLS), DRYRUN_MESH, reduced=True)


def build_reference() -> dict:
    import jax
    assert jax.device_count() == N_DEV, jax.device_count()
    serve = {}
    for key, arch, shape, batch in CASES:
        for dt in CACHE_DTYPES:
            serve[f"{key}/{dt}"] = run_serve(arch, shape, batch, dt)
            serve[f"{key}/{dt}"]["one"] = run_serve(arch, None, batch, dt)
            print(key, dt, flush=True)
    return {"jax_version": jax.__version__, "n_devices": N_DEV,
            "prompt": PROMPT, "decode": DECODE, "cache": CACHE,
            "serve": serve,
            "dryrun": {"mesh": list(DRYRUN_MESH), "cells": run_dryrun()}}


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count"
                                 f"={N_DEV} --xla_allow_excess_precision"
                                 f"=false")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    ref = build_reference()
    REF_PATH.write_text(json.dumps(ref))
    print(f"wrote {REF_PATH} ({REF_PATH.stat().st_size} bytes)")
    sys.exit(0)
