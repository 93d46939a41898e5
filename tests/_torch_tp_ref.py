"""Writes ``tests/data/torch_tp_ref.json``: the JAX package's runs on
meshes of 4 host devices that ``tests/test_torch_tp.py`` holds the port's
tensor-parallel split to.

  PYTHONPATH=src:tests python tests/_torch_tp_ref.py

It sets ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before JAX
is imported and builds its meshes as ``tests/_torch_launch_ref.py`` does
(Auto axes under ``jax.set_mesh``, the reference's
``activation_sharding``, ``state_shardings_for`` and ``jax.jit``), where
GSPMD partitions every product by the reference's param specs.  Two
parts (~1 min):

  * ``train``: each ``TRAIN`` case (a reduced config in float32 under a
    PE type, on a ("data", "model") mesh): ``STEPS`` AdamW steps
    (``warmup_cosine(*LM_SCHEDULE)``, clip 1.0) from
    ``transformer.numpy_params(cfg, 0)`` on ``tp_batches``: each step's
    loss and gradient norm, and a digest of the final params
    (``repro_torch.tp_check.param_digest``'s first ``DIGEST`` elements of
    every leaf);
  * ``serve``: each ``SERVE`` case on a (1, 2) mesh, the params in the
    "serve" shardings (packed as int4 codes where asked) and the cache
    by ``cache_spec``: a prefill of ``PROMPT`` tokens then ``DECODE``
    teacher-forced decode steps, each step's last logits.

The JAX package is not edited.
"""

import base64
import json
import os
import sys
from pathlib import Path

import numpy as np

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_tp_ref.json"
N_DEV = 4
PARAM_SEED = 0
DATA_SEED = 7
BATCH, SEQ, STEPS = 4, 32, 3
# (key, arch, mesh, PE type): q and kv split (Qwen3 at 2), q split over one
# replicated KV head a rank (Qwen3 at 4, Gemma-3 at 2: its window and its
# tied vocabulary-parallel head), the attention whole with the MLP and the
# vocabulary split (SmolLM's 3 heads), experts with FSDP and TP together
# (DeepSeek on (2, 2)) under the three numerics
TRAIN = (
    ("qwen3_1x2", "qwen3-32b", (1, 2), "fp32"),
    ("qwen3_1x4", "qwen3-32b", (1, 4), "fp32"),
    ("gemma3_1x2", "gemma3-1b", (1, 2), "fp32"),
    ("smollm_1x2", "smollm-135m", (1, 2), "fp32"),
    ("deepseek_2x2_fp32", "deepseek-moe-16b", (2, 2), "fp32"),
    ("deepseek_2x2_lightpe1", "deepseek-moe-16b", (2, 2), "lightpe1"),
    ("deepseek_2x2_int8", "deepseek-moe-16b", (2, 2), "int8"),
)
# serving on (1, 2): Qwen3's float32 weights on a float32 cache split over
# its 2 KV heads, and int4 codes with K/V replicated to 4 heads (each rank
# its 2)
PROMPT, DECODE, SERVE_BATCH, CACHE = 8, 4, 2, 16
SERVE = (
    ("qwen3_dense", "qwen3-32b", {}, None),
    ("qwen3_int4_kv4", "qwen3-32b", {"kv_replicate_to": 4}, "int4"),
)
PACK_MIN = 1          # every weight of the reduced config packed
DIGEST = 256          # elements a leaf of the final params


def _b64(a) -> str:
    return base64.b64encode(np.ascontiguousarray(a, np.float32)
                            .tobytes()).decode()


def unb64(s: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), np.float32)


def config(arch: str, pe_type: str = "fp32", overrides=None):
    """The port's reduced config of a case, in float32."""
    from repro_torch.configs import reduced
    return reduced(arch).replace(dtype="float32", pe_type=pe_type,
                                 **(overrides or {}))


def tp_batches(cfg) -> list:
    """``STEPS`` global batches of numpy tokens and next-token labels."""
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng([DATA_SEED, i])
        toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1), dtype=np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def serve_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(DATA_SEED + 1).integers(
        0, cfg.vocab, (SERVE_BATCH, PROMPT + DECODE)).astype(np.int32)


def digest(params) -> dict:
    """``param_digest`` (``DIGEST`` elements a leaf) of a tree of numpy /
    JAX arrays, as base64."""
    import torch
    from repro_torch.tp_check import param_digest
    from repro_torch.launch.sharding import map_with_path
    tree = map_with_path(lambda _, x: torch.from_numpy(
        np.array(x, np.float32)), params)
    return {k: _b64(v) for k, v in param_digest(tree, k=DIGEST).items()}


def _mesh(shape):
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:int(np.prod(shape))])


def run_train(arch, shape, pe_type) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import reduced
    from repro.models import transformer as JT
    from repro.models.layers import activation_sharding
    from repro.optim import adamw, warmup_cosine
    from repro.train.trainer import (TrainState, make_train_step,
                                     state_shardings_for)
    from repro_torch.models import transformer as T
    from repro_torch.train_check import LM_SCHEDULE

    cfg = config(arch, pe_type)
    jcfg = reduced(arch).replace(dtype="float32", pe_type=pe_type)
    params = T.numpy_params(cfg, PARAM_SEED)
    mesh = _mesh(shape)
    opt = adamw(warmup_cosine(*LM_SCHEDULE))
    jp = jax.tree.map(jnp.asarray, params)
    state = TrainState(params=jp, opt_state=opt.init(jp),
                       step=jnp.zeros((), jnp.int32))
    batch_sh = NamedSharding(mesh, P("data", None))
    losses, gnorms = [], []
    with jax.set_mesh(mesh), activation_sharding(("data",), shape[0],
                                                 mesh=mesh):
        state = jax.device_put(state, state_shardings_for(jcfg, JT, mesh,
                                                          opt))
        step = jax.jit(make_train_step(jcfg, JT, opt, dp=("data",)))
        for b in tp_batches(cfg):
            b = {k: jax.device_put(jnp.asarray(v), batch_sh)
                 for k, v in b.items()}
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    return {"arch": arch, "mesh": list(shape), "pe_type": pe_type,
            "losses": losses, "grad_norms": gnorms,
            "final": digest(jax.tree.map(np.asarray, state.params))}


def run_serve(arch, overrides, quant) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced
    from repro.launch.sharding import (make_cache_shardings,
                                       make_param_shardings)
    from repro.models import transformer as JT
    from repro.models.layers import activation_sharding
    from repro.serve.engine import quantize_params
    from repro_torch.models import transformer as T

    cfg = config(arch, "fp32", overrides)
    jcfg = reduced(arch).replace(dtype="float32", **overrides)
    params = jax.tree.map(jnp.asarray, T.numpy_params(cfg, PARAM_SEED))
    if quant:
        params = quantize_params(params, quant, min_size=PACK_MIN)
    toks = jnp.asarray(serve_tokens(cfg))
    mesh = _mesh((1, 2))
    logits_all = []
    with jax.set_mesh(mesh), activation_sharding(("data",), 1, mesh=mesh):
        cache = JT.init_cache(jcfg, SERVE_BATCH, CACHE, jnp.float32)
        params = jax.device_put(params, make_param_shardings(
            jcfg, params, mesh, "serve"))
        cache = jax.device_put(cache, make_cache_shardings(jcfg, cache,
                                                           mesh))
        prefill = jax.jit(lambda p, t, c: JT.prefill(p, t, jcfg, c))
        decode = jax.jit(lambda p, t, c: JT.decode_step(p, t, jcfg, c))
        logits, cache = prefill(params, toks[:, :PROMPT], cache)
        logits_all.append(np.asarray(logits[:, -1], np.float32))
        for i in range(DECODE):
            at = PROMPT + i
            logits, cache = decode(params, toks[:, at:at + 1], cache)
            logits_all.append(np.asarray(logits[:, -1], np.float32))
    steps = np.stack(logits_all)
    return {"arch": arch, "overrides": overrides, "quant": quant,
            "mesh": [1, 2], "shape": list(steps.shape),
            "logits": _b64(steps)}


def build_reference() -> dict:
    import jax
    assert jax.device_count() == N_DEV, jax.device_count()
    return {"jax_version": jax.__version__, "n_devices": N_DEV,
            "batch": BATCH, "seq": SEQ, "steps": STEPS,
            "train": {key: run_train(arch, shape, pe)
                      for key, arch, shape, pe in TRAIN},
            "serve": {key: run_serve(arch, over, quant)
                      for key, arch, over, quant in SERVE}}


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count"
                                 f"={N_DEV}")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    ref = build_reference()
    REF_PATH.write_text(json.dumps(ref))
    for key, run in ref["train"].items():
        print(key, "losses", run["losses"], "grad norms", run["grad_norms"])
    print(f"wrote {REF_PATH} ({REF_PATH.stat().st_size} bytes)")
    sys.exit(0)
