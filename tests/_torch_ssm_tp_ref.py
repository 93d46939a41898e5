"""Writes ``tests/data/torch_ssm_tp_ref.json``: the JAX package's runs of
the SSM and hybrid families on meshes of 4 host devices that
``tests/test_torch_ssm_tp.py`` holds the port's tensor-parallel split to.

  PYTHONPATH=src:tests python tests/_torch_ssm_tp_ref.py

As ``tests/_torch_tp_ref.py`` (whose batches, tokens, digest and meshes
it shares): ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set
before JAX is imported, Auto axes under ``jax.set_mesh``, the
reference's ``activation_sharding``, ``state_shardings_for`` and
``jax.jit``, where GSPMD partitions every layer by the reference's param
specs.  Two parts (~1 min):

  * ``train``: each ``TRAIN`` case (reduced RWKV6 or Zamba2 in float32
    under a PE type, on a ("data", "model") mesh): ``STEPS`` AdamW steps
    from the family's ``numpy_params(cfg, 0)``: each step's loss and
    gradient norm, and a digest of the final params;
  * ``serve``: each ``SERVE`` case on a (1, 2) mesh, the params in the
    "serve" shardings and a float32 cache by ``cache_spec``: a prefill of
    ``PROMPT`` tokens then ``DECODE`` teacher-forced decode steps, each
    step's last logits.

The JAX package is not edited.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np

from _torch_tp_ref import (BATCH, CACHE, DECODE, DIGEST, N_DEV, PARAM_SEED,
                           PROMPT, SEQ, SERVE_BATCH, STEPS, _b64, _mesh,
                           config, digest, serve_tokens, tp_batches, unb64)

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_ssm_tp_ref.json"
# (key, arch, mesh, PE type): every layer split at 2 (RWKV6's 4 heads 2 a
# rank; Zamba2's 2 Mamba2 heads one a rank, its shared block's 4 heads 2),
# with FSDP beside it on (2, 2), and at 4, where Zamba2's 2 Mamba2 heads
# do not divide the group and its blocks stay whole
TRAIN = (
    ("rwkv_1x2", "rwkv6-1.6b", (1, 2), "fp32"),
    ("rwkv_2x2", "rwkv6-1.6b", (2, 2), "fp32"),
    ("rwkv_1x4", "rwkv6-1.6b", (1, 4), "fp32"),
    ("rwkv_1x2_lightpe1", "rwkv6-1.6b", (1, 2), "lightpe1"),
    ("zamba_1x2", "zamba2-7b", (1, 2), "fp32"),
    ("zamba_2x2", "zamba2-7b", (2, 2), "fp32"),
    ("zamba_1x4", "zamba2-7b", (1, 4), "fp32"),
    ("zamba_1x2_lightpe1", "zamba2-7b", (1, 2), "lightpe1"),
)
SERVE = (("rwkv_serve", "rwkv6-1.6b"), ("zamba_serve", "zamba2-7b"))

__all__ = ["BATCH", "CACHE", "DECODE", "DIGEST", "PARAM_SEED", "PROMPT",
           "REF_PATH", "SEQ", "SERVE", "SERVE_BATCH", "STEPS", "TRAIN",
           "config", "numpy_params", "serve_tokens", "tp_batches", "unb64"]


def numpy_params(cfg):
    """The family's seed-``PARAM_SEED`` numpy params (the port's
    ``numpy_params``, which both packages load)."""
    from repro_torch.models import family_module
    return family_module(cfg).numpy_params(cfg, PARAM_SEED)


def run_train(arch, shape, pe_type) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import reduced
    from repro.models import family_module
    from repro.models.layers import activation_sharding
    from repro.optim import adamw, warmup_cosine
    from repro.train.trainer import (TrainState, make_train_step,
                                     state_shardings_for)
    from repro_torch.train_check import LM_SCHEDULE

    cfg = config(arch, pe_type)
    jcfg = reduced(arch).replace(dtype="float32", pe_type=pe_type)
    jm = family_module(jcfg)
    mesh = _mesh(shape)
    opt = adamw(warmup_cosine(*LM_SCHEDULE))
    jp = jax.tree.map(jnp.asarray, numpy_params(cfg))
    state = TrainState(params=jp, opt_state=opt.init(jp),
                       step=jnp.zeros((), jnp.int32))
    batch_sh = NamedSharding(mesh, P("data", None))
    losses, gnorms = [], []
    with jax.set_mesh(mesh), activation_sharding(("data",), shape[0],
                                                 mesh=mesh):
        state = jax.device_put(state, state_shardings_for(jcfg, jm, mesh,
                                                          opt))
        step = jax.jit(make_train_step(jcfg, jm, opt, dp=("data",)))
        for b in tp_batches(cfg):
            b = {k: jax.device_put(jnp.asarray(v), batch_sh)
                 for k, v in b.items()}
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    return {"arch": arch, "mesh": list(shape), "pe_type": pe_type,
            "losses": losses, "grad_norms": gnorms,
            "final": digest(jax.tree.map(np.asarray, state.params))}


def run_serve(arch) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced
    from repro.launch.sharding import (make_cache_shardings,
                                       make_param_shardings)
    from repro.models import family_module
    from repro.models.layers import activation_sharding

    cfg = config(arch)
    jcfg = reduced(arch).replace(dtype="float32")
    jm = family_module(jcfg)
    params = jax.tree.map(jnp.asarray, numpy_params(cfg))
    toks = jnp.asarray(serve_tokens(cfg))
    mesh = _mesh((1, 2))
    logits_all = []
    with jax.set_mesh(mesh), activation_sharding(("data",), 1, mesh=mesh):
        cache = jm.init_cache(jcfg, SERVE_BATCH, CACHE, jnp.float32)
        params = jax.device_put(params, make_param_shardings(
            jcfg, params, mesh, "serve"))
        cache = jax.device_put(cache, make_cache_shardings(jcfg, cache,
                                                           mesh))
        prefill = jax.jit(lambda p, t, c: jm.prefill(p, t, jcfg, c))
        decode = jax.jit(lambda p, t, c: jm.decode_step(p, t, jcfg, c))
        logits, cache = prefill(params, toks[:, :PROMPT], cache)
        logits_all.append(np.asarray(logits[:, -1], np.float32))
        for i in range(DECODE):
            at = PROMPT + i
            logits, cache = decode(params, toks[:, at:at + 1], cache)
            logits_all.append(np.asarray(logits[:, -1], np.float32))
    steps = np.stack(logits_all)
    return {"arch": arch, "mesh": [1, 2], "shape": list(steps.shape),
            "logits": _b64(steps)}


def build_reference() -> dict:
    import jax
    assert jax.device_count() == N_DEV, jax.device_count()
    return {"jax_version": jax.__version__, "n_devices": N_DEV,
            "batch": BATCH, "seq": SEQ, "steps": STEPS,
            "train": {key: run_train(arch, shape, pe)
                      for key, arch, shape, pe in TRAIN},
            "serve": {key: run_serve(arch) for key, arch in SERVE}}


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
