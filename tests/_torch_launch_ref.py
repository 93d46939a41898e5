"""Writes ``tests/data/torch_launch_ref.json``: the JAX package's runs on
4 devices that the launch layer's tests hold the port's gloo ranks to.

  PYTHONPATH=src:tests python tests/_torch_launch_ref.py

It sets ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before
JAX is imported (4 virtual CPU devices).  On JAX 0.9.0 ``jax.make_mesh``
makes Explicit axes and the reference's launcher sets no mesh context,
so its multi-device CLI raises (ROADMAP C); this script builds Auto
axes and runs under ``jax.set_mesh``, the reference's
``activation_sharding`` and ``jax.jit``.  Three parts (~25 s):

  * ``sharding``: every reduced config's param leaves (train and serve
    modes), a train batch and its cache on a (2, 2) mesh, each leaf's
    slice at each device (``devices_indices_map``), by mesh coordinate;
  * ``grad_compress``: the reference's ``compressed_psum_mean`` under
    ``shard_map`` over a ("data",) mesh of 4, each shard its own
    gradient and error buffer (drawn from ``GC_SEED``): each shard's
    codes, mean and new error;
  * ``moe_ep``: reduced DeepSeek-MoE-16B (float32, ``moe_ep_shard_map``)
    on a (1, 4) ("data", "model") mesh, 2 x 16 tokens, the float32 and
    the int8 payload: the logits, each MoE call's routing (ids, margins;
    the port pins router near ties to it) and, for int8, each shard's
    payload codes in call order (the port pins codes at a rounding tie).

  * ``moe_capacity``: reduced DeepSeek-MoE-16B (float32, the baseline
    ``moe_apply``, capacity factor ``CAP_FACTOR``: assignments past
    capacity are dropped) trained ``CAP_STEPS`` AdamW steps on a (4, 1)
    ("data", "model") mesh, the batch over the 4 dp devices: each step's
    loss and gradient norm, the final routers, and the drops of each MoE
    layer in a forward of the global batch (capacity over the global
    tokens, places token-major over the batch);
  * ``moe_capacity_qat``: the same run under ``CAP_QAT``'s numerics, whose
    experts' activation scales span the global batch's buffers.

``PYTHONPATH=src:tests python tests/_torch_launch_ref.py --only
moe_capacity`` rewrites those two parts alone.

The JAX package is not edited: ``moe_apply``, ``moe_apply_ep`` and
``jax.lax.all_to_all`` are wrapped at run time to log, and put back.
"""

import base64
import json
import os
import sys
from pathlib import Path

import numpy as np

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_launch_ref.json"
N_DEV = 4
GC_SEED = 0
GC_SHAPES = ((64,), (8, 16), (3, 5, 7))
MOE_CONFIG = "deepseek-moe-16b"
MOE_PARAM_SEED = 0
MOE_TOKEN_SEED = 1
MOE_BATCH, MOE_SEQ = 2, 16
CAP_FACTOR = 1.0
CAP_BATCH, CAP_SEQ, CAP_STEPS, CAP_LR = 8, 16, 3, 1e-3
CAP_TOKEN_SEED = 2
CAP_QAT = "int8"      # the quantizing run: 8-bit activations a scale an expert


def gc_inputs():
    """Each shard's gradient and error buffer of every leaf: lists of
    (N_DEV, *shape) float32 arrays."""
    rng = np.random.default_rng(GC_SEED)
    gs = [rng.standard_normal((N_DEV, *s), dtype=np.float32)
          * np.float32(10.0 ** -(i + 1)) for i, s in enumerate(GC_SHAPES)]
    errs = [rng.standard_normal((N_DEV, *s), dtype=np.float32)
            * np.float32(10.0 ** -(i + 3)) for i, s in enumerate(GC_SHAPES)]
    return gs, errs


def moe_inputs():
    """(port config, numpy params, tokens) of the EP run."""
    from repro_torch.configs import reduced
    from repro_torch.models import transformer as T
    cfg = reduced(MOE_CONFIG).replace(dtype="float32", moe_ep_shard_map=True)
    params = T.numpy_params(cfg, MOE_PARAM_SEED)
    tokens = np.random.default_rng(MOE_TOKEN_SEED).integers(
        0, cfg.vocab, (MOE_BATCH, MOE_SEQ)).astype(np.int32)
    return cfg, params, tokens


def capacity_inputs(pe_type: str = "fp32"):
    """(port config, numpy params, tokens, labels) of the capacity run
    under ``pe_type``'s numerics."""
    from repro_torch.configs import reduced
    from repro_torch.models import transformer as T
    cfg = reduced(MOE_CONFIG).replace(dtype="float32",
                                      capacity_factor=CAP_FACTOR,
                                      pe_type=pe_type)
    params = T.numpy_params(cfg, MOE_PARAM_SEED)
    rng = np.random.default_rng(CAP_TOKEN_SEED)
    tokens = rng.integers(0, cfg.vocab, (CAP_BATCH, CAP_SEQ)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (CAP_BATCH, CAP_SEQ)).astype(np.int32)
    return cfg, params, tokens, labels


def run_moe_capacity(pe_type: str = "fp32", n_dev: int = N_DEV):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs import reduced
    from repro.models import moe as JM
    from repro.models import transformer as JT
    from repro.models.layers import activation_sharding
    from repro.optim import adamw, constant
    from repro.train.trainer import (TrainState, make_train_step,
                                     state_shardings_for)
    from repro_torch.models.moe import capacity, kept

    cfg, params, tokens, labels = capacity_inputs(pe_type)
    jcfg = reduced(MOE_CONFIG).replace(dtype="float32",
                                       capacity_factor=CAP_FACTOR,
                                       pe_type=pe_type)
    mesh = jax.make_mesh((n_dev, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n_dev])
    opt = adamw(constant(CAP_LR))
    jp = jax.tree.map(jnp.asarray, params)
    state = TrainState(params=jp, opt_state=opt.init(jp),
                       step=jnp.zeros((), jnp.int32))
    batch_sh = NamedSharding(mesh, P("data", None))
    batch = {"tokens": jax.device_put(jnp.asarray(tokens), batch_sh),
             "labels": jax.device_put(jnp.asarray(labels), batch_sh)}
    routes, inner = [], JM.moe_apply

    def logged(p, x, cfg_, qcfg):
        b, s, d = x.shape
        k = cfg_.moe_topk
        logits = (x.reshape(b * s, d).astype(jnp.float32)
                  @ p["router"].astype(jnp.float32))
        vals, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k + 1)
        margin = vals[:, k - 1] - vals[:, k]
        jax.debug.callback(lambda i, m: routes.append(
            (np.asarray(i).reshape(b, s, k), np.asarray(m))), ids[:, :k],
            margin)
        return inner(p, x, cfg_, qcfg)

    with jax.set_mesh(mesh), activation_sharding(("data",), n_dev,
                                                 mesh=mesh):
        state = jax.device_put(state, state_shardings_for(jcfg, JT, mesh,
                                                          opt))
        step = jax.jit(make_train_step(jcfg, JT, opt, dp=("data",)))
        losses, gnorms = [], []
        for _ in range(CAP_STEPS):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        routers = np.asarray(state.params["layers"]["moe"]["router"],
                             np.float32)
        JM.moe_apply = logged
        jax.clear_caches()
        try:
            jax.block_until_ready(jax.jit(
                lambda p, t: JT.forward(p, t, jcfg))(jp, batch["tokens"]))
            jax.effects_barrier()
        finally:
            JM.moe_apply = inner
            jax.clear_caches()
    c = capacity(CAP_BATCH * CAP_SEQ, cfg)
    drops = [int((~kept(np.sort(ids, -1), c)).sum()) for ids, _ in routes]
    return {"config": MOE_CONFIG, "param_seed": MOE_PARAM_SEED,
            "pe_type": pe_type,
            "capacity_factor": CAP_FACTOR, "mesh": [n_dev, 1],
            "tokens": tokens.tolist(), "labels": labels.tolist(),
            "lr": CAP_LR, "steps": CAP_STEPS, "losses": losses,
            "grad_norms": gnorms, "capacity": c, "drops": drops,
            "min_router_margin": float(min(m.min() for _, m in routes)),
            "routers": _b64(routers), "routers_shape": list(routers.shape)}


def _b64(a) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def unb64(s: str, dtype, shape):
    return np.frombuffer(base64.b64decode(s), dtype).reshape(shape)


def run_grad_compress():
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.optim.grad_compress import _quantize, compressed_psum_mean

    mesh = jax.make_mesh((N_DEV,), ("data",), axis_types=(AxisType.Auto,))
    gs, errs = gc_inputs()
    out = {"means": [], "errs": [], "codes": []}

    def one(g, e):
        mean, new_err = compressed_psum_mean(g[0], e[0], ("data",), N_DEV)
        # the codes the reference's function sends: its own steps
        g32 = g[0].astype(jnp.float32) + e[0]
        absmax = jax.lax.pmax(jnp.max(jnp.abs(g32)), ("data",))
        q = _quantize(g32, jnp.maximum(absmax, 1e-12) / 127.0)
        return mean[None], new_err[None], q[None]

    f = jax.jit(jax.shard_map(one, mesh=mesh,
                              in_specs=(P("data"), P("data")),
                              out_specs=(P("data"),) * 3))
    with jax.set_mesh(mesh):
        for g, e in zip(gs, errs):
            mean, new_err, q = (np.asarray(a) for a in f(g, e))
            out["means"].append(_b64(mean.astype(np.float32)))
            out["errs"].append(_b64(new_err.astype(np.float32)))
            out["codes"].append(_b64(q.astype(np.int8)))
    return out


SHARD_MESH = (2, 2)
SHARD_BATCH, SHARD_SEQ = 4, 16


def _slices(index, shape) -> list:
    return [[0 if sl.start is None else sl.start,
             n if sl.stop is None else sl.stop]
            for sl, n in zip(index, shape)]


def run_sharding():
    """Every reduced config's params (train and serve modes), a train
    batch and its cache on a (2, 2) mesh: each leaf's slices at each mesh
    coordinate (row-major), from ``devices_indices_map``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import list_archs, reduced
    from repro.launch.sharding import (make_batch_shardings,
                                       make_cache_shardings,
                                       make_param_shardings)
    from repro.launch.shapes import ShapeSpec, batch_specs
    from repro.models import family_module

    mesh = jax.make_mesh(SHARD_MESH, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    devices = [d for row in mesh.devices for d in row]

    def table(shapes, shardings):
        out = {}
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        sh = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(
            x, "devices_indices_map"))
        for (path, leaf), s in zip(flat, sh):
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            m = s.devices_indices_map(leaf.shape)
            out[key] = [_slices(m[d], leaf.shape) for d in devices]
        return out

    out = {}
    for arch in list_archs():
        cfg = reduced(arch)
        mod = family_module(cfg)
        shapes = jax.eval_shape(lambda k, c=cfg, m=mod: m.init_params(c, k),
                                jax.random.PRNGKey(0))
        entry = {mode: table(shapes, make_param_shardings(cfg, shapes, mesh,
                                                          mode))
                 for mode in ("train", "serve")}
        spec = ShapeSpec("t", SHARD_SEQ, SHARD_BATCH, "train")
        batch = batch_specs(cfg, spec)
        entry["batch"] = table(batch, make_batch_shardings(batch, cfg, mesh))
        if cfg.has_decode and cfg.family != "encdec":
            cache = jax.eval_shape(
                (lambda c=cfg, m=mod: m.init_cache(c, SHARD_BATCH))
                if cfg.family == "ssm" else
                (lambda c=cfg, m=mod: m.init_cache(c, SHARD_BATCH, SHARD_SEQ,
                                                   jnp.bfloat16)))
            entry["cache"] = table(cache, make_cache_shardings(cfg, cache,
                                                               mesh))
        out[arch] = entry
    return out


def run_moe_ep(int8: bool, cfg, params, tokens):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import reduced
    from repro.models import moe as JM
    from repro.models import transformer as JT
    from repro.models.layers import activation_sharding

    jcfg = reduced(MOE_CONFIG).replace(dtype="float32", moe_ep_shard_map=True,
                                       moe_ep_int8_payload=int8)
    assert jcfg.moe_experts == cfg.moe_experts
    mesh = jax.make_mesh((1, N_DEV), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    routes, payloads = [], {i: [] for i in range(N_DEV)}
    inner_ep, inner_a2a = JM.moe_apply_ep, jax.lax.all_to_all

    def logged_ep(p, x, cfg_, qcfg):
        b, s, d = x.shape
        k, e = cfg_.moe_topk, cfg_.moe_experts
        logits = (x.reshape(b * s, d).astype(jnp.float32)
                  @ p["router"].astype(jnp.float32))
        vals, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                  min(k + 1, e))
        margin = vals[:, k - 1] - vals[:, k]
        ids = jnp.sort(ids[:, :k], axis=-1)

        def host(i, m):
            routes.append((np.asarray(i).reshape(b, s, k),
                           np.asarray(m, np.float32).reshape(b, s)))

        jax.debug.callback(host, ids, margin)
        return inner_ep(p, x, cfg_, qcfg)

    def logged_a2a(x, axis_name, *args, **kwargs):
        if x.dtype == jnp.int8:
            def host(q, shard):
                payloads[int(shard)].append(np.asarray(q))
            jax.debug.callback(host, x, jax.lax.axis_index(axis_name))
        return inner_a2a(x, axis_name, *args, **kwargs)

    JM.moe_apply_ep, jax.lax.all_to_all = logged_ep, logged_a2a
    jax.clear_caches()
    try:
        jp = jax.tree.map(jnp.asarray, params)
        with jax.set_mesh(mesh), \
                activation_sharding(("data",), 1, mesh=mesh):
            logits = jax.jit(lambda p, t: JT.forward(p, t, jcfg))(
                jp, jnp.asarray(tokens))
            logits = np.asarray(jax.block_until_ready(logits), np.float32)
        jax.effects_barrier()
    finally:
        JM.moe_apply_ep, jax.lax.all_to_all = inner_ep, inner_a2a
        jax.clear_caches()
    no_ep = np.asarray(JT.forward(jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(tokens),
                                  jcfg.replace(moe_ep_shard_map=False)),
                       np.float32)
    run = {"logits": _b64(logits), "shape": list(logits.shape),
           "routes": [{"ids": i.tolist(), "margin": m.tolist()}
                      for i, m in routes],
           "max_abs_diff_from_moe_apply": float(np.abs(logits - no_ep).max())}
    if int8:
        shapes = {tuple(a.shape) for v in payloads.values() for a in v}
        assert len(shapes) == 1, shapes
        run["payload_shape"] = list(shapes.pop())
        run["payloads"] = [[_b64(a.astype(np.int8)) for a in payloads[i]]
                           for i in range(N_DEV)]
    return run


def build_reference() -> dict:
    import jax
    assert jax.device_count() == N_DEV, jax.device_count()
    cfg, params, tokens = moe_inputs()
    return {
        "moe_capacity": run_moe_capacity(),
        "moe_capacity_qat": run_moe_capacity(CAP_QAT),
        "jax_version": jax.__version__, "n_devices": N_DEV,
        "sharding": dict(mesh=list(SHARD_MESH), batch=SHARD_BATCH,
                         seq=SHARD_SEQ, configs=run_sharding()),
        "grad_compress": dict(seed=GC_SEED, shapes=[list(s) for s in GC_SHAPES],
                              **run_grad_compress()),
        "moe_ep": {"config": MOE_CONFIG, "param_seed": MOE_PARAM_SEED,
                   "tokens": tokens.tolist(), "mesh": [1, N_DEV],
                   "runs": {name: run_moe_ep(int8, cfg, params, tokens)
                            for name, int8 in (("float32", False),
                                               ("int8", True))}}}


if __name__ == "__main__":
    # 4 virtual CPU devices: set before JAX is first imported (every JAX
    # import of this file is inside a function)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count"
                                 f"={N_DEV}")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if sys.argv[1:] == ["--only", "moe_capacity"]:
        ref = json.loads(REF_PATH.read_text())
        ref["moe_capacity"] = run_moe_capacity()
        ref["moe_capacity_qat"] = run_moe_capacity(CAP_QAT)
    else:
        ref = build_reference()
    REF_PATH.write_text(json.dumps(ref))
    for key in ("moe_capacity", "moe_capacity_qat"):
        print(key, "drops", ref[key]["drops"], "losses", ref[key]["losses"],
              "min router margin", ref[key]["min_router_margin"])
    for name, run in ref["moe_ep"]["runs"].items():
        print(name, "routes", len(run["routes"]), "payload calls",
              [len(p) for p in run.get("payloads", [])],
              "EP vs moe_apply", run["max_abs_diff_from_moe_apply"])
    print(f"wrote {REF_PATH} ({REF_PATH.stat().st_size} bytes)")
