"""One rank of the launch layer's multi-process tests (``_torch_dist``):

  python tests/_torch_dist_worker.py <spec.json> <rank>

It joins a gloo process group through a ``FileStore`` in the spec's
directory (with a timeout), runs the spec's tasks in order and writes
each task's result as ``<task>.<rank>.json`` (numbers) and
``<task>.<rank>.npz`` (arrays).  It imports torch and the port, never
JAX: the JAX side of each comparison is in the test process or in
``tests/data/torch_launch_ref.json``.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import list_archs, reduced
from repro_torch.launch import mesh as M
from repro_torch.launch.sharding import (make_batch_shardings,
                                         make_cache_shardings,
                                         make_param_shardings)
from repro_torch.launch.shapes import ShapeSpec, batch_specs
from repro_torch.models import family_module
from repro_torch.models import layers as L
from repro_torch.optim import tree_leaves

TIMEOUT_S = 120


def _slices(tree, shardings, out, prefix=""):
    """{path: [[start, stop] a dim]} of this rank's slice of every leaf."""
    if isinstance(tree, dict):
        for k in tree:
            _slices(tree[k], shardings[k], out, f"{prefix}/{k}" if prefix
                    else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _slices(v, shardings[i], out, f"{prefix}/{i}" if prefix
                    else str(i))
    elif shardings is not None:
        out[prefix] = [[s.start, s.stop]
                       for s in shardings.local_slices(tree.shape)]
    return out


def task_sharding(rank, task):
    """Each reduced config's param (train, serve), batch and cache slices
    on the task's mesh, and a shard / gather round trip."""
    mesh = M.make_mesh(task["mesh"], ("data", "model"), "cpu")
    b, s = task["batch"], task["seq"]
    meta = {"coord": M.coordinate(mesh), "configs": {}}
    for arch in list_archs():
        cfg = reduced(arch)
        mod = family_module(cfg)
        shapes = mod.init_params(cfg, torch.Generator(), device="meta")
        entry = {mode: _slices(shapes, make_param_shardings(
            cfg, shapes, mesh, mode), {}) for mode in ("train", "serve")}
        batch = batch_specs(cfg, ShapeSpec("t", s, b, "train"))
        entry["batch"] = _slices(batch, make_batch_shardings(batch, cfg,
                                                             mesh), {})
        if cfg.has_decode and cfg.family != "encdec":
            cache = (mod.init_cache(cfg, b, device="meta")
                     if cfg.family == "ssm" else
                     mod.init_cache(cfg, b, s, torch.bfloat16,
                                    device="meta"))
            entry["cache"] = _slices(cache, make_cache_shardings(
                cfg, cache, mesh), {})
        meta["configs"][arch] = entry
    # shard then gather gives back every leaf of a real model
    cfg = reduced("qwen3-32b")
    params = family_module(cfg).init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    sh = make_param_shardings(cfg, params, mesh, "train")
    from repro_torch.optim import tree_map
    back = tree_map(lambda x, s_: s_.gather(s_.shard(x)), params, sh)
    meta["round_trip_differing"] = sum(
        int((a != b_).sum()) for a, b_ in zip(tree_leaves(params),
                                              tree_leaves(back)))
    return meta, {}


def task_grad_compress(rank, task):
    """This rank's shard of every leaf of ``_torch_launch_ref.gc_inputs``
    through ``compressed_psum_mean`` over ("data",), the codes it sends,
    and ``make_compressed_allreduce`` on the leaves as one tree."""
    from _torch_launch_ref import gc_inputs
    from repro_torch.optim.grad_compress import (compressed_psum_mean,
                                                 make_compressed_allreduce,
                                                 quantize, shared_scale)
    mesh = M.make_mesh((dist.get_world_size(),), ("data",), "cpu")
    gs, errs = gc_inputs()
    i = M.dp_index(mesh)
    arrays = {}
    grads, buffers = {}, {}
    for j, (g, e) in enumerate(zip(gs, errs)):
        g, e = torch.from_numpy(g[i].copy()), torch.from_numpy(e[i].copy())
        mean, new_err = compressed_psum_mean(g, e, mesh, ("data",),
                                             dist.get_world_size())
        absmax = M.all_reduce(torch.max(torch.abs(g + e)), mesh, ("data",),
                              dist.ReduceOp.MAX)
        arrays[f"mean{j}"] = mean.numpy()
        arrays[f"err{j}"] = new_err.numpy()
        arrays[f"codes{j}"] = quantize(g + e, shared_scale(absmax)).numpy()
        grads[f"leaf{j}"], buffers[f"leaf{j}"] = g, e
    mean, new_err = make_compressed_allreduce(mesh, ("data",))(grads, buffers)
    tree_same = all(
        bool(torch.equal(mean[f"leaf{j}"], torch.from_numpy(arrays[f"mean{j}"])))
        and bool(torch.equal(new_err[f"leaf{j}"],
                             torch.from_numpy(arrays[f"err{j}"])))
        for j in range(len(gs)))
    return {"dp_index": i, "tree_same": tree_same}, arrays


def task_moe_ep(rank, task):
    """Reduced DeepSeek-MoE-16B's forward with ``moe_ep_shard_map`` on a
    (1, n) mesh under the float32 and the int8 payload, the reference's
    routing pinned at router near ties and its payload codes at rounding
    ties; and both fallbacks to ``moe_apply``."""
    from _torch_launch_ref import REF_PATH, moe_inputs, unb64
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import PayloadPins, RoutePins
    ref = json.loads(REF_PATH.read_text())["moe_ep"]
    n = dist.get_world_size()
    mesh = M.make_mesh((1, n), ("data", "model"), "cpu")
    cfg, arrays, tokens = moe_inputs()
    params = convert.params_from_numpy(arrays, "cpu")
    tokens = torch.from_numpy(tokens).to(torch.int64)
    meta, out = {"coord": M.coordinate(mesh)}, {}
    for name, int8 in (("float32", False), ("int8", True)):
        run = ref["runs"][name]
        rcfg = cfg.replace(moe_ep_int8_payload=int8)
        routes = RoutePins(task["router_tol"])
        routes.load([(np.array(r["ids"]), np.array(r["margin"], np.float32))
                     for r in run["routes"]])
        shape = run.get("payload_shape")
        codes = [unb64(c, np.int8, shape) for c in run.get(
            "payloads", [[]] * n)[M.coordinate(mesh)["model"]]]
        payload = PayloadPins(codes, task["payload_tie"])
        with torch.no_grad(), L.activation_sharding(("data",), 1, mesh=mesh), \
                routes, payload:
            logits = T.forward(params, tokens, rcfg)
        out[name] = logits.numpy()
        meta[name] = dict(route_pins=routes.pinned, payload_pins=payload.pinned,
                          payload_away=payload.away,
                          payloads_left=len(payload.codes),
                          routes_left=len(routes.queue))
    # fallbacks: no mesh, and a sequence the model axis does not divide
    short = tokens[:, : tokens.shape[1] - 1]
    with torch.no_grad():
        plain = T.forward(params, short, cfg.replace(moe_ep_shard_map=False))
        with L.activation_sharding(("data",), 1, mesh=mesh):
            uneven = T.forward(params, short, cfg)
        no_mesh = T.forward(params, tokens, cfg)
        base = T.forward(params, tokens, cfg.replace(moe_ep_shard_map=False))
    meta["uneven_differing"] = int((uneven != plain).sum())
    meta["no_mesh_differing"] = int((no_mesh != base).sum())
    return meta, out


def task_ep_train(rank, task):
    """Training steps of reduced DeepSeek-MoE-16B with ``moe_ep_shard_map``
    on the task's mesh (its capacity factor E / k: no assignment is
    dropped, so the layer is ``moe_apply``'s function): each step's
    metrics and the params after, gathered."""
    from repro_torch.data import lm_pipeline
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import (fit, init_state, jit_train_step,
                                   make_train_step, shard_state,
                                   state_shardings_for)
    cfg = ep_train_config()
    mod = family_module(cfg)
    mesh = M.make_mesh(task["mesh"], ("data", "model"), "cpu")
    opt = adamw(warmup_cosine(task["lr"], 20, task["steps"]))
    sh = state_shardings_for(cfg, mod, mesh, opt)
    state = shard_state(init_state(cfg, mod, opt,
                                   torch.Generator().manual_seed(0),
                                   device="cpu"), sh)
    step = jit_train_step(make_train_step(cfg, mod, opt), sh, mesh)
    pipe = lm_pipeline(cfg, task["batch"], task["seq"], device="cpu",
                       mesh=mesh)
    metrics = []
    for _ in range(task["steps"]):
        state, m = step(state, next(pipe))
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    return {"metrics": metrics}, _full_params(state, sh)


def task_moe_capacity(rank, task):
    """``_torch_launch_ref.run_moe_capacity``'s run on the task's (n, 1)
    mesh: the same numpy params and global batch, this rank's dp slice,
    the baseline MoE layer with drops past capacity.  Each step's
    metrics, the drops of this rank's assignments in the first step's
    forward, and the params after, gathered."""
    from _torch_launch_ref import CAP_LR, CAP_STEPS, capacity_inputs
    from repro_torch.models import moe
    from repro_torch.optim import adamw, constant
    from repro_torch.train import (TrainState, jit_train_step,
                                   make_train_step, shard_state,
                                   state_shardings_for)
    cfg, params, tokens, labels = capacity_inputs(task.get("pe_type",
                                                           "fp32"))
    mod = family_module(cfg)
    mesh = M.make_mesh(task["mesh"], ("data", "model"), "cpu")
    opt = adamw(constant(CAP_LR))
    p = convert.params_from_numpy(params, device="cpu")
    state = TrainState(params=p, opt_state=opt.init(p),
                       step=torch.zeros((), dtype=torch.int32))
    sh = state_shardings_for(cfg, mod, mesh, opt)
    state = shard_state(state, sh)
    rows = tokens.shape[0] // task["mesh"][0]
    at = M.dp_index(mesh) * rows
    batch = {"tokens": torch.from_numpy(tokens[at:at + rows]),
             "labels": torch.from_numpy(labels[at:at + rows])}
    step = jit_train_step(make_train_step(cfg, mod, opt), sh, mesh)
    drops, inner = [], moe._dispatch

    def counted(*a, **k):
        out = inner(*a, **k)
        drops.append(int((~out[2]).sum()))
        return out

    metrics = []
    moe._dispatch = counted
    try:
        for i in range(CAP_STEPS):
            state, m = step(state, batch)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
            if i == 0:
                first = list(drops)
    finally:
        moe._dispatch = inner
    n_moe = cfg.n_layers - cfg.first_dense
    meta = {"metrics": metrics, "drops": first[:n_moe]}
    full = _full_params(state, sh)
    if task.get("plain"):
        # the trainer without a mesh on the same batch: one dp rank is
        # the same function, bit for bit
        from repro_torch.train import make_train_step as plain_step
        p = convert.params_from_numpy(params, device="cpu")
        st = TrainState(params=p, opt_state=opt.init(p),
                        step=torch.zeros((), dtype=torch.int32))
        plain = plain_step(cfg, mod, opt)
        rows = []
        for _ in range(CAP_STEPS):
            st, m = plain(st, batch)
            rows.append([float(m["loss"]), float(m["grad_norm"])])
        meta["plain_metrics"] = rows
        meta["plain_differing"] = sum(
            int((v.detach().numpy() != full["/".join(map(str, k))]).sum())
            for k, v in _flat(st.params))
    return meta, full


def task_all_reduce(rank, task):
    """``op_analysis`` of one ``all_reduce`` of ``n`` float32 values."""
    from repro_torch.launch import op_analysis
    x = torch.ones(task["n"], dtype=torch.float32)
    _, rep = op_analysis.analyze(dist.all_reduce, x)
    return {"collectives": rep["collectives"], "sum": float(x[0])}, {}


def task_dryrun_cell(rank, task):
    """The dry run's step of ``_torch_dryrun_ref.MESH_CELLS``' first cell
    on this gloo group (CPU tensors: the kernels' plain versions), counted
    by ``op_analysis``."""
    from _torch_dryrun_ref import MESH_CELLS, mesh_config
    from repro_torch.launch import dryrun
    arch, (name, seq, batch, kind) = MESH_CELLS[task["cell"]]
    mesh = M.make_mesh(task["mesh"], ("data", "model"), "cpu")
    step, args, _ = dryrun.build_cell(
        arch, name, mesh, cfg=mesh_config(arch, reduced),
        shape=ShapeSpec(name, seq, batch, kind), device="cpu")
    counts = dryrun.analyze_cell(step, args)
    return {k: counts[k] for k in ("flops", "collectives", "memory")}, {}


def ep_train_config():
    """Reduced DeepSeek-MoE-16B in float32 under ``moe_ep_shard_map``,
    its capacity factor E / k (capacity = the tokens: no drops)."""
    cfg = reduced("deepseek-moe-16b")
    return cfg.replace(dtype="float32", moe_ep_shard_map=True,
                       capacity_factor=cfg.moe_experts / cfg.moe_topk)


def _full_params(state, shardings):
    from repro_torch.train import gather_state
    full = gather_state(state, shardings)
    return {"/".join(map(str, k)): v.detach().numpy() for k, v in
            _flat(full.params)}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


def task_train_cli(rank, task):
    """``python -m repro_torch.launch.train``'s ``main`` on this group
    (the mesh it picks), then the final params gathered."""
    from repro_torch.launch import train as cli
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import state_shardings_for
    state = cli.main(task["argv"])
    args = cli.parser().parse_args(task["argv"])
    cfg = reduced(args.arch).replace(pe_type=args.pe_type)
    n = dist.get_world_size()
    mp = cli.model_parallel(n, cfg)
    mesh = M.make_mesh((n // mp, mp), ("data", "model"), "cpu")
    opt = adamw(warmup_cosine(args.lr, 20, args.steps))
    sh = state_shardings_for(cfg, family_module(cfg), mesh, opt)
    return {"mesh": [n // mp, mp], "step": int(state.step)}, \
        _full_params(state, sh)


def task_train_mesh(rank, task):
    """The trainer's mesh functions on the task's mesh: the same run as
    the CLI's, each step's metrics, a checkpoint at the last step."""
    from repro_torch.data import lm_pipeline
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import (fit, init_state, jit_train_step,
                                   make_train_step, shard_state,
                                   state_shardings_for)
    cfg = reduced(task["arch"]).replace(pe_type=task["pe_type"])
    mod = family_module(cfg)
    mesh = M.make_mesh(task["mesh"], ("data", "model"), "cpu")
    opt = adamw(warmup_cosine(task["lr"], 20, task["steps"]))
    sh = state_shardings_for(cfg, mod, mesh, opt)
    state = shard_state(init_state(cfg, mod, opt,
                                   torch.Generator().manual_seed(0),
                                   device="cpu"), sh)
    step = jit_train_step(make_train_step(cfg, mod, opt), sh, mesh)
    pipe = lm_pipeline(cfg, task["batch"], task["seq"], device="cpu",
                       mesh=mesh)
    metrics = []

    def logged(st, batch):
        st, m = step(st, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
        return st, m

    local = {"/".join(map(str, k)): list(v.shape)
             for k, v in _flat(state.params)}
    state = fit(state, logged, pipe, task["steps"],
                ckpt_dir=task.get("ckpt_dir"), ckpt_every=task["steps"],
                log_fn=lambda _m: None, shardings=sh)
    return {"metrics": metrics, "local_shapes": local,
            "coord": M.coordinate(mesh)}, _full_params(state, sh)


def task_restore(rank, task):
    """``trainer.resume`` of a checkpoint onto the task's mesh: this
    rank's shards, held to the saved arrays' slices, and gathered."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import resume, state_shardings_for
    cfg = reduced(task["arch"]).replace(pe_type=task["pe_type"])
    mod = family_module(cfg)
    mesh = M.make_mesh(task["mesh"], ("data", "model"), "cpu")
    opt = adamw(warmup_cosine(task["lr"], 20, task["steps"]))
    state = resume(cfg, mod, opt, task["ckpt_dir"], device="cpu", mesh=mesh)
    sh = state_shardings_for(cfg, mod, mesh, opt)
    step = ckpt.latest_step(task["ckpt_dir"])
    root = os.path.join(task["ckpt_dir"], f"step_{step}")
    differing, sharded = 0, 0
    for group, tree, shards in (("params", state.params, sh.params),
                                ("opt", state.opt_state, sh.opt_state)):
        for key, leaf in _flat(tree):
            s_ = shards
            for k in key:
                s_ = s_[k]
            name = "__".join(map(str, key)) + ".npy"
            full = np.load(os.path.join(root, group, name))
            want = full[s_.local_slices(full.shape)]
            differing += int((leaf.numpy() != want).sum())
            sharded += int(tuple(leaf.shape) != full.shape)
    return {"step": int(state.step), "differing": differing,
            "sharded_leaves": sharded, "coord": M.coordinate(mesh)}, \
        _full_params(state, sh)


TASKS = {"sharding": task_sharding, "grad_compress": task_grad_compress,
         "moe_ep": task_moe_ep, "train_cli": task_train_cli,
         "train_mesh": task_train_mesh, "restore": task_restore,
         "ep_train": task_ep_train, "moe_capacity": task_moe_capacity,
         "all_reduce": task_all_reduce, "dryrun_cell": task_dryrun_cell}


def main():
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path) as f:
        spec = json.load(f)
    workdir, world = spec["workdir"], spec["world"]
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    M.init_process_group("cpu", rank, world, store=store,
                         timeout_s=TIMEOUT_S)
    try:
        for task in spec["tasks"]:
            meta, arrays = TASKS[task["name"]](rank, task)
            with open(os.path.join(workdir, f"{task['name']}.{rank}.json"),
                      "w") as f:
                json.dump(meta, f)
            np.savez(os.path.join(workdir, f"{task['name']}.{rank}.npz"),
                     **arrays)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
