"""The tasks of the launch layer's multi-process tests (``_torch_dist``),
each ``TASKS[kind](task, at)`` on one rank of ``repro_torch.launch.ranks``
(``at`` its ``Rank``): a task's ``kind`` (default its name) picks its
function, so one spec may run a kind several times.  It imports torch
and the port, never JAX: the JAX side of each comparison is in the test
process or in ``tests/data/torch_launch_ref.json``.
"""

import contextlib
import json
import os

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


def task_sharding(task, at):
    """Each reduced config's param (train, serve), batch and cache slices
    on the task's mesh, and a shard / gather round trip."""
    mesh = at.mesh(task["mesh"])
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
        cfg, torch.Generator().manual_seed(0), device=at.device)
    sh = make_param_shardings(cfg, params, mesh, "train")
    from repro_torch.optim import tree_map
    back = tree_map(lambda x, s_: s_.gather(s_.shard(x)), params, sh)
    meta["round_trip_differing"] = sum(
        int((a != b_).sum()) for a, b_ in zip(tree_leaves(params),
                                              tree_leaves(back)))
    return meta, {}


def task_grad_compress(task, at):
    """This rank's shard of every leaf of ``_torch_launch_ref.gc_inputs``
    through ``compressed_psum_mean`` over ("data",), the codes it sends,
    and ``make_compressed_allreduce`` on the leaves as one tree."""
    from _torch_launch_ref import gc_inputs
    from repro_torch.optim.grad_compress import (compressed_psum_mean,
                                                 make_compressed_allreduce,
                                                 quantize, shared_scale)
    mesh = at.mesh((at.world,), ("data",))
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


def task_moe_ep(task, at):
    """Reduced DeepSeek-MoE-16B's forward with ``moe_ep_shard_map`` on a
    (1, n) mesh under the float32 and the int8 payload, the reference's
    routing pinned at router near ties and its payload codes at rounding
    ties; and both fallbacks to ``moe_apply``."""
    from _torch_launch_ref import REF_PATH, moe_inputs, unb64
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import PayloadPins, RoutePins
    ref = json.loads(REF_PATH.read_text())["moe_ep"]
    n = dist.get_world_size()
    mesh = at.mesh((1, n))
    cfg, arrays, tokens = moe_inputs()
    params = convert.params_from_numpy(arrays, at.device)
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


def task_ep_train(task, at):
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
    mesh = at.mesh(task["mesh"])
    opt = adamw(warmup_cosine(task["lr"], 20, task["steps"]))
    sh = state_shardings_for(cfg, mod, mesh, opt)
    state = shard_state(init_state(cfg, mod, opt,
                                   torch.Generator().manual_seed(0),
                                   device=at.device), sh)
    step = jit_train_step(make_train_step(cfg, mod, opt), sh, mesh)
    pipe = lm_pipeline(cfg, task["batch"], task["seq"], device=at.device,
                       mesh=mesh)
    metrics = []
    for _ in range(task["steps"]):
        state, m = step(state, next(pipe))
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    return {"metrics": metrics}, _full_params(state, sh)


def task_moe_capacity(task, at):
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
    mesh = at.mesh(task["mesh"])
    opt = adamw(constant(CAP_LR))
    p = convert.params_from_numpy(params, device=at.device)
    state = TrainState(params=p, opt_state=opt.init(p),
                       step=torch.zeros((), dtype=torch.int32))
    sh = state_shardings_for(cfg, mod, mesh, opt)
    state = shard_state(state, sh)
    rows = tokens.shape[0] // task["mesh"][0]
    lo = M.dp_index(mesh) * rows
    batch = {"tokens": torch.from_numpy(tokens[lo:lo + rows]),
             "labels": torch.from_numpy(labels[lo:lo + rows])}
    step = jit_train_step(make_train_step(cfg, mod, opt), sh, mesh)
    drops, inner = [], moe._dispatch

    def counted(*a, **k):
        out = inner(*a, **k)
        drops.append(int((~out[2]).sum()))
        return out

    metrics = []
    pins = None
    if task.get("pins"):
        # the reference's codes at rounding ties (``CodePins``), located in
        # the global batch's tensors: one rank only
        assert task["mesh"] == [1, 1], "pins locate codes on one rank"
        from _torch_act_pins import CodePins, records_from_json
        from _torch_launch_ref import REF_PATH
        ref = json.loads(REF_PATH.read_text())["moe_capacity_qat"]["pins"]
        pins = CodePins(records_from_json(ref["records"]))
    moe._dispatch = counted
    try:
        with pins.installed() if pins else contextlib.nullcontext():
            for i in range(CAP_STEPS):
                state, m = step(state, batch)
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
                if i == 0:
                    first = list(drops)
    finally:
        moe._dispatch = inner
    n_moe = cfg.n_layers - cfg.first_dense
    meta = {"metrics": metrics, "drops": first[:n_moe]}
    if pins:
        meta["pins"] = dict(pinned=pins.pinned, calls=pins.calls,
                            unmatched=pins.unmatched)
    full = _full_params(state, sh)
    if task.get("plain"):
        # the trainer without a mesh on the same batch: one dp rank is
        # the same function, bit for bit
        from repro_torch.train import make_train_step as plain_step
        p = convert.params_from_numpy(params, device=at.device)
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


def task_all_reduce(task, at):
    """``op_analysis`` of one ``all_reduce`` of ``n`` float32 values."""
    from repro_torch.launch import op_analysis
    x = torch.ones(task["n"], dtype=torch.float32)
    _, rep = op_analysis.analyze(dist.all_reduce, x)
    return {"collectives": rep["collectives"], "sum": float(x[0])}, {}


def task_dryrun_cell(task, at):
    """The dry run's step of ``_torch_dryrun_ref.MESH_CELLS``' first cell
    on this gloo group (CPU tensors: the kernels' plain versions), counted
    by ``op_analysis``."""
    from _torch_dryrun_ref import MESH_CELLS, mesh_config
    from repro_torch.launch import dryrun
    arch, (name, seq, batch, kind) = MESH_CELLS[task["cell"]]
    mesh = at.mesh(task["mesh"])
    step, args, _ = dryrun.build_cell(
        arch, name, mesh, cfg=mesh_config(arch, reduced),
        shape=ShapeSpec(name, seq, batch, kind), device=at.device)
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


def task_train_cli(task, at):
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
    mesh = at.mesh((n // mp, mp))
    opt = adamw(warmup_cosine(args.lr, 20, args.steps))
    sh = state_shardings_for(cfg, family_module(cfg), mesh, opt)
    return {"mesh": [n // mp, mp], "step": int(state.step)}, \
        _full_params(state, sh)


def task_train_mesh(task, at):
    """The trainer's mesh functions on the task's mesh: the same run as
    the CLI's, each step's metrics, a checkpoint at the last step; under
    the task's ``variant`` (``tp_check.variant``), a control."""
    from repro_torch import tp_check
    from repro_torch.data import lm_pipeline
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import (fit, init_state, jit_train_step,
                                   make_train_step, shard_state,
                                   state_shardings_for)
    cfg = reduced(task["arch"]).replace(pe_type=task["pe_type"])
    if "dtype" in task:
        cfg = cfg.replace(dtype=task["dtype"])
    mod = family_module(cfg)
    mesh = at.mesh(task["mesh"])
    opt = adamw(warmup_cosine(task["lr"], 20, task["steps"]))
    sh = state_shardings_for(cfg, mod, mesh, opt)
    state = shard_state(init_state(cfg, mod, opt,
                                   torch.Generator().manual_seed(0),
                                   device=at.device), sh)
    step = jit_train_step(make_train_step(cfg, mod, opt), sh, mesh)
    pipe = lm_pipeline(cfg, task["batch"], task["seq"], device=at.device,
                       mesh=mesh)
    metrics = []

    def logged(st, batch):
        st, m = step(st, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
        return st, m

    local = {"/".join(map(str, k)): list(v.shape)
             for k, v in _flat(state.params)}
    with tp_check.variant(task.get("variant")):
        state = fit(state, logged, pipe, task["steps"],
                    ckpt_dir=task.get("ckpt_dir"), ckpt_every=task["steps"],
                    log_fn=lambda _m: None, shardings=sh)
    return {"metrics": metrics, "local_shapes": local,
            "coord": M.coordinate(mesh)}, _full_params(state, sh)


def task_restore(task, at):
    """``trainer.resume`` of a checkpoint onto the task's mesh: this
    rank's shards, held to the saved arrays' slices, and gathered."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import resume, state_shardings_for
    cfg = reduced(task["arch"]).replace(pe_type=task["pe_type"])
    mod = family_module(cfg)
    mesh = at.mesh(task["mesh"])
    opt = adamw(warmup_cosine(task["lr"], 20, task["steps"]))
    state = resume(cfg, mod, opt, task["ckpt_dir"], device=at.device,
                   mesh=mesh)
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


def _tp_case(task, at):
    from _torch_tp_ref import PARAM_SEED, config
    cfg = config(task["arch"], task.get("pe_type", "fp32"),
                 task.get("overrides"))
    mesh = at.mesh(task["mesh"])
    params = convert.params_from_numpy(
        family_module(cfg).numpy_params(cfg, PARAM_SEED), at.device)
    return cfg, mesh, params


def task_tp_train(task, at):
    """A ``_torch_tp_ref.TRAIN`` (or ``_torch_ssm_tp_ref.TRAIN``) case on
    the task's mesh through the tensor-parallel split
    (``tp_check.train_run``): each step's loss and gradient norm, the
    FLOPs and collectives of a step, and the final params' digest; under
    its ``variant`` (``tp_check.variant``) the control run (``steps`` and
    ``count`` may cut it).  ``pins``: an ``.npz`` of the one-rank run's
    activation log (``_torch_act_pins.port_act_log``, ``ratio<i>`` /
    ``codes<i>`` a call), to which the rank's codes at rounding ties are
    pinned (``SplitActPins``; the pins counted)."""
    from _torch_tp_ref import DIGEST, STEPS, tp_batches
    from repro_torch import tp_check
    cfg, mesh, params = _tp_case(task, at)
    steps = task.get("steps", STEPS)
    with tp_check.variant(task.get("variant")), _Patches() as patches:
        pins = None
        if task.get("pins"):
            from _torch_act_pins import SplitActPins
            log = np.load(task["pins"])
            split = M.model_split(mesh)
            pins = SplitActPins(patches, split.rank, split.size)
            pins.load([(log[f"ratio{i}"], log[f"codes{i}"])
                       for i in range(len(log.files) // 2)])
        r = tp_check.train_run(cfg, steps, 0, 0, at.device, mesh,
                               params=params,
                               batches=tp_batches(cfg)[:steps],
                               count=task.get("count", True))
    return ({"rows": r["rows"], "flops": r.get("flops"),
             "collectives": r.get("collectives"),
             "coord": M.coordinate(mesh),
             "pinned": pins and pins.pinned,
             "pins_done": pins and pins.n == len(pins.calls)},
            {k: v[:DIGEST] for k, v in r["final"].items()})


def task_tp_serve(task, at):
    """A ``_torch_tp_ref.SERVE`` (or ``_torch_ssm_tp_ref.SERVE``) case on
    (1, 2): each step's last logits (gathered over the vocabulary split)
    and greedy tokens."""
    from _torch_tp_ref import CACHE, PACK_MIN, PROMPT, serve_tokens
    from repro_torch import tp_check
    cfg, mesh, params = _tp_case(task, at)
    r = tp_check.serve_run(cfg, torch.from_numpy(serve_tokens(cfg)), PROMPT,
                           CACHE, at.device, mesh, quant=task.get("quant"),
                           cache_dtype=torch.float32, params=params,
                           pack_min=PACK_MIN)
    return {"launches": r["launches"]}, {"logits": r["logits"],
                                         "greedy": r["greedy"]}


def task_tp_resume(task, at):
    """A ``_torch_tp_ref.TRAIN`` case's split run checkpointed after its
    first step, resumed onto a fresh state on the same mesh and run to
    the end: its final params' digest and the steps after the resume."""
    from _torch_tp_ref import DIGEST, STEPS, tp_batches
    from repro_torch import tp_check
    from repro_torch.data import DataPipeline
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import (TrainState, fit, jit_train_step,
                                   make_train_step, resume, shard_state,
                                   state_shardings_for)
    from repro_torch.train_check import LM_SCHEDULE
    cfg, mesh, params = _tp_case(task, at)
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(*LM_SCHEDULE))
    sh = state_shardings_for(cfg, mod, mesh, opt)
    batches = tp_batches(cfg)

    def pipe():
        return DataPipeline(lambda s, i: tp_check._dp_slice(
            batches[i % len(batches)], mesh, at.device), 0, at.device)

    step = jit_train_step(make_train_step(cfg, mod, opt), sh, mesh)
    rows = []

    def logged(st, b):
        st, m = step(st, b)
        rows.append([float(m["loss"]), float(m["grad_norm"])])
        return st, m

    state = shard_state(TrainState(params, opt.init(params),
                                   torch.zeros((), dtype=torch.int32)), sh)
    fit(state, logged, pipe(), 1, ckpt_dir=task["ckpt_dir"], ckpt_every=1,
        log_fn=lambda _m: None, shardings=sh)
    p = pipe()
    state = resume(cfg, mod, opt, task["ckpt_dir"], p, device=at.device,
                   mesh=mesh)
    state = fit(state, logged, p, STEPS, log_fn=lambda _m: None,
                shardings=sh)
    final = tp_check.param_digest(state.params, sh.params, k=DIGEST)
    return {"rows": rows, "step": int(state.step)}, final


def task_seq_serve(task, at):
    """A ``_torch_seqshard_ref.CASES`` case on one cache type through the
    sequence-sharded cache (``tp_check.serve_run``): each step's last
    logits and greedy tokens, the launches, and the rank's cache at the
    end (``cache/<path>``)."""
    from _torch_seqshard_ref import (CACHE, PARAM_SEED, PROMPT, config,
                                     serve_tokens)
    from repro_torch import tp_check
    from repro_torch.models import transformer as T
    cfg = config(task["arch"])
    mesh = at.mesh(task["mesh"])
    params = convert.params_from_numpy(T.numpy_params(cfg, PARAM_SEED),
                                       at.device)
    coord, shape = M.coordinate(mesh), task["mesh"]
    slot = coord["data"] * shape[1] + coord["model"]   # the rank's slice
    pins = writes = None
    with _Patches() as patches:
        if task.get("pin"):
            # the JAX one-device run's P of every call, cut to this rank's
            # keys (its slice of the cache's rows), and its cache writes
            from _torch_act_pins import ProbPins, WritePins
            from _torch_seqshard_ref import (REF_PATH, cache_writes,
                                             unpack_probs)
            one = json.loads(REF_PATH.read_text())["serve"][task["key"]][
                "one"]
            rows = CACHE // (shape[0] * shape[1])
            pins = ProbPins(patches)
            pins.load([c[..., slot * rows:(slot + 1) * rows]
                       for c in unpack_probs(one["probs"])])
            writes = WritePins(patches, cache_writes(one))
        r = tp_check.serve_run(
            cfg, torch.from_numpy(serve_tokens(cfg, task["batch"])), PROMPT,
            CACHE, at.device, mesh,
            cache_dtype=getattr(torch, task["cache_dtype"]), params=params,
            keep_cache=True)
    arrays = {"logits": r["logits"], "greedy": r["greedy"]}
    arrays.update({f"cache/{k}": v for k, v in r["cache"].items()})
    return {"launches": r["launches"], "coord": M.coordinate(mesh),
            "pinned": pins and [pins.pinned, writes.pinned],
            "pins_done": pins and pins.done() and writes.done()}, arrays


class _Patches:
    """``monkeypatch.setattr`` for a rank's task: the attributes set
    while open, put back after."""

    def __enter__(self):
        self.saved = []
        return self

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __exit__(self, *exc):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)


TASKS = {"sharding": task_sharding, "grad_compress": task_grad_compress,
         "moe_ep": task_moe_ep, "train_cli": task_train_cli,
         "train_mesh": task_train_mesh, "restore": task_restore,
         "ep_train": task_ep_train, "moe_capacity": task_moe_capacity,
         "all_reduce": task_all_reduce, "dryrun_cell": task_dryrun_cell,
         "tp_train": task_tp_train, "tp_serve": task_tp_serve,
         "tp_resume": task_tp_resume, "seq_serve": task_seq_serve}
