"""Multi-pod dry run: count every (arch x shape x mesh) cell's per-device
work on the ``meta`` device (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step on 256 or 512 virtual
devices and reads ``memory_analysis()``, its HLO's FLOPs and bytes, and
its collectives' payloads.  The port has no compiler to ask: one process
stands for rank 0 of the production mesh over PyTorch's fake process
group (``mesh.init_process_group("meta", ...)``: collectives complete and
move nothing), builds the rank's state, batch and cache as ``meta``
tensors (shapes and types, no storage), runs the port's own step once
under ``op_analysis.analyze`` and records

  * ``flops`` and ``bytes_out`` of the rank (the kernels, which launch
    nothing on ``meta``, declare theirs), and ``matvec_flops``, the part
    of ``flops`` in matrix-vector products, which the reference's count
    mostly leaves out (``op_analysis``; ``reference_flops``),
  * ``collectives``: payload bytes by kind, as the rank issues them,
  * ``memory``: the rank's argument bytes (state, batch and cache; a
    host-int cache index counts 4 bytes, the reference's int32 index),
    its output bytes, and ``temp_size_in_bytes``, the peak of the bytes
    the step allocates and holds above its arguments,
  * ``launches`` per kernel, ``fits_80gb`` (arguments and temporaries
    within an H100's 80 GB) and ``notes``.

The steps are the port's: training is ``trainer.jit_train_step`` with the
reference's microbatch rule; serving is a mesh step built here as the
reference builds its own (params in the "serve" shardings, bfloat16 where
the reference's are, gathered as the training step gathers them; the
batch over the dp axes).  The decoder, SSM and hybrid families run the
tensor-parallel split in both (the model module's ``keeps_model_shard``:
each rank computes its attention, RWKV6 and Mamba2 heads, columns,
vocabulary rows and experts); their serving caches follow ``cache_spec``
as the reference's perf runner calls it: a KV cache split over its heads
where they divide ``model``, else over its sequence (over ``model``, or
``("data", "model")`` where the batch does not divide the dp axes), each
rank attending over its slice of the keys and the softmax combined
across the group (``layers.seq_attention``); an SSM state over its
heads, a Mamba2 conv window over its channels (an even split, gathered
a step).  The encoder-decoder family gathers every leaf over ``model``,
computes the whole layer on every rank of a ``model`` group
(``NOTE_TP``) and keeps its cache split over the dp axes only
(``NOTE_SERVE``).  Ranks are symmetric under these rules: rank 0 stands
for all.  A cell the card's kernels
refuse fails here with the kernel's own message, recorded as data
(``status: error``), as the reference records a failed compile.

Results land in ``results/torch_dryrun/<arch>__<shape>__<mesh>.json``.
No card is needed:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import get as get_cfg, list_archs
from repro_torch.launch import mesh as M
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import shapes as SH
from repro_torch.launch.sharding import (Sharding, cache_seq_axes,
                                         cache_spec, make_param_shardings,
                                         map_with_path, seq_sharded)
from repro_torch.models import family_module
from repro_torch.optim import adamw, constant, tree_map

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "torch_dryrun"
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
HBM_BYTES = 80e9            # an H100's 80 GB
INDEX_BYTES = 4             # the reference's int32 cache index
NOTE_TP = ("products not split over 'model': every rank of a model group "
           "computes the whole layer (the tensor-parallel split of this "
           "family is later work, ROADMAP A)")
NOTE_GATHER = ("each param leaf all-gathered over the mesh axes of its spec "
               "before the step")
NOTE_SPLIT = ("the products split over 'model': each rank computes its "
              "attention, RWKV6 and Mamba2 heads, MLP columns, vocabulary "
              "rows and experts; the product leaves gathered over the dp "
              "axes of their spec alone, the others (norm scales, the "
              "router, the SSM layers' small leaves) over every axis of "
              "theirs before the step")
NOTE_SERVE = ("the cache split over the dp axes only: each rank of a model "
              "group holds every head of its rows (the reference splits "
              "the heads over 'model', or where they do not divide it the "
              "sequence; the port splits them for every family it splits "
              "the products of)")
NOTE_META = ("counted on meta tensors over the fake process group: no "
             "kernel launched, each declared its work")


def mesh_name(sizes) -> str:
    for name, (s, _) in MESHES.items():
        if tuple(sizes) == s:
            return name
    return "x".join(map(str, sizes))


def start_mesh(sizes, axes=("data", "model"), rank: int = 0,
               device="meta"):
    """A ``DeviceMesh`` of ``sizes`` with this process as ``rank``: over
    the fake backend for ``meta`` (any size), over gloo for the CPU (one
    rank only: the CPU counts run every value).  An earlier default group
    of another size, rank or backend is destroyed first."""
    world = math.prod(sizes)
    backend = M.backend_for(device)
    if dist.is_initialized():
        if (dist.get_backend() == backend and dist.get_world_size() == world
                and dist.get_rank() == rank):
            return M.make_mesh(sizes, axes, device)
        dist.destroy_process_group()
    if backend == "gloo":
        if world != 1:
            raise ValueError("a CPU dry run takes a mesh of one rank")
        M.init_process_group(device, 0, 1, store=dist.HashStore())
    else:
        M.init_process_group(device, rank, world)
    return M.make_mesh(sizes, axes, device)


def _maybe_dp(mesh, dim: int):
    """The dp axes where they divide ``dim``, else None (replicated), as
    the reference's ``_maybe_dp``."""
    return M.dp_axes(mesh) if dim % M.dp_total(mesh) == 0 else None


def _batch_sharding(mesh, x) -> Sharding:
    return Sharding(mesh, (_maybe_dp(mesh, x.shape[0]),
                           *(None,) * (x.ndim - 1)))


def _dp_only(spec, dp) -> tuple:
    """A cache spec with every entry but the dp axes dropped."""
    return tuple(e if e == dp else None for e in spec)


def _on(device, tree):
    """The meta stand-ins of ``tree`` as tensors on ``device`` (zeros;
    the counts depend on no value)."""
    if torch.device(device).type == "meta":
        return tree
    return tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype,
                                          device=device)
                    if torch.is_tensor(x) else x, tree)


def _mrope_positions(b: int, s: int, device) -> torch.Tensor:
    """(B, S, 3) int32 M-RoPE positions of a text-only prompt: arange(S)
    on every stream (the port's kernel takes start + arange(S) a row)."""
    return torch.arange(s, dtype=torch.int32, device=device)[
        None, :, None].expand(b, s, 3).contiguous()


def _host_indices(tree) -> int:
    """Host-int cache indices in a cache tree."""
    if isinstance(tree, dict):
        return sum(_host_indices(v) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_host_indices(v) for v in tree)
    return int(isinstance(tree, int))


def _generator(device) -> torch.Generator:
    """A seeded generator on a card for a card's draws, else on the CPU
    (``meta`` draws nothing)."""
    device = torch.device(device)
    gen = torch.Generator(device=device) if device.type == "cuda" \
        else torch.Generator()
    return gen.manual_seed(0)


def train_cell(cfg, shape, mesh, device="meta"):
    """(step, args) of a training cell: ``jit_train_step`` of the port's
    trainer, the rank's shards of a fresh AdamW state and its slice of
    the batch."""
    from repro_torch.train import trainer as T
    mod = family_module(cfg)
    micro = n_micro(cfg, shape, M.dp_total(mesh))
    opt = adamw(constant(1e-4))
    sh = T.state_shardings_for(cfg, mod, mesh, opt)
    state = T.shard_state(T.init_state(cfg, mod, opt, _generator(device),
                                       device=device), sh)
    batch = _on(device, SH.batch_specs(cfg, shape))
    if "positions" in batch:
        batch["positions"] = _mrope_positions(shape.batch, shape.seq, device)
    batch = {k: _batch_sharding(mesh, v).shard(v) for k, v in batch.items()}
    step = T.jit_train_step(T.make_train_step(cfg, mod, opt, n_micro=micro),
                            sh, mesh)
    return step, (state, batch)


def serve_params(cfg, mod, device, *, bf16: bool = True,
                 serve_quant: str | None = None):
    """Fresh params for a serving cell: float32 leaves in bfloat16 (the
    reference's dry run serves bfloat16 weights), or packed by
    ``serve_quant`` (the reference's perf runner packs float32 ones)."""
    params = mod.init_params(cfg, _generator(device), device=device)
    if serve_quant:
        from repro_torch.serve.engine import quantize_params
        return quantize_params(params, serve_quant)
    if bf16:
        params = tree_map(lambda x: x.to(torch.bfloat16)
                          if x.dtype == torch.float32 else x, params)
    return params


def serve_cell(cfg, shape, mesh, device="meta", params=None, cache=None):
    """(step, args) of a prefill or decode cell: the rank's shards of the
    params ("serve" rules), its dp slice of the tokens and the cache; the
    step gathers the params and runs the family's ``prefill`` /
    ``decode_step`` under the mesh context, with no gradient."""
    from repro_torch.train.trainer import model_kept
    mod = family_module(cfg)
    dp, n_dp = M.dp_axes(mesh), M.dp_total(mesh)
    if params is None:
        params = serve_params(cfg, mod, device)
    p_shard = make_param_shardings(cfg, params, mesh, "serve")
    kept = model_kept(cfg, mod, p_shard)
    split = splits(cfg) and M.model_split(mesh) is not None
    local = tree_map(lambda x, s: s.shard(x), params, p_shard)
    if cache is None:
        cache = _on(device, SH.cache_shape(cfg, mod, shape))
    seq_shard = seq_sharded(cfg, mesh)
    # the split families' cache as the reference's perf runner splits it
    seq_axes = cache_seq_axes(cfg, mesh, shape.batch,
                              seq_shard) if split else None

    def cache_sharding(path, x):
        spec = cache_spec(cfg, mesh, path, tuple(x.shape), seq_shard)
        return Sharding(mesh, spec if split else _dp_only(spec, dp))

    cache = map_with_path(lambda path, x: cache_sharding(path, x).shard(x)
                          if torch.is_tensor(x) else x, cache)

    def dp_slice(x):
        return _batch_sharding(mesh, x).shard(x)

    family = cfg.family
    if shape.kind == "prefill":
        toks = _on(device, SH.prefill_token_specs(cfg, shape))
        if family == "encdec":
            inputs = ({k: dp_slice(v) for k, v in toks.items()},)

            def call(p, batch, cache):
                logits, cache, _ = mod.prefill(p, batch, cfg, cache)
                return logits, cache
        elif family == "vlm":
            pos = _mrope_positions(shape.batch, shape.seq, device)
            inputs = (dp_slice(toks), dp_slice(pos))

            def call(p, tokens, positions, cache):
                return mod.prefill(p, tokens, cfg, cache, positions)
        else:
            inputs = (dp_slice(toks),)

            def call(p, tokens, cache):
                return mod.prefill(p, tokens, cfg, cache)
    else:
        tok = dp_slice(_on(device, SH.decode_token_specs(cfg, shape)))
        extra = _on(device, SH.decode_extra_specs(cfg, shape))
        if family == "encdec":
            inputs = (tok, dp_slice(extra["enc_out"]))

            def call(p, token, enc_out, cache):
                return mod.decode_step(p, token, enc_out, cfg, cache)
        elif family == "vlm":
            inputs = (tok, dp_slice(extra["positions"]))

            def call(p, token, positions, cache):
                return mod.decode_step(p, token, cfg, cache, positions)
        else:
            inputs = (tok,)

            def call(p, token, cache):
                return mod.decode_step(p, token, cfg, cache)

    def step(params, *rest):
        full = tree_map(lambda x, s, k: s.gather(x, keep=k), params, p_shard,
                        kept)
        with torch.no_grad(), M.activation_sharding(dp, n_dp, mesh=mesh,
                                                    split=split,
                                                    seq_axes=seq_axes):
            return call(full, *rest)

    return step, (local, *inputs, cache)


def splits(cfg) -> bool:
    """The config runs the tensor-parallel split: its model module keeps
    product leaves' ``model`` shards (``keeps_model_shard``)."""
    keeps = getattr(family_module(cfg), "keeps_model_shard", None)
    return keeps is not None and keeps(cfg, "embed")


def build_cell(arch: str, shape_name: str, mesh, *, cfg=None, shape=None,
               device="meta"):
    """(step, args, notes) of one cell: ``cfg`` and ``shape`` default to
    the arch's full config and ``SHAPES[shape_name]``."""
    cfg = cfg or get_cfg(arch)
    shape = shape or SH.SHAPES[shape_name]
    notes = cell_notes(cfg, shape, mesh)
    if torch.device(device).type == "meta":
        notes.append(NOTE_META)
    if shape.kind == "train":
        step, args = train_cell(cfg, shape, mesh, device)
    else:
        step, args = serve_cell(cfg, shape, mesh, device)
    return step, args, notes


def cell_notes(cfg, shape, mesh) -> list:
    """What a cell's counts are of: the split or the whole layer, the
    gathers, and a serving cache kept on the dp axes where the reference
    splits it further (the families the split does not take)."""
    split = splits(cfg)
    notes = [NOTE_SPLIT] if split else [NOTE_TP, NOTE_GATHER]
    if shape.kind != "train" and not split:
        notes.append(NOTE_SERVE)
    return notes


def analyze_cell(step, args) -> dict:
    """The analyzer's counts of one run of ``step(*args)`` and the cell's
    keys: ``fits_80gb``, host-int cache indices in the argument bytes."""
    _, rep = OA.analyze(step, *args)
    mem = rep["memory"]
    index_bytes = INDEX_BYTES * _host_indices(args[-1])
    mem["argument_size_in_bytes"] += index_bytes
    mem["resident_argument_bytes"] += index_bytes
    return dict(
        flops=rep["flops"], matvec_flops=rep["matvec_flops"],
        bytes_out=rep["bytes_out"], memory=mem,
        collectives=rep["collectives"], launches=rep["launches"],
        kernels=rep["kernels"], n_computations=rep["n_computations"],
        fits_80gb=(mem["resident_argument_bytes"]
                   + mem["temp_size_in_bytes"]) <= HBM_BYTES)


def n_micro(cfg, shape, n_dp: int) -> int:
    """The reference's microbatch rule: at most the arch's count, and
    every microbatch at least one row of the rank's slice."""
    return min(SH.TRAIN_MICROBATCHES.get(cfg.name, 8),
               max(shape.batch // n_dp, 1))


def scan_state_grad_flops(cfg, shape, n_dp: int = 1) -> float:
    """FLOPs by which the reference's count of a training cell exceeds the
    port's in the chunk-scan families (RWKV6, Zamba2's Mamba2 layers):
    XLA's scan computes the gradient of every chunk's incoming state,
    the first chunk's too (a product of 2 * B * H * C * dk * dv a layer
    and microbatch), where the first state is zeros that need none and
    autograd skips it.  0 for other cells."""
    if shape.kind != "train" or cfg.family not in ("ssm", "hybrid"):
        return 0.0
    micro = n_micro(cfg, shape, n_dp)
    rows = shape.batch // n_dp // micro
    chunk = 16
    while shape.seq % chunk:
        chunk //= 2
    if cfg.family == "ssm":
        h = cfg.ssm_heads
        per_layer = 2.0 * rows * h * chunk * (cfg.d_model // h) ** 2
        return per_layer * cfg.n_layers * micro
    from repro_torch.models import hybrid, mamba
    d_in, hd, heads, d_state = mamba.dims(cfg)
    period, n_groups, tail = hybrid._group_shape(cfg)
    per_layer = 2.0 * rows * heads * chunk * d_state * hd
    return per_layer * (period * n_groups + tail) * micro


def reference_flops(cfg, shape, result, n_dp: int = 1) -> float:
    """The port's FLOPs of a cell (``result``) as the reference's count
    is compared with them: without the matrix-vector products
    (``matvec_flops``; XLA fuses most of them into loops, whose bodies the
    reference's count does not read, so both sides are compared without
    that part), and with the scan's zero-state gradient, which XLA takes
    and autograd skips (``scan_state_grad_flops``)."""
    return (result["flops"] - result["matvec_flops"]
            + scan_state_grad_flops(cfg, shape, n_dp))


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             save: bool = True, verbose: bool = True, *, mesh_shape=None,
             cfg=None, shape=None, rank: int = 0, device="meta") -> dict:
    """Count one cell as ``rank`` of its mesh (the production pod16x16 or
    pod2x16x16 unless ``mesh_shape`` = (sizes, axes) says otherwise) and
    save the result (``results/torch_dryrun/``)."""
    cfg = cfg or get_cfg(arch)
    shape = shape or SH.SHAPES[shape_name]
    sizes, axes = mesh_shape or MESHES["pod2x16x16" if multi_pod
                                       else "pod16x16"]
    result = {"arch": arch, "shape": shape.name, "mesh": mesh_name(sizes),
              "kind": shape.kind, "device": torch.device(device).type,
              "rank": rank}
    if not SH.shape_runs(cfg, shape):
        result["status"] = "skipped"
        result["reason"] = ("no decode step" if not cfg.has_decode else
                            "long_500k needs sub-quadratic attention")
        if save:
            _save(result)
        return result
    t0 = time.time()
    try:
        mesh = start_mesh(sizes, axes, rank, device)
        step, args, notes = build_cell(arch, shape.name, mesh, cfg=cfg,
                                       shape=shape, device=device)
        result.update(status="ok", devices=math.prod(sizes),
                      **analyze_cell(step, args), notes=notes)
        result["seconds"] = round(time.time() - t0, 2)
        if verbose:
            coll = {k: round(v / 1e9, 3) for k, v in
                    result["collectives"].items() if not k.endswith("_count")}
            print(f"[{arch} x {shape.name} x {result['mesh']}] OK "
                  f"{result['seconds']:.1f}s flops/dev={result['flops']:.4e} "
                  f"bytes_out/dev={result['bytes_out']:.4e} "
                  f"memory={result['memory']} collectives={coll} GB")
    except Exception as e:  # noqa: BLE001 -- failures are recorded as data
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"[:2000]
        result["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[{arch} x {shape.name} x {result['mesh']}] FAIL: "
                  f"{result['error'][:300]}")
    if save:
        _save(result)
    return result


def _path(arch: str, shape: str, mesh: str) -> Path:
    return RESULTS_DIR / f"{arch}__{shape}__{mesh}.json"


def _save(result: dict) -> None:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    _path(result["arch"], result["shape"], result["mesh"]).write_text(
        json.dumps(result, indent=1))


def run_cells(cells, out) -> None:
    """Count each (arch, shape name, mesh name) cell, the mesh "1x1" or a
    production mesh, as rank 0, and append its result to the file
    ``out`` as a JSON line (nothing under ``results/``)."""
    try:
        for arch, shape, mesh in cells:
            ms = ((1, 1), ("data", "model")) if mesh == "1x1" else None
            r = run_cell(arch, shape, mesh == "pod2x16x16", save=False,
                         verbose=False, mesh_shape=ms)
            r.pop("traceback", None)
            with open(out, "a") as f:
                f.write(json.dumps(r) + "\n")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_archs() + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SH.SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = (list(SH.SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    mesh = "pod2x16x16" if args.multi_pod else "pod16x16"
    statuses = []
    try:
        for arch in archs:
            for shape in shapes:
                fn = _path(arch, shape, mesh)
                if args.skip_existing and fn.exists():
                    st = json.loads(fn.read_text()).get("status")
                    if st in ("ok", "skipped"):
                        statuses.append((arch, shape, st + " (cached)"))
                        continue
                r = run_cell(arch, shape, args.multi_pod)
                statuses.append((arch, shape, r["status"]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print("\n=== dry-run summary ===")
    for a, s, st in statuses:
        print(f"{a:24s} {s:12s} {st}")
    bad = [s for s in statuses if s[2] == "error"]
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
