"""Writes ``tests/data/torch_dryrun_ref.json``: the JAX package's dry-run
counts that the port's dry run (``repro_torch.launch.dryrun``) is held
to.

  PYTHONPATH=src:tests python tests/_torch_dryrun_ref.py [--reduced-only]

It sets ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before JAX
is imported and builds each cell with the reference's own
``repro.launch.dryrun.build_cell``, lowered and compiled as its
``run_cell`` does, on a mesh of Auto axes under ``jax.set_mesh`` and the
reference's ``activation_sharding`` (the reference's production meshes
need 256 devices).  For each cell it keeps the trip-count-aware FLOPs
and bytes of ``repro.launch.hlo_analysis.analyze`` (and the part of those
FLOPs in matrix-vector dots, ``_matvec_flops``) and
``memory_analysis()``'s argument and temporary bytes (per device).
Three parts:

  * ``reduced``: every arch's reduced config x ``REDUCED_SHAPES`` (train,
    prefill and decode at batch 2 x 64, decode at batch 1) on a (1, 1)
    mesh (~1 min);
  * ``mesh2x2``: ``MESH_CELLS`` (reduced, head_dim 64, the attention
    backward kernel's, so that the port counts them on ``meta``; batch 4
    x 64) on a (2, 2) mesh;
  * ``full``: every cell of ``repro.launch.shapes.SHAPES`` x the ten full
    configs on a (1, 1) mesh, skipped cells as the reference skips them
    (several minutes; ``--reduced-only`` keeps the file's ``full``).

The JAX package is not edited: ``build_cell`` reads its config and shape
through ``get_cfg`` and ``SHAPES``, which this script points at the
reduced configs and shapes for the first two parts and puts back.
"""

import json
import os
import sys
import time
from pathlib import Path

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_dryrun_ref.json"
N_DEV = 4
# (name, seq, batch, kind): the reduced cells' shapes
REDUCED_SHAPES = (("train_r", 64, 2, "train"), ("prefill_r", 64, 2, "prefill"),
                  ("decode_r", 64, 2, "decode"), ("decode_1", 64, 1, "decode"))
MESH_SHAPE = (2, 2)
# (arch, (name, seq, batch, kind)) on the 2 x 2 mesh, reduced configs with
# MESH_OVERRIDES
MESH_CELLS = (("smollm-135m", ("train_m", 64, 4, "train")),
              ("deepseek-moe-16b", ("train_m", 64, 4, "train")))
MESH_OVERRIDES = {"head_dim": 64}


def mesh_config(arch: str, reduced):
    """The 2 x 2 cells' config from a package's ``reduced``."""
    return reduced(arch).replace(**MESH_OVERRIDES)


def _cell(D, HA, arch, shape_name, mesh):
    import jax
    from repro.launch.mesh import dp_axes
    from repro.models.layers import activation_sharding
    dp = dp_axes(mesh)
    n_dp = 1
    for a in dp:
        n_dp *= mesh.shape[a]
    t0 = time.time()
    with jax.set_mesh(mesh), activation_sharding(dp, n_dp, mesh=mesh):
        step, in_sh, specs, donate = D.build_cell(arch, shape_name, mesh)
        compiled = jax.jit(step, in_shardings=in_sh,
                           donate_argnums=donate).lower(*specs).compile()
    mem = compiled.memory_analysis()
    hlo = compiled.as_text()
    ana = HA.analyze(hlo)
    return {"status": "ok", "flops": float(ana["flops"]),
            "matvec_flops": _matvec_flops(HA, hlo),
            "bytes_out": float(ana["bytes_out"]),
            "collectives": ana["collectives"],
            "memory": {k: int(getattr(mem, k, 0)) for k in
                       ("argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes")},
            "compile_s": round(time.time() - t0, 2)}


def _matvec_flops(HA, hlo: str) -> float:
    """The part of ``HA.analyze(hlo)["flops"]`` in matrix-vector dots (no
    batch dimension, a rank-1 result), walked and weighted as ``analyze``
    walks them.  XLA's CPU compiler fuses most matrix-vector products into
    loop fusions, whose bodies ``analyze`` does not read
    (``hlo_analysis.comp_multipliers`` skips fusions), and keeps some as
    dots; the port counts all of them (``op_analysis``'s
    ``matvec_flops``), so the two counts are compared without this
    part."""
    comps, entry = HA.parse_module(hlo)
    mult = HA.comp_multipliers(comps, entry)
    total = 0.0
    for cname, instrs in comps.items():
        w = mult.get(cname, 0.0)
        symtab = {i.name: i.shape for i in instrs}
        for i in instrs:
            if w and i.op == "dot" and "lhs_batch_dims" not in i.tail \
                    and len(HA._shape_dims(i.shape)[0]) == 1:
                total += w * HA._dot_flops(i, symtab)
    return total


def _mesh(shape):
    import jax
    from jax.sharding import AxisType
    n = shape[0] * shape[1]
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])


def _run(cells, mesh_shape, reduced: bool, overrides=None) -> dict:
    """{arch: {shape: result}} of (arch, (name, seq, batch, kind)) cells;
    with ``reduced`` the reference's build reads reduced configs (with
    ``overrides``)."""
    from repro.configs import get, reduced as get_reduced
    from repro.launch import dryrun as D
    from repro.launch import hlo_analysis as HA
    from repro.launch import shapes as SH
    mesh = _mesh(mesh_shape)
    added = []
    out = {}
    D.get_cfg = ((lambda a: get_reduced(a).replace(**(overrides or {})))
                 if reduced else get)
    try:
        for arch, (name, seq, batch, kind) in cells:
            if name not in SH.SHAPES:
                SH.SHAPES[name] = SH.ShapeSpec(name, seq, batch, kind)
                added.append(name)
            cfg = D.get_cfg(arch)
            if not SH.shape_runs(cfg, SH.SHAPES[name]):
                out.setdefault(arch, {})[name] = {"status": "skipped"}
                continue
            try:
                r = _cell(D, HA, arch, name, mesh)
            except Exception as e:  # noqa: BLE001 -- kept as data
                r = {"status": "error", "error": f"{type(e).__name__}: {e}"}
            out.setdefault(arch, {})[name] = r
            print(arch, name, r.get("status"), r.get("flops"),
                  r.get("memory", {}).get("argument_size_in_bytes"),
                  r.get("compile_s"), flush=True)
    finally:
        D.get_cfg = get
        for name in added:
            del SH.SHAPES[name]
    return out


def build_reference(full: bool = True, old: dict | None = None) -> dict:
    import jax
    from repro.configs import list_archs
    from repro.launch import shapes as SH
    assert jax.device_count() == N_DEV, jax.device_count()
    archs = list_archs()
    ref = {"jax_version": jax.__version__, "n_devices": N_DEV,
           "reduced_shapes": [list(s) for s in REDUCED_SHAPES],
           "reduced": _run([(a, s) for a in archs for s in REDUCED_SHAPES],
                           (1, 1), reduced=True),
           "mesh2x2": {"mesh": list(MESH_SHAPE),
                       "overrides": MESH_OVERRIDES,
                       "cells": _run(list(MESH_CELLS), MESH_SHAPE,
                                     reduced=True,
                                     overrides=MESH_OVERRIDES)}}
    if full:
        ref["full"] = _run([(a, (n, s.seq, s.batch, s.kind)) for a in archs
                            for n, s in SH.SHAPES.items()], (1, 1),
                           reduced=False)
    else:
        ref["full"] = (old or {}).get("full", {})
    return ref


if __name__ == "__main__":
    # 4 virtual CPU devices: set before JAX is first imported (every JAX
    # import of this file is inside a function; repro.launch.dryrun keeps
    # a device count already set)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count"
                                 f"={N_DEV}")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    only = "--reduced-only" in sys.argv[1:]
    old = json.loads(REF_PATH.read_text()) if REF_PATH.exists() else None
    ref = build_reference(full=not only, old=old)
    REF_PATH.write_text(json.dumps(ref, indent=0))
    print(f"wrote {REF_PATH} ({REF_PATH.stat().st_size} bytes)")
