"""The port's sharding rules and shapes (``repro_torch.launch.{mesh,
sharding,shapes}``) against the JAX package's (``repro.launch``), the
mirror of ``tests/test_substrate.py::TestShardingRules``.

* ``param_spec`` for every leaf of all ten configs at full width (the
  port's params on ``meta``, the reference's from ``jax.eval_shape``),
  train and serve modes, on the (16, 16) and (2, 16, 16) production
  meshes and on (2, 2) and (1, 4), as mesh shapes: nothing is allocated
  and no process started;
* ``cache_spec`` on the ``decode_32k`` / ``long_500k`` caches, sequence
  sharding on and off; the ``shapes.py`` stand-ins for 10 configs x 4
  shapes;
* on 4 gloo ranks (a (2, 2) mesh), each rank's slice of every leaf of the
  reduced configs' params, a batch and a cache, held to the slice that the
  reference's ``NamedSharding(...).devices_indices_map`` gives the device
  at the same mesh coordinate (``tests/data/torch_launch_ref.json``,
  written by ``tests/_torch_launch_ref.py`` on 4 virtual devices), and a
  shard / gather round trip.

Exact: the rules are integer arithmetic.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get, list_archs as jax_archs
from repro.launch import shapes as JS
from repro.launch.sharding import cache_spec as jax_cache_spec
from repro.launch.sharding import param_spec as jax_param_spec
from repro.models import family_module as jax_family
from repro_torch.configs import get, list_archs
from repro_torch.launch import shapes as S
from repro_torch.launch.mesh import (MeshShape, axis_sizes, backend_for,
                                     dp_axes, make_production_mesh)
from repro_torch.launch.sharding import (Sharding, cache_spec, map_with_path,
                                         param_spec)
from repro_torch.models import family_module

from _torch_dist import run_ranks
from _torch_launch_ref import REF_PATH

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x2": (("data", "model"), (2, 2)),
          "1x4": (("data", "model"), (1, 4))}


class FakeMesh:
    """The reference's mesh as its rules read it (its own test's)."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _norm(spec) -> tuple:
    """A spec with each entry as a tuple of axis names."""
    out = []
    for e in tuple(spec):
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out)


def _jax_leaves(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    out = {}
    map_with_path(lambda p, x: out.__setitem__(p, x)
                  if torch.is_tensor(x) else None, tree)
    return out


def test_archs_and_meshes():
    assert list_archs() == jax_archs()
    assert axis_sizes(make_production_mesh()) == {"data": 16, "model": 16}
    assert axis_sizes(make_production_mesh(multi_pod=True)) == {
        "pod": 2, "data": 16, "model": 16}
    assert dp_axes(make_production_mesh(multi_pod=True)) == ("pod", "data")
    assert backend_for("cpu") == "gloo" and backend_for("cuda") == "nccl"


@pytest.mark.parametrize("arch", jax_archs())
def test_param_specs_match_the_reference_at_full_width(arch):
    cfg, jcfg = get(arch), jax_get(arch)
    port = _port_leaves(family_module(cfg).init_params(
        cfg, torch.Generator(), device="meta"))
    ref = _jax_leaves(jax.eval_shape(
        lambda k: jax_family(jcfg).init_params(jcfg, k),
        jax.random.PRNGKey(0)))
    assert set(port) == set(ref)
    for path, leaf in ref.items():
        assert tuple(port[path].shape) == tuple(leaf.shape), path
    for names, sizes in MESHES.values():
        for mode in ("train", "serve"):
            for path, leaf in ref.items():
                want = jax_param_spec(jcfg, FakeMesh(names, sizes), path,
                                      leaf.shape, mode)
                got = param_spec(cfg, MeshShape(names, sizes), path,
                                 tuple(leaf.shape), mode)
                assert _norm(got) == _norm(want), (path, mode, sizes)
                # every named axis divides its dimension
                Sharding(MeshShape(names, sizes), got).slices(
                    leaf.shape, {a: 0 for a in names})


@pytest.mark.parametrize("arch", jax_archs())
def test_cache_specs_match_the_reference(arch):
    cfg, jcfg = get(arch), jax_get(arch)
    mod, jmod = family_module(cfg), jax_family(jcfg)
    ran = 0
    for name in ("decode_32k", "long_500k"):
        shape = JS.SHAPES[name]
        if not JS.shape_runs(jcfg, shape) or jcfg.family == "encdec":
            continue
        ran += 1
        port = _port_leaves(S.cache_shape(cfg, mod, S.SHAPES[name]))
        ref = _jax_leaves(JS.cache_shape(jcfg, jmod, shape))
        assert set(port) <= set(ref)
        for path, leaf in port.items():
            assert tuple(leaf.shape) == tuple(ref[path].shape), path
            for names, sizes in MESHES.values():
                for seq_shard in (False, True):
                    want = jax_cache_spec(jcfg, FakeMesh(names, sizes), path,
                                          ref[path].shape, seq_shard)
                    got = cache_spec(cfg, MeshShape(names, sizes), path,
                                     tuple(leaf.shape), seq_shard)
                    assert _norm(got) == _norm(want), (path, sizes, seq_shard)
    assert ran or not jcfg.has_decode or jcfg.family == "encdec"


def _same_stand_in(port, ref):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _same_stand_in(port[k], ref[k])
        return
    assert port.device.type == "meta"
    assert tuple(port.shape) == tuple(ref.shape)
    assert str(port.dtype).split(".")[-1] == str(ref.dtype)


@pytest.mark.parametrize("shape", list(JS.SHAPES))
@pytest.mark.parametrize("arch", jax_archs())
def test_shape_stand_ins_match_the_reference(arch, shape):
    cfg, jcfg = get(arch), jax_get(arch)
    sp, jsp = S.SHAPES[shape], JS.SHAPES[shape]
    assert (sp.name, sp.seq, sp.batch, sp.kind) == (jsp.name, jsp.seq,
                                                    jsp.batch, jsp.kind)
    assert S.shape_runs(cfg, sp) == JS.shape_runs(jcfg, jsp)
    _same_stand_in(S.batch_specs(cfg, sp), JS.batch_specs(jcfg, jsp))
    _same_stand_in(S.prefill_token_specs(cfg, sp),
                   JS.prefill_token_specs(jcfg, jsp))
    _same_stand_in(S.decode_token_specs(cfg, sp),
                   JS.decode_token_specs(jcfg, jsp))
    _same_stand_in(S.decode_extra_specs(cfg, sp),
                   JS.decode_extra_specs(jcfg, jsp))
    assert S.TRAIN_MICROBATCHES == JS.TRAIN_MICROBATCHES
    assert S.WHISPER_DEC_FRAC == JS.WHISPER_DEC_FRAC


def test_an_uneven_shard_raises():
    sh = Sharding(MeshShape(("data", "model"), (2, 2)), ("model", None))
    with pytest.raises(ValueError, match="evenly"):
        sh.slices((3, 4), {"data": 0, "model": 1})
    with pytest.raises(ValueError, match="not in the mesh"):
        Sharding(MeshShape(("data", "model"), (2, 2)), ("pod",))


def test_a_tuple_entry_splits_over_the_product_major_first():
    sh = Sharding(MeshShape(("data", "model"), (2, 4)), (("data", "model"),))
    got = {(d, m): sh.slices((16,), {"data": d, "model": m})[0]
           for d in range(2) for m in range(4)}
    assert got[(0, 0)] == slice(0, 2) and got[(0, 3)] == slice(6, 8)
    assert got[(1, 0)] == slice(8, 10) and got[(1, 3)] == slice(14, 16)


def test_spec_trees_match_the_per_leaf_rules():
    """``make_param_specs`` is ``param_spec`` over the tree's paths."""
    from repro_torch.launch.sharding import make_param_specs
    cfg = get("deepseek-moe-16b")
    shapes = family_module(cfg).init_params(cfg, torch.Generator(),
                                            device="meta")
    mesh = make_production_mesh()
    specs = make_param_specs(cfg, shapes, mesh, "train")
    for path, leaf in _port_leaves(shapes).items():
        node = specs
        for k in path.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        assert node == param_spec(cfg, mesh, path, tuple(leaf.shape))


# ---------------------------------------------------------------------------
# 4 gloo ranks against the reference's devices_indices_map
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    import json
    return json.loads(REF_PATH.read_text())["sharding"]


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    out = run_ranks(4, [{"name": "sharding", "mesh": ref["mesh"],
                         "batch": ref["batch"], "seq": ref["seq"]}],
                    tmp_path_factory.mktemp("sharding"))
    return [meta for meta, _ in out["sharding"]]


@pytest.mark.parametrize("arch", jax_archs())
def test_gloo_rank_slices_match_the_reference_devices(arch, ref, ranks):
    want = ref["configs"][arch]
    coords = set()
    for meta in ranks:
        c = meta["coord"]
        coords.add((c["data"], c["model"]))
        at = c["data"] * ref["mesh"][1] + c["model"]
        got = meta["configs"][arch]
        assert set(got) == set(want)
        for group, leaves in want.items():
            # the reference's cache keeps its index as an array, the
            # port's as host ints: only tensors have slices
            tensors = {p for p in leaves if not p.endswith("index")}
            assert set(got[group]) == tensors, group
            for path in tensors:
                assert got[group][path] == leaves[path][at], (group, path, c)
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_shard_then_gather_is_the_identity(ranks):
    assert [m["round_trip_differing"] for m in ranks] == [0, 0, 0, 0]
