"""The port's perf runner (``repro_torch.launch.perf``) against the
reference's (``repro.launch.perf``, read through ``ast``: importing it
would set ``XLA_FLAGS`` to 512 host devices in this process).

``CELLS`` equal the reference's, variant for variant; a packed variant
counts its products on ``quant_matmul``; the fp8-cache variants count on
the kernel (float8_e4m3fn K/V), their cache half a bfloat16 one's bytes,
and hold the reference's FLOPs and argument bytes (``fp8`` of
``tests/data/torch_dryrun_ref.json``, the reference's own
``build_variant`` compiled on a (1, 1) mesh).  Qwen3-32B's
``decode_32k`` at full size on a (1, 1) ``meta`` mesh, and the reduced
config at the dry run's reduced serving shapes.
"""

import ast
import json
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.configs import reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch import perf as P
from repro_torch.launch import shapes as SH

from _torch_dryrun_ref import FP8_VARIANTS, REDUCED_SHAPES, REF_PATH

REF = Path(__file__).resolve().parents[1] / "src" / "repro" / "launch" \
    / "perf.py"
ONE = ((1, 1), ("data", "model"))


@pytest.fixture(autouse=True)
def _no_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def fp8_ref():
    return json.loads(REF_PATH.read_text())["fp8"]


def _held(cfg, shape, r, want):
    """FLOPs as the dry run's (1, 1) cells are held (both sides without
    their matrix-vector part) and argument bytes exact."""
    assert D.reference_flops(cfg, shape, r) == \
        want["flops"] - want["matvec_flops"]
    assert r["matvec_flops"] >= want["matvec_flops"]
    assert r["memory"]["argument_size_in_bytes"] == \
        want["memory"]["argument_size_in_bytes"]


def _reference_cells():
    tree = ast.parse(REF.read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "CELLS" for t in n.targets))
    # literals and dict(...) calls only
    return eval(compile(ast.Expression(node.value), str(REF), "eval"),
                {"__builtins__": {}, "dict": dict})


def test_cells_are_the_references():
    assert P.CELLS == _reference_cells()


def _variant(name):
    (arch, shape), variants = next((k, v) for k, v in P.CELLS.items()
                                   if k == ("qwen3-32b", "decode_32k"))
    vname, overrides, options = next(v for v in variants if v[0] == name)
    return arch, shape, vname, overrides, options


@pytest.mark.parametrize("name,bf16_name", [
    ("v1b_f8_cache_seqshard", "v0_native_dtype_attn"),
    ("v3_f8_cache", "v2_int4_weights")])
def test_fp8_cache_variants_count_ok(name, bf16_name, tmp_path, monkeypatch,
                                    fp8_ref):
    """The fp8 cache variants count on ``meta`` like the others (the
    kernel takes float8_e4m3fn K and V) and hold the reference's counts,
    and their cache is half the bytes of the same variant's bfloat16
    cache: the argument bytes drop by one byte a cache element, all else
    equal."""
    monkeypatch.setattr(P, "RESULTS_DIR", tmp_path)
    arch, shape, vname, overrides, options = _variant(name)
    r = P.run_variant(arch, shape, vname, overrides, options,
                      mesh_shape=ONE)
    assert r["status"] == "ok", r.get("error")
    assert r["launches"]["flash_attention"] == 64
    saved = json.loads((tmp_path / f"{arch}__{shape}__{vname}.json")
                       .read_text())
    assert saved["status"] == "ok" and saved["options"] == options
    cfg = P.get_cfg(arch).replace(**overrides)
    sh = SH.SHAPES[shape]
    _held(cfg, sh, r, fp8_ref[name]["full"])
    bf16 = P.run_variant(*_variant(bf16_name), mesh_shape=ONE)
    kv = cfg.kv_replicate_to or cfg.kv_heads
    elems = 2 * cfg.n_layers * sh.batch * sh.seq * kv * cfg.head_dim
    args = "argument_size_in_bytes"
    assert bf16["memory"][args] - r["memory"][args] == elems


@pytest.mark.parametrize("shape", [s for s in REDUCED_SHAPES
                                   if s[3] != "train"],
                         ids=lambda s: s[0])
def test_fp8_cache_variants_at_reduced_shapes(shape, tmp_path, monkeypatch,
                                              fp8_ref):
    """The reduced Qwen3-32B's fp8-cache variant ``v1b`` at the dry run's
    reduced prefill and decode shapes holds the reference's FLOPs and
    argument bytes (``v3``'s 16 replicated KV heads exceed the reduced
    config's 4 query heads: the reference cannot build it)."""
    name = FP8_VARIANTS[0]
    assert all(r["status"] == "error"
               for r in fp8_ref[FP8_VARIANTS[1]]["reduced"].values())
    monkeypatch.setattr(P, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(P, "get_cfg", reduced)
    sname, seq, batch, kind = shape
    monkeypatch.setitem(SH.SHAPES, sname,
                        SH.ShapeSpec(sname, seq, batch, kind))
    arch, _, vname, overrides, options = _variant(name)
    r = P.run_variant(arch, sname, vname, overrides, options,
                      mesh_shape=ONE)
    assert r["status"] == "ok", r.get("error")
    _held(reduced(arch).replace(**overrides), SH.SHAPES[sname], r,
          fp8_ref[name]["reduced"][sname])


def test_packed_weights_count_on_quant_matmul(monkeypatch, tmp_path):
    monkeypatch.setattr(P, "RESULTS_DIR", tmp_path)
    dense = P.run_variant(*_variant("v1_kv_pad_tp"), mesh_shape=ONE)
    packed = P.run_variant(*_variant("v2_int4_weights"), mesh_shape=ONE)
    assert dense["status"] == packed["status"] == "ok"
    assert "quant_matmul" not in dense["launches"]
    # every projection of the 64 layers, and the untied output head
    assert packed["launches"]["quant_matmul"] == 64 * 7 + 1
    # the same products; int4 codes move an eighth of float32's bytes
    assert packed["flops"] == dense["flops"]
    assert packed["memory"]["argument_size_in_bytes"] < \
        dense["memory"]["argument_size_in_bytes"]
