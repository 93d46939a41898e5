"""The port's perf runner (``repro_torch.launch.perf``) against the
reference's (``repro.launch.perf``, read through ``ast``: importing it
would set ``XLA_FLAGS`` to 512 host devices in this process).

``CELLS`` equal the reference's, variant for variant; a packed variant
counts its products on ``quant_matmul``; the fp8-cache variants are
recorded as errors with the kernel's own refusal (``flash_attention``
takes float32 or bfloat16 K/V), not faked.  Qwen3-32B's ``decode_32k``
at full size on a (1, 1) ``meta`` mesh.
"""

import ast
import json
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.launch import perf as P

REF = Path(__file__).resolve().parents[1] / "src" / "repro" / "launch" \
    / "perf.py"
ONE = ((1, 1), ("data", "model"))


@pytest.fixture(autouse=True)
def _no_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


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


@pytest.mark.parametrize("name", ["v1b_f8_cache_seqshard", "v3_f8_cache"])
def test_fp8_cache_variants_are_refused_by_the_kernel(name, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(P, "RESULTS_DIR", tmp_path)
    arch, shape, vname, overrides, options = _variant(name)
    r = P.run_variant(arch, shape, vname, overrides, options,
                      mesh_shape=ONE)
    assert r["status"] == "error"
    assert r["error"] == (
        "ValueError: flash attention takes float32 or bfloat16 q and k, v "
        "of one type, float32 or bfloat16, got torch.float32, "
        "torch.float8_e4m3fn, torch.float8_e4m3fn")
    saved = json.loads((tmp_path / f"{arch}__{shape}__{vname}.json")
                       .read_text())
    assert saved["status"] == "error" and saved["options"] == options


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
