"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``tests/data/torch_dryrun_ref.json``, written by
``tests/_torch_dryrun_ref.py``: the reference's ``build_cell`` compiled,
its HLO counted by ``hlo_analysis.analyze``).

* Every reduced config x train / prefill / decode (batch 2 x 64) and
  decode at batch 1 on a (1, 1) mesh: FLOPs and argument bytes equal the
  reference's.  A cell is
  counted on ``meta`` where the card's kernels take it, else on CPU
  tensors through the kernels' plain versions, and the kernel's refusal
  is asserted on ``meta`` (the reduced head_dim 16 / 32 is no backward
  instance; Gemma's windows take no backward).  In the chunk-scan
  families' training the reference counts one product more a layer and
  microbatch (``dryrun.scan_state_grad_flops``: XLA's scan takes the
  first chunk's zero state's gradient, autograd skips it); at batch 1
  it leaves out most matrix-vector products (XLA fuses them into loops,
  whose bodies its count does not read), so both sides are compared
  without their matrix-vector part (the port's ``matvec_flops``, the
  reference's ``matvec_flops`` from its HLO), and the port's part must
  hold the reference's.  ``dryrun.reference_flops`` applies both.
* Two full-size cells (SmolLM-135M ``train_4k``, Gemma-3-1B
  ``decode_32k``) on ``meta``.
* A 2 x 2 mesh (reduced, head_dim 64, batch 4 x 64): the argument bytes a
  rank equal the reference's ``memory_analysis`` on 4 devices, rank 0
  and rank 3 count alike, and the fake group's collectives equal those
  of a real 4-rank gloo run.
* At pod16x16 a leaf sharded over ``data`` is all-gathered over the
  ``data`` group alone: its own bytes, not 16 x.

Counts are exact.
"""

import json

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get, list_archs, reduced
from repro_torch.kernels.flash_attention import flash_attention_gqa
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import shapes as SH
from repro_torch.launch.sharding import Sharding

from _torch_dist import run_ranks
from _torch_dryrun_ref import (MESH_CELLS, MESH_SHAPE, REDUCED_SHAPES,
                               REF_PATH, mesh_config)

ONE = ((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def ref():
    return json.loads(REF_PATH.read_text())


@pytest.fixture(autouse=True)
def _no_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _held(cfg, shape, r, want):
    """The port's FLOPs equal the reference's, both without their
    matrix-vector part; the port's part holds the reference's."""
    assert D.reference_flops(cfg, shape, r) == \
        want["flops"] - want["matvec_flops"]
    assert r["matvec_flops"] >= want["matvec_flops"]


@pytest.mark.parametrize("arch", list_archs())
def test_reduced_cells_count_the_references_flops_and_arguments(arch, ref):
    """Every reduced cell on ``meta``, the card's kernels' checks
    included: the training cells of Gemma-2 / Gemma-3 (windows, soft-caps,
    head_dim 32), Zamba2 and Whisper (head_dim 16) too, since the
    backward takes them."""
    cfg = reduced(arch)
    for name, seq, batch, kind in REDUCED_SHAPES:
        shape = SH.ShapeSpec(name, seq, batch, kind)
        r = D.run_cell(arch, name, save=False, verbose=False, mesh_shape=ONE,
                       cfg=cfg, shape=shape)
        assert r["status"] == "ok", r.get("error")
        want = ref["reduced"][arch][name]
        _held(cfg, shape, r, want)
        # only a batch-1 decode step holds matrix-vector products
        assert (r["matvec_flops"] > 0) == (kind == "decode" and batch == 1)
        assert r["memory"]["argument_size_in_bytes"] == \
            want["memory"]["argument_size_in_bytes"]


@pytest.mark.parametrize("arch,shape_name", [("smollm-135m", "train_4k"),
                                             ("gemma3-1b", "decode_32k")])
def test_full_size_cells_on_meta(arch, shape_name, ref):
    r = D.run_cell(arch, shape_name, save=False, verbose=False,
                   mesh_shape=ONE)
    assert r["status"] == "ok", r.get("error")
    want = ref["full"][arch][shape_name]
    _held(get(arch), SH.SHAPES[shape_name], r, want)
    assert r["flops"] == want["flops"]
    assert r["memory"]["argument_size_in_bytes"] == \
        want["memory"]["argument_size_in_bytes"]
    n = get(arch).n_layers
    if shape_name == "train_4k":
        micro = D.n_micro(get(arch), SH.SHAPES[shape_name], 1)
        # each layer's forward, its recomputation, and its backward
        assert r["launches"] == {"flash_attention": 2 * n * micro,
                                 "flash_attention_backward": n * micro}
    else:
        assert r["launches"] == {"flash_attention": n}


def _mesh_cell(i, rank):
    arch, (name, seq, batch, kind) = MESH_CELLS[i]
    return D.run_cell(arch, name, save=False, verbose=False,
                      mesh_shape=(MESH_SHAPE, ("data", "model")),
                      cfg=mesh_config(arch, reduced),
                      shape=SH.ShapeSpec(name, seq, batch, kind), rank=rank)


@pytest.mark.parametrize("i", range(len(MESH_CELLS)))
def test_a_2x2_mesh_holds_the_references_argument_bytes(i, ref):
    arch, (name, *_) = MESH_CELLS[i]
    r0, r3 = _mesh_cell(i, 0), _mesh_cell(i, 3)
    assert r0["status"] == "ok", r0.get("error")
    want = ref["mesh2x2"]["cells"][arch][name]
    assert r0["memory"]["argument_size_in_bytes"] == \
        want["memory"]["argument_size_in_bytes"]
    for key in ("flops", "bytes_out", "collectives", "memory", "launches"):
        assert r0[key] == r3[key], key


def test_fake_collectives_are_those_of_four_gloo_ranks(tmp_path):
    fake = _mesh_cell(0, 0)
    dist.destroy_process_group()
    out = run_ranks(4, [{"name": "dryrun_cell", "cell": 0,
                         "mesh": list(MESH_SHAPE)}], tmp_path)
    for meta, _ in out["dryrun_cell"]:
        assert meta["collectives"] == fake["collectives"]
        assert meta["flops"] == fake["flops"]
        assert meta["memory"]["argument_size_in_bytes"] == \
            fake["memory"]["argument_size_in_bytes"]


def test_gemma_training_is_refused_with_the_kernels_message():
    """Gemma trains on the card since the backward took windows: the dry
    run counts a windowed training cell on ``meta`` (each layer's forward,
    its recomputation and its backward, as a SmolLM cell of the same
    shape); a window without the causal mask is still refused, with the
    kernels' message."""
    shape = SH.ShapeSpec("train_r", 64, 2, "train")
    for arch in ("gemma3-1b", "smollm-135m"):
        cfg = reduced(arch).replace(head_dim=64)
        r = D.run_cell(arch, "train_r", save=False, verbose=False,
                       mesh_shape=ONE, cfg=cfg, shape=shape)
        assert r["status"] == "ok", r.get("error")
        micro = D.n_micro(cfg, shape, 1)
        assert r["launches"] == {
            "flash_attention": 2 * cfg.n_layers * micro,
            "flash_attention_backward": cfg.n_layers * micro}
    q = torch.empty(1, 4, 2, 64, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="sliding window needs the causal"):
        flash_attention_gqa(q, q, q, causal=False, window=4)


def test_a_data_sharded_leaf_gathers_over_data_alone():
    """pod16x16: the leaf is split 16 ways over ``data``; its all-gather
    runs over the 16 ranks of the data group and moves the leaf's own
    bytes (over all 256 ranks it moved 16 x)."""
    mesh = D.start_mesh(*D.MESHES["pod16x16"])
    sh = Sharding(mesh, ("data", None))
    local = torch.empty(64, 128, device="meta")
    full, rep = OA.analyze(sh.gather, local)
    assert full.shape == (16 * 64, 128)
    assert rep["collectives"] == {"all-gather": 16 * 64 * 128 * 4,
                                  "all-gather_count": 1,
                                  "total": 16 * 64 * 128 * 4}


def test_the_cli_writes_every_cell(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.dryrun``: a cell that runs and one
    the reference skips, recorded as data."""
    monkeypatch.setattr(D, "RESULTS_DIR", tmp_path)
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "smollm-135m", "--shape", "long_500k"])
    assert e.value.code == 0
    r = json.loads((tmp_path / "smollm-135m__long_500k__pod16x16.json")
                   .read_text())
    assert r["status"] == "skipped" and "sub-quadratic" in r["reason"]
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "gemma3-1b", "--shape", "decode_32k"])
    assert e.value.code == 0
    r = json.loads((tmp_path / "gemma3-1b__decode_32k__pod16x16.json")
                   .read_text())
    assert r["status"] == "ok" and r["devices"] == 256
    assert r["fits_80gb"] and r["launches"] == {"flash_attention": 26}
    assert r["collectives"]["all-gather"] > 0
