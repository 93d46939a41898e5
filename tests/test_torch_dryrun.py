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
  rank equal the reference's ``memory_analysis`` on 4 devices, its FLOPs
  a rank are at most ``SPLIT_FLOPS`` x the reference's (the
  tensor-parallel split: each rank computes its heads, columns,
  vocabulary rows and experts; GSPMD partitions some of what the split
  leaves whole, as SmolLM's 3 heads, and the dp ranks' MoE buffers hold
  the global capacity), rank 0 and rank 3 count alike, and the fake
  group's collectives equal those of a real 4-rank gloo run.
* Qwen3-32B at pod16x16 on ``meta``: ``train_4k`` below ``TRAIN_4K_FLOPS``
  a device (64 equal layers: counted at 1 and 2 layers and taken to 64,
  as each layer and microbatch counts alike; 1.782e16 before the split)
  and ``decode_32k`` below ``DECODE_32K_TEMP`` bytes of temporaries
  (79.4 GB of them before, most of them the bfloat16 params gathered
  over ``model``), its cache split over the sequence (8 KV heads do not
  divide 16): each rank attends with every query head (gathered over the
  split) over its 2,048 rows of every KV head, and holds 1/16 of the
  dp-only cache's bytes; the split families' cells carry no ``NOTE_TP``
  and no ``NOTE_SERVE``.
* A reduced serving cell on the 2 x 2 mesh whose cache splits its
  sequence (over ``model``, and over ("data", "model") at batch 1): the
  argument bytes a rank equal the reference's ``memory_analysis``
  (``tests/data/torch_seqshard_ref.json``).
* At pod16x16 a leaf sharded over ``data`` is all-gathered over the
  ``data`` group alone: its own bytes, not 16 x.

Counts are exact.
"""

import json
import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get, list_archs, reduced
from repro_torch.kernels.flash_attention import flash_attention_gqa
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import shapes as SH
from repro_torch.launch.sharding import Sharding
from repro_torch.models import family_module
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

from _torch_dist import run_ranks
from _torch_dryrun_ref import (MESH_CELLS, MESH_SHAPE, REDUCED_SHAPES,
                               REF_PATH, mesh_config)
from _torch_seqshard_ref import DRYRUN_CELLS as SEQ_CELLS
from _torch_seqshard_ref import DRYRUN_MESH as SEQ_MESH
from _torch_seqshard_ref import REF_PATH as SEQ_REF_PATH

ONE = ((1, 1), ("data", "model"))
SPLIT_FLOPS = 1.10
TRAIN_4K_FLOPS = 2.0e15
DECODE_32K_TEMP = 20e9


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
    assert r0["flops"] <= SPLIT_FLOPS * want["flops"], (r0["flops"],
                                                        want["flops"])
    for key in ("flops", "bytes_out", "collectives", "memory", "launches"):
        assert r0[key] == r3[key], key


@pytest.mark.parametrize("i", range(len(SEQ_CELLS)))
def test_a_seq_sharded_serving_cell_on_2x2_holds_the_reference(i):
    """The reference's ``memory_analysis`` argument bytes a device of a
    serving cell whose cache splits its sequence (``SEQ_CELLS``), rank 0
    and rank 3 alike; each rank attends over its slice (the slice forms
    launched, no whole-key launch)."""
    arch, (name, seq, batch, kind) = SEQ_CELLS[i]
    want = json.loads(SEQ_REF_PATH.read_text())["dryrun"]["cells"][arch][
        name]
    assert want["status"] == "ok"
    rs = [D.run_cell(arch, name, save=False, verbose=False,
                     mesh_shape=(SEQ_MESH, ("data", "model")),
                     cfg=reduced(arch),
                     shape=SH.ShapeSpec(name, seq, batch, kind), rank=rank)
          for rank in (0, 3)]
    for r in rs:
        assert r["status"] == "ok", r.get("error")
        assert D.NOTE_SERVE not in r["notes"]
        assert r["memory"]["argument_size_in_bytes"] == \
            want["memory"]["argument_size_in_bytes"]
        assert r["launches"] == {"flash_attention":
                                 2 * reduced(arch).n_layers}
    for key in ("flops", "collectives", "memory", "launches"):
        assert rs[0][key] == rs[1][key], key


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
    # one KV head does not divide 16: the bfloat16 cache splits its
    # sequence, and each layer attends in a stats and a pass-2 launch
    assert r["fits_80gb"] and r["launches"] == {"flash_attention": 2 * 26}
    assert r["collectives"]["all-gather"] > 0


def test_qwen3_32b_at_pod16x16_splits_its_products():
    """A device's ``train_4k`` FLOPs and ``decode_32k`` temporaries under
    the split (module docstring)."""
    cfg = get("qwen3-32b")
    flops = []
    for n in (1, 2):
        r = D.run_cell("qwen3-32b", "train_4k", save=False, verbose=False,
                       cfg=cfg.replace(n_layers=n))
        assert r["status"] == "ok", r.get("error")
        assert D.NOTE_TP not in r["notes"] and D.NOTE_SPLIT in r["notes"]
        flops.append(r["flops"])
    per_layer = flops[1] - flops[0]
    assert per_layer > 0
    assert flops[0] + (cfg.n_layers - 1) * per_layer < TRAIN_4K_FLOPS

    views = []
    seq_attention = L.seq_attention

    def attend(q, k, v, *args, **kwargs):
        views.append((q.shape[2], k.shape[1], k.shape[2]))
        return seq_attention(q, k, v, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "seq_attention", attend)
        r = D.run_cell("qwen3-32b", "decode_32k", save=False, verbose=False)
    assert r["status"] == "ok", r.get("error")
    assert r["memory"]["temp_size_in_bytes"] < DECODE_32K_TEMP
    # 8 KV heads do not divide 16: the cache splits its sequence, and each
    # rank's q heads, gathered, read its 32,768 / 16 rows of every KV head
    assert D.NOTE_SERVE not in r["notes"] and D.NOTE_TP not in r["notes"]
    assert views == [(cfg.n_heads, 32768 // 16, cfg.kv_heads)] * cfg.n_layers
    assert r["launches"] == {"flash_attention": 2 * cfg.n_layers}


@pytest.mark.parametrize("arch,layers", [("rwkv6-1.6b", 2),
                                         ("zamba2-7b", 7)])
def test_ssm_and_hybrid_training_at_pod16x16_split_their_layers(
        arch, layers, monkeypatch):
    """``train_4k`` as rank 0 of pod16x16 at a cut depth (RWKV6-1.6B 2 of
    24 layers; Zamba2-7B a group of 6 Mamba2 blocks, the shared block and
    a tail block): the split at least 8 x fewer FLOPs a device than the
    same step with every layer whole (the module keeping no shard, as
    before the split), and noted as the split."""
    cfg = get(arch).replace(n_layers=layers)
    split = D.run_cell(arch, "train_4k", save=False, verbose=False,
                       cfg=cfg)
    assert split["status"] == "ok", split.get("error")
    assert split["notes"] == [D.NOTE_SPLIT, D.NOTE_META]
    monkeypatch.setattr(family_module(cfg), "keeps_model_shard",
                        lambda cfg, path, model=0: False)
    whole = D.run_cell(arch, "train_4k", save=False, verbose=False,
                       cfg=cfg)
    assert whole["status"] == "ok", whole.get("error")
    assert D.NOTE_TP in whole["notes"]
    assert whole["flops"] >= 8 * split["flops"], (whole["flops"],
                                                  split["flops"])


def test_ssm_and_hybrid_serving_at_pod16x16_split_their_caches():
    """Zamba2-7B's ``long_500k`` fits 80 GB at pod16x16 (its shared
    attention's KV cache split over its 32 heads, 2 a device: 97.9 GB of
    arguments before the split), ``decode_32k`` holds under 5 GB of
    arguments, and RWKV6-1.6B's ``prefill_32k`` fits (81.3 GB of
    temporaries before)."""
    for arch, shape, most in (("zamba2-7b", "long_500k", 8e9),
                              ("zamba2-7b", "decode_32k", 5e9),
                              ("rwkv6-1.6b", "prefill_32k", 1e9)):
        r = D.run_cell(arch, shape, save=False, verbose=False)
        assert r["status"] == "ok", r.get("error")
        assert r["fits_80gb"] and r["notes"] == [D.NOTE_SPLIT, D.NOTE_META]
        assert r["memory"]["argument_size_in_bytes"] < most, (arch, shape)


def test_serving_cells_note_only_what_they_leave_out():
    """Neither the head-split cache of ``kv_replicate_to=16`` nor the
    sequence-split one of 8 KV heads carries ``NOTE_SERVE``, and the
    latter's cache bytes a device are 1/16 of the dp-only layout's; the
    SSM and hybrid families split (``NOTE_SPLIT``), and the one family
    the split does not take, Whisper's, keeps ``NOTE_TP``."""
    mesh = D.start_mesh(*D.MESHES["pod16x16"])
    decode = SH.SHAPES["decode_32k"]
    assert D.NOTE_SERVE not in D.cell_notes(
        get("qwen3-32b").replace(kv_replicate_to=16), decode, mesh)
    for arch in ("qwen3-32b", "gemma2-9b", "qwen2-vl-72b"):
        cfg = get(arch)
        assert D.seq_sharded(cfg, mesh)
        assert D.NOTE_SERVE not in D.cell_notes(cfg, decode, mesh)
        shape = (cfg.n_layers, decode.batch, decode.seq, cfg.kv_heads,
                 cfg.head_dim)
        spec = D.cache_spec(cfg, mesh, "scan/k", shape, True)
        seq = Sharding(mesh, spec).local_shape(shape)
        dp = Sharding(mesh, D._dp_only(spec, ("data",))).local_shape(shape)
        assert spec[2] == "model" and 16 * math.prod(seq) == math.prod(dp)
    for arch in ("rwkv6-1.6b", "zamba2-7b"):
        for shape in ("train_4k", "decode_32k"):
            notes = D.cell_notes(get(arch), SH.SHAPES[shape], mesh)
            assert notes == [D.NOTE_SPLIT]
    notes = D.cell_notes(get("whisper-medium"), SH.SHAPES["train_4k"], mesh)
    assert D.NOTE_TP in notes and D.NOTE_SPLIT not in notes
