"""Phase 12's reference (``tests/data/torch_variants_ref.json``, written by
``tests/_torch_variants_ref.py`` from the JAX package) and the port's
side of its runs (``repro_torch.variants_check``).

``build_reference`` at the reduced size gives the committed full-size
file's layout, and the port's CPU runs of the same reduced models (the
kernels' plain versions) agree with it at the smoke's tolerances:
Gemma-3 under ``attn_block_local`` on LightPE-1 codes in bfloat16 (0.1,
the serving runs' bfloat16 tolerance, the reference's codes pinned at
log2 ties), SmolLM under ``attn_flash`` (float32 2e-3 and bfloat16 0.1,
the serving runs'), its AdamW steps under ``attn_flash`` and under
``compute_dtype(bfloat16)`` (1e-2 relative, phase 10's) and Whisper's
greedy runs (the serving runs' 0.1 in bfloat16, 2e-3 for LightPE-1 in
float32).
"""

import json

import numpy as np
import pytest
import torch

from repro_torch import convert, train_check as tc, variants_check as vc
from repro_torch.configs import get, reduced
from repro_torch.models import encdec, transformer as T
from repro_torch.serve import check, quantize_params

from _torch_variants_ref import REF_PATH, build_reference

GEMMA_TOL = 0.1
FLASH_TOL = {"float32": 2e-3, "bfloat16": 0.1}
TRAIN_RTOL = 1e-2
WHISPER_TOL = {"fp32/dense": 0.1, "lightpe1": 0.1, "int8": 0.1,
               "lightpe1/float32": 2e-3}


@pytest.fixture(scope="module")
def small():
    return build_reference("reduced")


def _keys(tree, depth=2):
    if not isinstance(tree, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in tree.items()}


def test_reference_format_is_stable(small):
    """The committed full-size file and the reduced build have one layout;
    the full file is at full width with the cut depths it states, on the
    run shapes of ``variants_check``."""
    ref = json.loads(REF_PATH.read_text())
    assert ref["size"] == "full"
    assert "--xla_allow_excess_precision=false" in ref["xla_flags"]
    assert _keys(small, 1) == _keys(ref, 1)
    for part in ("gemma_block_local", "smollm_flash", "smollm_train",
                 "whisper"):
        assert small[part].keys() == ref[part].keys(), part
    g = ref["gemma_block_local"]
    assert g["n_layers"] == vc.GEMMA_REF_LAYERS
    assert g["shape"] == list(vc.GEMMA_TOKENS)
    assert len(g["run"]["tokens"]) == int(np.prod(vc.GEMMA_TOKENS))
    assert ref["smollm_flash"]["shape"] == list(vc.FLASH_TOKENS)
    w = ref["whisper"]
    full = get(vc.WHISPER_CONFIG)
    assert (w["enc_layers"], w["dec_layers"]) == (vc.WHISPER_REF_LAYERS,) * 2
    assert (w["batch"], w["frames"], w["prompt"], w["max_len"],
            w["max_new"]) == (check.WHISPER_BATCH, check.WHISPER_FRAMES,
                              check.WHISPER_PROMPT, check.WHISPER_MAX_LEN,
                              vc.WHISPER_MAX_NEW)
    assert full.d_model == 1024 and sorted(w["modes"]) == sorted(
        vc.whisper_mode_key(*m) for m in vc.WHISPER_MODES)
    for mode in w["modes"].values():
        assert [len(t) for t in mode["run"]["tokens"]] == \
            [vc.WHISPER_MAX_NEW] * check.WHISPER_BATCH


def test_gemma_block_local_matches_reference(small):
    part = small["gemma_block_local"]
    cfg = reduced(vc.GEMMA_CONFIG)
    packed = quantize_params(convert.params_from_numpy(
        T.numpy_params(cfg, vc.PARAM_SEED), "cpu"), "lightpe1",
        min_size=part["min_size"])
    check.pin_pow2_codes(packed, part["pow2_ties"])
    got = vc.gemma_forward(cfg, packed, part["shape"], "cpu")
    res = vc.compare_forward(got, part["run"], GEMMA_TOL)
    assert res["ok"], res
    base = vc.gemma_forward(cfg, packed, part["shape"], "cpu",
                            block_local=False)
    assert vc.compare_forward(base, got, GEMMA_TOL)["ok"]


@pytest.mark.parametrize("dtype", vc.FLASH_DTYPES)
def test_flash_forward_matches_reference(small, dtype):
    part = small["smollm_flash"]
    cfg = reduced(vc.FLASH_CONFIG)
    params = convert.params_from_numpy(T.numpy_params(cfg, vc.PARAM_SEED),
                                       "cpu")
    got = vc.flash_forward(cfg, params, part["shape"], dtype, "cpu")
    res = vc.compare_forward(got, part["runs"][dtype], FLASH_TOL[dtype])
    assert res["ok"], res


@pytest.mark.parametrize("kind,pe", [("flash", "fp32"), ("flash", "lightpe1"),
                                     ("mixed", "lightpe1")])
def test_train_steps_match_reference(small, kind, pe):
    cfg = reduced(vc.FLASH_CONFIG)
    if kind == "flash":
        rows = tc.run_lm(cfg.replace(attn_flash=True), pe, "cpu")
    else:
        rows = tc.run_lm(cfg, pe, "cpu", compute_dtype=torch.bfloat16)
    res = tc.compare(rows, small["smollm_train"][kind][pe], TRAIN_RTOL)
    assert res["ok"], res


def test_whisper_runs_match_reference(small):
    part = small["whisper"]
    cfg = reduced(vc.WHISPER_CONFIG)
    dense = convert.params_from_numpy(encdec.numpy_params(cfg, vc.PARAM_SEED),
                                      "cpu")
    packs = {pe: quantize_params(dense, pe, min_size=part["min_size"])
             for pe in ("lightpe1", "int8")}
    check.pin_pow2_codes(packs["lightpe1"], part["pow2_ties"])
    for key, mode in part["modes"].items():
        params = packs[mode["pe_type"]] if mode["packed"] else dense
        got = vc.whisper_run(cfg, params, mode, part, "cpu")
        problems, _ = check.compare(got, mode["run"], WHISPER_TOL[key])
        assert not problems, (key, problems)
