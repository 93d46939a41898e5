"""Hold the port's perf variants and its encoder-decoder model to the JAX
package's.

``chip_smoke.py`` (phase 12) and ``tests/_torch_variants_ref.py``, which
writes ``tests/data/torch_variants_ref.json`` from the JAX package, run
the same inputs through the same entry points:

* Gemma-3-1B under ``attn_block_local``: ``forward`` on ``GEMMA_TOKENS``
  numpy tokens, LightPE-1 packed codes, bfloat16, its depth cut to
  ``GEMMA_REF_LAYERS`` for the reference (one 5 local + 1 global period
  and 2 leftover local layers: both parts of the grouped backbone);
* SmolLM-135M under ``attn_flash``: ``forward`` on ``FLASH_TOKENS``
  numpy tokens (its context length) on dense weights, float32 and
  bfloat16; ``train_check``'s ``LM_STEPS`` AdamW steps under
  ``attn_flash`` (FP32, LightPE-1) and under ``compute_dtype(bfloat16)``
  (LightPE-1, the ``mixed_precision`` variant);
* Whisper-medium: ``serve.check.record_encdec``'s greedy run on the
  frontend stub's frames, its depth cut to ``WHISPER_REF_LAYERS`` encoder
  and decoder layers for the reference, on dense weights (FP32) and on
  LightPE-1 and INT8 packed codes.

The reference's depth is cut so that a CPU with a few GB of memory
runs it (the widths are full); the card also runs both models at full
depth, held there to the port's own baseline (Gemma-3) and to its launch
counts.

``forward_summary`` keeps, of a forward's logits, each position's argmax,
top-2 margin, top logit and first ``check.SLICE`` logits;
``compare_forward`` holds one summary to another.
"""

from __future__ import annotations

import numpy as np

from repro_torch.serve import check

PARAM_SEED = 0
TOKEN_SEED = 12
GEMMA_CONFIG = "gemma3-1b"
GEMMA_TOKENS = (2, 1024)
GEMMA_REF_LAYERS = 8
FLASH_CONFIG = "smollm-135m"
FLASH_TOKENS = (4, 2048)
FLASH_DTYPES = ("float32", "bfloat16")
FLASH_TRAIN_PE_TYPES = ("fp32", "lightpe1")
MIXED_PE_TYPE = "lightpe1"
WHISPER_CONFIG = "whisper-medium"
WHISPER_REF_LAYERS = 4
WHISPER_MAX_NEW = check.MAX_NEW
# (pe_type, dtype, packed) of the Whisper runs
WHISPER_MODES = (("fp32", "bfloat16", False), ("lightpe1", "bfloat16", True),
                 ("int8", "bfloat16", True), ("lightpe1", "float32", True))
# reduced sizes, for the CPU test of the reference's format
REDUCED = dict(gemma_tokens=(2, 64), flash_tokens=(2, 32),
               whisper=dict(batch=2, frames=24, prompt=4, max_len=16,
                            max_new=4))


def tokens(vocab: int, shape, seed: int = TOKEN_SEED) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def whisper_mode_key(pe: str, dtype: str, packed: bool) -> str:
    return check.mode_key(pe, dtype) + ("" if packed else "/dense")


def forward_summary(logits: np.ndarray) -> dict:
    """(B, S, V) float32 logits -> per position (flattened B x S): argmax
    token, top-2 margin, top logit, the first ``check.SLICE`` logits."""
    flat = np.asarray(logits, np.float32).reshape(-1, logits.shape[-1])
    top = np.argmax(flat, axis=-1)
    top_val = flat[np.arange(len(flat)), top]
    rest = flat.copy()
    rest[np.arange(len(flat)), top] = -np.inf
    return {"tokens": top.tolist(),
            "margins": (top_val - rest.max(axis=-1)).tolist(),
            "top_logits": top_val.tolist(),
            "logits": flat[:, :check.SLICE].tolist()}


def compare_forward(got: dict, want: dict, tol: float) -> dict:
    """The largest difference of the kept logits over the positions (the
    top logit where both chose the same token), and the positions whose
    token differs: allowed only where the reference's top-2 margin is
    below ``tol`` (a near tie).  {ok, max_abs_err, ties, positions}."""
    g_tok, w_tok = np.array(got["tokens"]), np.array(want["tokens"])
    same = g_tok == w_tok
    err = np.abs(np.array(got["logits"]) - np.array(want["logits"])).max(
        initial=0.0)
    top = np.abs(np.array(got["top_logits"]) - np.array(want["top_logits"]))
    err = max(float(err), float(top[same].max(initial=0.0)))
    margins = np.array(want["margins"])
    bad = int(np.sum(~same & (margins >= tol)))
    return dict(ok=bool(err <= tol and bad == 0 and len(g_tok) == len(w_tok)),
                max_abs_err=err, ties=int(np.sum(~same)), positions=len(g_tok))


# ---------------------------------------------------------------------------
# the port's side of the runs
# ---------------------------------------------------------------------------

def gemma_forward(cfg, packed, shape, device, block_local: bool = True):
    """The summary of ``transformer.forward`` of ``cfg`` (under
    ``attn_block_local`` or the baseline) on ``packed`` params and the
    run's tokens."""
    import torch
    from repro_torch.models import transformer as T
    toks = torch.as_tensor(tokens(cfg.vocab, shape), device=device)
    with torch.no_grad():
        logits = T.forward(packed, toks,
                           cfg.replace(attn_block_local=block_local))
    return forward_summary(logits.float().cpu().numpy())


def flash_forward(cfg, params, shape, dtype: str, device):
    """The summary of ``forward`` under ``attn_flash`` in ``dtype``."""
    import torch
    from repro_torch.models import transformer as T
    toks = torch.as_tensor(tokens(cfg.vocab, shape), device=device)
    with torch.no_grad():
        logits = T.forward(params, toks,
                           cfg.replace(attn_flash=True, dtype=dtype))
    return forward_summary(logits.float().cpu().numpy())


def whisper_run(cfg, params, mode: dict, ref: dict, device) -> dict:
    """``check.record_encdec``'s greedy run of the reference's Whisper
    mode (``ref``: the reference file's ``whisper`` part) on ``params``
    (dense, or packed for a packed mode)."""
    import torch
    from repro_torch.models import encdec
    run_cfg = cfg.replace(pe_type="fp32" if mode["packed"]
                          else mode["pe_type"], dtype=mode["dtype"])
    inputs = check.whisper_inputs(cfg.d_model, cfg.vocab, ref["batch"],
                                  ref["frames"], ref["prompt"])
    batch = {"frames": torch.as_tensor(inputs["frames"], device=device),
             "tokens": torch.as_tensor(inputs["tokens"], device=device)}
    cache = encdec.init_cache(run_cfg, ref["batch"], ref["max_len"],
                              torch.float32, device=device)
    with torch.no_grad():
        return check.record_encdec(
            encdec, params, run_cfg, batch, cache, ref["max_new"],
            lambda t: t.float().cpu().numpy(),
            lambda t: torch.as_tensor(t, device=device))
