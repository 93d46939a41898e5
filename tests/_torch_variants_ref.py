"""The JAX package's runs that ``chip_smoke.py`` phase 12 holds the port's
perf variants and Whisper to (``repro_torch.variants_check`` names them):

* Gemma-3-1B at full width, its depth cut to ``GEMMA_REF_LAYERS``, packed
  as LightPE-1 by the JAX package's ``quantize_params``: ``forward`` under
  ``attn_block_local`` on 2 x 1024 tokens in bfloat16, with the JAX
  package's codes at the weights at a log2 tie (``pow2_ties``, pinned by
  the smoke as in phase 11.2);
* SmolLM-135M at full size: ``forward`` under ``attn_flash`` on 4 x 2048
  tokens in float32 and bfloat16; ``train_check``'s AdamW steps under
  ``attn_flash`` (FP32, LightPE-1) and under
  ``repro.models.layers.compute_dtype(bfloat16)`` (LightPE-1), each
  step's loss and gradient norm;
* Whisper-medium at full width, its depth cut to ``WHISPER_REF_LAYERS`` +
  ``WHISPER_REF_LAYERS``: ``serve.check.record_encdec``'s greedy run (4 x
  1500 frames, prompts of 8, 12 new tokens, a 448-row float32 cache) on
  dense weights and on LightPE-1 and INT8 packed codes.

``tests/data/torch_variants_ref.json`` holds the full-size result;
``tests/test_torch_variants.py`` rebuilds it at the reduced size to keep
the format honest and holds the port's CPU runs to it.

  PYTHONPATH=src:tests python tests/_torch_variants_ref.py   # rewrite

Run as a script it turns off XLA's excess precision before JAX starts, so
that bfloat16 is rounded where the model's source rounds it, as the port
rounds it.  At full size it takes a few GB and some minutes of CPU.
"""

import json
import os
import time
from pathlib import Path

import numpy as np

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_variants_ref.json"
NO_EXCESS_PRECISION = "--xla_allow_excess_precision=false"


def _configs(size: str):
    from repro.configs import get, reduced
    from repro_torch import variants_check as vc
    if size == "full":
        return (get(vc.GEMMA_CONFIG).replace(n_layers=vc.GEMMA_REF_LAYERS),
                get(vc.FLASH_CONFIG),
                get(vc.WHISPER_CONFIG).replace(
                    enc_layers=vc.WHISPER_REF_LAYERS,
                    dec_layers=vc.WHISPER_REF_LAYERS))
    return (reduced(vc.GEMMA_CONFIG), reduced(vc.FLASH_CONFIG),
            reduced(vc.WHISPER_CONFIG))


def gemma_block_local(cfg, shape) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as JT
    from repro.serve import quantize_params
    from repro_torch import variants_check as vc
    from repro_torch.models.transformer import numpy_params
    from repro_torch.serve import check
    from _torch_gemma3_ref import pow2_ties

    arrays = numpy_params(cfg, vc.PARAM_SEED)
    packed = quantize_params(jax.tree.map(jnp.asarray, arrays), "lightpe1",
                             min_size=check.MIN_SIZE)
    ties = pow2_ties(arrays, packed)
    del arrays
    toks = vc.tokens(cfg.vocab, shape)
    logits = jax.jit(JT.forward, static_argnums=2)(
        packed, jnp.asarray(toks), cfg.replace(attn_block_local=True))
    return dict(config=cfg.name, n_layers=cfg.n_layers, shape=list(shape),
                min_size=check.MIN_SIZE, pow2_ties=ties,
                run=vc.forward_summary(np.asarray(logits, np.float32)))


def smollm_flash(cfg, shape) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as JT
    from repro_torch import variants_check as vc
    from repro_torch.models.transformer import numpy_params

    params = jax.tree.map(jnp.asarray, numpy_params(cfg, vc.PARAM_SEED))
    toks = jnp.asarray(vc.tokens(cfg.vocab, shape))
    forward = jax.jit(JT.forward, static_argnums=2)
    runs = {}
    for dtype in vc.FLASH_DTYPES:
        logits = forward(params, toks,
                         cfg.replace(attn_flash=True, dtype=dtype))
        runs[dtype] = vc.forward_summary(np.asarray(logits, np.float32))
    return dict(config=cfg.name, shape=list(shape), runs=runs)


def lm_steps(cfg, pe: str, mixed: bool) -> list:
    """``train_check.run_lm``'s steps in the JAX package."""
    import jax
    import jax.numpy as jnp
    from repro.models import family_module
    from repro.models.layers import compute_dtype
    from repro.optim import adamw, warmup_cosine
    from repro.train import TrainState, make_train_step
    from repro_torch import train_check as tc
    from repro_torch.models.transformer import numpy_params

    run_cfg = cfg.replace(pe_type=pe)
    mod = family_module(run_cfg)
    opt = adamw(warmup_cosine(*tc.LM_SCHEDULE))
    params = jax.tree.map(jnp.asarray, numpy_params(cfg, tc.PARAM_SEED))
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    with compute_dtype(jnp.bfloat16 if mixed else None):
        step = jax.jit(make_train_step(run_cfg, mod, opt, n_micro=1,
                                       clip_norm=tc.LM_CLIP))
        rows = []
        for i in range(tc.LM_STEPS):
            batch = {k: jnp.asarray(v)
                     for k, v in tc.lm_batch(cfg.vocab, i).items()}
            state, m = step(state, batch)
            rows.append([float(m["loss"]), float(m["grad_norm"])])
    return rows


def whisper(cfg, size: str) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models import encdec as JE
    from repro.serve import quantize_params
    from repro_torch import variants_check as vc
    from repro_torch.models.encdec import numpy_params
    from repro_torch.serve import check
    from _torch_gemma3_ref import pow2_ties

    small = vc.REDUCED["whisper"] if size != "full" else {}
    batch_n = small.get("batch", check.WHISPER_BATCH)
    frames_n = small.get("frames", check.WHISPER_FRAMES)
    prompt = small.get("prompt", check.WHISPER_PROMPT)
    max_len = small.get("max_len", check.WHISPER_MAX_LEN)
    max_new = small.get("max_new", vc.WHISPER_MAX_NEW)
    arrays = numpy_params(cfg, vc.PARAM_SEED)
    dense = jax.tree.map(jnp.asarray, arrays)
    packs = {pe: quantize_params(dense, pe, min_size=check.MIN_SIZE)
             for pe in ("lightpe1", "int8")}
    ties = pow2_ties(arrays, packs["lightpe1"])
    del arrays
    inputs = check.whisper_inputs(cfg.d_model, cfg.vocab, batch_n, frames_n,
                                  prompt)
    batch = {"frames": jnp.asarray(inputs["frames"]),
             "tokens": jnp.asarray(inputs["tokens"], jnp.int32)}
    jitted = type("M", (), dict(
        prefill=staticmethod(jax.jit(JE.prefill, static_argnums=2)),
        decode_step=staticmethod(jax.jit(JE.decode_step,
                                         static_argnums=3))))
    modes = {}
    for pe, dtype, packed in vc.WHISPER_MODES:
        run_cfg = cfg.replace(pe_type="fp32" if packed else pe, dtype=dtype)
        params = packs[pe] if packed else dense
        cache = JE.init_cache(run_cfg, batch_n, max_len, jnp.float32)
        t0 = time.perf_counter()
        modes[vc.whisper_mode_key(pe, dtype, packed)] = dict(
            pe_type=pe, dtype=dtype, packed=packed,
            run=check.record_encdec(
                jitted, params, run_cfg, batch, cache, max_new, np.asarray,
                lambda t: jnp.asarray(t, jnp.int32)),
            seconds=time.perf_counter() - t0)
    return dict(config=cfg.name, enc_layers=cfg.enc_layers,
                dec_layers=cfg.dec_layers, batch=batch_n, frames=frames_n,
                prompt=prompt, max_len=max_len, max_new=max_new,
                min_size=check.MIN_SIZE, pow2_ties=ties, modes=modes)


def build_reference(size: str = "full", parts=("gemma", "flash", "train",
                                               "whisper")) -> dict:
    from repro_torch import variants_check as vc
    gcfg, fcfg, wcfg = _configs(size)
    out = dict(size=size, xla_flags=os.environ.get("XLA_FLAGS", ""),
               param_seed=vc.PARAM_SEED, token_seed=vc.TOKEN_SEED,
               seconds={})
    t0 = time.perf_counter()
    if "gemma" in parts:
        out["gemma_block_local"] = gemma_block_local(
            gcfg, vc.GEMMA_TOKENS if size == "full"
            else vc.REDUCED["gemma_tokens"])
        out["seconds"]["gemma"] = time.perf_counter() - t0
    if "flash" in parts:
        t0 = time.perf_counter()
        out["smollm_flash"] = smollm_flash(
            fcfg, vc.FLASH_TOKENS if size == "full"
            else vc.REDUCED["flash_tokens"])
        out["seconds"]["flash"] = time.perf_counter() - t0
    if "train" in parts:
        t0 = time.perf_counter()
        flash = fcfg.replace(attn_flash=True)
        out["smollm_train"] = dict(
            config=fcfg.name,
            flash={pe: lm_steps(flash, pe, False)
                   for pe in vc.FLASH_TRAIN_PE_TYPES},
            mixed={vc.MIXED_PE_TYPE: lm_steps(fcfg, vc.MIXED_PE_TYPE, True)})
        out["seconds"]["train"] = time.perf_counter() - t0
    if "whisper" in parts:
        t0 = time.perf_counter()
        out["whisper"] = whisper(wcfg, size)
        out["seconds"]["whisper"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = " ".join(
        filter(None, [os.environ.get("XLA_FLAGS"), NO_EXCESS_PRECISION]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    t0 = time.perf_counter()
    ref = build_reference("full")
    REF_PATH.parent.mkdir(parents=True, exist_ok=True)
    REF_PATH.write_text(json.dumps(ref) + "\n")
    print(f"wrote {REF_PATH} in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(ref['seconds'])}")
