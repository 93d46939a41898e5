"""The JAX package served on an fp8 (float8_e4m3fn) K/V cache at full
width, for the port's card check (``chip_smoke.py`` phase 17.2) and its
CPU test (``tests/test_torch_fp8_cache.py``).

Qwen3-32B at full width cut to ``fp8_check.REF_LAYERS`` layers (float32
weights from ``fp8_check.hashed_params``, float32 activations), a prefill
of 2 x 130 numpy tokens into a 160-row fp8 cache and 8 greedy decode
steps, through the JAX package's jitted ``prefill`` / ``decode_step``.  It writes
``fp8_check.summary``'s keys (the logits at 64 fixed columns of every
step, argmax and top-2 margins, layer 0's K / V codes as a sha256 and a
histogram), the greedy tokens, and the share of the attention's e4m3 P
codes over the visible keys that are not 0 (``jax_probs_log``).  Not
collected by pytest.  Rewrite the file with

  PYTHONPATH=src:tests python tests/_torch_fp8_ref.py   (~4 min, ~14 GB)

``port_run`` is the port's run on the CPU against a built reference.
"""

import json
import sys
from pathlib import Path

import numpy as np

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_fp8_ref.json"


def _params(cfg):
    """The reference's weights (``fp8_check.hashed_params``, drawn by the
    port's torch on the CPU: the card draws the same bits), as JAX arrays
    leaf by leaf (the torch leaf dropped as it is copied)."""
    import jax.numpy as jnp
    from repro_torch.fp8_check import PARAM_SEED, hashed_params

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(tree.pop(k)) for k in list(tree)}
        if isinstance(tree, list):
            return [move(x) for x in tree]
        return jnp.asarray(tree.numpy())

    return move(hashed_params(cfg, PARAM_SEED, "cpu"))


def _p_share(calls, n_layers: int, prompt: int) -> float:
    """Nonzero e4m3 codes of P over the visible keys, every logged call
    (pass = call // n_layers: the prefill, then one a decode step)."""
    import ml_dtypes
    nonzero = visible = 0
    for c, p in enumerate(calls):
        step = c // n_layers
        sq, skv = p.shape[-2], p.shape[-1]
        qpos = np.arange(sq) if step == 0 else np.array([prompt + step - 1])
        vis = np.arange(skv)[None, :] <= qpos[:, None]            # (Sq, Skv)
        codes = p.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
        nonzero += int(((codes & 0x7F) != 0)[..., vis].sum())
        visible += int(np.broadcast_to(vis, p.shape).sum())
    return nonzero / visible


def build(size: str = "full") -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import get, reduced
    from repro.models import transformer as JT
    from repro_torch import fp8_check as F
    from _torch_act_pins import jax_probs_log

    cfg = F.config(size)
    s = F.shape(size)
    jcfg = (get(F.CONFIG).replace(n_layers=F.REF_LAYERS) if size == "full"
            else reduced(F.CONFIG)).replace(dtype="float32")
    params = _params(cfg)
    prompt = F.prompt_tokens(cfg, size)
    with jax_probs_log() as log:
        prefill = jax.jit(JT.prefill, static_argnums=2)
        decode = jax.jit(JT.decode_step, static_argnums=2)
        cache = JT.init_cache(jcfg, s["batch"], s["max_len"],
                              jnp.float8_e4m3fn)
        logits, cache = prefill(params, jnp.asarray(prompt), jcfg, cache)
        steps = [np.asarray(logits[:, -1], np.float32)]
        greedy = []
        for _ in range(s["steps"]):
            tok = np.argmax(steps[-1], axis=-1)[:, None]
            greedy.append(tok)
            logits, cache = decode(params, jnp.asarray(tok), jcfg, cache)
            steps.append(np.asarray(logits[:, -1], np.float32))
        jax.block_until_ready(cache)
        calls = log.drain()
    k0, v0 = (np.asarray(cache["scan"][n][0]).view(np.uint8)
              for n in ("k", "v"))
    out = {"config": {f: getattr(cfg, f) for f in (
               "name", "n_layers", "d_model", "n_heads", "kv_heads",
               "head_dim", "d_ff", "vocab", "dtype")},
           "cache_dtype": "float8_e4m3fn", "shape": s,
           "param_seed": F.PARAM_SEED, "token_seed": F.TOKEN_SEED,
           "columns": F.columns(cfg).tolist(),
           "greedy": np.concatenate(greedy, axis=1).tolist(),
           "p_nonzero_share": _p_share(calls, cfg.n_layers, s["prompt"]),
           **F.summary(np.stack(steps), F.columns(cfg), k0, v0)}
    return out


def port_run(size: str, greedy) -> dict:
    """The port on the CPU, fed the reference's greedy tokens: the
    summary of its run (``fp8_check.summary``)."""
    from repro_torch import fp8_check as F
    cfg = F.config(size)
    s = F.shape(size)
    params = F.hashed_params(cfg, F.PARAM_SEED, "cpu")
    steps, cache = F.port_run(params, cfg, F.prompt_tokens(cfg, size),
                              np.asarray(greedy), s["max_len"], "cpu")
    return F.summary(steps, F.columns(cfg), *F.layer0_bits(cache))


if __name__ == "__main__":
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if sys.argv[1:2] == ["--port"]:
        # the port's CPU run against the written file: its distance
        ref = json.loads(REF_PATH.read_text())
        got = port_run("full", ref["greedy"])
        err = np.abs(np.asarray(got["logits"]) - np.asarray(ref["logits"]))
        hist = sum(int(np.abs(np.asarray(a) - np.asarray(b)).sum())
                   for a, b in zip(got["cache_histogram"],
                                   ref["cache_histogram"]))
        print(json.dumps({"max_logit_err": float(err.max()),
                          "per_step": err.max(axis=(1, 2)).tolist(),
                          "argmax_equal": got["argmax"] == ref["argmax"],
                          "cache_hash_equal": got["cache_sha256"]
                          == ref["cache_sha256"],
                          "histogram_l1": hist}))
        sys.exit(0)
    REF_PATH.write_text(json.dumps(build("full")) + "\n")
    print(f"wrote {REF_PATH}")
