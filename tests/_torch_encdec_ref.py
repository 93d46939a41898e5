"""The JAX package's reduced Whisper (encoder-decoder) runs, for the
port's CPU tests (``tests/test_torch_encdec.py``).

For each numerics and compute type of ``CASES`` it draws the reduced
model's params with numpy (``repro_torch.models.encdec.numpy_params``,
seed 0) and, on numpy frames and tokens (``inputs``), writes from the
JAX package's jitted entry points: ``encode``; the loss (``loss_fn``, its
activation calls logged from a forward-only run) and its gradients; ``prefill`` of the first ``PROMPT`` tokens into
a ``MAX_LEN``-row float32 cache and ``decode_step`` of the rest; and
under a quantizing PE type every activation call's x / s and codes
(``_torch_act_pins.jax_act_log``), to which the port pins its codes at
rounding ties.

It runs in its own process with XLA's excess precision off (set before
JAX starts), so that bfloat16 is rounded where the model's source rounds
it, as the port rounds it:

  PYTHONPATH=src:tests python tests/_torch_encdec_ref.py OUT.pkl
"""

import os
import pickle
import sys

import numpy as np

CONFIG = "whisper-medium"
CASES = [(pe, dtype) for pe in ("fp32", "lightpe1")
         for dtype in ("float32", "bfloat16")]
BATCH, S_ENC, SEQ, PROMPT, MAX_LEN = 2, 24, 8, 5, 16
INPUT_SEED = 3


def inputs(cfg) -> dict:
    """Frames N(0, 1) (B, S_ENC, D), tokens and next-token labels."""
    rng = np.random.default_rng(INPUT_SEED)
    frames = rng.standard_normal((BATCH, S_ENC, cfg.d_model),
                                 dtype=np.float32)
    toks = rng.integers(0, cfg.vocab, size=(BATCH, SEQ + 1))
    return {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def run_case(pe: str, dtype: str, acts) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced
    from repro.models import encdec as JE
    from repro_torch.models.encdec import numpy_params

    cfg = reduced(CONFIG).replace(pe_type=pe, dtype=dtype)
    params = jax.tree.map(jnp.asarray, numpy_params(cfg, 0))
    batch = jax.tree.map(jnp.asarray, inputs(cfg))
    out = {"encode": np.asarray(jax.jit(JE.encode, static_argnums=2)(
        params, batch["frames"], cfg), np.float32)}
    out["encode_acts"] = acts.drain()
    # the loss alone first: under grad the rematerialized scans replay
    # their activation calls out of forward order
    out["loss"] = float(jax.jit(JE.loss_fn, static_argnums=2)(params, batch,
                                                              cfg))
    out["loss_acts"] = acts.drain()
    loss, grads = jax.jit(jax.value_and_grad(JE.loss_fn),
                          static_argnums=2)(params, batch, cfg)
    acts.drain()
    out["grad_loss"] = float(loss)
    out["grads"] = [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)]
    cache = JE.init_cache(cfg, BATCH, MAX_LEN, jnp.float32)
    logits, cache, enc = jax.jit(JE.prefill, static_argnums=2)(
        params, {"frames": batch["frames"],
                 "tokens": batch["tokens"][:, :PROMPT]}, cfg, cache)
    steps = [np.asarray(logits, np.float32)]
    decode = jax.jit(JE.decode_step, static_argnums=3)
    for i in range(PROMPT, SEQ):
        logits, cache = decode(params, batch["tokens"][:, i:i + 1], enc, cfg,
                               cache)
        steps.append(np.asarray(logits, np.float32))
    out["steps"] = np.concatenate(steps, axis=1)
    out["step_acts"] = acts.drain()
    return out


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = " ".join(filter(None, [
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false"]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from _torch_act_pins import jax_act_log
    with jax_act_log() as acts:
        result = {case: run_case(*case, acts) for case in CASES}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(result, f)
