"""The JAX package's reduced decoder models, for the port's CPU tests
(``tests/test_torch_decoder.py``).

For each config and numerics of ``CASES`` it draws the reduced model's
params with numpy (``numpy_params``, seed 0) and writes, for each token
seed of ``TOKEN_SEEDS``, from the JAX package's jitted entry points:
``forward`` on 2 x 20 tokens; ``prefill`` of their first 17 into a
24-row cache and 3 ``decode_step``s of the last 3; for an MoE model, the
routing of every MoE call of both (``_torch_moe_ref.jax_router_log``);
under a quantizing PE type every activation call's x / s and codes
(``_torch_act_pins.jax_act_log``), to which the port pins its codes at
rounding ties; and in bfloat16 the float32 value before each rounding
of a block's norms, attention and feed-forward outputs to bfloat16
(``jax_round_log``), to which the port pins its roundings at ties.

It runs in its own process with XLA's excess precision off (set before
JAX starts), so that bfloat16 is rounded where the model's source rounds
it, as the port rounds it:

  PYTHONPATH=src:tests python tests/_torch_decoder_ref.py OUT.pkl
"""

import os
import pickle
import sys

import numpy as np

CONFIGS = ("gemma3-1b", "gemma2-9b", "qwen3-32b", "qwen2-vl-72b",
           "deepseek-moe-16b", "phi3.5-moe-42b-a6.6b")
CASES = [(name, pe, dtype) for name in CONFIGS for pe in ("fp32", "lightpe1")
         for dtype in ("float32", "bfloat16")]
BATCH, SEQ, PROMPT, MAX_LEN = 2, 20, 17, 24
TOKEN_SEED = 1          # the other tests' tokens
TOKEN_SEEDS = tuple(range(8))


def tokens(vocab: int, seed: int = TOKEN_SEED) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=(BATCH, SEQ))


def run_case(name: str, pe: str, dtype: str, acts, rounds) -> dict:
    """{seed: the runs of one token seed} of one config and numerics;
    ``acts``, ``rounds``: an open ``jax_act_log`` and ``jax_round_log``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced
    from repro.models import transformer as JT
    from repro_torch.models.transformer import numpy_params
    from _torch_moe_ref import jax_router_log

    cfg = reduced(name).replace(pe_type=pe, dtype=dtype)
    params = jax.tree.map(jnp.asarray, numpy_params(cfg, 0))
    forward = jax.jit(JT.forward, static_argnums=2)
    prefill = jax.jit(JT.prefill, static_argnums=2)
    decode = jax.jit(JT.decode_step, static_argnums=2)
    runs = {}
    with jax_router_log() as log:
        for seed in TOKEN_SEEDS:
            toks = jnp.asarray(tokens(cfg.vocab, seed))
            out = {}
            out["forward"] = np.asarray(forward(params, toks, cfg),
                                        np.float32)
            out["forward_routes"] = log.drain()
            out["forward_acts"] = acts.drain()
            out["forward_rounds"] = {k: v.drain() for k, v in rounds.items()}
            cache = JT.init_cache(cfg, BATCH, MAX_LEN, jnp.float32)
            logits, cache = prefill(params, toks[:, :PROMPT], cfg, cache)
            steps = [np.asarray(logits, np.float32)]
            for i in range(PROMPT, SEQ):
                logits, cache = decode(params, toks[:, i:i + 1], cfg, cache)
                steps.append(np.asarray(logits, np.float32))
            out["steps"] = np.concatenate(steps, axis=1)
            out["step_routes"] = log.drain()
            out["step_acts"] = acts.drain()
            out["step_rounds"] = {k: v.drain() for k, v in rounds.items()}
            runs[seed] = out
    return runs


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = " ".join(filter(None, [
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false"]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from _torch_act_pins import jax_act_log, jax_round_log
    with jax_act_log() as acts, jax_round_log() as rounds:
        result = {case: run_case(*case, acts, rounds) for case in CASES}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(result, f)
