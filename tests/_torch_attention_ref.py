"""The JAX model's attention (``repro.models.transformer._attention_dynwin``)
on inputs from an ``.npz`` file, with XLA's excess precision off, so that
bf16 is rounded at exactly the places the model's source rounds it (the
port does the same).  ``tests/test_torch_flash_attention.py`` runs it in a
subprocess, since the flag is read once, when JAX starts:

  PYTHONPATH=src python tests/_torch_attention_ref.py IN.npz OUT.npz

IN holds x, positions, wq/wk/wv/wo (float32 arrays, cast to ``dtype``),
index and, for a cache, cache_k/cache_v (float32, as the serving engine
holds it); OUT gets the attention's output (as float32) and the new
cache.
"""

import os
import sys

NO_EXCESS_PRECISION = "--xla_allow_excess_precision=false"


def run(src: str, dst: str):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import reduced
    from repro.models import transformer as JT
    from repro.quant.qconfig import preset

    data = np.load(src)
    dtype = str(data["dtype"])
    cfg = reduced("smollm-135m").replace(dtype=dtype)
    p = {n: jnp.asarray(data[n], dtype) for n in ("wq", "wk", "wv", "wo")}
    cache = None
    if "cache_k" in data:
        cache = {"k": jnp.asarray(data["cache_k"]),
                 "v": jnp.asarray(data["cache_v"]),
                 "index": jnp.asarray(int(data["index"]), jnp.int32)}
    fn = jax.jit(JT._attention_dynwin, static_argnums=(2, 3, 5))
    out, new = fn(p, jnp.asarray(data["x"], dtype), JT.attn_spec(cfg),
                  preset("fp32"), jnp.asarray(data["positions"]), 1 << 30,
                  cache)
    res = {"out": np.asarray(out.astype(jnp.float32))}
    if cache is not None:
        res.update(cache_k=np.asarray(new["k"]), cache_v=np.asarray(new["v"]))
    np.savez(dst, **res)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = " ".join(
        filter(None, [os.environ.get("XLA_FLAGS"), NO_EXCESS_PRECISION]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    run(sys.argv[1], sys.argv[2])
