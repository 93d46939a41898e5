"""The gradient of the JAX model's attention (the core of
``repro.models.transformer._attention_dynwin`` without a cache: GQA
einsums with float32 accumulation, the logit soft-cap, the causal -1e30
mask and its sliding window, softmax, P rounded to V's type before P V)
by ``jax.vjp``, on inputs from an
``.npz`` file, with XLA's excess precision off so that bfloat16 is
rounded where the source rounds it.  ``tests/test_torch_attention_bwd.py``
runs it in a subprocess, since the flag is read when JAX starts:

  PYTHONPATH=src python tests/_torch_attention_grad_ref.py IN.npz OUT.npz \
      [IN2.npz OUT2.npz ...]

IN holds q, k, v, dout (float32), dtype, causal and scale, and
optionally window and softcap (0: none); OUT gets out, dq, dk, dv as
float32.
"""

import os
import sys

NO_EXCESS_PRECISION = "--xla_allow_excess_precision=false"


def attention(q, k, v, causal: bool, scale: float, window: int = 0,
              softcap: float = 0.0):
    """``_attention_dynwin``'s lines from the logits to the output, on q
    (B, S, Hq, D) and k, v (B, S, Hkv, D) at positions 0..S-1."""
    import jax
    import jax.numpy as jnp
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, dh)
    logits = jnp.einsum("bqhgd,bkhd->bhgqk", qg, k.astype(qg.dtype),
                        preferred_element_type=jnp.float32) * scale
    if softcap > 0.0:
        logits = softcap * jnp.tanh(logits / softcap)
    if causal:
        pos = jnp.arange(s)
        qp = pos[None, None, None, :, None]
        kp = pos[None, None, None, None, :]
        ok = kp <= qp
        if window > 0:
            ok = ok & (kp > qp - window)
        logits = jnp.where(ok, logits, -1e30)
    probs = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bhgqk,bkhd->bqhgd", probs.astype(v.dtype), v,
                     preferred_element_type=jnp.float32)
    return out.reshape(b, s, hq, dh)


def run(src: str, dst: str):
    import jax
    import jax.numpy as jnp
    import numpy as np

    data = np.load(src)
    dtype = str(data["dtype"])
    causal, scale = bool(data["causal"]), float(data["scale"])
    window = int(data["window"]) if "window" in data else 0
    softcap = float(data["softcap"]) if "softcap" in data else 0.0
    q, k, v = (jnp.asarray(data[n], dtype) for n in ("q", "k", "v"))
    out, vjp = jax.vjp(lambda a, b, c: attention(a, b, c, causal, scale,
                                                 window, softcap), q, k, v)
    dq, dk, dv = vjp(jnp.asarray(data["dout"]))
    np.savez(dst, out=np.asarray(out),
             **{n: np.asarray(g.astype(jnp.float32))
                for n, g in (("dq", dq), ("dk", dk), ("dv", dv))})


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = " ".join(
        filter(None, [os.environ.get("XLA_FLAGS"), NO_EXCESS_PRECISION]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    args = sys.argv[1:]
    for src, dst in zip(args[::2], args[1::2]):
        run(src, dst)
