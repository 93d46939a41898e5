"""Activation codes at round(x / s) ties, pinned to the JAX package's.

Under a quantizing PE type every projection's activation is fake
quantized with one scale s for the tensor: code = round(x / s), 8 bits.
Where x / s lies at a half-integer, the last float32 bit of x decides the
code, and the two packages sum x in other orders: an activation at x / s
= -26.499998 in JAX and -26.5 in the port takes codes one step apart,
and the model carries that step on (1.6e-3 to 4.1e-2 of logit on the
reduced decoders).  So a cross-framework test records the JAX side's
x / s and codes of every activation call (``jax_act_log``: the JAX
package's ``repro.models.layers.fake_quant_act`` wrapped at run time,
the package not edited), and the port's run takes the JAX code where its
own differs at a tie (``ActPins``), counted in ``pinned``; a code that
differs anywhere else fails.

bfloat16 has the same kind of tie where a float32 result is rounded to
bfloat16 (RMSNorm's output, a block's attention and feed-forward outputs
as it adds them): the last float32 bits depend on the sum order (XLA's
dot and torch's), and one flipped element moves the reduced model's
logits by ~0.02.  So in bfloat16 a test also records the JAX side's
float32 values before those roundings (``jax_round_log``), and the
port's rounding takes the JAX one only where the two float32 values
agree to float32 noise (``ROUND_TIE`` of the call's largest value), so
that the rounding boundary lies between them (``RoundPins``), counted;
any other difference fails.
"""

import contextlib

import numpy as np
import pytest

TIE = 1e-3      # |x / s| this close to a half-integer: a rounding tie
# float32 values this close, relative to the call's largest |value|, round
# to bfloat16 as one value but for a tie: a float32 sum's error scales with
# its terms, not with its result, so where the result cancels to far below
# the call's largest value a few float32 ulps of that value can cross a
# bfloat16 rounding boundary (8 ulps at its binade; the widest difference
# seen on the reduced decoders is 8.1e-8 of it)
ROUND_TIE = 2.0 ** -20


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a test module's many small torch models on one intra-op thread:
    beside other test processes, torch's thread pool spins on every tiny
    op (a reduced case took 10 s, not 0.1).  Restored after the module.
    The comparisons with JAX hold either way: float32 sums in another
    order are what their tolerances and tie pins allow for."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Log:
    def __init__(self):
        self.calls = []

    def drain(self):
        calls, self.calls = self.calls, []
        return calls


@contextlib.contextmanager
def jax_act_log():
    """While open, every activation fake quantization of the JAX package
    (``qdense``'s, under jit, vmap, grad and scan too) reports (x / s,
    codes) to the host as float32 numpy arrays, in call order; under
    vmap (an MoE layer's experts) one call an expert."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro.quant.fake_quant import affine_scale

    log = _Log()
    inner = JL.fake_quant_act
    jax.clear_caches()      # no trace from before the wrapper is reused

    def logged(x, qcfg):
        out = inner(x, qcfg)
        if qcfg.act_scheme == "none" or not qcfg.quantize_acts:
            return out
        x0 = jax.lax.stop_gradient(x)
        s = affine_scale(x0, qcfg.act_bits)
        codes = jnp.round(jax.lax.stop_gradient(out) / s)

        def host(r, c):
            log.calls.append((np.asarray(r, np.float32),
                              np.asarray(c, np.float32)))

        jax.debug.callback(host, x0 / s, codes, ordered=True)
        return out

    JL.fake_quant_act = logged
    try:
        yield log
    finally:
        JL.fake_quant_act = inner
        jax.clear_caches()


class ActPins:
    """The port's activation fake quantizations (``layers.qdense``'s and an
    MoE layer's expert buffers, ``moe.fake_quant_expert_acts``), pinned to
    a JAX log.  ``load(calls)`` gives the JAX calls of the next run; in
    it each port call takes the next call (an expert stack one an
    expert), and where its code differs from the JAX code at a rounding
    tie (both x / s within ``TIE`` of the same half-integer) the JAX code
    is taken (the STE's gradient kept), counted in ``pinned``.  A code
    that differs anywhere else, or a call the log lacks, fails; with
    ``strict=False`` (an MoE layer whose routing may flip at a router
    near tie, which the test then handles) it ends the pinning for the
    run instead (``diverged``)."""

    def __init__(self, monkeypatch, strict: bool = True):
        from repro_torch.models import layers as L
        from repro_torch.models import moe as MOE
        self.calls, self.n, self.pinned = [], 0, 0
        self.strict, self.diverged = strict, False
        monkeypatch.setattr(L, "fake_quant_act",
                            self._wrap(L.fake_quant_act, False))
        monkeypatch.setattr(MOE, "fake_quant_expert_acts",
                            self._wrap(MOE.fake_quant_expert_acts, True))

    def load(self, calls):
        self.calls, self.n, self.diverged = list(calls), 0, False

    def done(self) -> bool:
        """Every loaded call was met (or the pinning ended)."""
        return self.diverged or self.n == len(self.calls)

    def _take(self, k):
        if self.n + k > len(self.calls):
            raise AssertionError(f"activation call {self.n}: the JAX log "
                                 f"has {len(self.calls)} calls")
        got = self.calls[self.n:self.n + k]
        self.n += k
        return (np.stack([r for r, _ in got]), np.stack([c for _, c in got]))

    def _wrap(self, fn, expert):
        import torch
        from repro_torch.quant.fake_quant import affine_scale

        def act(x, qcfg):
            out = fn(x, qcfg)
            if qcfg.act_scheme == "none" or not qcfg.quantize_acts \
                    or self.diverged:
                return out
            x0 = x.detach()
            if expert:
                s = torch.stack([affine_scale(xe, qcfg.act_bits)
                                 for xe in x0.unbind(0)]).reshape(
                                     -1, *[1] * (x0.ndim - 1))
                want_ratio, want = self._take(x0.shape[0])
            else:
                s = affine_scale(x0, qcfg.act_bits)
                want_ratio, want = (a[0] for a in self._take(1))
            ratio = x0 / s
            codes = torch.round(ratio)
            want_ratio = torch.as_tensor(want_ratio).reshape(ratio.shape)
            want = torch.as_tensor(want).reshape(ratio.shape)
            differ = codes != want.to(codes.dtype)
            if not bool(differ.any()):
                return out
            mag = ratio.float().abs()
            tie = (((mag - mag.floor() - 0.5).abs() < TIE)
                   & ((ratio.float() - want_ratio).abs() < TIE))
            if not self.strict and not bool(tie[differ].all()):
                self.diverged = True
                return out
            assert bool(tie[differ].all()), (
                f"activation call {self.n - 1}: codes differ away from a "
                f"rounding tie at x / s = {ratio[differ & ~tie][:4]} "
                f"(JAX {want_ratio[differ & ~tie][:4]})")
            self.pinned += int(differ.sum())
            fix = torch.where(differ, want.to(out.dtype) * s - out,
                              torch.zeros_like(out))
            return out + fix.detach()
        return act


# the roundings of a float32 result to bfloat16 in a decoder block, as
# (module of ``models``, function, position of its input x): RMSNorm's
# result (rounded by the function itself; the float32 value is the same
# function on a float32 input) and a block's attention and feed-forward
# outputs (an MLP's, or an MoE layer's with shared experts: float32 on
# float32 weights, rounded as the block adds them to the residual).
# Calls inside an MoE layer are not sites: the block's rounding of its
# sum is.  One more site is inside the attention: its context P V
# (float32), rounded before the output projection ("context": the JAX
# package's einsum of P and V, the port's ``flash_attention_gqa``).
ROUND_SITES = (("layers", "rmsnorm", 0), ("transformer", "_attention_dynwin", 1),
               ("layers", "mlp", 1), ("moe", "moe_apply", 1))
CONTEXT_EINSUM = "bhgqk,bkhd->bqhgd"
SITE_NAMES = tuple(name for _, name, _ in ROUND_SITES) + ("context",)


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _with_first(out, first):
    return (first, *out[1:]) if isinstance(out, tuple) else first


class _Sites:
    """Wraps the ``ROUND_SITES`` and the attention context of one package
    (``repro`` or ``repro_torch``); ``on_round(name, f, res)`` sees each
    site call whose input x is bfloat16, outside an MoE layer, with ``f``
    its float32 value before the rounding, and returns the call's
    result."""

    def __init__(self, package, bf16, f32, on_round, setattr_=setattr):
        import importlib
        self.depth, self.in_attn, self.saved = 0, False, []

        def patch(module, name, wrapper):
            fn = getattr(module, name)
            self.saved.append((module, name, fn))
            setattr_(module, name, wrapper(fn))

        for mod, name, at in ROUND_SITES:
            patch(importlib.import_module(f"{package}.models.{mod}"), name,
                  lambda fn, name=name, at=at: self._site(
                      package, name, at, fn, bf16, f32, on_round))
        if package == "repro":
            module = importlib.import_module("jax.numpy")
            name, match = "einsum", lambda a: a[:1] == (CONTEXT_EINSUM,)
        else:
            module = importlib.import_module(f"{package}.models.transformer")
            name, match = "flash_attention_gqa", lambda a: True

        def context(fn):
            def site(*args, **kwargs):
                out = fn(*args, **kwargs)
                if self.in_attn and match(args) and out.dtype == f32:
                    return on_round("context", out, out)
                return out
            return site
        patch(module, name, context)

    def restore(self):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)

    def _site(self, package, name, at, fn, bf16, f32, on_round):
        def site(*args, **kwargs):
            outer = self.in_attn
            self.in_attn = (name == "_attention_dynwin" and not self.depth
                            and args[at].dtype == bf16)
            self.depth += name == "moe_apply"
            try:
                res = fn(*args, **kwargs)
            finally:
                self.depth -= name == "moe_apply"
                self.in_attn = outer
            if self.depth or args[at].dtype != bf16:
                return res
            if name == "rmsnorm":
                f = fn(args[0].astype(f32) if package == "repro"
                       else args[0].to(f32), *args[1:], **kwargs)
            else:
                f = _first(res)
            if f.dtype != f32:
                return res
            return on_round(name, f, res)
        return site


@contextlib.contextmanager
def jax_round_log():
    """While open, the float32 value before each ``ROUND_SITES`` rounding
    of the JAX package reports to the host as a numpy array, in call
    order, one list a site."""
    import jax
    import jax.numpy as jnp

    logs = {name: _Log() for name in SITE_NAMES}

    def on_round(name, f, res):
        jax.debug.callback(lambda h: logs[name].calls.append(
            np.asarray(h, np.float32)), jax.lax.stop_gradient(f),
            ordered=True)
        return res

    jax.clear_caches()
    sites = _Sites("repro", jnp.bfloat16, jnp.float32, on_round)
    try:
        yield logs
    finally:
        sites.restore()
        jax.clear_caches()


class RoundPins:
    """The port's ``ROUND_SITES`` roundings to bfloat16, pinned to a JAX
    log: ``load(calls)`` gives the next run's JAX float32 values ({site:
    list}); where the port's value rounds to another bfloat16 than the
    JAX one, the two float32 values must agree within ``ROUND_TIE`` of
    the call's largest |value| (a rounding tie: both sit that close to
    the rounding boundary between them); there the port's rounding takes
    the JAX one, counted in ``pinned``.  Any other difference fails; with
    ``strict=False`` (an MoE model whose routing may flip at a router
    near tie, which the test then handles) it ends the pinning for the
    run instead (``diverged``; ``ended`` counts the runs it ended)."""

    def __init__(self, monkeypatch, strict: bool = True):
        import torch
        self.calls, self.n = {}, {}
        self.pinned, self.strict, self.diverged = 0, strict, False
        self.ended = 0
        _Sites("repro_torch", torch.bfloat16, torch.float32, self._round,
               monkeypatch.setattr)

    def load(self, calls):
        self.calls = {k: list(v.calls if hasattr(v, "calls") else v)
                      for k, v in calls.items()}
        self.n = {k: 0 for k in self.calls}
        self.diverged = False

    def done(self) -> bool:
        return self.diverged or all(self.n[k] == len(v)
                                    for k, v in self.calls.items())

    def _round(self, name, f, res):
        import torch
        if self.diverged:
            return res
        calls, n = self.calls[name], self.n[name]
        assert n < len(calls), f"{name} call {n}: the JAX log has {len(calls)}"
        self.n[name] += 1
        f = f.detach().float()
        w = torch.as_tensor(calls[n])
        if w.numel() != f.numel():
            # the port's prefill normalizes only its last position, the
            # JAX package every one (row by row: the last rows are the
            # port's)
            w = w.reshape(f.shape[0], -1, f.shape[-1])[:, -f.shape[1]:]
        w = w.reshape(f.shape)
        got, want = f.to(torch.bfloat16), w.to(torch.bfloat16)
        differ = got != want
        if not bool(differ.any()):
            return res
        tie = (f - w).abs() <= ROUND_TIE * float(w.abs().max())
        if not bool(tie[differ].all()):
            if not self.strict:
                self.diverged = True
                self.ended += 1
                return res
            bad = differ & ~tie
            raise AssertionError(
                f"{name} call {n}: bfloat16 roundings differ away from a "
                f"tie at {f[bad][:4].tolist()} (JAX {w[bad][:4].tolist()})")
        self.pinned += int(differ.sum())
        out = _first(res)
        return _with_first(res, torch.where(differ, want.to(out.dtype), out))
