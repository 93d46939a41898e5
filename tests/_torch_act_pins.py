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

    def _scale(self, x0, qcfg, split: bool):
        from repro_torch.quant.fake_quant import affine_scale
        return affine_scale(x0, qcfg.act_bits)

    def _shaped(self, a, shape):
        import torch
        return torch.as_tensor(a).reshape(shape)

    def _wrap(self, fn, expert):
        import torch
        from repro_torch.quant.fake_quant import affine_scale

        def act(x, qcfg, *split):
            out = fn(x, qcfg, *split)
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
                s = self._scale(x0, qcfg, bool(split and split[0]))
                taken = self._take(1)
                if taken is None:
                    return out
                want_ratio, want = (a[0] for a in taken)
            ratio = x0 / s
            codes = torch.round(ratio)
            want_ratio = self._shaped(want_ratio, ratio.shape)
            want = self._shaped(want, ratio.shape)
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


class SplitActPins(ActPins):
    """A rank's activation codes under the tensor-parallel split pinned to
    the one-rank port's (``port_act_log``) of the same run, call by call:
    a column-split or whole product's activation is the one-rank call's
    tensor, a row-split one's (``split``) the rank's block of its
    features (its heads', its columns': the ``rank``-th of ``size`` equal
    blocks of the last axis), scaled by the group's absmax.  Calls past
    the log (a counting step after the run) are not pinned."""

    def __init__(self, monkeypatch, rank: int, size: int):
        super().__init__(monkeypatch)
        self.rank, self.size = rank, size

    def _take(self, k):
        if self.n >= len(self.calls):
            return None
        return super()._take(k)

    def _scale(self, x0, qcfg, split: bool):
        if not split:
            return super()._scale(x0, qcfg, split)
        import torch
        from repro_torch.launch.mesh import split_max
        from repro_torch.quant.fake_quant import _scale_of
        return _scale_of(split_max(torch.amax(torch.abs(x0))[None])[0],
                         qcfg.act_bits)

    def _shaped(self, a, shape):
        import torch
        a = torch.as_tensor(a).reshape(*shape[:-1], -1)
        return a.chunk(self.size, -1)[self.rank] if a.shape[-1] != shape[-1] \
            else a


@contextlib.contextmanager
def port_act_log():
    """While open, every activation fake quantization of the port
    (``layers.qdense``'s) records (x / s, codes) as float32 numpy arrays,
    in call order: the one-rank run that ``SplitActPins`` pins a split
    run to."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.quant.fake_quant import affine_scale

    log = _Log()
    inner = L.fake_quant_act

    def logged(x, qcfg, *split):
        out = inner(x, qcfg, *split)
        if qcfg.act_scheme != "none" and qcfg.quantize_acts:
            x0 = x.detach()
            s = affine_scale(x0, qcfg.act_bits)
            log.calls.append(((x0 / s).float().numpy(),
                              torch.round(out.detach() / s).float().numpy()))
        return out

    L.fake_quant_act = logged
    try:
        yield log
    finally:
        L.fake_quant_act = inner


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
# the SSM and hybrid families' (``rwkv``, ``mamba``, ``hybrid``): the
# norms, RWKV's time and channel mixes, a Mamba2 block's output and the
# shared blocks' attention and MLP outputs, each rounded as its block adds
# it to the residual (the unified attention keeps its context float32);
# one more site is inside a Mamba2 block: its gated norm (float32, of a
# float32 input), rounded before the output projection ("mamba_norm")
SSM_ROUND_SITES = (("layers", "rmsnorm", 0), ("rwkv", "_time_mix", 1),
                   ("rwkv", "_channel_mix", 1), ("mamba", "mamba_apply", 1),
                   ("layers", "attention", 1), ("layers", "mlp", 1))


def site_names(sites=ROUND_SITES):
    """The log's keys of ``sites``: each site's function, "context" when
    the decoder's attention is one of them and "mamba_norm" when a Mamba2
    block is."""
    names = tuple(name for _, name, _ in sites)
    return (names + (("context",) if "_attention_dynwin" in names else ())
            + (("mamba_norm",) if "mamba_apply" in names else ()))


SITE_NAMES = site_names()


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _with_first(out, first):
    return (first, *out[1:]) if isinstance(out, tuple) else first


class _Sites:
    """Wraps the rounding ``sites`` (``ROUND_SITES``, with the decoder's
    attention context) of one package (``repro`` or ``repro_torch``);
    ``on_round(name, f, res)`` sees each site call whose input x is
    bfloat16, outside an MoE layer, with ``f`` its float32 value before
    the rounding, and returns the call's result."""

    def __init__(self, package, bf16, f32, on_round, setattr_=setattr,
                 sites=ROUND_SITES):
        import importlib
        self.depth, self.in_attn, self.saved = 0, False, []
        self.in_mamba = False

        def patch(module, name, wrapper):
            fn = getattr(module, name)
            self.saved.append((module, name, fn))
            setattr_(module, name, wrapper(fn))

        for mod, name, at in sites:
            patch(importlib.import_module(f"{package}.models.{mod}"), name,
                  lambda fn, name=name, at=at: self._site(
                      package, name, at, fn, bf16, f32, on_round))
        if "context" not in site_names(sites):
            return
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
            outer, outer_m = self.in_attn, self.in_mamba
            self.in_attn = (name == "_attention_dynwin" and not self.depth
                            and args[at].dtype == bf16)
            if name == "mamba_apply":
                self.in_mamba = args[at].dtype == bf16
            self.depth += name == "moe_apply"
            try:
                res = fn(*args, **kwargs)
            finally:
                self.depth -= name == "moe_apply"
                self.in_attn, self.in_mamba = outer, outer_m
            if (name == "rmsnorm" and self.in_mamba and not self.depth
                    and args[at].dtype == f32):
                return on_round("mamba_norm", res, res)
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
def jax_round_log(sites=ROUND_SITES):
    """While open, the float32 value before each rounding at ``sites``
    of the JAX package reports to the host as a numpy array, in call
    order, one list a site."""
    import jax
    import jax.numpy as jnp

    logs = {name: _Log() for name in site_names(sites)}

    def on_round(name, f, res):
        jax.debug.callback(lambda h: logs[name].calls.append(
            np.asarray(h, np.float32)), jax.lax.stop_gradient(f),
            ordered=True)
        return res

    jax.clear_caches()
    wrapped = _Sites("repro", jnp.bfloat16, jnp.float32, on_round,
                     sites=sites)
    try:
        yield logs
    finally:
        wrapped.restore()
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

    def __init__(self, monkeypatch, strict: bool = True, sites=ROUND_SITES):
        import torch
        self.calls, self.n = {}, {}
        self.pinned, self.strict, self.diverged = 0, strict, False
        self.ended = 0
        _Sites("repro_torch", torch.bfloat16, torch.float32, self._round,
               monkeypatch.setattr, sites)

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


# The normalized attention probabilities P of the decoder family's
# attention on a bfloat16 or fp8 cache are rounded to V's type before P V
# (``round_p``), and K and V to the cache's type as a step writes them:
# an e4m3 code is 1/16 of its value wide, and a float32 value at a
# rounding midpoint whose last bits differ between the packages (float32
# sums in other orders; RoPE's rotation cancels) takes codes one apart,
# which moves the reduced models' logits by ~0.04.  Such a tie is taken
# where the two values lie within ``ROUND_TIE`` of the call's largest
# |value| of the midpoint, as ``RoundPins`` takes bfloat16 ties.


@contextlib.contextmanager
def jax_probs_log():
    """While open, every float32 softmax of 5-D logits in the JAX package
    (the decoder attention's (B, Hkv, G, Sq, Skv) probabilities, before
    they are rounded to V's type) reports to the host as a numpy array,
    in call order."""
    import jax

    log = _Log()
    inner = jax.nn.softmax

    def logged(x, axis=-1, *args, **kwargs):
        out = inner(x, axis, *args, **kwargs)
        if out.ndim == 5 and out.dtype == np.float32:
            jax.debug.callback(lambda h: log.calls.append(
                np.asarray(h, np.float32)), jax.lax.stop_gradient(out),
                ordered=True)
        return out

    jax.clear_caches()
    jax.nn.softmax = logged
    try:
        yield log
    finally:
        jax.nn.softmax = inner
        jax.clear_caches()


class ProbPins:
    """The port's rounding of P to V's type (``ref.round_probs``, the
    plain attention's ``round_p``), pinned to a JAX log
    (``jax_probs_log``): ``load(calls)`` gives the next run's JAX P's, one
    a call; where the port's P rounds to another code than the JAX P, the
    two must lie within ``ROUND_TIE`` of the call's largest P of each
    other (a rounding tie); there the JAX code is taken, counted in
    ``pinned``.  Any other difference fails."""

    def __init__(self, monkeypatch):
        from repro_torch.kernels.flash_attention import ref
        self.calls, self.n, self.pinned = [], 0, 0
        inner = ref.round_probs

        def pinned(probs, dtype):
            got = inner(probs, dtype)
            if dtype == probs.dtype:
                return got
            import torch
            assert self.n < len(self.calls), (
                f"P call {self.n}: the JAX log has {len(self.calls)}")
            w = torch.as_tensor(np.array(self.calls[self.n])).reshape(
                probs.shape)
            self.n += 1
            want = inner(w, dtype)
            # float8 has no comparison or where: its bits do
            bits = (lambda t: t.view(torch.uint8)) \
                if got.element_size() == 1 else (lambda t: t)
            differ = bits(got) != bits(want)
            if not bool(differ.any()):
                return got
            tie = (probs - w).abs() <= ROUND_TIE * float(w.abs().max())
            bad = differ & ~tie
            assert not bool(bad.any()), (
                f"P call {self.n - 1}: codes differ away from a rounding "
                f"tie at {probs[bad][:4].tolist()} (JAX {w[bad][:4].tolist()})")
            self.pinned += int(differ.sum())
            return torch.where(differ, bits(want), bits(got)).view(dtype)

        monkeypatch.setattr(ref, "round_probs", pinned)

    def load(self, calls):
        self.calls, self.n = list(calls), 0

    def done(self) -> bool:
        return self.n == len(self.calls)


class CachePins:
    """The port's writes to an fp8 cache (``layers.to_cache``), pinned to
    the JAX run's final cache codes: ``k_bits`` / ``v_bits`` (L, B, T, H,
    D) uint8 of its L cache layers, every position written once (a
    prefill of ``prompt`` rows, then one row a decode step).  The port's
    n-th fp8 write is pass n // (2 L) (the prefill, then a step each),
    layer (n // 2) % L, K then V; where its code differs from the JAX
    code, the value written must lie within ``ROUND_TIE`` of the write's
    largest |value| of the midpoint between the two codes' values (a
    rounding tie); there the JAX code is taken, counted in ``pinned``.
    Any other difference fails."""

    def __init__(self, monkeypatch, k_bits, v_bits, prompt: int):
        import torch
        from repro_torch.models import layers as L
        self.want, self.prompt = (k_bits, v_bits), prompt
        self.n, self.pinned = 0, 0
        inner = L.to_cache

        def pinned(x, dtype):
            got = inner(x, dtype)
            if dtype != torch.float8_e4m3fn:
                return got
            layers = self.want[0].shape[0]
            step, rest = divmod(self.n, 2 * layers)
            layer, kind = divmod(rest, 2)
            self.n += 1
            rows = (slice(0, prompt) if step == 0
                    else slice(prompt + step - 1, prompt + step))
            w = torch.from_numpy(np.ascontiguousarray(
                self.want[kind][layer][:, rows])).view(dtype)
            assert w.shape == got.shape, (self.n - 1, w.shape, got.shape)
            differ = got.view(torch.uint8) != w.view(torch.uint8)
            if not bool(differ.any()):
                return got
            mid = (got.float() + w.float()) / 2
            xf = x.float()
            tie = (xf - mid).abs() <= ROUND_TIE * float(xf.abs().max())
            bad = differ & ~tie
            assert not bool(bad.any()), (
                f"cache write {self.n - 1}: codes differ away from a "
                f"rounding tie at {xf[bad][:4].tolist()} (JAX "
                f"{w.float()[bad][:4].tolist()})")
            self.pinned += int(differ.sum())
            return torch.where(differ, w.view(torch.uint8),
                               got.view(torch.uint8)).view(dtype)

        monkeypatch.setattr(L, "to_cache", pinned)


class WritePins:
    """The port's writes to a bfloat16 or e4m3 cache (``layers.to_cache``,
    called once a layer, K then V, on the step's rows: every rank of a
    sequence-split cache converts the step's rows, then writes its own),
    pinned to the JAX run's: ``writes`` [(k, v) a step], each (L, B, rows,
    H, D) float32 of the cache's values
    (``_torch_seqshard_ref.cache_writes``).  Where the port's code differs
    from the JAX code the value written must lie within ``ROUND_TIE`` of
    the write's largest |value| of the midpoint between the two codes'
    values (a rounding tie); there the JAX code is taken, counted in
    ``pinned``.  Any other difference fails."""

    def __init__(self, monkeypatch, writes):
        import torch
        from repro_torch.models import layers as L
        self.writes, self.n, self.pinned = writes, 0, 0
        inner = L.to_cache

        def pinned(x, dtype):
            got = inner(x, dtype)
            if dtype == torch.float32:
                return got
            layers = self.writes[0][0].shape[0]
            step, rest = divmod(self.n, 2 * layers)
            layer, kind = divmod(rest, 2)
            self.n += 1
            w = torch.tensor(np.asarray(self.writes[step][kind][layer],
                                        np.float32)).to(dtype)
            assert w.shape == got.shape, (self.n - 1, w.shape, got.shape)
            view = torch.uint8 if got.element_size() == 1 else torch.int16
            differ = got.view(view) != w.view(view)
            if not bool(differ.any()):
                return got
            mid = (got.float() + w.float()) / 2
            xf = x.float()
            tie = (xf - mid).abs() <= ROUND_TIE * float(xf.abs().max())
            bad = differ & ~tie
            assert not bool(bad.any()), (
                f"cache write {self.n - 1}: codes differ away from a "
                f"rounding tie at {xf[bad][:4].tolist()} (JAX "
                f"{w.float()[bad][:4].tolist()})")
            self.pinned += int(differ.sum())
            return torch.where(differ, w.view(view),
                               got.view(view)).view(dtype)

        monkeypatch.setattr(L, "to_cache", pinned)

    def done(self) -> bool:
        layers = self.writes[0][0].shape[0]
        return self.n == 2 * layers * len(self.writes)


# ---------------------------------------------------------------------------
# every affine code at a round(x / s) tie, located by position (training)
# ---------------------------------------------------------------------------

FINGERPRINT = 64      # elements of x / s that tell one quantization from another


def _fingerprint_at(n: int) -> np.ndarray:
    """FINGERPRINT fixed flat positions of a tensor of n elements."""
    k = min(FINGERPRINT, n)
    return (np.arange(k, dtype=np.int64) * 7919) % n


def code_record(ratio: np.ndarray, codes: np.ndarray, bits: int,
                tie: float = TIE) -> dict:
    """One affine quantization's record: its shape, x / s at
    ``_fingerprint_at``'s positions, and the flat positions whose x / s
    lies within ``tie`` of a half-integer (inside the clip) with their
    codes."""
    flat = np.asarray(ratio, np.float32).reshape(-1)
    mag = np.abs(flat.astype(np.float64))
    near = (np.abs(mag - np.floor(mag) - 0.5) < tie) & (
        mag < 2.0 ** (bits - 1) - 1)
    at = np.flatnonzero(near).astype(np.int32)
    return {"shape": list(np.shape(ratio)),
            "fp": flat[_fingerprint_at(flat.size)].astype(np.float32),
            "at": at, "codes": np.asarray(codes).reshape(-1)[at]
            .astype(np.int16)}


@contextlib.contextmanager
def jax_code_log():
    """While open, every affine quantization of the JAX package
    (``repro.quant.fake_quant.affine_quantize``: weights per channel,
    activations per tensor, an MoE layer's experts one call an expert
    under vmap; in a training step's forward and its rematerialized
    replay alike) adds its ``code_record`` to the yielded list, in the
    order the host sees them (the records are matched by position and
    fingerprint, not by order)."""
    import jax
    from repro.quant import fake_quant as JFQ

    log = []
    inner = JFQ.affine_quantize
    jax.clear_caches()

    def logged(x, scale, bits):
        out = inner(x, scale, bits)
        ratio = jax.lax.stop_gradient(x / scale)

        def host(r, c):
            log.append(code_record(np.asarray(r), np.asarray(c), bits))

        jax.debug.callback(host, ratio, jax.lax.stop_gradient(out))
        return out

    JFQ.affine_quantize = logged
    try:
        yield log
    finally:
        JFQ.affine_quantize = inner
        jax.clear_caches()


def unique_records(log) -> list:
    """The log without the replays of a quantization (the same shape and
    fingerprint, bit for bit)."""
    seen, out = set(), []
    for r in log:
        key = (tuple(r["shape"]), r["fp"].tobytes())
        if key not in seen:
            seen.add(key)
            out.append(r)
    return out


class CodePins:
    """The port's affine quantizations (the ``fake_quant`` kernel's plain
    version, through ``quant.fake_quant._fused_group``) pinned to a JAX
    log of ``code_record``s: each call finds the record of its shape
    whose fingerprint matches its x / s within ``match`` (the two
    packages read up to 1.2e-3 of a code apart there on the MoE capacity
    run; two steps' quantizations differ by 0.6 and more), and at the
    record's tie positions where its own
    code differs from JAX's takes JAX's, counted in ``pinned``.  A call
    with no record counts in ``unmatched``."""

    def __init__(self, records, match: float = 1e-2):
        self.match = match
        self.by_shape = {}
        for r in records:
            self.by_shape.setdefault(tuple(r["shape"]), []).append(r)
        self.pinned = self.calls = self.unmatched = 0

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.quant import fake_quant as FQ
        inner = FQ._fused_group

        def fused(xs, scales, mode, bits=8):
            outs = inner(xs, scales, mode, bits)
            if mode != "affine":
                return outs
            return [self._pin(x, s, o, bits) for x, s, o in
                    zip(xs, scales, outs)]

        FQ._fused_group = fused
        try:
            yield self
        finally:
            FQ._fused_group = inner

    def _pin(self, x, scale, out, bits):
        import torch
        self.calls += 1
        s = scale.reshape(-1) if scale.numel() == 1 else scale
        ratio = (x / s).reshape(-1)
        fp = ratio[torch.as_tensor(_fingerprint_at(ratio.numel()))].numpy()
        best, gap = None, self.match
        for r in self.by_shape.get(tuple(x.shape), ()):
            d = float(np.abs(r["fp"] - fp).max()) if fp.size else 0.0
            if d < gap:
                best, gap = r, d
        if best is None:
            self.unmatched += 1
            return out
        at = torch.as_tensor(best["at"].astype(np.int64))
        if not at.numel():
            return out
        qmax = 2.0 ** (bits - 1) - 1.0
        mine = torch.clamp(torch.round(ratio[at]), -qmax, qmax)
        want = torch.as_tensor(best["codes"].astype(np.float32)).to(
            mine.dtype)
        differ = mine != want
        if not bool(differ.any()):
            return out
        assert bool(((mine - want).abs() <= 1)[differ].all()), \
            "a code away from JAX's by more than one level at a tie"
        self.pinned += int(differ.sum())
        steps = torch.broadcast_to(s, x.shape).reshape(-1)[at]
        flat = out.reshape(-1).clone()
        flat[at] = torch.where(differ, want * steps, flat[at])
        return flat.reshape(out.shape)


def records_to_json(records) -> list:
    import base64

    def b64(a):
        return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()

    return [{"shape": r["shape"], "fp": b64(r["fp"]), "at": b64(r["at"]),
             "codes": b64(r["codes"])} for r in records]


def records_from_json(items) -> list:
    import base64

    def un(s, dt):
        return np.frombuffer(base64.b64decode(s), dt)

    return [{"shape": r["shape"], "fp": un(r["fp"], np.float32),
             "at": un(r["at"], np.int32), "codes": un(r["codes"], np.int16)}
            for r in items]
