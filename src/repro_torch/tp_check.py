"""The tensor-parallel split on ranks of one ``model`` group, held to one
rank: the runs of ``chip_smoke.py`` phases 18.1-20.1 and of the CPU
tests.

Its ``TASKS`` run on the ranks of ``repro_torch.launch.ranks`` (each
rank on a (1, world) ("data", "model") mesh on its device; on a card the
ranks may share one device over gloo, which stages the card's tensors
through the host, since NCCL refuses two ranks on one GPU):

  * "train" (``train_run``): ``steps`` AdamW steps of a config from
    seed-0 params on ``lm_pipeline``'s batches through
    ``trainer.jit_train_step``: each step's loss and gradient norm, step
    time, each kernel's launches a step, the peak memory, and a digest
    of the params before and after (``param_digest``: fixed elements of
    every leaf, gathered over the mesh);
  * "serve" (``serve_run``): a prompt then decode steps on given tokens
    (teacher-forced) of any family with the params in the "serve"
    shardings (packed by ``quantize_params`` if asked) and the cache as
    ``cache_spec`` splits it (its heads over ``model``, or where they do
    not divide it its sequence, as the reference's perf runner asks; an
    SSM state over its heads, a conv window over its channels): each
    step's last logits gathered over the vocabulary split, the greedy
    tokens (``layers.greedy_tokens``), step times, launches, peak
    memory.

A task's ``variant`` (``variant``) runs another function on purpose: the
plain whole-layer step the token split is timed against, or a control
that must miss the one-rank run.  With no mesh both tasks run the plain
trainer / the model on one rank, the runs they are held to.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

DIGEST = 4096           # elements a leaf in ``param_digest``


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device):
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def _counters():
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    return dict(fake_quant=(fake_quant, "launches"),
                flash_attention=(flash_attention, "launches"),
                flash_attention_backward=(flash_attention,
                                          "backward_launches"),
                flash_attention_wgmma=(flash_attention, "wgmma_launches"),
                flash_attention_fp8=(flash_attention, "fp8_launches"),
                flash_attention_stats=(flash_attention, "stats_launches"),
                flash_attention_pass2=(flash_attention, "pass2_launches"),
                quant_matmul=(quant_matmul, "launches"))


def zero_launches() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def launches() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def _positions(n: int, k: int) -> torch.Tensor:
    """min(k, n) fixed flat positions of a leaf of n elements, by a stride
    coprime with n (a digest of k elements is the first k of a longer
    one's)."""
    step = 1_000_003
    while np.gcd(step, n) != 1:
        step += 2
    return (torch.arange(min(k, n), dtype=torch.int64) * step) % n


def param_digest(params, shardings=None, k: int = DIGEST) -> dict:
    """{path: float32 numpy array} of ``k`` fixed elements of every leaf
    of ``params`` (each rank's shards gathered over the mesh first when
    ``shardings`` is given: a collective, leaf by leaf)."""
    from repro_torch.launch.sharding import map_with_path
    from repro_torch.optim import tree_map
    out = {}

    def take(path, x, sh=None):
        full = sh.gather(x) if sh is not None else x
        flat = full.detach().reshape(-1)
        at = _positions(flat.numel(), k).to(flat.device)
        out[path] = flat[at].to(torch.float32).cpu().numpy()

    if shardings is None:
        map_with_path(take, params)
    else:
        paths = map_with_path(lambda p, _: p, params)
        tree_map(lambda p, x, sh: take(p, x, sh), paths, params, shardings)
    return out


def change_gap(start: dict, got: dict, want: dict) -> float:
    """The largest ``|d_got - d_want| / |d_want|`` over the leaves whose
    digest moved, d the change from ``start`` (float64 norms)."""
    gaps = [0.0]
    for k, s in start.items():
        s = s.astype(np.float64)
        d_want = want[k].astype(np.float64) - s
        if np.abs(d_want).max() == 0:
            continue
        d_got = got[k].astype(np.float64) - s
        gaps.append(float(np.linalg.norm(d_got - d_want)
                          / np.linalg.norm(d_want)))
    return max(gaps)


def train_run(cfg, steps: int, batch: int, seq: int, device=None,
              mesh=None, params=None, batches=None,
              count: bool = False, nudge: float = 0.0) -> dict:
    """``steps`` AdamW steps (``train_check.LM_SCHEDULE``) of ``cfg`` on
    ``lm_pipeline``'s batches (or ``batches``, a global batch of numpy
    arrays a step, of which a rank takes its dp slice) from seed-0 params
    drawn on ``device`` (or ``params``, a full tree), through
    ``jit_train_step`` on ``mesh`` or the plain trainer.  ``count``: one
    more step after the run, under ``op_analysis.analyze``: its FLOPs and
    collective bytes (this rank's).  ``nudge``: the embedding scaled by
    (1 + nudge) before the first step (a twin run, the one-rank run's own
    spread under a perturbation of the size of the sum order's)."""
    from repro_torch.data import lm_pipeline
    from repro_torch.models import family_module
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import (TrainState, init_state, jit_train_step,
                                   make_train_step, shard_state,
                                   state_shardings_for)
    from repro_torch.train_check import LM_SCHEDULE

    device = resolve_device(device)
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(*LM_SCHEDULE))
    if params is None:
        dev = device
        gen = (torch.Generator(device=dev) if dev.type == "cuda"
               else torch.Generator()).manual_seed(0)
        state = init_state(cfg, mod, opt, gen, device=device)
    else:
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32, device=device))
    if nudge:
        with torch.no_grad():
            state.params["embed"].mul_(1 + nudge)
    start = param_digest(state.params)
    step = make_train_step(cfg, mod, opt)
    sh = None
    if mesh is not None:
        sh = state_shardings_for(cfg, mod, mesh, opt)
        state = shard_state(state, sh)
        step = jit_train_step(step, sh, mesh)
    if batches is None:
        pipe = lm_pipeline(cfg, batch, seq, device=device, mesh=mesh)
    else:
        pipe = iter([_dp_slice(b, mesh, device) for b in batches])
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rows, times, counts, counted = [], [], [], {}
    for _ in range(steps):
        b = next(pipe)
        _sync(device)
        zero_launches()
        t0 = time.perf_counter()
        state, m = step(state, b)
        rows.append([m["loss"].item(), m["grad_norm"].item()])
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(launches())
    peak = _peak(device)
    final = param_digest(state.params, None if sh is None else sh.params)
    if count:
        from repro_torch.launch.op_analysis import analyze
        _, rep = analyze(step, state, b)
        counted = dict(flops=rep["flops"], collectives=rep["collectives"])
    return dict(rows=rows, step_ms=times, launches=counts, peak_gib=peak,
                start=start, final=final, **counted)


def _dp_slice(batch: dict, mesh, device) -> dict:
    """This rank's dp slice of a global batch of numpy arrays, as tensors
    on ``device``."""
    from repro_torch.launch.mesh import dp_index, dp_total
    n = dp_total(mesh) if mesh is not None else 1
    i = dp_index(mesh)
    out = {}
    for k, v in batch.items():
        rows = v.shape[0] // n
        out[k] = torch.as_tensor(np.ascontiguousarray(
            v[i * rows:(i + 1) * rows]), device=device)
    return out


def serve_run(cfg, tokens, prompt: int, cache_rows: int, device=None,
              mesh=None,
              quant=None, cache_dtype=torch.float8_e4m3fn,
              params=None, pack_min: int = 1 << 14,
              keep_cache: bool = False) -> dict:
    """A prefill of ``tokens[:, :prompt]`` into a cache of ``cache_rows``
    rows, then a decode step on each later token (teacher-forced), with
    seed-0 params drawn on ``device`` (or ``params``), packed by
    ``quant`` (leaves of at least ``pack_min`` elements); on ``mesh`` each
    rank holds its "serve" shards and its part of the cache (its heads,
    or where they do not divide ``model`` its slice of the rows; every
    rank holds the whole batch).  Each step's last logits (gathered over
    the vocabulary split) and greedy tokens, on the host; with
    ``keep_cache`` also the rank's cache at the end ({path: float32
    numpy}, "cache")."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.sharding import (Sharding, cache_seq_axes,
                                             cache_spec,
                                             make_param_shardings,
                                             map_with_path, seq_sharded)
    from repro_torch.models import family_module
    from repro_torch.models import layers as L
    from repro_torch.optim import tree_map
    from repro_torch.serve.engine import quantize_params
    from repro_torch.train.trainer import model_kept

    device = resolve_device(device)
    T = family_module(cfg)
    if params is None:
        dev = device
        gen = (torch.Generator(device=dev) if dev.type == "cuda"
               else torch.Generator()).manual_seed(0)
        params = T.init_params(cfg, gen, device=device)
    if quant:
        params = quantize_params(params, quant, min_size=pack_min)
    b = tokens.shape[0]
    shapes = T.init_cache(cfg, b, cache_rows, cache_dtype, device="meta")
    seq_shard = mesh is not None and seq_sharded(cfg, mesh)
    ctx = M.activation_sharding(
        (), 1, mesh=mesh, split=mesh is not None,
        seq_axes=cache_seq_axes(cfg, mesh, b, seq_shard) if seq_shard
        else None)
    if mesh is not None:
        p_shard = make_param_shardings(cfg, params, mesh, "serve")
        kept = model_kept(cfg, T, p_shard)
        params = tree_map(lambda x, s, k: s.gather(s.shard(x), keep=k),
                          params, p_shard, kept)

        def local(path, x):
            if not torch.is_tensor(x):
                return x
            sh = Sharding(mesh, cache_spec(cfg, mesh, path, tuple(x.shape),
                                           seq_shard))
            if M.dp_total(mesh) > 1 and M.dp_axes(mesh) in sh.spec:
                raise ValueError(f"serve_run holds the whole batch on every "
                                 f"rank, not a cache split over the dp axes "
                                 f"({sh.spec})")
            return torch.zeros(sh.local_shape(x.shape), dtype=x.dtype,
                               device=device)
        cache = map_with_path(local, shapes)
    else:
        cache = map_with_path(lambda _, x: torch.zeros(
            x.shape, dtype=x.dtype, device=device) if torch.is_tensor(x)
            else x, shapes)
    split = M.current_split
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    logits_all, greedy, times = [], [], []
    zero_launches()
    with torch.no_grad(), ctx:
        for i in range(1 + tokens.shape[1] - prompt):
            _sync(device)
            t0 = time.perf_counter()
            if i == 0:
                logits, cache = T.prefill(params, tokens[:, :prompt], cfg,
                                          cache)
            else:
                at = prompt + i - 1
                logits, cache = T.decode_step(params, tokens[:, at:at + 1],
                                              cfg, cache)
            last = logits[:, -1]
            greedy.append(L.greedy_tokens(last, cfg.padded_vocab).cpu()
                          .numpy())
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
            logits_all.append(_whole_vocab(last.float(), split()))
    out = dict(logits=np.stack(logits_all), greedy=np.stack(greedy),
               step_ms=times, launches=launches(), peak_gib=_peak(device))
    if keep_cache:
        kept_cache = {}
        map_with_path(lambda path, x: kept_cache.__setitem__(
            path, x.to(torch.float32).cpu().numpy())
            if torch.is_tensor(x) else None, cache)
        out["cache"] = kept_cache
    return out


def _whole_vocab(x: torch.Tensor, split) -> np.ndarray:
    """(B, V / m) logits of each rank -> (B, V) on the host."""
    if split is None:
        return x.cpu().numpy()
    parts = [torch.empty_like(x) for _ in range(split.size)]
    dist.all_gather(parts, x.contiguous(), group=split.group)
    return torch.cat(parts, dim=-1).cpu().numpy()


def _config(task: dict):
    from repro_torch.configs import get, reduced
    cfg = (reduced if task.get("reduced") else get)(task["arch"])
    return cfg.replace(**task.get("overrides", {}))


@contextlib.contextmanager
def variant(name: str | None):
    """Another function than the split's, on purpose, while it is open:

    * "whole_layers": each layer the split leaves whole takes its weight
      gradients over every token on every rank, with no collective (the
      plain whole-layer step the token split, ``layers._TokenSplitGrad``,
      is timed against; the same gradients);
    * "unsummed_norms" (a control): the attention's 1-D replicated
      leaves (``q_norm`` / ``k_norm``) enter a split region without
      ``copy_to_model``, so their gradients stay each rank's part;
    * "per_rank_scales" (a control): every quantization scale that spans
      the model group taken over the rank's own slice (``fake_quant``'s
      model-group max made the identity);
    * "unsummed_leaves" (a control): the replicated leaves that RWKV6's
      mixes and Mamba2's blocks use for the rank's heads alone (``mu``,
      the decay's ``wa`` / ``wb`` / ``w0``, ``u``, ``ln_x``, the conv,
      ``a_log``, ``dt_bias``, ``d_skip``, the gated norm's scale) enter
      the split region without ``copy_to_model``
      (``layers.replicated_leaves`` made the identity), so their
      gradients stay each rank's part.
    """
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.quant import fake_quant as FQ
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in (
        (L, "_TokenSplitGrad"), (T, "copy_to_model"), (FQ, "model_max"),
        (FQ, "split_max"), (L, "replicated_leaves"))]
    copy = T.copy_to_model
    if name == "whole_layers":
        L._TokenSplitGrad = _WholeLayer
    elif name == "unsummed_norms":
        T.copy_to_model = lambda t: t if t.ndim == 1 else copy(t)
    elif name == "per_rank_scales":
        FQ.model_max, FQ.split_max = (lambda t: t), M.dp_max
    elif name == "unsummed_leaves":
        L.replicated_leaves = lambda p, names: {n: p[n] for n in names}
    elif name is not None:
        raise ValueError(f"no variant {name!r}")
    try:
        yield
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)


class _WholeLayer:
    """``layers._TokenSplitGrad`` as the plain product: autograd takes the
    weight's gradient over every token."""

    @staticmethod
    def apply(x, w, _split):
        return torch.matmul(x, w)


def run_task(task: dict, device, mesh) -> tuple:
    """(numbers, arrays) of one task: its ``kind`` (default its name),
    "train" or "serve", under its ``variant``, on ``mesh`` (None: one
    rank)."""
    cfg = _config(task)
    with variant(task.get("variant")):
        if task.get("kind", task["name"]) == "train":
            r = train_run(cfg, task["steps"], task["batch"], task["seq"],
                          device, mesh, nudge=task.get("nudge", 0.0))
            arrays = {f"start/{k}": v for k, v in r.pop("start").items()}
            arrays.update({f"final/{k}": v
                           for k, v in r.pop("final").items()})
            return r, arrays
        toks = torch.as_tensor(np.random.default_rng(
            task["token_seed"]).integers(0, cfg.vocab, size=(
                task["batch"], task["prompt"] + task["steps"])),
            device=device)
        r = serve_run(cfg, toks, task["prompt"], task["cache_rows"], device,
                      mesh, quant=task.get("quant"),
                      cache_dtype=getattr(torch, task.get(
                          "cache_dtype", "float8_e4m3fn")))
    return r, {"logits": r.pop("logits"), "greedy": r.pop("greedy")}


def task_split(task: dict, at) -> tuple:
    """A task on the rank ``at`` (``launch.ranks.Rank``) of a (1, world)
    mesh."""
    return run_task(task, at.device, at.mesh((1, at.world)))


TASKS = {"train": task_split, "serve": task_split}
