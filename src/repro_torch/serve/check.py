"""Record what a serving run generates, and hold it to a reference run.

The serving smoke of the port (``chip_smoke.py``) and the script that
writes its reference from the JAX package (``tests/_torch_serve_ref.py``)
drive their engines through the same ``record``: both engines call
``self._prefill`` / ``self._decode`` once per step, and ``record`` wraps
those two to keep, for every request and step, the token the engine
chose, the top-2 logit margin, the chosen token's logit and a slice of
the logits.  ``compare`` holds one record to another at a logit
tolerance: a token may differ only from a step where the reference's
top-2 margin is below that tolerance (a near tie, which any other order
of the float32 sums can flip); before that, tokens are equal and logits
agree within the tolerance.
"""

from __future__ import annotations

import numpy as np

SLICE = 8              # logits kept per step: token ids 0..SLICE-1
PROMPT_LENS = (8, 37, 100, 130)
REUSE_LENS = (8, 37, 100, 130, 20, 64)   # 6 requests in 4 slots
BATCH_SLOTS = 4
MAX_LEN = 256
MAX_NEW = 12
REUSE_MAX_NEW = 6
PARAM_SEED = 0
PROMPT_SEED = 1
MIN_SIZE = 1 << 10     # examples/serve_quantized.py's quantize_params floor


def mode_key(pe_type: str, dtype: str) -> str:
    """The reference's key of a run: "lightpe1", or "lightpe1/float32"
    for a compute type other than the config's bfloat16."""
    return pe_type if dtype == "bfloat16" else f"{pe_type}/{dtype}"


def prompts(vocab: int, lens=PROMPT_LENS, seed: int = PROMPT_SEED):
    """The smoke's prompts: token ids drawn from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int64) for n in lens]


def record(engine, prompt_list, max_new: int, to_numpy) -> dict:
    """Serve ``prompt_list`` on ``engine`` and return, per request,
    ``tokens``, ``margins``, ``top_logits`` and ``logits`` (the first
    SLICE of each step).  ``to_numpy`` turns the engine's logits into a
    numpy array."""
    reqs = [engine.submit(p, max_new=max_new) for p in prompt_list]
    rows = {id(r): [] for r in reqs}

    def wrap(fn):
        def step(params, tokens, cache):
            occupants = list(engine.slots)
            logits, cache = fn(params, tokens, cache)
            last = np.asarray(to_numpy(logits), np.float32)[:, -1]
            for slot, r in enumerate(occupants):
                if r is not None:
                    rows[id(r)].append(last[slot])
            return logits, cache
        return step

    prefill, decode = engine._prefill, engine._decode
    engine._prefill, engine._decode = wrap(prefill), wrap(decode)
    try:
        engine.run()
    finally:   # the wrappers hold the engine: no cycle keeps its cache
        engine._prefill, engine._decode = prefill, decode
    out = {"tokens": [], "margins": [], "top_logits": [], "logits": []}
    for r in reqs:
        steps = rows[id(r)]
        out["tokens"].append([int(t) for t in r.out])
        margins, tops, heads = [], [], []
        for row in steps:
            top = int(np.argmax(row))
            rest = np.delete(row, top)
            margins.append(float(row[top] - rest.max()))
            tops.append(float(row[top]))
            heads.append([float(v) for v in row[:SLICE]])
        out["margins"].append(margins)
        out["top_logits"].append(tops)
        out["logits"].append(heads)
    return out


def _logit_err(got: dict, want: dict, i: int, t: int) -> float:
    """Largest difference of request i's kept logits at step t."""
    return max(abs(got["top_logits"][i][t] - want["top_logits"][i][t]),
               float(np.max(np.abs(np.subtract(got["logits"][i][t],
                                               want["logits"][i][t])))))


def compare(got: dict, want: dict, tol: float, coupled: bool = False):
    """(problems, notes) of ``got`` against the reference ``want``.

    ``coupled``: the requests share numbers across the batch (QAT
    numerics: one activation scale for the whole batch), so a token that
    differs in one request moves the logits of all from the next step on;
    then no request is compared past the first step at which any token
    differed.  The requests must have run in lockstep (all admitted at
    the first step, with the same ``max_new``), so that step t of every
    request is the same engine step."""
    problems, notes = [], []
    last = None
    if coupled:
        firsts = [next((t for t, (a, b) in enumerate(zip(gt, wt)) if a != b),
                       None)
                  for gt, wt in zip(got["tokens"], want["tokens"])]
        if any(f is not None for f in firsts):
            last = min(f for f in firsts if f is not None)
    for i, (gt, wt) in enumerate(zip(got["tokens"], want["tokens"])):
        if len(gt) != len(wt):
            problems.append(f"request {i}: {len(gt)} tokens, reference "
                            f"{len(wt)}")
            continue
        for t, (a, b) in enumerate(zip(gt, wt)):
            if last is not None and t > last:
                notes.append(f"request {i}: not compared after step {last}, "
                             f"where a token of the batch differed")
                break
            err = _logit_err(got, want, i, t)
            if err > tol:
                problems.append(f"request {i} step {t}: logits differ by "
                                f"{err:.3g} > {tol}")
                break
            if a != b:
                margin = want["margins"][i][t]
                if margin >= tol:
                    problems.append(f"request {i} step {t}: token {a} vs "
                                    f"reference {b} at margin {margin:.3g}")
                else:
                    notes.append(f"request {i} step {t}: token {a} vs {b} "
                                 f"at a near tie (margin {margin:.3g}); "
                                 f"not compared further")
                break
    return problems, notes


def compared_steps(got: dict, want: dict, coupled: bool = False) -> list:
    """Steps of each request that ``max_logit_err`` reads: up to and
    including the first at which the request's tokens differ
    (``coupled``: at which any request's did), all of them where none
    did."""
    firsts = [next((t for t, (a, b) in enumerate(zip(gt, wt)) if a != b),
                   None)
              for gt, wt in zip(got["tokens"], want["tokens"])]
    stop = [f for f in firsts if f is not None]
    steps = []
    for i, (gt, wt) in enumerate(zip(got["tokens"], want["tokens"])):
        last = min(stop) if coupled and stop else firsts[i]
        n = min(len(gt), len(wt))
        steps.append(n if last is None else min(n, last + 1))
    return steps


def max_logit_err(got: dict, want: dict, coupled: bool = False) -> float:
    """Largest logit difference over the steps where both runs had fed
    the same tokens so far (``coupled``: in every request of the batch,
    as ``compare`` takes it)."""
    return max((_logit_err(got, want, i, t)
                for i, n in enumerate(compared_steps(got, want, coupled))
                for t in range(n)), default=0.0)
