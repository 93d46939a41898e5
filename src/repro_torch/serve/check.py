"""Record what a serving run generates, and hold it to a reference run.

(``record_encdec`` records an encoder-decoder model's greedy run the
same way, through its ``prefill`` / ``decode_step``.)

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

An MoE model's runs also keep their routing (``record(router=...)``:
each step's expert ids and router margins, per request and MoE layer).
``compare(router_tol=...)`` then holds the routing too: it may differ
only at a token whose reference margin (k-th over (k+1)-th router
probability) is below ``router_tol``, a near tie of the router, and a
request is not compared from the step where its routing differs, nor is
one whose assignment that difference moved past capacity; under QAT
numerics (``coupled``: the per-expert activation scales couple the
batch's tokens) no request is.  So ``record(pins=..., want=...)`` can
give the MoE layers the reference's experts at its near ties
(``models.moe.RoutePins``): the routing then differs only where it is a
fault, and the run is compared past the ties.
"""

from __future__ import annotations

import numpy as np

from repro_torch.models.moe import kept

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
# Gemma-3-1B's run: the padded prompt crosses the 512-token window of
# every local layer, and decode runs at positions 900-911; no slot-reuse
# wave (the unreset cache index would clamp there, ROADMAP C)
GEMMA_PROMPT_LENS = (64, 300, 700, 900)
GEMMA_MAX_LEN = 1024


# Whisper-medium's run (an encoder-decoder model: the engine serves none,
# so the reference's entry points are driven directly): 4 rows of 1500
# frames (its 30 s window after the conv stem, drawn N(0, 1)), a prompt
# of 8 tokens a row, 12 greedy tokens, a cache of 448 rows (the model's
# max_target_positions)
WHISPER_BATCH = 4
WHISPER_FRAMES = 1500
WHISPER_PROMPT = 8
WHISPER_MAX_LEN = 448
FRAME_SEED = 2


def pin_pow2_codes(packed, ties: dict) -> dict:
    """Put the reference's pow2 codes into ``packed`` (the port's
    LightPE-1 packing of the same weights) at the weights ``ties`` lists
    (``tests/_torch_gemma3_ref.py``'s ``pow2_ties``: those whose log2 sits
    within 2 float32 ulps of a half-integer, where the two packages'
    ``log2`` may round to neighbouring codes).  Returns how many codes it
    changed and how many columns' e_max differ from the reference's at an
    absmax tie (a column it cannot pin)."""
    import torch

    def leaf(path):
        node = packed
        for key in path.split("/"):
            node = node[int(key)] if isinstance(node, list) else node[key]
        return node

    groups = {}
    for path, layer, k, n, code in ties["codes"]:
        groups.setdefault((path, layer), []).append((k, n, code))
    changed = 0
    for (path, layer), rows in groups.items():
        codes = leaf(path)["codes__pow2"]
        view = codes if layer < 0 else codes[layer]
        for parity, keep in ((0, 0xF0), (1, 0x0F)):
            sel = [(k // 2, n, c) for k, n, c in rows if k % 2 == parity]
            if not sel:
                continue
            ks, ns, want = (torch.tensor(x, device=codes.device)
                            for x in zip(*sel))
            byte = view[ks, ns]
            want = want.to(torch.uint8)
            changed += int(((byte >> (4 * parity)) & 0xF).ne(want).sum())
            view[ks, ns] = (byte & keep) | (want << (4 * parity))
    e_max_differ = 0
    for path, layer, n, e_max in ties["e_max"]:
        scale = leaf(path)["scale"]
        have = scale[n] if layer < 0 else scale[layer, n]
        e_max_differ += int(float(have) != e_max)
    return {"pinned": len(ties["codes"]), "changed": changed,
            "e_max_ties": len(ties["e_max"]), "e_max_differ": e_max_differ}


def mode_key(pe_type: str, dtype: str) -> str:
    """The reference's key of a run: "lightpe1", or "lightpe1/float32"
    for a compute type other than the config's bfloat16."""
    return pe_type if dtype == "bfloat16" else f"{pe_type}/{dtype}"


def prompts(vocab: int, lens=PROMPT_LENS, seed: int = PROMPT_SEED):
    """The smoke's prompts: token ids drawn from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int64) for n in lens]


def record(engine, prompt_list, max_new: int, to_numpy,
           router=None, pins=None, want=None) -> dict:
    """Serve ``prompt_list`` on ``engine`` and return, per request,
    ``tokens``, ``margins``, ``top_logits`` and ``logits`` (the first
    SLICE of each step).  ``to_numpy`` turns the engine's logits into a
    numpy array.  ``router`` (an MoE model's; ``drain()`` gives the
    routing of the MoE calls since the last drain as (ids (B, S, k),
    margin (B, S)) numpy pairs, as ``models.moe.RouterLog`` does) adds,
    per request and step, ``routes`` (each MoE layer's (S, k) expert
    ids) and ``route_margins`` (each layer's (S,) margins).  ``pins`` (a
    ``models.moe.RoutePins``) gets before each step the routing that the
    reference record ``want`` (of the same prompts) has for the requests
    in the slots at that step, so that the MoE layers take the
    reference's experts at its router near ties."""
    reqs = [engine.submit(p, max_new=max_new) for p in prompt_list]
    index = {id(r): i for i, r in enumerate(reqs)}
    rows = {id(r): [] for r in reqs}
    routes = {id(r): [] for r in reqs}
    route_margins = {id(r): [] for r in reqs}

    def wrap(fn):
        def step(params, tokens, cache):
            occupants = list(engine.slots)
            if pins is not None:
                pins.load(_step_routing(want, [
                    None if r is None else (index[id(r)], len(rows[id(r)]))
                    for r in occupants]))
            logits, cache = fn(params, tokens, cache)
            last = np.asarray(to_numpy(logits), np.float32)[:, -1]
            calls = router.drain() if router is not None else None
            for slot, r in enumerate(occupants):
                if r is not None:
                    rows[id(r)].append(last[slot])
                    if calls is not None:
                        routes[id(r)].append(
                            [np.asarray(ids)[slot].tolist()
                             for ids, _ in calls])
                        route_margins[id(r)].append(
                            [np.asarray(m, np.float64)[slot].tolist()
                             for _, m in calls])
            return logits, cache
        return step

    prefill, decode = engine._prefill, engine._decode
    engine._prefill, engine._decode = wrap(prefill), wrap(decode)
    try:
        engine.run()
    finally:   # the wrappers hold the engine: no cycle keeps its cache
        engine._prefill, engine._decode = prefill, decode
    out = _summary([[int(t) for t in r.out] for r in reqs],
                   [rows[id(r)] for r in reqs])
    if router is not None:
        out["routes"] = [routes[id(r)] for r in reqs]
        out["route_margins"] = [route_margins[id(r)] for r in reqs]
    return out


def _summary(tokens, rows) -> dict:
    """The record of requests' ``tokens`` and the float32 logit ``rows``
    of their steps: per request and step the top-2 margin, the top logit
    and the first SLICE logits."""
    out = {"tokens": tokens, "margins": [], "top_logits": [], "logits": []}
    for steps in rows:
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


def whisper_inputs(d_model: int, vocab: int, batch: int = WHISPER_BATCH,
                   frames: int = WHISPER_FRAMES, prompt: int = WHISPER_PROMPT,
                   seed: int = FRAME_SEED) -> dict:
    """Whisper's run inputs from ``default_rng(seed)``: frames (batch,
    frames, d_model) N(0, 1) float32 (the frontend stub's embeddings)
    and prompt tokens (batch, prompt)."""
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((batch, frames, d_model),
                                          dtype=np.float32),
            "tokens": rng.integers(0, vocab, size=(batch, prompt))}


def record_encdec(mod, params, cfg, batch, cache, max_new: int, to_numpy,
                  to_tokens) -> dict:
    """Greedy generation of an encoder-decoder model through its entry
    points (either package's): ``prefill`` (the encoder and the prompt),
    then ``decode_step`` on each chosen token (argmax of the float32
    logits over the padded vocabulary, as the serving engines choose)
    until ``max_new`` tokens a row; returns ``record``'s format, a
    request a batch row.  ``to_numpy`` turns logits into numpy,
    ``to_tokens`` a (B, 1) numpy array into the package's tokens."""
    logits, cache, enc = mod.prefill(params, batch, cfg, cache)
    rows, tokens = [], []
    for step in range(max_new):
        last = np.asarray(to_numpy(logits), np.float32)[:, -1]
        nxt = np.argmax(last, axis=-1)
        rows.append(last)
        tokens.append(nxt)
        if step + 1 < max_new:
            logits, cache = mod.decode_step(params, to_tokens(nxt[:, None]),
                                            enc, cfg, cache)
    return _summary([[int(t[i]) for t in tokens] for i in range(len(nxt))],
                    [[r[i] for r in rows] for i in range(len(nxt))])


def _step_routing(want: dict, at) -> list:
    """The routing of one engine step in ``want`` as (ids (B, S, k),
    margins (B, S)) a MoE layer; ``at``: each slot's (request, step), or
    None for an empty slot (ids 0, margins inf: never pinned)."""
    i0, t0 = next(a for a in at if a is not None)
    calls = []
    for layer, ids0 in enumerate(want["routes"][i0][t0]):
        fill = np.zeros_like(np.asarray(ids0))
        ids = [fill if a is None else want["routes"][a[0]][a[1]][layer]
               for a in at]
        margins = [np.full(fill.shape[0], np.inf) if a is None
                   else want["route_margins"][a[0]][a[1]][layer]
                   for a in at]
        calls.append((np.asarray(ids), np.asarray(margins)))
    return calls


def _logit_err(got: dict, want: dict, i: int, t: int) -> float:
    """Largest difference of request i's kept logits at step t."""
    return max(abs(got["top_logits"][i][t] - want["top_logits"][i][t]),
               float(np.max(np.abs(np.subtract(got["logits"][i][t],
                                               want["logits"][i][t])))))


def route_cut(got: dict, want: dict, router_tol: float,
              coupled: bool = False, capacity=None):
    """(cuts, problems, notes): per request, the first step from which it
    is not compared because the routing of ``got`` differs from the
    reference's there (None: compared throughout), within the steps where
    both fed the same tokens (``compared_steps``).

    A step's MoE layers are read in order.  Where a request's routing
    first differs, each differing token's reference margin must be below
    ``router_tol`` (a near tie); else it is a problem.  From there the
    request is affected: its later layers take other inputs, so their
    differences are not read.  Another request is affected too when a
    difference moved one of its assignments past capacity (``capacity``:
    an MoE layer's capacity for a token count; without it every request
    is), and every request is under ``coupled`` numerics (the per-expert
    activation scales span the batch).  The affected requests are cut at
    that step."""
    problems, notes = [], []
    n_req = len(got["tokens"])
    cuts = [None] * n_req
    n_steps = compared_steps(got, want, coupled)
    for t in range(max(n_steps, default=0)):
        live = [i for i in range(n_req)
                if t < n_steps[i] and cuts[i] is None]
        if not live:
            break
        affected = set()
        for layer in range(len(want["routes"][live[0]][t])):
            a = np.array([got["routes"][i][t][layer] for i in range(n_req)])
            b = np.array([want["routes"][i][t][layer] for i in range(n_req)])
            differ = np.any(a != b, axis=-1)                 # (B, S)
            flipped = set()
            for i in live:
                if i in affected:
                    continue
                for s in np.flatnonzero(differ[i]):
                    margin = want["route_margins"][i][t][layer][s]
                    what = (f"request {i} step {t} MoE layer {layer} token "
                            f"{s}: experts {a[i, s].tolist()} vs reference "
                            f"{b[i, s].tolist()} at router margin "
                            f"{margin:.3g}")
                    if margin >= router_tol:
                        problems.append(what)
                    else:
                        notes.append(what + " (a router near tie)")
                    flipped.add(i)
            affected |= flipped
            if not differ.any():
                continue
            if capacity is None or len(n_steps) != n_req:
                affected |= set(live)
                continue
            c = capacity(a.shape[0] * a.shape[1])
            moved = np.any((kept(a, c) != kept(b, c)) & ~differ[..., None],
                           axis=(1, 2))
            for i in live:
                if moved[i] and i not in affected:
                    notes.append(f"request {i} step {t} MoE layer {layer}: "
                                 f"an assignment moved past capacity")
                    affected.add(i)
        if affected and coupled:
            affected = set(live)
        for i in sorted(affected):
            cuts[i] = t
    return cuts, problems, notes


def compare(got: dict, want: dict, tol: float, coupled: bool = False,
            router_tol: float | None = None, capacity=None):
    """(problems, notes) of ``got`` against the reference ``want``.

    ``coupled``: the requests share numbers across the batch (QAT
    numerics: one activation scale for the whole batch), so a token that
    differs in one request moves the logits of all from the next step on;
    then no request is compared past the first step at which any token
    differed.  The requests must have run in lockstep (all admitted at
    the first step, with the same ``max_new``), so that step t of every
    request is the same engine step.  ``router_tol``: the routing is held
    too (``route_cut``, with ``capacity``), and a request is not compared
    from the step at which its routing differs at a near tie."""
    problems, notes = [], []
    last = None
    if coupled:
        firsts = [next((t for t, (a, b) in enumerate(zip(gt, wt)) if a != b),
                       None)
                  for gt, wt in zip(got["tokens"], want["tokens"])]
        if any(f is not None for f in firsts):
            last = min(f for f in firsts if f is not None)
    cuts = [None] * len(got["tokens"])
    if router_tol is not None:
        cuts, route_problems, route_notes = route_cut(
            got, want, router_tol, coupled, capacity)
        problems += route_problems
        notes += route_notes
    for i, (gt, wt) in enumerate(zip(got["tokens"], want["tokens"])):
        if len(gt) != len(wt):
            problems.append(f"request {i}: {len(gt)} tokens, reference "
                            f"{len(wt)}")
            continue
        for t, (a, b) in enumerate(zip(gt, wt)):
            if cuts[i] is not None and t >= cuts[i]:
                notes.append(f"request {i}: not compared from step "
                             f"{cuts[i]}, where the routing differed")
                break
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


def compared_steps(got: dict, want: dict, coupled: bool = False,
                   cuts=None) -> list:
    """Steps of each request that ``max_logit_err`` reads: up to and
    including the first at which the request's tokens differ
    (``coupled``: at which any request's did), all of them where none
    did; none from its step in ``cuts`` on (``route_cut``'s)."""
    firsts = [next((t for t, (a, b) in enumerate(zip(gt, wt)) if a != b),
                   None)
              for gt, wt in zip(got["tokens"], want["tokens"])]
    stop = [f for f in firsts if f is not None]
    steps = []
    for i, (gt, wt) in enumerate(zip(got["tokens"], want["tokens"])):
        last = min(stop) if coupled and stop else firsts[i]
        n = min(len(gt), len(wt))
        n = n if last is None else min(n, last + 1)
        cut = None if cuts is None else cuts[i]
        steps.append(n if cut is None else min(n, cut))
    return steps


def max_logit_err(got: dict, want: dict, coupled: bool = False,
                  cuts=None) -> float:
    """Largest logit difference over the steps where both runs had fed
    the same tokens so far (``coupled``: in every request of the batch,
    as ``compare`` takes it), before each request's step in ``cuts``."""
    return max((_logit_err(got, want, i, t)
                for i, n in enumerate(compared_steps(got, want, coupled,
                                                     cuts))
                for t in range(n)), default=0.0)
