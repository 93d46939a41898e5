"""Where the time goes in the port's quickstart loop on the card.

  python3 benchmarks/torch_profile.py [--out results/torch/profile.json]
      [--only quickstart|serving|coexplore|training]

Runs each step of ``repro_torch.quickstart`` at full size (27,000-point
paper grid, VGG-16/CIFAR-10, every preset's fake quantization), the
2^20-point WIDE_SPACE sweep, and one prefill step (4 prompts of 130
tokens) and one decode step (cache index 130) of SmolLM-135M served on
LightPE-1 codes, once warm, each under its own ``torch.profiler``
session, and reports per step: host wall time, device busy time (sum of
the CUDA kernel and copy durations), the device idle share, the number
of device events, and the top kernels by device time; the serving steps
also count the port's own kernel launches.  Writes the full table, top
kernels included, to ``--out``.  The ``coexplore`` steps profile the
joint walk of the 13-model ``default_model_set`` on the paper grid
(oracle): one full bucket-16 and one full bucket-64 mixed chunk
(``dse.evaluate_chunk`` with model ids, 4,096 lanes) and the whole
351,000-point ``coexplore_front``, then the walk's wall time split into
decode, evaluation and fold.  The ``training`` step profiles one
train step of full-width SmolLM-135M under LightPE-1 at the example's
16 x 256 tokens (``make_train_step``, AdamW), warm, with its
``fake_quant`` and ``flash_attention`` forward and backward launches.
``--only`` runs one group.
"""

import argparse
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def profile_step(torch, name, fn):
    """Run ``fn`` once under the profiler; returns (result, row)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, launches, by_kernel = 0.0, 0, Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            launches += 1
            by_kernel[e.name[:80]] += us
    row = dict(step=name, wall_s=wall, device_busy_s=busy / 1e6,
               idle_share=(1.0 - busy / 1e6 / wall) if busy else None,
               device_events=launches,
               top_kernels_us=by_kernel.most_common(5))
    print(f"{name:14s} wall={wall * 1e3:9.3f} ms "
          f"device_busy={busy / 1e3:9.3f} ms "
          f"idle={row['idle_share'] if busy else 'not measured'} "
          f"device_events={launches}")
    return out, row


def profile_serving(torch, dev):
    """One prefill step and one decode step of SmolLM-135M on LightPE-1
    codes (4 slots, bfloat16), warm, with the port's kernel launches."""
    from repro_torch import convert
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import transformer as T
    from repro_torch.serve import check, quantize_params

    import numpy as np
    cfg = get("smollm-135m")
    params = quantize_params(
        convert.params_from_numpy(T.numpy_params(cfg, check.PARAM_SEED), dev),
        "lightpe1", min_size=check.MIN_SIZE)
    plen = max(check.PROMPT_LENS)
    toks = torch.as_tensor(np.stack(check.prompts(cfg.vocab, [plen] * 4)),
                           device=dev)
    last = toks[:, -1:]

    def cache():
        return T.init_cache(cfg, check.BATCH_SLOTS, check.MAX_LEN,
                            torch.float32, device=dev)

    warm = T.prefill(params, toks, cfg, cache())[1]  # warm-up
    T.decode_step(params, last, cfg, warm)
    filled, empty = T.prefill(params, toks, cfg, cache())[1], cache()
    rows = []
    for name, fn in (
            ("serve_prefill", lambda: T.prefill(params, toks, cfg, empty)),
            ("serve_decode", lambda: T.decode_step(params, last, cfg,
                                                   filled))):
        counts = (quant_matmul.launches, flash_attention.launches)
        _, row = profile_step(torch, name, fn)
        row["quant_matmul_launches"] = quant_matmul.launches - counts[0]
        row["flash_attention_launches"] = flash_attention.launches - counts[1]
        print(f"  launches: quant_matmul {row['quant_matmul_launches']}, "
              f"flash_attention {row['flash_attention_launches']}")
        rows.append(row)
    return rows


def profile_training(torch, dev):
    """One warm train step of SmolLM-135M (LightPE-1, 16 x 256, AdamW)."""
    from repro_torch.configs import get
    from repro_torch.data import lm_pipeline
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import family_module
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import init_state, make_train_step

    cfg = get("smollm-135m").replace(pe_type="lightpe1")
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(3e-4, 20, 200))
    state = init_state(cfg, mod, opt,
                       torch.Generator(device=dev).manual_seed(0), device=dev)
    train_step = make_train_step(cfg, mod, opt)
    pipe = lm_pipeline(cfg, 16, 256, device=dev)
    for _ in range(2):                                  # warm-up
        state, _ = train_step(state, next(pipe))
    batch = next(pipe)
    counts = (fake_quant.launches, flash_attention.launches,
              flash_attention.backward_launches)
    (state, _), row = profile_step(torch, "train_step",
                                   lambda: train_step(state, batch))
    row["fake_quant_launches"] = fake_quant.launches - counts[0]
    row["flash_attention_launches"] = flash_attention.launches - counts[1]
    row["flash_attention_backward_launches"] = \
        flash_attention.backward_launches - counts[2]
    print(f"  launches: fake_quant {row['fake_quant_launches']}, "
          f"flash_attention {row['flash_attention_launches']}, backward "
          f"{row['flash_attention_backward_launches']}")
    return [row]


def profile_coexplore(torch, dev, step):
    """One bucket-16 and one bucket-64 chunk of the mixed joint walk, then
    the whole walk, each warm."""
    from repro_torch.core import coexplore, dse
    models = coexplore.default_model_set(device=dev)
    coexplore.coexplore_front(models)  # warm-up
    walk = coexplore.plan_joint_walk(models)
    chunks = {}
    for depth, wl, model_ids, _, cfg, idx in walk.chunks():
        if len(idx) == walk.chunk_size:
            chunks.setdefault(depth, (wl, model_ids, cfg))
    for depth in (16, 64):
        wl, model_ids, cfg = chunks[depth]
        step(f"coex_chunk_L{depth}", lambda: dse.evaluate_chunk(
            cfg, wl, pad_to=walk.chunk_size, model_ids=model_ids))
    step("coexplore_351k", lambda: coexplore.coexplore_front(models))
    return host_phases(torch, models, walk)


def host_phases(torch, models, walk):
    """Wall time of the mixed walk's phases, the walk's own loop timed
    piece by piece: the mixed-radix decode and upload, the evaluation
    (dispatch, wait, host float64 columns) and the fold (objectives,
    archive, per-(model, PE) bests)."""
    import numpy as np
    from repro_torch.core import coexplore as C, dse
    acc = C.accuracy_matrix(models)
    archive, best = dse.ParetoArchive(3), {}
    t = dict(decode=0.0, evaluate=0.0, fold=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks = walk.chunks()
    while True:
        a = time.perf_counter()
        try:
            _, wl, model_ids, mids, cfg, idx = next(chunks)
        except StopIteration:
            break
        codes = cfg.pe_type.cpu().numpy().astype(np.int64)
        b = time.perf_counter()
        res = dse.evaluate_chunk(cfg, wl, pad_to=walk.chunk_size,
                                 model_ids=model_ids)
        c = time.perf_counter()
        obj = C._joint_objectives(res, acc[mids, codes])
        archive.update(obj, idx)
        C._update_per_model_best(best, models, acc, mids, codes, obj)
        d = time.perf_counter()
        t["decode"] += b - a
        t["evaluate"] += c - b
        t["fold"] += d - c
    t["total"] = time.perf_counter() - t0
    print("coexplore host phases (s): " + json.dumps(t))
    return t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path,
                    default=ROOT / "results" / "torch" / "profile.json")
    ap.add_argument("--only", choices=("quickstart", "serving", "coexplore",
                                       "training"),
                    default=None, help="profile one group of steps")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile needs a CUDA card")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    rows = []

    def step(name, fn):
        out, row = profile_step(torch, name, fn)
        rows.append(row)
        return out

    if args.only in (None, "quickstart"):
        profile_quickstart(torch, dev, step)
    if args.only in (None, "serving"):
        rows.extend(profile_serving(torch, dev))
    phases = None
    if args.only in (None, "coexplore"):
        phases = profile_coexplore(torch, dev, step)
    if args.only in (None, "training"):
        rows.extend(profile_training(torch, dev))

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=card, rows=rows,
                                        coexplore_phases_s=phases), indent=1))
    print(json.dumps(dict(card=card, rows=[
        {k: v for k, v in r.items() if k != "top_kernels_us"}
        for r in rows])))


def profile_quickstart(torch, dev, step):
    """The quickstart's steps at full size and the WIDE_SPACE sweep."""
    import numpy as np
    from repro_torch import quickstart
    from repro_torch.core import arch, dse, ppa, workloads
    from repro_torch.quant import PE_TYPES, fake_quant_weights, preset
    quickstart.run(max_points=None, presets=PE_TYPES, device=dev)  # warm-up

    space = step("enumerate", lambda: arch.enumerate_space(device=dev))
    sample = arch.enumerate_space(max_points=2000, device=dev)
    models = step("fit", lambda: ppa.fit_ppa_models(
        sample, degrees=(1, 2), k=4, device=dev))
    wl = workloads.vgg16("cifar10", device=dev)
    res = step("dse_oracle", lambda: dse.evaluate_space(space, wl))
    step("dse_surrogate", lambda: dse.evaluate_space(space, wl,
                                                     surrogate=models))
    step("pareto", lambda: np.asarray(dse.pareto_front(res)))
    weights = quickstart.draw_weights(workloads.weight_shapes(wl), 0, dev)
    step("fake_quant", lambda: {p: fake_quant_weights(weights, preset(p))
                                for p in PE_TYPES})
    wide = arch.enumerate_space(arch.WIDE_SPACE, max_points=2 ** 20,
                                device=dev)
    step("wide_2^20", lambda: dse.evaluate_space(wide, wl, chunk_size=65536))


if __name__ == "__main__":
    main()
