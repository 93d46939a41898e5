"""Where the port's QAT MoE steps part from the JAX package's under 8-bit
codes (``test_torch_moe_capacity.py``'s ``moe_capacity_qat`` run).

  PYTHONPATH=src:tests python tests/_torch_moe_qat_flips.py

Prints one JSON object:

  * ``jax``: ``_torch_launch_ref.run_moe_capacity``'s losses and gradient
    norms under FP32 and INT8 numerics on 1 and on 4 virtual devices, and
    each step's largest relative gap between the two device counts: the
    reference parted from itself by its own summation orders alone;
  * ``port``: the plain trainer's same run (one rank, the worker's inputs)
    under both numerics, and its gap to each JAX run; ``nudged``: the
    port's run again with every affine scale one float32 ulp larger
    (``_scale_of`` x (1 + 2^-23)), and its gap to the port's own run: how
    far an ulp of the codes' inputs moves the steps;
  * ``near_ties``: every 8-bit affine code of the port's INT8 run (weights
    per channel, activations a scale a tensor or an expert), by step:
    the elements whose x / scale lies within 1, 4 and 16 float32 ulps of
    x / scale from a rounding tie (k + 1/2), where an ulp's difference in
    x or in the scale moves the code by one level.

The JAX package is not edited; nothing here runs in the tests.
"""

import json
import os
import sys

import numpy as np

N_DEV = 4


def jax_runs():
    from _torch_launch_ref import run_moe_capacity
    out = {}
    for pe in ("fp32", "int8"):
        runs = {n: run_moe_capacity(pe, n_dev=n) for n in (1, N_DEV)}
        out[pe] = {f"{n}_devices": dict(losses=r["losses"],
                                        grad_norms=r["grad_norms"])
                   for n, r in runs.items()}
        out[pe]["gap_1_vs_4"] = _gaps(runs[1], runs[N_DEV])
    return out


def _gaps(a, b) -> list:
    """Each step's largest relative gap of the loss and gradient norm."""
    return [max(abs(a[k][i] - b[k][i]) / abs(b[k][i])
                for k in ("losses", "grad_norms"))
            for i in range(len(b["losses"]))]


def port_run(pe: str, record=None):
    """The plain trainer's steps of the capacity run under ``pe``: its
    losses and gradient norms; ``record(step)`` is told each step."""
    import torch
    from _torch_launch_ref import CAP_LR, CAP_STEPS, capacity_inputs
    from repro_torch import convert
    from repro_torch.models import family_module
    from repro_torch.optim import adamw, constant
    from repro_torch.train import TrainState, make_train_step
    cfg, params, tokens, labels = capacity_inputs(pe)
    opt = adamw(constant(CAP_LR))
    p = convert.params_from_numpy(params, device="cpu")
    state = TrainState(params=p, opt_state=opt.init(p),
                       step=torch.zeros((), dtype=torch.int32))
    step = make_train_step(cfg, family_module(cfg), opt)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    losses, gnorms = [], []
    for i in range(CAP_STEPS):
        if record:
            record(i)
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return dict(losses=losses, grad_norms=gnorms)


def near_ties():
    """The port's INT8 run with every affine group of the kernel's plain
    version recorded: near-tie counts by step and by kind."""
    import torch
    from repro_torch.quant import fake_quant as FQ
    inner, at, counts = FQ._fused_group, [0], {}

    def recorded(xs, scales, mode, bits=8):
        if mode == "affine":
            for x, s in zip(xs, scales):
                kind = "activations" if s.numel() == 1 else "weights"
                t = x.detach().double() / s.detach().double()
                qmax = 2.0 ** (bits - 1) - 1.0
                t = t[t.abs() < qmax]          # not clipped
                dist = ((t - torch.floor(t)) - 0.5).abs()
                ulp = t.abs() * 2.0 ** -23
                c = counts.setdefault(f"step {at[0]}", {}).setdefault(
                    kind, {"codes": 0, "1_ulp": 0, "4_ulps": 0,
                           "16_ulps": 0})
                c["codes"] += x.numel()
                for n, key in ((1, "1_ulp"), (4, "4_ulps"), (16, "16_ulps")):
                    c[key] += int((dist <= n * ulp).sum())
        return inner(xs, scales, mode, bits)

    FQ._fused_group = recorded
    try:
        port_run("int8", record=lambda i: at.__setitem__(0, i))
    finally:
        FQ._fused_group = inner
    return counts


def nudged_run(pe: str):
    """``port_run`` with every affine scale one float32 ulp larger."""
    import torch
    from repro_torch.quant import fake_quant as FQ
    inner = FQ._scale_of

    def nudged(absmax, bits):
        s = inner(absmax, bits)
        return torch.nextafter(s, torch.full_like(s, float("inf")))

    FQ._scale_of = nudged
    try:
        return port_run(pe)
    finally:
        FQ._scale_of = inner


def main():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count"
                                 f"={N_DEV}")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    out = {"jax": jax_runs()}
    out["port"] = {}
    for pe in ("fp32", "int8"):
        run = port_run(pe)
        j = out["jax"][pe]
        out["port"][pe] = dict(run, gap_to_jax_1=_gaps(run, j["1_devices"]),
                               gap_to_jax_4=_gaps(run, j[f"{N_DEV}_devices"]))
    run = nudged_run("int8")
    out["nudged"] = dict(run, gap_to_port=_gaps(run, out["port"]["int8"]))
    out["near_ties"] = near_ties()
    json.dump(out, sys.stdout, indent=1)
    print()


if __name__ == "__main__":
    main()
