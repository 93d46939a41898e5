"""The port's launch layer end to end: ``python -m repro_torch.launch.train``
and ``repro_torch.launch.serve`` against the JAX package's CLIs, the
trainer on ``torch.distributed`` meshes of gloo ranks against one
process, the elastic restore (the mirror of
``tests/test_system.py::test_elastic_restore_changes_mesh``), the
per-process data pipeline, and ``trainer.resume``'s templates on
``meta``.

Tolerances: the CLIs' 3 steps on reduced SmolLM-135M, LightPE-1, in
float32 on the same numpy params and batches: loss and gradient norm at
the trainer tests' float32 ones (``test_torch_trainer``: 1e-5 and 1e-4
relative), each parameter's change over the run against the reference's
change within 1e-3 of its norm under FP32 and 5e-2 under LightPE-1; 2
gloo ranks against one process on the same global batches at rtol 1e-5 (the gradients summed
over the ranks in another order); restores exact.
"""

import argparse
import datetime
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import serve as jax_serve_cli
from repro.launch import train as jax_train_cli
from repro.train import trainer as jax_trainer
from repro_torch import convert
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import list_archs, reduced
from repro_torch.data import DataPipeline, lm_pipeline, synthetic
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import family_module, hybrid, layers as L
from repro_torch.models import transformer
from repro_torch.optim import Optimizer, adamw, tree_leaves, warmup_cosine
from repro_torch.train import (TrainState, init_state, make_train_step,
                               resume, trainer)

from _torch_dist import run_ranks

ARGV = ["--arch", "smollm-135m", "--reduced", "--pe-type", "lightpe1",
        "--steps", "3", "--batch", "4", "--seq", "32"]
RUN = dict(arch="smollm-135m", pe_type="lightpe1", lr=3e-4, steps=3,
           batch=4, seq=32)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo process group of this process alone."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the CLIs' flags and the ten reduced configs
# ---------------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _reference_parser(module, monkeypatch):
    """The argparse parser that a reference CLI's ``main`` builds."""
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as got:
            module.main([])
    return got.value.args[0]


def _flags(parser) -> dict:
    return {a.option_strings[0]: (a.dest, a.default, a.type, a.choices,
                                  a.required, a.help, a.nargs, a.const)
            for a in parser._actions if a.option_strings
            and a.option_strings[0] != "-h"}


@pytest.mark.parametrize("name", ["train", "serve"])
def test_cli_flags_and_defaults_are_the_reference_ones(name, monkeypatch):
    port = {"train": train_cli, "serve": serve_cli}[name]
    ref = {"train": jax_train_cli, "serve": jax_serve_cli}[name]
    want = _flags(_reference_parser(ref, monkeypatch))
    got = _flags(port.parser())
    assert set(got) == set(want) | {"--device"}
    for flag, spec in want.items():
        assert got[flag] == spec, flag
    assert got["--device"][1] is None          # the card unless told


@pytest.mark.parametrize("arch", list_archs())
def test_reduced_config_trains_and_serves_through_the_clis(arch, capsys):
    cfg = reduced(arch)
    state = train_cli.main(["--arch", arch, "--reduced", "--pe-type",
                            "lightpe1", "--steps", "1", "--batch", "2",
                            "--seq", "32", "--device", "cpu"])
    assert int(state.step) == 1
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params))
    assert "final step 1 loss" in capsys.readouterr().out
    argv = ["--arch", arch, "--reduced", "--pe-type", "lightpe1",
            "--prompts", "2", "--max-new", "2", "--device", "cpu"]
    if cfg.family == "encdec":
        with pytest.raises(NotImplementedError, match="idx='frames'"):
            serve_cli.main(argv)
        return
    reqs = serve_cli.main(argv)
    out = capsys.readouterr().out
    assert [len(r.out) for r in reqs] == [2, 2]
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
    assert "packed weights:" in out and "served 2 requests, 4 tokens" in out


def test_the_reference_serve_cli_cannot_serve_whisper():
    with pytest.raises(TypeError, match="frames"):
        jax_serve_cli.main(["--arch", "whisper-medium", "--reduced",
                            "--prompts", "1", "--max-new", "1"])


# ---------------------------------------------------------------------------
# the train CLI against the reference's, on the same params and batches
# ---------------------------------------------------------------------------

class _JaxPipe:
    def __init__(self, batches):
        self.batches, self.i = batches, 0

    def __next__(self):
        b = {k: jnp.asarray(v) for k, v in self.batches[self.i].items()}
        self.i += 1
        return b

    def state_dict(self):
        return {"step": self.i, "seed": 0}


@pytest.mark.parametrize("pe", ["fp32", "lightpe1"])
def test_train_cli_matches_the_reference_cli(pe, monkeypatch):
    """The CLIs' 3 steps on reduced SmolLM-135M in float32.  Under the
    FP32 preset every step at the float32 tolerances.  Under LightPE-1
    the first step at them too; after the first update the two packages'
    weights differ by float32 noise, and an 8-bit activation code at a
    round(x / s) tie flips (the trainer tests' note): the later losses
    read 3.8e-5 apart (a flipped code moves a reduced model's loss by
    1e-5-1e-4), and no pin reaches a training step (JAX's log of a
    gradient replays its callbacks out of order).  So 1e-4 there.

    The parameters: each leaf's change over the run (params minus the
    initial ones, at most 9e-5 an element under the warmup's lr) against
    the reference's change, as ``|d_port - d_jax| / |d_jax|`` (norms over
    the leaf).  Measured at most 4.2e-4 under FP32 and 2.2e-2 under
    LightPE-1 (the flipped codes), held to 1e-3 and 5e-2.  A control run
    of the port's CLI that skips the optimizer's update must fail it."""
    cfg = reduced("smollm-135m").replace(dtype="float32", pe_type=pe)
    arrays = transformer.numpy_params(cfg, 0)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(5):           # 3 steps and the pipeline's prefetch
        toks = rng.integers(0, cfg.vocab, (4, 33)).astype(np.int32)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    metrics = {"port": [], "jax": []}

    def recorded(fit, key, fetch):
        def wrapped(state, step, pipe, **kw):
            def step_rec(s, b):
                s, m = step(s, b)
                metrics[key].append([fetch(m["loss"]),
                                     fetch(m["grad_norm"])])
                return s, m
            return fit(state, step_rec, pipe, **kw)
        return wrapped

    import repro_torch.launch.train as P
    import repro.launch.train as J
    monkeypatch.setattr(P, "get_reduced",
                        lambda a: reduced(a).replace(dtype="float32"))
    monkeypatch.setattr(J, "get_reduced",
                        lambda a: J.get_cfg.__globals__["reduced"](a).replace(
                            dtype="float32"))
    monkeypatch.setattr(P, "lm_pipeline", lambda *a, **k: DataPipeline(
        lambda s, i: batches[i], 0, "cpu"))
    monkeypatch.setattr(J, "lm_pipeline", lambda *a, **k: _JaxPipe(batches))
    monkeypatch.setattr(trainer, "init_state", lambda c, m, opt, gen, device:
                        TrainState(*(lambda p: (p, opt.init(p)))(
                            convert.params_from_numpy(arrays, device)),
                                   torch.zeros((), dtype=torch.int32)))
    monkeypatch.setattr(jax_trainer, "init_state", lambda c, m, opt, key:
                        jax_trainer.TrainState(*(lambda p: (p, opt.init(p)))(
                            jax.tree.map(jnp.asarray, arrays)),
                            jnp.zeros((), jnp.int32)))
    monkeypatch.setattr(trainer, "fit", recorded(trainer.fit, "port",
                                                 lambda t: t.item()))
    monkeypatch.setattr(jax_trainer, "fit", recorded(jax_trainer.fit, "jax",
                                                     float))
    argv = [a if a != "lightpe1" else pe for a in ARGV]
    state = train_cli.main(argv + ["--device", "cpu"])
    jstate = jax_train_cli.main(argv)
    got, want = np.array(metrics["port"]), np.array(metrics["jax"])
    assert got.shape == want.shape == (3, 2)
    later = 1 if pe == "fp32" else 10
    np.testing.assert_allclose(got[:1], want[:1], rtol=1e-5)
    np.testing.assert_allclose(got[1:, 0], want[1:, 0], rtol=1e-5 * later)
    np.testing.assert_allclose(got[1:, 1], want[1:, 1], rtol=1e-4 * later)
    start = jax.tree.leaves(arrays)
    want_change = [np.asarray(j, np.float64) - a
                   for a, j in zip(start, jax.tree.leaves(jstate.params))]
    tol = 1e-3 if pe == "fp32" else 5e-2
    assert _change_gap(start, state, want_change) <= tol

    # control: the same run without the optimizer's update must fail
    frozen = lambda sched: (lambda o: Optimizer(  # noqa: E731
        o.init, lambda g, s, p: (p, s)))(adamw(sched))
    monkeypatch.setattr(P, "adamw", frozen)
    assert _change_gap(start, train_cli.main(argv + ["--device", "cpu"]),
                       want_change) > tol


def _change_gap(start, state, want_change) -> float:
    """The largest ``|d - want| / |want|`` over the leaves, where ``d`` is
    a leaf of ``state.params`` minus the same leaf of ``start``."""
    gaps = []
    for a, p, w in zip(start, tree_leaves(state.params), want_change):
        d = p.detach().numpy().astype(np.float64) - a
        assert np.abs(w).max() > 0
        gaps.append(np.linalg.norm(d - w) / np.linalg.norm(w))
    return max(gaps)


# ---------------------------------------------------------------------------
# gloo meshes against one process; the elastic restore
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("two_ranks")
    out = run_ranks(2, [
        {"name": "train_cli", "argv": ARGV + ["--device", "cpu"]},
        {"name": "train_mesh", "mesh": [1, 2], **RUN,
         "ckpt_dir": str(work / "ckpt")}], work)
    return out, str(work / "ckpt")


def _one_process(global_batch):
    """RUN's 3 steps in this process on ``global_batch(seed, step)``:
    (full params as {path: array}, each step's [loss, grad norm])."""
    cfg = reduced(RUN["arch"]).replace(pe_type=RUN["pe_type"])
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(RUN["lr"], 20, RUN["steps"]))
    state = init_state(cfg, mod, opt, torch.Generator().manual_seed(0),
                       device="cpu")
    step = make_train_step(cfg, mod, opt)
    pipe = DataPipeline(global_batch, 0, "cpu")
    metrics = []
    for _ in range(RUN["steps"]):
        state, m = step(state, next(pipe))
        metrics.append([m["loss"].item(), m["grad_norm"].item()])
    return _named(state.params), np.array(metrics)


def _named(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_named(tree[k], prefix + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_named(v, prefix + (i,)))
    else:
        out["/".join(map(str, prefix))] = tree.detach().numpy()
    return out


def _dp_slices(seed, step):
    """The global batch that two dp ranks draw together: rank i's slice
    seeded with ``seed * 1000003 + i``."""
    cfg = reduced(RUN["arch"])
    half = RUN["batch"] // 2
    parts = [synthetic.token_batch(seed * 1000003 + i, step, half, RUN["seq"],
                                   cfg.vocab) for i in range(2)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def test_two_ranks_on_a_data_mesh_match_one_process(two_ranks):
    """The CLI on 2 ranks picks a (2, 1) mesh for reduced SmolLM (3
    heads): each rank its half of the batch, the gradients averaged."""
    (out, _) = two_ranks
    params, _ = _one_process(_dp_slices)
    for meta, arrays in out["train_cli"]:
        assert meta["mesh"] == [2, 1] and meta["step"] == RUN["steps"]
        assert set(arrays) == set(params)
        for k, v in params.items():
            np.testing.assert_allclose(arrays[k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_two_ranks_on_a_model_mesh_match_one_process(two_ranks):
    """A (1, 2) mesh: params and optimizer state sharded over ``model``,
    each rank the whole batch."""
    (out, _) = two_ranks
    cfg = reduced(RUN["arch"])
    params, metrics = _one_process(
        lambda s, i: synthetic.token_batch(s * 1000003, i, RUN["batch"],
                                           RUN["seq"], cfg.vocab))
    for meta, arrays in out["train_mesh"]:
        np.testing.assert_allclose(meta["metrics"], metrics, rtol=1e-5)
        for k, v in params.items():
            np.testing.assert_allclose(arrays[k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        # the rules shard over model where it divides: some leaves are
        # half-size on each rank
        halves = [k for k, s in meta["local_shapes"].items()
                  if list(params[k].shape) != s]
        assert halves


def test_elastic_restore_saves_on_two_ranks_restores_on_one_and_four(
        two_ranks, tmp_path):
    (out, ckpt_dir) = two_ranks
    saved = out["train_mesh"][0][1]
    assert ckpt.all_steps(ckpt_dir) == [RUN["steps"]]
    # on 4 ranks, a (2, 2) mesh: each rank holds the slices of the
    # written arrays, and they gather to the saved state
    four = run_ranks(4, [{"name": "restore", "mesh": [2, 2], **RUN,
                          "ckpt_dir": ckpt_dir}], tmp_path / "four")
    for meta, arrays in four["restore"]:
        assert meta["step"] == RUN["steps"] and meta["differing"] == 0
        assert meta["sharded_leaves"] > 0
        for k, v in saved.items():
            np.testing.assert_array_equal(arrays[k], v, err_msg=k)
    # on one process
    cfg = reduced(RUN["arch"]).replace(pe_type=RUN["pe_type"])
    opt = adamw(warmup_cosine(RUN["lr"], 20, RUN["steps"]))
    state = resume(cfg, family_module(cfg), opt, ckpt_dir, device="cpu")
    assert int(state.step) == RUN["steps"]
    for k, v in _named(state.params).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)


def test_elastic_restore_changes_mesh(one_rank, tmp_path):
    """The reference's test: reduced Qwen3-32B saved, restored through
    the train shardings of a (1, 1) mesh."""
    from repro_torch.launch.sharding import make_param_shardings
    cfg = reduced("qwen3-32b")
    params = family_module(cfg).init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    ckpt.save(str(tmp_path), 1, params)
    mesh = M.make_mesh((1, 1), ("data", "model"), "cpu")
    shardings = make_param_shardings(cfg, params, mesh, "train")
    restored, _, _ = ckpt.restore(str(tmp_path), 1, params, device="cpu",
                                  shardings=shardings)
    for a, b in zip(tree_leaves(params), tree_leaves(restored)):
        assert torch.equal(a, b)


def test_make_shardings_as_the_reference(one_rank):
    """(param shardings by the train rules, the replicated sharding, the
    batch's over the dp axes) on a (1, 1) mesh."""
    from repro_torch.launch.sharding import param_spec
    cfg = reduced("smollm-135m")
    mod = family_module(cfg)
    mesh = M.make_mesh((1, 1), ("data", "model"), "cpu")
    p_shard, repl, batch_shardings = trainer.make_shardings(cfg, mod, mesh)
    assert repl.spec == () and repl.replicated
    assert p_shard["layers"]["attn"]["wq"].spec == param_spec(
        cfg, mesh, "layers/attn/wq", (cfg.n_layers, cfg.d_model,
                                      cfg.n_heads * cfg.head_dim))
    batch = next(lm_pipeline(cfg, 2, 8, device="cpu"))
    sh = batch_shardings(batch)
    assert set(sh) == set(batch)
    assert all(s.spec == (("data",), None) for s in sh.values())


def test_a_mesh_takes_the_backend_of_its_device(one_rank):
    with pytest.raises(RuntimeError, match="nccl"):
        M.make_mesh((1, 1), ("data", "model"), "cuda")
    with pytest.raises(ValueError, match="ranks"):
        M.make_mesh((2, 1), ("data", "model"), "cpu")
    mesh = M.make_mesh((1, 1), ("data", "model"), "cpu")
    assert M.axis_sizes(mesh) == {"data": 1, "model": 1}
    assert M.coordinate(mesh) == {"data": 0, "model": 0}
    assert M.dp_index(mesh) == 0 and M.dp_total(mesh) == 1


# ---------------------------------------------------------------------------
# the data pipeline's slices and families; the mesh context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_lm_pipeline_feeds_every_family_as_the_reference(arch, one_rank):
    from repro.configs import reduced as jax_reduced
    from repro.data import lm_pipeline as jax_lm_pipeline
    cfg = reduced(arch)
    got = next(lm_pipeline(cfg, 4, 16, seed=2, device="cpu"))
    want = next(jax_lm_pipeline(jax_reduced(arch), 4, 16, seed=2))
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
    if cfg.family == "vlm":
        np.testing.assert_array_equal(got["positions"].numpy(),
                                      np.asarray(want["positions"]))
    # on a (1, 1) mesh the one slice is the whole batch
    mesh = M.make_mesh((1, 1), ("data", "model"), "cpu")
    same = next(lm_pipeline(cfg, 4, 16, seed=2, device="cpu", mesh=mesh))
    assert all(torch.equal(same[k], got[k]) for k in got)


def test_lm_pipeline_refuses_a_batch_the_ranks_do_not_split(one_rank):
    from repro_torch.launch.mesh import MeshShape  # noqa: F401
    mesh = M.make_mesh((1, 1), ("data", "model"), "cpu")
    assert M.dp_total(mesh) == 1
    with pytest.raises(ValueError, match="split"):
        lm_pipeline(reduced("smollm-135m"), 3, 8, device="cpu",
                    mesh=type("Two", (), {
                        "mesh_dim_names": ("data", "model"),
                        "shape": (2, 1)})())


def test_activation_sharding_context_as_the_reference():
    assert L.current_mesh() == (None, None) and L.current_dp() == ()
    x = torch.ones(4, 3)
    with L.activation_sharding(("data",), 2, mesh="m"):
        assert L.current_mesh() == ("m", "model")
        assert L.current_dp() == ("data",)
        assert L.shard_batch(x) is x
    assert L.current_mesh() == (None, None) and L.current_dp() == ()


# ---------------------------------------------------------------------------
# resume's templates
# ---------------------------------------------------------------------------

def test_resume_builds_its_templates_on_meta(tmp_path, monkeypatch):
    """Reduced Zamba2: the restore's templates come from an init on the
    meta device (no draw, no host allocation), and the state comes back
    exact."""
    cfg = reduced("zamba2-7b")
    opt = adamw(warmup_cosine(1e-3, 5, 10))
    state = init_state(cfg, hybrid, opt, torch.Generator().manual_seed(0),
                       device="cpu")
    ckpt.save(str(tmp_path), 2, state.params, state.opt_state)
    devices = []
    inner = hybrid.init_params

    def spy(c, gen, device=None):
        devices.append(torch.device(device))
        return inner(c, gen, device=device)

    monkeypatch.setattr(hybrid, "init_params", spy)
    got = resume(cfg, hybrid, opt, str(tmp_path), device="cpu")
    assert devices and all(d.type == "meta" for d in devices)
    assert int(got.step) == 2
    for a, b in zip(tree_leaves(state.params) + tree_leaves(state.opt_state),
                    tree_leaves(got.params) + tree_leaves(got.opt_state)):
        assert torch.equal(a, b)
