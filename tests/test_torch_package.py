"""The port stands alone: no JAX, nothing of repro, no silent CPU."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PACKAGE.rglob("*.py"))


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    return env


def test_every_module_imports_without_jax_or_repro():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for m in ("repro_torch.kernels.fake_quant.fake_quant",
              "repro_torch.kernels.quant_matmul.quant_matmul",
              "repro_torch.kernels.flash_attention.flash_attention",
              "repro_torch.models", "repro_torch.models.transformer",
              "repro_torch.serve", "repro_torch.serve.engine",
              "repro_torch.configs", "repro_torch.quant.pack",
              "repro_torch.core.accuracy", "repro_torch.core.coexplore",
              "repro_torch.core.constraints", "repro_torch.coexplore_check",
              "repro_torch.configs.qwen3_32b",
              "repro_torch.configs.deepseek_moe_16b",
              "repro_torch.configs.phi35_moe",
              "repro_torch.obs", "repro_torch.obs.tracer",
              "repro_torch.obs.export", "repro_torch.obs.report",
              "repro_torch.checkpoint.manager", "repro_torch.core.shard",
              "repro_torch.core.search", "repro_torch.serve.frontserver",
              "repro_torch.scale_check", "repro_torch.data",
              "repro_torch.data.synthetic", "repro_torch.data.pipeline",
              "repro_torch.optim", "repro_torch.optim.optimizers",
              "repro_torch.optim.schedule", "repro_torch.models.cnn",
              "repro_torch.train", "repro_torch.train.trainer",
              "repro_torch.train.qat", "repro_torch.train_check",
              "repro_torch.launch.op_analysis", "repro_torch.launch.dryrun",
              "repro_torch.launch.perf", "repro_torch._work"):
        assert m in MODULES, m


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PACKAGE.rglob("*.py"), ROOT / "chip_smoke.py",
     ROOT / "examples" / "torch_quickstart.py",
     ROOT / "examples" / "torch_serve_quantized.py",
     ROOT / "examples" / "torch_coexplore_pareto.py",
     ROOT / "examples" / "torch_trace_sweep.py",
     ROOT / "examples" / "torch_search_front.py",
     ROOT / "examples" / "torch_query_front.py",
     ROOT / "examples" / "torch_train_qat.py",
     ROOT / "benchmarks" / "torch_profile.py",
     ROOT / "benchmarks" / "torch_fa_sweep.py",
     ROOT / "benchmarks" / "torch_fq_sweep.py",
     ROOT / "benchmarks" / "torch_qat_sensitivity.py",
     ROOT / "benchmarks" / "torch_qmm_sweep.py",
     ROOT / "benchmarks" / "torch_router_noise.py"]))
def test_no_jax_or_repro_import_in_source(path):
    text = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"^\s*(from repro[.\s]|import repro[.\s])", text,
                         re.M)


CREATORS = {
    "make_config": lambda: _core().make_config(),
    "space_points": lambda: _core().space_points([0, 1, 2]),
    "enumerate_space": lambda: _core().enumerate_space(max_points=10),
    "iter_space_chunks": lambda: next(_core().iter_space_chunks()),
    "vgg16": lambda: _core().vgg16("cifar10"),
    "resnet_cifar": lambda: _core().resnet_cifar(20),
    "fit_ppa_models": lambda: _core().fit_ppa_models(
        _core().enumerate_space(max_points=50, device="cpu")),
    "config_from_numpy": lambda: _convert().config_from_numpy(
        {f: [1.0] for f in _core().AcceleratorConfig._fields}),
    "ppa_models_from_numpy": lambda: _convert().ppa_models_from_numpy({}),
    "draw_weights": lambda: _quickstart().draw_weights([(2, 2)]),
    "quickstart.run": lambda: _quickstart().run(max_points=50),
    "params_from_numpy": lambda: _convert().params_from_numpy(
        {"w": [[1.0]]}),
    "init_params": lambda: _transformer().init_params(
        _reduced(), torch.Generator()),
    "init_cache": lambda: _transformer().init_cache(_reduced(), 1, 4),
    "make_cache": lambda: _layers().make_cache(
        1, 4, _transformer().attn_spec(_reduced())),
    "rope_freqs": lambda: _layers().rope_freqs(16),
    "default_model_set": lambda: _core().default_model_set(),
    "llm_decode": lambda: _core().llm_decode("qwen3-32b"),
    "llm_moe": lambda: _core().llm_moe(),
    "transformer_gemm": lambda: _core().transformer_gemm(),
    "resnet34": lambda: _core().resnet34(),
    "resnet50": lambda: _core().resnet50(),
    "iter_joint_space_chunks": lambda: next(
        _core().iter_joint_space_chunks(num_models=2)),
    "joint_space_points": lambda: _core().joint_space_points([0, 1]),
    "resolve_shards": lambda: _core().resolve_shards(),
    "delta_array": lambda: _core().AccuracySurrogate().delta_array(),
    "stacked_workload_from_numpy":
        lambda: _convert().stacked_workload_from_numpy(
            ["m"], {f: [[1.0]] for f in _core().LayerSpec._fields}, [1]),
    "train_state_from_numpy": lambda: _convert().train_state_from_numpy(
        {"w": [[1.0]]}, {"step": 0}, 0),
    "conv_init": lambda: _cnn().conv_init(torch.Generator(), 3, 4),
    "resnet_init": lambda: _cnn().resnet_init(torch.Generator(), depth=8),
    "vgg16_init": lambda: _cnn().vgg16_init(torch.Generator()),
    "init_state": lambda: _train().init_state(
        _reduced(), _transformer(), _optim().adamw(_optim().constant(1e-3)),
        torch.Generator()),
    "lm_pipeline": lambda: _data().lm_pipeline(_reduced(), 2, 8),
    "cifar_pipeline": lambda: _data().cifar_pipeline(2),
    "run_lm": lambda: _qat().run_lm("reduced", steps=1),
    "run_cnn": lambda: _qat().run_cnn(steps=1, trials=1, out=None),
}


def _cnn():
    from repro_torch.models import cnn
    return cnn


def _train():
    import repro_torch.train as train
    return train


def _optim():
    import repro_torch.optim as optim
    return optim


def _data():
    import repro_torch.data as data
    return data


def _qat():
    from repro_torch.train import qat
    return qat


def _core():
    import repro_torch.core as core
    return core


def _convert():
    from repro_torch import convert
    return convert


def _quickstart():
    from repro_torch import quickstart
    return quickstart


def _transformer():
    from repro_torch.models import transformer
    return transformer


def _layers():
    from repro_torch.models import layers
    return layers


def _reduced():
    from repro_torch.configs import reduced
    return reduced("smollm-135m")


@pytest.mark.parametrize("name", sorted(CREATORS))
def test_creators_raise_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CREATORS[name]()


def test_example_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
         "--device", "cpu", "--max-points", "400"], env=_env(),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "Pareto front:" in out.stdout and "lightpe1" in out.stdout


def test_serving_example_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_serve_quantized.py"),
         "--size", "reduced", "--device", "cpu", "--max-new", "3"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "lightpe1: packed" in out.stdout and "req1: [" in out.stdout


def test_coexplore_example_runs_on_cpu(tmp_path):
    out_csv = tmp_path / "front.csv"
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_coexplore_pareto.py"),
         "--device", "cpu", "--max-points", "3000", "--area-mm2", "2.0",
         "--out", str(out_csv)], env=_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "paper claim" in out.stdout and "feasible" in out.stdout
    assert out_csv.read_text().startswith("model,pe_type,accuracy")


@pytest.mark.parametrize("script,args,expect", [
    ("torch_trace_sweep.py", ["--max-points", "2000", "--shards", "2"],
     "front bit-identical with telemetry off: True"),
    ("torch_search_front.py", ["--evals", "1500", "--models", "2"],
     "non-dominated"),
    ("torch_query_front.py", ["--max-points", "1500"],
     "served_from=cache:repeat")])
def test_scale_examples_run_on_cpu(tmp_path, script, args, expect):
    """The three DSE-at-scale examples on the CPU at small sizes (they
    write under results/ of their working directory)."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *args], cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No card: non-zero exit and no result line; alone in a directory
    (nothing else of the repo beside it): the same."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA card")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env=_env(), capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
