"""The QAT training example of the port (``examples/torch_train_qat.py``,
``repro_torch.train.qat``) and the reference file the card's training
runs are held to (``tests/data/torch_train_ref.json``, written by
``tests/_torch_train_ref.py`` from the JAX package).

The reference is rebuilt here at the reduced size (FP32 only, to stay
quick) to keep its format honest, and the port's CPU run of the same
steps is held to it (``train_check.compare``): the LM at 2e-3 relative
(bfloat16 activations: the in-process reference keeps XLA's excess
precision; measured 2.5e-4 of gradient norm over three steps), the CNN
at 1e-5 (float32 convolutions in another order; measured 1.5e-6)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_train_ref import REF_PATH, build_reference
from repro.core.accuracy import AccuracySurrogate as JaxAccuracySurrogate
from repro_torch import train_check
from repro_torch.configs import get, reduced
from repro_torch.core.accuracy import AccuracySurrogate

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def small_ref():
    return build_reference("reduced", lm_pe_types=("fp32",),
                           cnn_pe_types=("fp32",))


def test_reference_format_is_stable(small_ref):
    ref = json.loads(REF_PATH.read_text())
    assert ref["size"] == "full" and ref["config"] == "smollm-135m"
    assert "--xla_allow_excess_precision=false" in ref["xla_flags"]
    assert small_ref.keys() == ref.keys()
    for part in ("lm", "cnn"):
        assert small_ref[part].keys() == ref[part].keys()
        assert {k: v for k, v in small_ref[part].items() if k != "runs"} == \
            {k: v for k, v in ref[part].items() if k != "runs"}
    assert sorted(ref["lm"]["runs"]) == sorted(train_check.LM_PE_TYPES)
    assert sorted(ref["cnn"]["runs"]) == sorted(train_check.CNN_PE_TYPES)
    for part, steps in (("lm", train_check.LM_STEPS),
                        ("cnn", train_check.CNN_STEPS)):
        for rows in ref[part]["runs"].values():
            assert np.asarray(rows).shape == (steps, 2)
            assert np.isfinite(rows).all()
    # the full-width LM starts at about ln(vocab) on uniform tokens
    assert abs(ref["lm"]["runs"]["fp32"][0][0]
               - np.log(get("smollm-135m").vocab)) < 0.3


def test_port_matches_the_reduced_reference(small_ref):
    lm = train_check.run_lm(reduced("smollm-135m"), "fp32", "cpu")
    got = train_check.compare(lm, small_ref["lm"]["runs"]["fp32"], 2e-3)
    assert got["ok"], got
    with train_check.detached_attention():
        parent = train_check.run_lm(reduced("smollm-135m"), "fp32", "cpu")
    assert not train_check.compare(parent, small_ref["lm"]["runs"]["fp32"],
                                   2e-3)["ok"]
    cnn = train_check.run_cnn("fp32", "cpu")
    got = train_check.compare(cnn, small_ref["cnn"]["runs"]["fp32"], 1e-5)
    assert got["ok"], got


def _run(args, cwd):
    # one thread: the example is small, and the test workers share the CPU
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable,
                           str(ROOT / "examples" / "torch_train_qat.py"),
                           *args, "--device", "cpu"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_cnn_mode_writes_a_table_both_packages_load(tmp_path):
    out = _run(["--mode", "cnn", "--steps", "1", "--trials", "1"], tmp_path)
    assert out.returncode == 0, out.stderr
    path = tmp_path / "results" / "torch_qat_pareto.json"
    table = json.loads(path.read_text())
    assert sorted(table) == ["fp32", "int16", "lightpe1", "lightpe2"]
    for row in table.values():
        assert set(row) == {"top1_mean", "top1_std", "norm_perf_per_area",
                            "norm_energy", "trials"}
        assert 0.0 <= row["top1_mean"] <= 1.0 and row["trials"] == 1
    assert table["int16"]["norm_perf_per_area"] == pytest.approx(1.0)
    assert not (tmp_path / "results" / "qat_pareto.json").exists()
    ours, ref = AccuracySurrogate(), JaxAccuracySurrogate()
    assert ours.load_qat_results(path=str(path)) == 4
    assert ref.load_qat_results(path=str(path)) == 4
    for pe in table:
        assert ours.predict("resnet20-cifar10", pe) == \
            ref.predict("resnet20-cifar10", pe) == table[pe]["top1_mean"]


def test_convolutions_are_deterministic():
    """The Figs. 5-6 run's top-1 is one sample of a spiking loss: the
    convolutions must add in one order for one seed to give one table."""
    import torch

    import repro_torch  # noqa: F401  (sets the backend flags)
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.allow_tf32


def test_one_seed_gives_one_cnn_trial():
    import torch

    from repro_torch.optim import tree_leaves
    from repro_torch.train import qat
    runs = [tree_leaves(qat.train_cnn("lightpe1", 2, device="cpu"))
            for _ in range(2)]
    other = tree_leaves(qat.train_cnn("lightpe1", 2, trial=1, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert not torch.equal(runs[0][0], other[0])


def test_lm_mode_trains_on_the_cpu(tmp_path):
    out = _run(["--mode", "lm", "--reduced", "--steps", "3", "--batch", "4",
                "--seq", "16", "--ckpt-dir", str(tmp_path / "ck")], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "training smollm-135m" in out.stdout
    assert "final step 3 loss" in out.stdout
