"""repro_torch's workload IR and architecture configs against repro's, on
the CPU: every LayerSpec field of the co-exploration model axis equal to
the reference's bit for bit, the configs copied field for field, and the
closed-form MAC identities, decode memory-boundness and layer-class
accuracy contracts of ``tests/test_serving_workloads.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get as jax_get, reduced as jax_reduced
from repro.core import coexplore as jc, workloads as jw
from repro_torch.configs import ARCH_IDS, ASSIGNED, get, list_archs, reduced
from repro_torch.core import (ACC_CLASS_SENS, AccuracySurrogate,
                              accuracy_matrix, default_model_set,
                              layer_bucket, llm_decode, llm_moe,
                              make_config, model_entry, resnet_cifar,
                              touched_experts, transformer_workload,
                              workload_layers, workload_macs)
from repro_torch.core import workloads as tw
from repro_torch.core.dataflow import layer_cost, network_cost
from repro_torch.core.workloads import (ACC_CLASSES, ACC_DEFAULT, KIND_ATTN_KV,
                                        KIND_CONV, KIND_GEMM, LAYER_KINDS,
                                        LayerSpec, acc_class_mix, gemm,
                                        pad_workload)

SEQ = 16
CPU = "cpu"


def _fields(wl):
    return {f: getattr(wl.layers, f).numpy() for f in LayerSpec._fields}


def _assert_workload_equal(jwl, twl):
    assert twl.name == jwl.name and twl.layer_names == jwl.layer_names
    for f, got in _fields(twl).items():
        want = np.asarray(getattr(jwl.layers, f))
        assert got.dtype == want.dtype == np.float32, f
        np.testing.assert_array_equal(got, want, err_msg=f"{jwl.name}.{f}")


def _row(wl, tag):
    i = wl.layer_names.index(tag)
    return LayerSpec(*[getattr(wl.layers, f)[i] for f in LayerSpec._fields])


# ---------------------------------------------------------------------------
# The configs and the model axis, exactly as the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_configs_copied_field_for_field(arch):
    for mine, ref in ((get(arch), jax_get(arch)),
                      (reduced(arch), jax_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_registry():
    from repro.configs import ARCH_IDS as J_IDS, ASSIGNED as J_ASSIGNED
    assert ARCH_IDS == J_IDS and ASSIGNED == J_ASSIGNED
    assert list_archs() == list(J_IDS)
    with pytest.raises(ValueError):
        get("no-such-arch")


@pytest.fixture(scope="module")
def model_axes():
    return jc.default_model_set(), default_model_set(device=CPU)


def test_default_model_set_names(model_axes):
    jm, tm = model_axes
    assert [m.name for m in tm] == [m.name for m in jm]
    assert len(tm) == 13


@pytest.mark.parametrize("i", range(13))
def test_model_axis_fields_equal_reference(model_axes, i):
    """Every LayerSpec field of every member, and its MACs, base accuracy
    and class mix: computed in float64 like the reference's, rounded once."""
    jm, tm = model_axes
    _assert_workload_equal(jm[i].workload, tm[i].workload)
    assert tm[i].macs == jm[i].macs
    assert tm[i].base_acc == jm[i].base_acc
    assert tm[i].acc_mix == jm[i].acc_mix
    assert workload_macs(tm[i].workload) == jw.workload_macs(jm[i].workload)


def test_accuracy_matrix_equals_reference(model_axes):
    jm, tm = model_axes
    np.testing.assert_array_equal(accuracy_matrix(tm),
                                  jc.accuracy_matrix(jm))


@pytest.mark.parametrize("make", ["resnet34", "resnet50"])
def test_imagenet_resnets_equal_reference(make):
    _assert_workload_equal(getattr(jw, make)(batch=2),
                           getattr(tw, make)(batch=2, device=CPU))


@pytest.mark.parametrize("name", sorted(jw.PAPER_WORKLOADS))
def test_paper_workloads_equal_reference(name):
    _assert_workload_equal(jw.PAPER_WORKLOADS[name](),
                           tw.PAPER_WORKLOADS[name](device=CPU))


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_transformer_workload_equals_reference(arch, mode):
    _assert_workload_equal(
        jw.transformer_workload(jax_get(arch), seq=512, batch=3, mode=mode),
        transformer_workload(get(arch), seq=512, batch=3, mode=mode,
                             device=CPU))


@pytest.mark.parametrize("kw", [dict(topk=1), dict(experts=8, topk=4),
                                dict(seq=64, mode="prefill", batch=4)])
def test_llm_moe_equals_reference(kw):
    _assert_workload_equal(jw.llm_moe("deepseek-moe-16b", **kw),
                           llm_moe("deepseek-moe-16b", device=CPU, **kw))


# ---------------------------------------------------------------------------
# first_dense / dense_d_ff extraction
# ---------------------------------------------------------------------------

def test_deepseek_dense_first_layer_extracted_as_dense():
    cfg = get("deepseek-moe-16b")
    wl = transformer_workload(cfg, seq=SEQ, batch=1, mode="prefill",
                              device=CPU)
    assert float(_row(wl, "ffn_in").count) == float(cfg.first_dense)
    assert float(_row(wl, "ffn_in").K) == 2.0 * cfg.dense_d_ff
    assert float(_row(wl, "moe_in").count) == float(
        cfg.n_layers - cfg.first_dense)
    assert float(_row(wl, "moe_in").K) == 2.0 * cfg.moe_d_ff
    assert float(_row(wl, "moe_shared_in").count) == float(
        (cfg.n_layers - cfg.first_dense) * cfg.moe_shared)


def test_non_moe_config_unaffected():
    cfg = reduced("qwen3-32b")
    wl = transformer_workload(cfg, seq=SEQ, batch=1, mode="prefill",
                              device=CPU)
    assert "moe_in" not in wl.layer_names
    assert float(_row(wl, "ffn_in").count) == float(cfg.n_layers)


# ---------------------------------------------------------------------------
# Closed-form MAC identities across every config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_prefill_is_seq_times_decode(arch):
    cfg = reduced(arch)
    pre = workload_macs(transformer_workload(cfg, seq=SEQ, batch=1,
                                             mode="prefill", device=CPU))
    dec = workload_macs(transformer_workload(cfg, seq=SEQ, batch=1,
                                             mode="decode", device=CPU))
    assert pre == pytest.approx(SEQ * dec, rel=1e-6)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"])
def test_moe_active_macs_linear_in_topk(arch):
    cfg = reduced(arch)
    m = {k: workload_macs(llm_moe(cfg, topk=k, seq=SEQ, mode="decode",
                                  device=CPU)) for k in (1, 2, 4)}
    assert m[2] > m[1]
    assert m[4] - m[2] == pytest.approx(2.0 * (m[2] - m[1]), rel=1e-6)


def test_touched_experts():
    for args in ((64, 6, 1), (8, 2, 1), (64, 6, 100_000), (0, 2, 1),
                 (16, 2, 7)):
        assert touched_experts(*args) == jw.touched_experts(*args)
    assert touched_experts(64, 6, 1) == pytest.approx(6.0)
    assert touched_experts(64, 6, 100_000) == pytest.approx(64.0)
    ts = [touched_experts(64, 6, n) for n in (1, 4, 64, 4096)]
    assert all(a <= b for a, b in zip(ts, ts[1:]))


def test_llm_moe_rejects_dense_configs():
    with pytest.raises(ValueError):
        llm_moe("qwen3-32b", device=CPU)


def test_creators_follow_device_argument():
    wl = llm_decode(reduced("qwen3-32b"), context=64, device=CPU)
    assert wl.layers.H.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# Decode attention is memory-bound at long context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,context", [
    ("qwen3-32b", 1024), ("qwen3-32b", 8192), ("deepseek-moe-16b", 4096)])
def test_streamed_kv_layers_memory_bound(arch, context):
    wl = llm_decode(arch, context=context, device=CPU)
    cfg = make_config(device=CPU)
    lane = lambda x: torch.as_tensor(x).reshape(1, 1)  # noqa: E731
    pl = layer_cost(LayerSpec(*[f[None, :] for f in wl.layers]),
                    type(cfg)(*map(lane, cfg)), lane(1.0))
    kinds = wl.layers.kind.numpy()
    assert (kinds == float(KIND_ATTN_KV)).sum() == 2  # qk + av
    for i, name in enumerate(wl.layer_names):
        if kinds[i] == float(KIND_ATTN_KV):
            assert float(pl.cycles_memory[0, i]) \
                > float(pl.cycles_compute[0, i]), name


def test_stream_words_grow_linearly_with_context():
    def stream(context):
        wl = llm_decode("qwen3-32b", context=context, device=CPU)
        sel = wl.layers.kind.numpy() == float(KIND_ATTN_KV)
        return wl.layers.stream_words.numpy()[sel]
    np.testing.assert_allclose(stream(8192), 4.0 * stream(2048), rtol=1e-6)


def test_prefill_attention_stays_resident():
    wl = transformer_workload(reduced("qwen3-32b"), seq=SEQ, batch=1,
                              mode="prefill", device=CPU)
    assert not np.any(wl.layers.kind.numpy() == float(KIND_ATTN_KV))


# ---------------------------------------------------------------------------
# Neutral IR fields and padding, bit for bit
# ---------------------------------------------------------------------------

def test_defaulted_fields_are_neutral():
    wl = resnet_cifar(20, device=CPU)
    assert np.all(np.isin(wl.layers.kind.numpy(),
                          [float(KIND_CONV), float(KIND_GEMM)]))
    assert np.all(wl.layers.stream_words.numpy() == 0.0)
    assert np.all(wl.layers.active_frac.numpy() == 1.0)
    assert np.all(wl.layers.acc_class.numpy() == float(ACC_DEFAULT))


def test_gemm_kind_costs_identically_to_conv_kind():
    a = LayerSpec(**{k: torch.tensor([float(v)]) for k, v in
                     gemm(32, 64, 128, kind=KIND_CONV).items()})
    b = LayerSpec(**{k: torch.tensor([float(v)]) for k, v in
                     gemm(32, 64, 128, kind=KIND_GEMM).items()})
    cfg = make_config(device=CPU)
    for f, va, vb in zip(LayerSpec._fields, network_cost(a, cfg, 1.0),
                         network_cost(b, cfg, 1.0)):
        assert torch.equal(va, vb), f


@pytest.mark.parametrize("wl", ["decode", "moe"])
def test_padding_contract_holds_for_serving_workloads(wl):
    wl = (llm_decode(reduced("qwen3-32b"), context=128, device=CPU)
          if wl == "decode" else
          llm_moe(reduced("deepseek-moe-16b"), seq=32, device=CPU))
    cfg = make_config(device=CPU)
    base = network_cost(wl.layers, cfg, torch.tensor(1.0))
    padded = network_cost(pad_workload(wl, workload_layers(wl) + 5).layers,
                          cfg, torch.tensor(1.0))
    for f, va, vb in zip(base._fields, base, padded):
        assert torch.equal(va, vb), f


def test_default_zoo_buckets(model_axes):
    _, tm = model_axes
    names = [m.name for m in tm]
    assert any("decode" in n for n in names)
    assert any("-moe-" in n for n in names)
    assert {layer_bucket(workload_layers(m.workload))
            for m in tm} == {16, 32, 64}


# ---------------------------------------------------------------------------
# Per-layer-class accuracy sensitivity (opt-in, exact when off)
# ---------------------------------------------------------------------------

def test_class_sensitivity_registry():
    from repro.core.accuracy import ACC_CLASS_SENS as J_SENS
    assert ACC_CLASS_SENS == J_SENS and ACC_CLASS_SENS["default"] == 1.0
    assert LAYER_KINDS == ("conv", "gemm", "attn_kv", "moe_expert")
    assert ACC_CLASSES == ("default", "attn", "ffn", "expert")
    assert set(ACC_CLASS_SENS) == set(ACC_CLASSES)


def test_none_and_all_default_mix_are_exact_legacy():
    acc = AccuracySurrogate()
    all_default = tuple(1.0 if i == 0 else 0.0
                        for i in range(len(ACC_CLASSES)))
    for pe in ("int16", "lightpe1"):
        base = acc.delta_pp(pe, macs=1e9)
        assert acc.delta_pp(pe, macs=1e9, class_mix=None) == base
        assert acc.delta_pp(pe, macs=1e9, class_mix=all_default) == base
    assert acc.class_multiplier(None) == 1.0
    assert acc.class_multiplier(all_default) == 1.0


def test_attn_heavy_mix_amplifies_ffn_heavy_shrinks():
    acc = AccuracySurrogate()
    assert acc.class_multiplier((0.0, 1.0, 0.0, 0.0)) > 1.0
    assert acc.class_multiplier((0.0, 0.0, 1.0, 0.0)) < 1.0
    base = abs(acc.delta_pp("lightpe1", macs=1e9))
    assert abs(acc.delta_pp("lightpe1", macs=1e9,
                            class_mix=(0.0, 1.0, 0.0, 0.0))) > base


def test_acc_class_mix_equals_reference():
    for jwl, twl in (
            (jw.llm_decode(jax_reduced("qwen3-32b"), context=128),
             llm_decode(reduced("qwen3-32b"), context=128, device=CPU)),
            (jw.resnet_cifar(20), resnet_cifar(20, device=CPU))):
        assert acc_class_mix(twl) == jw.acc_class_mix(jwl)
    mix = acc_class_mix(llm_decode(reduced("qwen3-32b"), context=128,
                                   device=CPU))
    assert sum(mix) == pytest.approx(1.0)
    assert mix[ACC_CLASSES.index("attn")] > 0.0


def test_accuracy_matrix_untagged_rows_unchanged():
    models = (model_entry(llm_decode(reduced("qwen3-32b"), context=256,
                                     device=CPU), acc_classes=True),
              model_entry(resnet_cifar(20, device=CPU)))
    tagged = accuracy_matrix(models)
    untagged = accuracy_matrix([m._replace(acc_mix=None) for m in models])
    np.testing.assert_array_equal(tagged[1], untagged[1])
    assert np.abs(tagged[0] - untagged[0]).max() > 0.0


def test_bad_class_inputs_rejected():
    with pytest.raises(KeyError):
        AccuracySurrogate(class_sens={"bogus": 2.0})
    with pytest.raises(ValueError):
        AccuracySurrogate().class_multiplier((1.0, 0.0))
