"""Shared inputs of the port's scale-out tests (obs, shard, search,
front server): the reference tests' tiny space and models, built on the
CPU, and the front comparisons."""

import functools

import numpy as np

TINY_SPACE = dict(
    pe_rows=(8, 12), pe_cols=(8, 14), gbuf_kb=(54.0,), spad_ifmap=(12,),
    spad_filter=(112, 224), spad_psum=(16,),
    pe_type=tuple(range(5)), bandwidth_gbps=(25.6,),
)
CHUNK = 16
METRICS = ("perf_per_area", "neg_energy_j")
CPU = "cpu"


def cpus(k: int) -> list:
    """``k`` shards on the CPU (the CPU tests' stand-in for k cards)."""
    return [CPU] * k


@functools.lru_cache(maxsize=None)
def workload():
    from repro_torch.core import resnet_cifar
    return resnet_cifar(20, device=CPU)


@functools.lru_cache(maxsize=None)
def tiny_models():
    from repro_torch.core import model_entry, resnet_cifar, transformer_gemm
    return (model_entry(resnet_cifar(20, device=CPU)),
            model_entry(transformer_gemm(seq=128, d_model=128, n_layers=2,
                                         n_heads=4, d_ff=256, vocab=1024,
                                         device=CPU)))


@functools.lru_cache(maxsize=None)
def jax_tiny_models():
    from repro.core import model_entry, resnet_cifar, transformer_gemm
    return (model_entry(resnet_cifar(20)),
            model_entry(transformer_gemm(seq=128, d_model=128, n_layers=2,
                                         n_heads=4, d_ff=256, vocab=1024)))


@functools.lru_cache(maxsize=None)
def ppa_models():
    from repro_torch.core import enumerate_space, fit_ppa_models
    return fit_ppa_models(enumerate_space(max_points=500, seed=1, device=CPU),
                          degrees=(1, 2), k=4, device=CPU)


def assert_front_equal(a_idx, a_obj, b_idx, b_obj):
    """Equal fronts as (index, objective) row sets, bit for bit."""
    np.testing.assert_array_equal(np.sort(a_idx), np.sort(b_idx))
    order_a, order_b = np.argsort(a_idx), np.argsort(b_idx)
    np.testing.assert_array_equal(np.asarray(a_obj)[order_a],
                                  np.asarray(b_obj)[order_b])


def assert_archives_equal(a, b):
    assert_front_equal(a.indices, a.objectives, b.indices, b.objectives)


def assert_archives_identical(a, b):
    """Equal fronts row for row (row order included), bit for bit."""
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.objectives, b.objectives)


def assert_archive_close(port, ref, rtol):
    """A port front against the JAX package's: the same index set, the
    objectives at ``rtol``."""
    np.testing.assert_array_equal(np.sort(port.indices), np.sort(ref.indices))
    np.testing.assert_allclose(
        np.asarray(port.objectives)[np.argsort(port.indices)],
        np.asarray(ref.objectives)[np.argsort(ref.indices)],
        rtol=rtol, atol=0)
