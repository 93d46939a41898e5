"""The port's int8 error-feedback all-reduce
(``repro_torch.optim.grad_compress``) against the JAX package's
(``repro.optim.grad_compress``), the mirror of
``tests/test_system.py::TestGradCompression``.

* one shard in-process: the reference under ``shard_map`` on one device,
  the port on a gloo group of one rank;
* 4 gloo ranks, each its own gradient and error buffer, against the
  reference on 4 virtual devices (``tests/data/torch_launch_ref.json``,
  written by ``tests/_torch_launch_ref.py``).

Codes exact; the mean and the new error within one float32 ulp of the
reference's (of |g + err|, the value the error is the residual of: XLA
may fuse ``g32 - q * scale`` into one rounding, the port rounds the
product first); the contract ``|mean - g| <= scale / 2`` and
``new_err == g32 - mean`` (one shard) exact.
"""

import datetime
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim.grad_compress import compressed_psum_mean as jax_compressed
from repro_torch.launch import mesh as M
from repro_torch.optim.grad_compress import (compressed_psum_mean,
                                             make_compressed_allreduce,
                                             quantize, shared_scale)

from _torch_dist import run_ranks
from _torch_launch_ref import GC_SHAPES, N_DEV, REF_PATH, gc_inputs, unb64


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo process group of this process alone, and its (1,) mesh."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield M.make_mesh((1,), ("data",), "cpu")
    finally:
        dist.destroy_process_group()


def _ulp_close(got, want, of):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = np.spacing(np.abs(np.asarray(of, np.float32))).astype(np.float64)
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_error_feedback_single_shard(one_rank, seed):
    from jax.sharding import PartitionSpec as P
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(64,)).astype(np.float32)
    err = (rng.normal(size=(64,)) * 1e-3 * seed).astype(np.float32)
    mesh = jax.make_mesh((1,), ("data",))
    f = jax.shard_map(lambda a, b: jax_compressed(a, b, ("data",), 1),
                  mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()))
    jmean, jerr = (np.asarray(a) for a in f(jnp.asarray(g), jnp.asarray(err)))
    mean, new_err = compressed_psum_mean(torch.from_numpy(g),
                                         torch.from_numpy(err), one_rank,
                                         ("data",), 1)
    g32 = g + err
    _ulp_close(mean.numpy(), jmean, g32)
    _ulp_close(new_err.numpy(), jerr, g32)
    # the reference test's contract, on the port
    scale = float(np.max(np.abs(g32))) / 127.0
    assert float(np.max(np.abs(mean.numpy() - g32))) <= scale / 2 + 1e-6
    assert torch.equal(new_err, torch.from_numpy(g32) - mean)
    codes = quantize(torch.from_numpy(g32),
                     shared_scale(torch.tensor(np.abs(g32).max())))
    assert torch.equal(codes.to(torch.float32) * shared_scale(
        torch.tensor(np.abs(g32).max())), mean)


def test_compressed_allreduce_over_a_tree(one_rank):
    rng = np.random.default_rng(3)
    grads = {"a": torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32)),
             "b": [torch.from_numpy(rng.normal(size=(7,)).astype(np.float32))]}
    errs = {"a": torch.zeros(4, 5), "b": [torch.zeros(7)]}
    mean, new = make_compressed_allreduce(one_rank, ("data",))(grads, errs)
    assert set(mean) == {"a", "b"} and isinstance(mean["b"], list)
    for g, m, e in ((grads["a"], mean["a"], new["a"]),
                    (grads["b"][0], mean["b"][0], new["b"][0])):
        assert torch.equal(e, g - m)
        assert float((m - g).abs().max()) <= float(g.abs().max()) / 254 + 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = run_ranks(N_DEV, [{"name": "grad_compress"}],
                    tmp_path_factory.mktemp("grad_compress"))
    return out["grad_compress"]


@pytest.mark.parametrize("leaf", range(len(GC_SHAPES)))
def test_four_gloo_ranks_match_jax_on_four_devices(leaf, ranks):
    ref = json.loads(REF_PATH.read_text())["grad_compress"]
    shape = (N_DEV, *GC_SHAPES[leaf])
    gs, errs = gc_inputs()
    g32 = gs[leaf] + errs[leaf]
    by_shard = sorted(ranks, key=lambda r: r[0]["dp_index"])
    assert [m["dp_index"] for m, _ in by_shard] == list(range(N_DEV))
    codes = np.stack([a[f"codes{leaf}"] for _, a in by_shard])
    mean = np.stack([a[f"mean{leaf}"] for _, a in by_shard])
    err = np.stack([a[f"err{leaf}"] for _, a in by_shard])
    np.testing.assert_array_equal(codes, unb64(ref["codes"][leaf], np.int8,
                                               shape))
    _ulp_close(mean, unb64(ref["means"][leaf], np.float32, shape), g32)
    _ulp_close(err, unb64(ref["errs"][leaf], np.float32, shape), g32)
    # every rank holds the same mean
    assert all(np.array_equal(m, mean[0]) for m in mean)


def test_the_tree_form_equals_the_leaf_form(ranks):
    assert all(meta["tree_same"] for meta, _ in ranks)
