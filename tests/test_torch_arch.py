"""repro_torch.core.arch against repro.core.arch: decode is exact."""

import numpy as np
import pytest

from repro.core import arch as ja
from repro_torch.core import arch as ta

from _torch_helpers import jax_config_arrays, port_config

SPACES = {"default": ja.DEFAULT_SPACE, "wide": ja.WIDE_SPACE,
          "mapped": ja.MAPPED_SPACE}


def _assert_same_config(jcfg, tcfg):
    for f in ja.AcceleratorConfig._fields:
        want = np.asarray(getattr(jcfg, f))
        got = getattr(tcfg, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_full_paper_grid_decodes_identically():
    _assert_same_config(ja.enumerate_space(), ta.enumerate_space(device="cpu"))


@pytest.mark.parametrize("name,max_points", [("default", 2000),
                                             ("wide", 5000),
                                             ("mapped", 5000)])
def test_subsample_decodes_identically(name, max_points):
    space = SPACES[name]
    n = ja.space_size(space)
    np.testing.assert_array_equal(ta.subsample_indices(n, max_points, 3),
                                  ja.subsample_indices(n, max_points, 3))
    _assert_same_config(ja.enumerate_space(space, max_points, seed=3),
                        ta.enumerate_space(space, max_points, seed=3,
                                           device="cpu"))


@pytest.mark.parametrize("name", sorted(SPACES))
def test_space_size_and_radices(name):
    space = SPACES[name]
    assert ta.space_size(space) == ja.space_size(space)
    np.testing.assert_array_equal(ta.space_radices(space),
                                  ja.space_radices(space))


def test_chunk_walk_matches():
    jw = list(ja.iter_space_chunks(ja.WIDE_SPACE, chunk_size=1000,
                                   max_points=3500, seed=1, start_chunk=1))
    tw = list(ta.iter_space_chunks(ta.WIDE_SPACE, chunk_size=1000,
                                   max_points=3500, seed=1, start_chunk=1,
                                   device="cpu"))
    assert len(jw) == len(tw) == 3
    for (jc, ji), (tc, ti) in zip(jw, tw):
        np.testing.assert_array_equal(ti, ji)
        _assert_same_config(jc, tc)


def test_config_rows_match():
    idx = np.arange(0, ja.space_size(ja.MAPPED_SPACE), 9973)
    jrows = list(ja.config_rows(ja.space_points(idx, ja.MAPPED_SPACE)))
    trows = list(ta.config_rows(ta.space_points(idx, ta.MAPPED_SPACE,
                                                device="cpu")))
    assert trows == jrows


def test_make_and_stack_configs():
    kw = [dict(pe_rows=16, pe_type="lightpe1", gbuf_kb=216.0),
          dict(pe_cols=28, pe_type=4, bandwidth_gbps=51.2, mapping=17.0)]
    jcfg = ja.stack_configs([ja.make_config(**k) for k in kw])
    tcfg = ta.stack_configs([ta.make_config(**k, device="cpu") for k in kw])
    _assert_same_config(jcfg, tcfg)
    assert tcfg.num_pes.tolist() == np.asarray(jcfg.num_pes).tolist()


def test_config_carried_across_equals_decode():
    jcfg = ja.enumerate_space(ja.MAPPED_SPACE, max_points=1000)
    _assert_same_config(jcfg, port_config(jcfg))
    legacy = {f: v for f, v in jax_config_arrays(jcfg).items()
              if f != "mapping"}
    from repro_torch import convert
    assert not convert.config_from_numpy(legacy, "cpu").mapping.any()
