"""The flash attention kernels' slice forms on the card (one rank's slice
of a sequence-split cache: ``flash_attention_stats``,
``flash_attention_pass2``) against their plain versions and the kernels'
emulation, and the slices combined against the unsharded kernel.

Needs a CUDA card and nvcc: every test is marked ``gpu`` and skips
without a card.  Imports no JAX:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_seqshard_gpu.py
"""

import concurrent.futures

import pytest
import torch

FA_TOL = 2e-5   # tests/test_kernels.py:122

# (b, sq, skv, hq, hkv, d, start, slices, window, softcap): decode (the
# split kernel) with most slices past the query or below its window,
# prefill on the mma kernel (head_dims 64 and 128) and on the wgmma kernel
# (256, and 128 with a float32 q), a window and a soft-cap (the MASK
# builds)
CASES = [
    (8, 1, 1024, 8, 1, 128, 700, 4, 0, 0.0),
    (2, 1, 512, 4, 1, 256, 300, 4, 100, 0.0),
    (2, 1, 256, 9, 3, 64, 200, 8, 0, 20.0),
    (2, 40, 256, 9, 3, 64, 100, 4, 0, 0.0),
    (1, 130, 512, 4, 2, 128, 200, 4, 77, 0.0),
    (1, 100, 512, 4, 1, 256, 300, 2, 64, 0.0),
    (1, 70, 256, 2, 1, 128, 100, 2, 0, 0.0),
]
TYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.float8_e4m3fn),
         (torch.bfloat16, torch.float8_e4m3fn)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _allowance(q, k, v, st, window, softcap):
    """One code step of V's type times |v| for each normalized P within
    2^-20 of a rounding midpoint (what a P at a tie may move between two
    sum orders), summed into each output element."""
    from repro_torch.kernels.flash_attention.ref import (attention_probs,
                                                         round_probs)
    if v.dtype == torch.float32:
        return 0.0
    probs = attention_probs(q, k, st, window=window, softcap=softcap)
    step = (round_probs(probs * (1 + 2 ** -20), v.dtype).float()
            - round_probs(probs * (1 - 2 ** -20), v.dtype).float())
    b, sq, hq, d = q.shape
    return torch.einsum("bhgqk,bkhd->bqhgd", step, v.float().abs()).reshape(
        b, sq, hq, d)


@pytest.mark.gpu
@pytest.mark.parametrize("q_type,kv_type", TYPES)
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,start,n,window,softcap", CASES)
def test_slice_forms_match_plain_emulation_and_the_whole(
        card, b, sq, skv, hq, hkv, d, start, n, window, softcap, q_type,
        kv_type):
    from repro_torch.kernels.flash_attention import (flash_attention_gqa,
                                                     flash_attention_pass2,
                                                     flash_attention_stats,
                                                     plan, two_passes)
    from repro_torch.kernels.flash_attention.ref import (
        emulate_attention, group_stats, ref_attention_pass2,
        ref_attention_stats)
    from repro_torch.launch.mesh import ThreadGroup
    from repro_torch.models.layers import seq_attention
    gen = torch.Generator(device=card).manual_seed(skv + sq + d)
    q = torch.randn((b, sq, hq, d), generator=gen, device=card).to(q_type)
    k = torch.randn((b, skv, hkv, d), generator=gen, device=card).to(kv_type)
    v = torch.randn((b, skv, hkv, d), generator=gen, device=card).to(kv_type)
    st = torch.full((b,), start, dtype=torch.int32, device=card)
    kw = dict(round_p=True, window=window, softcap=softcap)
    rows = skv // n
    two = two_passes(True, v)
    stats_all = []
    for i in range(n):
        ks, vs = k[:, i * rows:(i + 1) * rows], v[:, i * rows:(i + 1) * rows]
        s_st = st - i * rows
        out, stats = flash_attention_stats(q, ks, vs, s_st, **kw)
        p_out, p_stats = ref_attention_stats(q, ks, vs, s_st, True, 0.0, True,
                                             window, softcap)
        none = p_stats[1] == 0
        assert torch.equal(stats[1] == 0, none)
        assert bool(torch.all(stats[0][none] == -torch.inf))
        torch.testing.assert_close(stats[0][~none], p_stats[0][~none],
                                   rtol=0, atol=1e-5)
        torch.testing.assert_close(stats[1], p_stats[1], rtol=1e-5, atol=0)
        assert (out is None) == two
        if out is not None:
            assert bool(torch.all(out[none] == 0))
            torch.testing.assert_close(out, p_out, rtol=0, atol=FA_TOL)
        # the kernels' own arithmetic, on the host
        p = plan(b, sq, rows, hq, hkv, d, q_type == torch.bfloat16, window)
        e_out, e_stats = emulate_attention(
            q.cpu(), ks.cpu(), vs.cpu(), s_st.cpu(), p, True, 0.0, True,
            window, softcap, mode=1)
        torch.testing.assert_close(stats[1].cpu(), e_stats[1], rtol=1e-5,
                                   atol=0)
        if out is not None:
            torch.testing.assert_close(out.cpu(), e_out, rtol=0, atol=1e-5)
        stats_all.append(stats)
    whole = flash_attention_gqa(q, k, v, st, **kw)
    slack = _allowance(q, k, v, st, window, softcap)
    if two:
        big = group_stats(stats_all)
        for i in range(n):
            ks = k[:, i * rows:(i + 1) * rows]
            vs = v[:, i * rows:(i + 1) * rows]
            s_st = st - i * rows
            o = flash_attention_pass2(q, ks, vs, s_st, big, **kw)
            want = ref_attention_pass2(q, ks, vs, s_st, big, True, 0.0, True,
                                       window, softcap)
            assert bool(torch.all((o - want).abs() <= FA_TOL + slack))
    # the model's combine, a thread a slice standing for the ranks
    group = ThreadGroup(n)
    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        outs = list(pool.map(lambda i: seq_attention(
            q, k[:, i * rows:(i + 1) * rows], v[:, i * rows:(i + 1) * rows],
            st - i * rows, group.member(i), **kw), range(n)))
    for got in outs:
        assert bool(torch.all(torch.isfinite(got)))
        assert bool(torch.all((got - whole).abs() <= FA_TOL + 2 * slack))
