"""``repro_torch.launch.op_analysis``, the port's counterpart of
``repro.launch.hlo_analysis``: the reference's ``TestHLOAnalysis``
(``tests/test_perf_variants.py``) on eager torch, the kernels' declared
work against ``FlopCounterMode`` over their plain versions, the peak of
live bytes, and the private PyTorch module it stands on for meshes of
any size (``torch.testing._internal.distributed.fake_pg``).

Counts are exact: no tolerance.
"""

import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.fake_quant import fake_quant, fake_quant_group
from repro_torch.kernels.flash_attention import (attention_backward,
                                                 flash_attention,
                                                 flash_attention_gqa)
from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.quant_matmul.ref import ref_quant_matmul
from repro_torch.kernels.fake_quant.ref import ref_fake_quant_affine
from repro_torch.launch import dryrun
from repro_torch.launch import op_analysis as OA

from _torch_dist import run_ranks


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_every_loop_iteration_is_counted(device):
    """7 iterations of tanh(h @ w) count 7 x 2*16*32*32: eager torch runs
    each one (the reference corrects XLA's once-counted while body)."""
    h = torch.ones(16, 32, device=device)
    w = torch.ones(32, 32, device=device)

    def fn(h, w):
        for _ in range(7):
            h = torch.tanh(h @ w)
        return h

    _, rep = OA.analyze(fn, h, w)
    assert rep["flops"] == 7 * 2 * 16 * 32 * 32
    assert rep["whiles"] == [] and rep["n_computations"] == 14


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_row_write_is_credited_at_the_row(device):
    """A (1, 1024) write into a (1024, 1024) float32 buffer: the row's 4
    KB, not the buffer's 4 MB (the reference's dynamic-update-slice
    rule)."""
    buf = torch.zeros(1024, 1024, device=device)
    row = torch.ones(1, 1024, device=device)

    def fn(buf, row):
        buf[7:8] = row
        return buf

    _, rep = OA.analyze(fn, buf, row)
    assert rep["bytes_out"] < 1.5 * 4 * 1024 * 1024
    assert rep["bytes_out"] == 1024 * 4
    assert rep["memory"]["temp_size_in_bytes"] == 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_peak_of_live_bytes(device):
    """4 MB a; b = a @ a; del a; c = b * 2: the peak holds two of them."""
    def fn():
        a = torch.empty(1024, 1024, device=device)
        b = a @ a
        del a
        return b * 2

    _, rep = OA.analyze(fn)
    assert rep["memory"]["temp_size_in_bytes"] == 8_388_608
    assert rep["memory"]["output_size_in_bytes"] == 4 * 1024 * 1024


def test_argument_bytes_are_the_arguments_read():
    """An argument the step never reads is no argument byte, as jit
    prunes it; it stays resident."""
    a, unused = torch.ones(10), torch.ones(100)
    _, rep = OA.analyze(lambda a, u: a * 2, a, unused)
    assert rep["memory"]["argument_size_in_bytes"] == 40
    assert rep["memory"]["resident_argument_bytes"] == 440


@pytest.fixture
def fake_group():
    """The fake backend of ``torch.testing._internal.distributed.fake_pg``
    (a private module) with 8 ranks, this process rank 0."""
    mesh = dryrun.start_mesh((2, 4), ("data", "model"))
    yield mesh
    dist.destroy_process_group()


def test_the_fake_backend_is_there(fake_group):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert isinstance(FakeStore(), dist.Store)
    assert dist.get_backend() == "fake" and dist.get_world_size() == 8
    assert list(fake_group.get_coordinate()) == [0, 0]


N = 1000


def test_an_all_reduce_counts_its_payload_once(fake_group, tmp_path):
    """All-reduce of N float32: 4N bytes, once, on the fake group on meta
    and on 2 gloo ranks alike."""
    x = torch.empty(N, device="meta")
    _, rep = OA.analyze(dist.all_reduce, x)
    want = {"all-reduce": 4.0 * N, "all-reduce_count": 1, "total": 4.0 * N}
    assert rep["collectives"] == want
    out = run_ranks(2, [{"name": "all_reduce", "n": N}], tmp_path)
    for meta, _ in out["all_reduce"]:
        assert meta["collectives"] == want and meta["sum"] == 2.0


def test_an_all_gather_counts_its_output(fake_group):
    x = torch.empty(5, 3, device="meta")
    parts = [torch.empty_like(x) for _ in range(4)]
    _, rep = OA.analyze(dist.all_gather, parts, x,
                        group=fake_group.get_group("model"))
    assert rep["collectives"]["all-gather"] == 4 * 5 * 3 * 4
    assert rep["collectives"]["all-gather_count"] == 1


def _counted(fn, *args):
    with FlopCounterMode(display=False) as c:
        fn(*args)
    return c.get_total_flops()


def _meta(*ts):
    return [t.to("meta") for t in ts]


QMM = [(1, 64, 32, "int4"), (17, 128, 48, "int8"), (64, 256, 96, "pow2"),
       (3, 576, 192, "int4")]


@pytest.mark.parametrize("m,k,n,mode", QMM)
def test_quant_matmul_declares_the_plain_products(m, k, n, mode):
    x = torch.randn(m, k)
    rows = k if mode == "int8" else k // 2
    w = torch.randint(0, 100, (rows, n), dtype=torch.int8
                      if mode == "int8" else torch.uint8)
    s = torch.rand(n)
    want = _counted(ref_quant_matmul, x, w, s, mode)
    before = quant_matmul.launches
    out, rep = OA.analyze(lambda *a: quant_matmul(*a, mode=mode),
                          *_meta(x, w, s))
    assert rep["flops"] == want == 2 * m * k * n
    assert rep["launches"] == {"quant_matmul": 1}
    assert quant_matmul.launches == before
    assert out.device.type == "meta" and out.shape == (m, n)
    k_ = rep["kernels"]["quant_matmul"]
    assert k_["bytes_written"] == 4 * m * n
    assert k_["bytes_read"] == 4 * m * k + w.numel() * w.element_size() + 4 * n


FA = [(2, 5, 5, 4, 2, 16, 0), (1, 1, 64, 3, 1, 64, 0), (2, 8, 40, 8, 2, 32, 8),
      (1, 17, 17, 2, 2, 128, 0)]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window", FA)
def test_flash_attention_declares_the_plain_products(b, sq, skv, hq, hkv, d,
                                                     window):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, sq, hq, d, generator=g)
    k = torch.randn(b, skv, hkv, d, generator=g)
    v = torch.randn(b, skv, hkv, d, generator=g)
    st = torch.full((b,), skv - sq, dtype=torch.int32)
    want = _counted(ref_attention_gqa, q, k, v, st, True, 0.0, True, window)
    out, rep = OA.analyze(
        lambda *a: flash_attention_gqa(*a, round_p=True, window=window),
        *_meta(q, k, v, st))
    assert rep["flops"] == want == 4 * b * hq * sq * skv * d
    assert rep["launches"] == {"flash_attention": 1}
    assert out.shape == q.shape and out.dtype == torch.float32
    if d in (64, 128) and not window:
        # the gradient of the plain version: autograd's products behind
        # its forward (the reference's count of the attention's gradient)
        dout = torch.randn(b, sq, hq, d, generator=g)
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ref_attention_gqa(*ins, st, True, 0.0, True)
        want = _counted(lambda: torch.autograd.grad(out, ins, dout))
        grads, rep = OA.analyze(
            lambda *a: attention_backward(*a, round_p=True),
            *_meta(q, k, v, st, dout))
        assert rep["flops"] == want == 8 * b * hq * sq * skv * d
        assert rep["launches"] == {"flash_attention_backward": 1}
        assert [t.shape for t in grads] == [q.shape, k.shape, v.shape]


@pytest.mark.parametrize("chunks,bonus", [(1, False), (5, False), (5, True)])
def test_the_chunk_scan_on_meta_counts_the_loops_products(chunks, bonus):
    """On ``meta`` the chunk scan of RWKV6 (a bonus) and Mamba2 runs its
    chunks batched (``ssm_common._meta_scan``): the products that the loop
    runs chunk by chunk on the CPU, forward and backward, in fewer ops."""
    from repro_torch.models.ssm_common import chunked_linear_attention
    b, s, h, dk, dv = 2, 4 * chunks, 3, 8, 4
    g = torch.Generator().manual_seed(0)
    ins = [torch.randn(b, s, h, dk, generator=g),
           torch.randn(b, s, h, dk, generator=g),
           torch.randn(b, s, h, dv, generator=g),
           -torch.rand(b, s, h, dk, generator=g),
           torch.randn(h, dk, generator=g) if bonus else None]

    def step(*xs):
        xs = [x.requires_grad_() for x in xs if x is not None]
        o, state = chunked_linear_attention(*xs[:4], xs[4] if bonus else
                                            None, chunk=4)
        return (o, state, *torch.autograd.grad(o.sum(), xs))

    reps = {}
    for device in ("cpu", "meta"):
        xs = [x.to(device) if x is not None else None for x in ins]
        outs, reps[device] = OA.analyze(step, *xs)
        assert [t.shape for t in outs] == \
            [(b, s, h, dv), (b, h, dk, dv)] + [x.shape for x in ins if
                                               x is not None]
    cpu, meta = reps["cpu"], reps["meta"]
    assert meta["flops"] == cpu["flops"] > 0
    assert meta["matvec_flops"] == cpu["matvec_flops"] == 0
    assert meta["memory"]["argument_size_in_bytes"] == \
        cpu["memory"]["argument_size_in_bytes"]
    if chunks > 1:
        assert meta["n_computations"] < cpu["n_computations"]


@pytest.mark.parametrize("shapes", [[(4, 3)], [(300, 190), (1, 129), (7, 7)]])
def test_fake_quant_declares_no_products(shapes):
    ws = [torch.randn(*s) for s in shapes]
    ss = [torch.rand(s[1]) + 0.1 for s in shapes]
    assert _counted(lambda: [ref_fake_quant_affine(w, s, 8)
                             for w, s in zip(ws, ss)]) == 0
    before = fake_quant.launches
    outs, rep = OA.analyze(lambda w, s: fake_quant_group(w, s),
                           _meta(*ws), _meta(*ss))
    assert rep["flops"] == 0 and rep["launches"] == {"fake_quant": 1}
    assert fake_quant.launches == before
    k = rep["kernels"]["fake_quant"]
    assert k["bytes_written"] == 4 * sum(w.numel() for w in ws)
    assert k["bytes_read"] == k["bytes_written"] + 4 * sum(
        s.numel() for s in ss)
    assert [o.shape for o in outs] == [w.shape for w in ws]


def test_without_an_analyzer_meta_launches_nothing():
    """No analyzer: the meta branch checks, allocates and returns; no
    counter moves and nothing is recorded."""
    assert OA.active() is None
    before = (fake_quant.launches, quant_matmul.launches,
              flash_attention.launches, flash_attention.backward_launches)
    q = torch.empty(1, 4, 2, 64, device="meta")
    out = flash_attention_gqa(q, q, q)
    assert out.device.type == "meta"
    fake_quant(torch.empty(4, 3, device="meta"),
               torch.empty(3, device="meta"))
    attention_backward(q, q, q, None, q)
    assert (fake_quant.launches, quant_matmul.launches,
            flash_attention.launches,
            flash_attention.backward_launches) == before


def test_meta_runs_the_cards_checks():
    """The meta branch refuses what the card refuses, with its message,
    and takes what the card takes (a window, a soft-cap, head_dim 32)."""
    q = torch.empty(1, 4, 2, 48, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="backward takes head_dim"):
        flash_attention_gqa(q, q, q)
    q = torch.empty(1, 4, 2, 64, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_gqa(q, q, q, causal=False, window=2)
    for d in (32, 64):
        q = torch.empty(1, 4, 2, d, device="meta", requires_grad=True)
        out = flash_attention_gqa(q, q, q, window=2, softcap=30.0)
        assert out.device.type == "meta"
        assert torch.autograd.grad(out.sum(), q)[0].shape == q.shape
    # an fp8 cache: e4m3 K and V are taken (and read at 1 byte an
    # element); an fp8 q, or K and V of two types, are refused
    k = torch.empty(1, 4, 2, 64, device="meta", dtype=torch.float8_e4m3fn)
    assert flash_attention_gqa(q.detach(), k, k, round_p=True).shape == \
        q.shape
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        flash_attention_gqa(k, k, k)
    with pytest.raises(ValueError, match="one type"):
        flash_attention_gqa(q.detach(), k, k.to(torch.bfloat16))
