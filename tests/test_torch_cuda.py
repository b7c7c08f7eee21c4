"""Card-only tests of the port: the CUDA kernels (paged attention K1,
flash attention K2-K4) against their plain PyTorch versions, their
launch counts and refusals, the engine on the card against generate()
and against the CPU engine in its scheduling modes, the decode step's
CUDA graph against the eager loop, the engine's uploads against its
host mirrors, K1's split route in a bf16 decode step, the training
step's kernel launches, the request lifecycle on the card (a
quarantine mid-superstep, uploads after a quarantine or a cancel,
dropped readbacks, a fault inside the graph's capture, retune), and the
KV-cache hierarchy on the card (bf16 spill and reload bit for bit, a
reload behind a superstep in flight, a blob dropped after its reload,
the pools' addresses, the scripted runs against the CPU engine), and
perfbench's chains (the graphed attention chain against the eager one,
the graphed decode chunks against paged_decode_chunk, the peak table on
the card).  They skip without a CUDA device.
On a machine with a card (and without jax, which tests/conftest.py
imports):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

import workloads_torch.model as tmodel
from workloads_torch import train as ttrain
from workloads_torch.generate import generate
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.ops import attention as fa
from workloads_torch.ops import paged_attention as pa
from workloads_torch.paged import paged_decode_chunk
from workloads_torch.serve import ServeEngine

pytestmark = pytest.mark.gpu

# Kernel against plain version: both compute in float32 from the same
# inputs and round the output once; bf16 outputs may differ by one bf16
# ulp (2^-8 at magnitude 1).
ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dtype, heads, kv_heads, hd, ps, lengths, layers=2, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    max_pages = max(1, -(-max(lengths) // ps))
    n_pages = len(lengths) * max_pages + 1
    shape = (layers, n_pages, kv_heads, ps, hd)
    k = torch.randn(shape, generator=g, device="cuda").to(dtype)
    v = torch.randn(shape, generator=g, device="cuda").to(dtype)
    q = torch.randn((len(lengths), heads, hd), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda")
    tables = perm[: len(lengths) * max_pages].reshape(len(lengths), max_pages)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, tables.to(torch.int32).contiguous(), lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "heads, kv_heads, hd, ps, window",
    [
        (16, 16, 128, 64, None),
        (16, 4, 128, 64, None),
        (16, 2, 128, 64, 100),
        (8, 8, 64, 16, None),
        (4, 2, 16, 4, 5),
        (8, 8, 32, 16, 7),
    ],
)
def test_kernel_matches_plain_version(cuda, dtype, heads, kv_heads, hd, ps, window):
    lengths = [0, 1, ps - 1, ps, ps + 1, 5 * ps + 3]
    q, k, v, tables, lens = _inputs(dtype, heads, kv_heads, hd, ps, lengths)
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, k, v, tables, lens, layer=1, window=window)
    assert pa.paged_attention.launches == before + 1
    want = pa.paged_attention_reference(q, k, v, tables, lens, layer=1, window=window)
    torch.cuda.synchronize()
    assert torch.all(got[0] == 0)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("splits", [1, 2, 3, 9])
@pytest.mark.parametrize("heads, kv_heads, hd, ps, window",
                         [(16, 16, 128, 64, None), (16, 2, 128, 64, 100), (4, 2, 16, 4, 5)])
def test_split_kernel_matches_plain_version_and_repeats(cuda, dtype, splits, heads, kv_heads,
                                                        hd, ps, window):
    """The page walk cut into 1, 2, 3 and more shares than a row has live
    pages (6): within the plain version's tolerance, zeros for the
    length-0 row, and three launches bit-identical (the merge goes in
    split order and the tickets are back at 0)."""
    lengths = [0, 1, ps - 1, ps, ps + 1, 5 * ps + 3]
    q, k, v, tables, lens = _inputs(dtype, heads, kv_heads, hd, ps, lengths)
    want = pa.paged_attention_reference(q, k, v, tables, lens, layer=1, window=window)
    before = pa.paged_attention.launches
    runs = [pa.paged_attention(q, k, v, tables, lens, layer=1, window=window, splits=splits)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 3
    assert torch.all(runs[0][0] == 0)
    torch.testing.assert_close(runs[0].float(), want.float(), atol=ATOL[dtype], rtol=0)
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    for buf in pa._tickets.values():
        assert not buf.any()


def test_split_kernel_leaves_clean_tickets_after_a_refusal(cuda):
    """A call refused before its launch touches no ticket: the next split
    launch still merges."""
    q, k, v, tables, lens = _inputs(torch.bfloat16, 8, 8, 64, 16, [80, 1, 0, 47])
    want = pa.paged_attention_reference(q, k, v, tables, lens, layer=0, window=None)
    first = pa.paged_attention(q, k, v, tables, lens, splits=3)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, k, v, tables.long(), lens, splits=3)
    with pytest.raises(ValueError, match="splits"):
        pa.paged_attention(q, k, v, tables, lens, splits=0)
    again = pa.paged_attention(q, k, v, tables, lens, splits=3)
    torch.cuda.synchronize()
    for buf in pa._tickets.values():
        assert not buf.any()
    assert torch.equal(first, again)
    torch.testing.assert_close(again.float(), want.float(), atol=ATOL[torch.bfloat16], rtol=0)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, tables, lens = _inputs(torch.float32, 4, 4, 48, 4, [3, 5])
    before = pa.paged_attention.launches
    with pytest.raises(ValueError, match="head_dim in"):
        pa.paged_attention(q, k, v, tables, lens)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous(), tables.long(), lens)
    with pytest.raises(ValueError, match="on cpu"):
        pa.paged_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous(), tables.cpu(), lens)
    assert pa.paged_attention.launches == before


def test_engine_on_the_card_matches_generate(cuda):
    """float32 tiny model on the card: the engine's greedy streams (paged
    decode through the kernel) equal generate()'s (dense cached decode)."""
    config = ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2, dtype=torch.float32)
    params = init_params(config, torch.Generator("cuda").manual_seed(0))
    engine = ServeEngine(params, config, slots=2, page_size=4, prompt_bucket=12,
                         chunk=4)
    prompts = [[5, 9, 13], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [42]]
    rids = [engine.submit(p, 10) for p in prompts]
    before = pa.paged_attention.launches
    served = engine.run()
    assert pa.paged_attention.launches - before == (
        config.n_layers * engine.chunks_run * engine.chunk
    )
    for rid, p in zip(rids, prompts):
        want = generate(params, torch.tensor([p]), config, 10)[0].tolist()
        assert served[rid] == want
    assert engine.ctrl.used_pages == 0


# Flash kernels against their plain versions, as a share of the largest
# |value|: float32 differs by summation order; bf16 by a flipped bf16
# rounding of p, ds or the output (one ulp is 2^-8 of the value).
FLASH_SHARE = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


def _share(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _grad_shares(got, want):
    """Each gradient's max |error| as a share of its largest |value|.  A
    gradient that is zero in exact arithmetic carries only rounding noise
    (seq 1: one visible key, a constant softmax, so dq = dk = 0); below
    1e-3 of the call's largest gradient it is measured against that."""
    top = max(w.float().abs().max().item() for w in want)
    shares = []
    for g, w in zip(got, want):
        scale = w.float().abs().max().item()
        scale = top if scale < 1e-3 * top else scale
        shares.append((g.float() - w.float()).abs().max().item() / scale)
    return shares


def _flash_inputs(dtype, batch, seq, heads, kv_heads, hd, segments, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    q = torch.randn(batch, seq, heads, hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(batch, seq, kv_heads, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(batch, seq, kv_heads, hd, generator=g, device="cuda").to(dtype)
    dout = torch.randn(batch, seq, heads, hd, generator=g, device="cuda").to(dtype)
    seg = None
    if segments == "single":
        # Three segments, the middle one a single row that sees only itself.
        seg = torch.zeros(batch, seq, dtype=torch.int32, device="cuda")
        seg[:, seq // 2] = 1
        seg[:, seq // 2 + 1:] = 2
    elif segments:
        seg = torch.sort(torch.randint(0, 3, (batch, seq), generator=g, device="cuda"),
                         dim=1).values.to(torch.int32)
    return q, k, v, dout, seg


# The wgmma kernels (bf16 K2, K3 and K4 at head_dim 64 and 128) cut q and k
# into 64-row TMA boxes, 128-row q tiles (K2, K3) and 128-key tiles (K4):
# sequence lengths on either side of those edges, GQA groups 1, 4 and 8,
# windows shorter than a tile and across tiles, segment boundaries and
# full attention.
_EDGE_CASES = [
    (1, seq, heads, kv_heads, hd, True, None, False)
    for seq in (1, 63, 64, 65, 127, 128, 129)
    for heads, kv_heads, hd in ((4, 4, 64), (8, 2, 128), (8, 1, 128))
] + [
    (1, 2047, 16, 4, 128, True, None, False),
    (1, 2047, 8, 8, 64, True, None, False),
    (2, 300, 8, 2, 128, True, 37, False),
    (1, 700, 4, 1, 64, True, 200, False),
    (2, 257, 8, 8, 128, False, None, False),
    (2, 190, 8, 1, 64, False, None, True),
    (1, 300, 4, 2, 128, True, None, "single"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "batch, seq, heads, kv_heads, hd, causal, window, segments",
    [
        (2, 130, 4, 4, 64, True, None, False),
        (1, 200, 8, 2, 32, True, None, False),
        (1, 100, 8, 1, 16, False, None, False),
        (2, 150, 4, 4, 16, True, 37, False),
        (2, 97, 4, 2, 128, True, None, True),
        (1, 64, 2, 2, 128, False, None, True),
    ] + _EDGE_CASES,
)
def test_flash_kernels_match_plain_versions(cuda, dtype, batch, seq, heads, kv_heads, hd,
                                            causal, window, segments):
    q, k, v, dout, seg = _flash_inputs(dtype, batch, seq, heads, kv_heads, hd, segments)
    counts = [fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches]
    out, lse = fa.flash_fwd(q, k, v, causal, window, seg)
    want_out, want_lse = fa.flash_forward_reference(q, k, v, causal, window, seg)
    delta = fa._delta(want_out, dout)
    dq = fa.flash_bwd_dq(q, k, v, dout, want_lse, delta, causal, window, seg)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, want_lse, delta, causal, window, seg)
    want = fa.flash_backward_reference(q, k, v, want_out, dout, want_lse, causal, window, seg)
    torch.cuda.synchronize()
    assert [fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches] == [
        c + 1 for c in counts]
    limit = FLASH_SHARE[dtype]
    assert _share(out, want_out) <= limit
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    assert max(_grad_shares((dq, dk, dv), want)) <= limit
    if segments == "single":
        # The lone row's softmax is constant: its dq is zero up to rounding.
        row = dq[:, seq // 2].float().abs().max().item()
        assert row <= 1e-3 * dq.float().abs().max().item()


@pytest.mark.parametrize("hd, heads, kv_heads", [(64, 8, 8), (128, 16, 2)])
def test_flash_backward_launches_repeat_bit_identically(cuda, hd, heads, kv_heads):
    """K4 sums each GQA group inside one CTA and K3 each q tile's keys in
    one order, with no atomics: two launches give the same bits."""
    q, k, v, dout, seg = _flash_inputs(torch.bfloat16, 2, 333, heads, kv_heads, hd, True)
    out, lse = fa.flash_forward_reference(q, k, v, True, None, seg)
    delta = fa._delta(out, dout)
    first = (fa.flash_bwd_dq(q, k, v, dout, lse, delta, True, None, seg),
             *fa.flash_bwd_dkv(q, k, v, dout, lse, delta, True, None, seg))
    second = (fa.flash_bwd_dq(q, k, v, dout, lse, delta, True, None, seg),
              *fa.flash_bwd_dkv(q, k, v, dout, lse, delta, True, None, seg))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hd, heads, kv_heads", [(64, 8, 8), (128, 16, 2)])
def test_flash_forward_launches_repeat_bit_identically(cuda, hd, heads, kv_heads):
    """K2 on the wgmma route walks each row's keys in one order: two
    launches give the same out and lse."""
    q, k, v, _, seg = _flash_inputs(torch.bfloat16, 2, 333, heads, kv_heads, hd, True)
    first = fa.flash_fwd(q, k, v, True, None, seg)
    second = fa.flash_fwd(q, k, v, True, None, seg)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hd, heads, kv_heads, seq, window",
                         [(64, 8, 2, 300, None), (128, 8, 8, 257, None), (128, 4, 1, 700, 200)])
def test_flash_backward_takes_the_forward_kernels_out_and_lse(cuda, hd, heads, kv_heads, seq,
                                                              window):
    """Through FlashAttention the backward kernels are fed K2's own out and
    lse (the other tests feed them the plain forward's): the gradients
    stay within the limit of the plain forward and backward."""
    q, k, v, dout, _ = _flash_inputs(torch.bfloat16, 1, seq, heads, kv_heads, hd, False)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    fa.flash_attention(*leaves, window=window).backward(dout)
    want_out, want_lse = fa.flash_forward_reference(q, k, v, True, window)
    want = fa.flash_backward_reference(q, k, v, want_out, dout, want_lse, True, window)
    torch.cuda.synchronize()
    assert max(_grad_shares([x.grad for x in leaves], want)) <= FLASH_SHARE[torch.bfloat16]


def test_flash_kernels_take_a_view_off_the_16_byte_boundary(cuda):
    """The bf16 kernels load 16 bytes at a time and a TMA map needs a
    16-byte-aligned base; contiguous views that start 2 bytes into their
    storage still give the plain results, forward and backward."""
    shape = (1, 70, 4, 64)
    n = 70 * 4 * 64
    flat = torch.randn(4 * n + 1, device="cuda").to(torch.bfloat16)
    q, k, v, dout = (flat[1 + i * n:1 + (i + 1) * n].view(shape) for i in range(4))
    assert q.data_ptr() % 16
    out, lse = fa.flash_fwd(q, k, v)
    want, want_lse = fa.flash_forward_reference(q, k, v)
    assert _share(out, want) <= FLASH_SHARE[torch.bfloat16]
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    delta = fa._delta(want, dout)
    grads = (fa.flash_bwd_dq(q, k, v, dout, want_lse, delta),
             *fa.flash_bwd_dkv(q, k, v, dout, want_lse, delta))
    want_grads = fa.flash_backward_reference(q, k, v, want, dout, want_lse)
    assert max(_grad_shares(grads, want_grads)) <= FLASH_SHARE[torch.bfloat16]


def test_flash_autograd_launches_each_kernel_once(cuda):
    q, k, v, dout, _ = _flash_inputs(torch.bfloat16, 1, 70, 4, 2, 64, False)
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    counts = [fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches]
    fa.flash_attention(*leaves).backward(dout)
    assert [fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches] == [
        c + 1 for c in counts]
    xla = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    fa.flash_attention(*xla, bwd_impl="xla").backward(dout)
    assert fa.flash_bwd_dq.launches == counts[1] + 1  # xla runs the plain backward
    for a, b in zip(leaves, xla):
        assert _share(a.grad, b.grad) <= FLASH_SHARE[torch.bfloat16]


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    before = fa.flash_fwd.launches
    q = torch.randn(1, 16, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head_dim in"):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 16, 16, 16, device="cuda")
    with pytest.raises(ValueError, match="at most 8"):
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert fa.flash_fwd.launches == before


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_launches_the_flash_kernels(cuda, monkeypatch, remat):
    """One training step on the flash route: K2, K3 and K4 once per layer
    (K2 twice with remat, whose backward recomputes the forward)."""
    monkeypatch.setattr(tmodel, "flash_min_seq", lambda: 1)
    config = ModelConfig(max_seq_len=65, n_layers=2, attention_impl="flash",
                         remat_layers=remat)
    (params, state), opt = ttrain.make_train_state(config, device="cuda")
    step = ttrain.make_train_step(config, opt)
    tokens = ttrain.synthetic_batch(config, 2, device="cuda")
    counts = [fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches]
    _, _, loss = step(params, state, tokens)
    assert torch.isfinite(loss)
    n = config.n_layers
    assert [fa.flash_fwd.launches - counts[0], fa.flash_bwd_dq.launches - counts[1],
            fa.flash_bwd_dkv.launches - counts[2]] == [2 * n if remat else n, n, n]


# ---- the engine's decode step as a CUDA graph ---------------------------


def _on(params: dict, device) -> dict:
    return {"embed": params["embed"].to(device), "unembed": params["unembed"].to(device),
            "layers": [{k: w.to(device) for k, w in layer.items()} for layer in params["layers"]]}


@pytest.mark.parametrize("sampling", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("slots", [2, 4])
def test_decode_graph_chunk_equals_the_eager_chunk(cuda, slots, dtype, sampling):
    """One chunk through the engine's CUDA graph and through the eager
    loop from the same state (pools, inputs, generator): tokens and pools
    bit-identical, the sampled draws too (each replay advances the
    generator as an eager step does).  At 2 and 4 rows float32 pools take
    K1's split route inside the graph (bf16 pools keep one split); K1's
    count moves n_layers a replay."""
    config = ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2, dtype=dtype)
    params = tmodel.cast_params(init_params(config, torch.Generator("cuda").manual_seed(0)),
                                dtype)
    engine = ServeEngine(params, config, slots=slots, page_size=4, prompt_bucket=12, chunk=4,
                         temperature=0.8 if sampling else 0.0, top_k=40 if sampling else 0,
                         generator=torch.Generator("cuda").manual_seed(7))
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    assert pa.choose_splits(slots, config.kv_heads, engine.max_pages, sm_count) > 1
    for i in range(slots):
        engine.submit([5 + i, 9, 13, 2, 40][: 1 + 2 * i], 12)
    engine._admit()
    engine._cover_chunk()
    inputs = (engine._dev(engine._tables), engine._dev(engine._tokens),
              engine._dev(engine._positions), engine._dev(engine._occupied))
    engine._graph.capture()  # its warm-up writes the trash page: before the state is kept
    saved = [p.clone() for p in engine.pools]
    state = engine.generator.get_state()
    before = pa.paged_attention.launches
    graph_toks = engine._graph.run(*inputs, *engine._unbounded, engine.chunk)[0].clone()
    torch.cuda.synchronize()
    assert pa.paged_attention.launches - before == config.n_layers * engine.chunk
    graph_pools = [p.clone() for p in engine.pools]
    for pool, copy in zip(engine.pools, saved):
        pool.copy_(copy)
    engine.generator.set_state(state)
    with torch.inference_mode():
        eager_toks, _ = paged_decode_chunk(
            engine.params, engine.pools, *inputs, engine.generator if sampling else None,
            engine.temperature, engine.top_k, engine.top_p, config, engine.chunk, sampling)
    torch.cuda.synchronize()
    assert torch.equal(graph_toks, eager_toks)
    for a, b in zip(graph_pools, engine.pools):
        assert torch.equal(a, b)


_MODES = [{}, {"pipelined": True}, {"superstep_k": 2}, {"batched_admission": False},
          {"superstep_k": 4, "pipelined": True, "prefill_budget": 8}]


@pytest.mark.parametrize("mode", _MODES, ids=["defaults", "pipelined", "k2", "serial",
                                              "k4-pipelined-budget"])
def test_card_engine_streams_equal_the_cpu_engine(cuda, mode):
    """float32: the engine on the card (graph replays, pinned uploads and
    readbacks) emits the CPU engine's greedy streams, and K1 launched
    n_layers times a decode step."""
    config = ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2, dtype=torch.float32)
    params = init_params(config, torch.Generator().manual_seed(0))
    rng = torch.Generator().manual_seed(3)
    requests = [(torch.randint(0, 256, (n,), generator=rng).tolist(), new)
                for n, new in ((3, 17), (19, 9), (11, 24), (1, 5), (26, 12))]
    streams = {}
    for device in ("cpu", "cuda"):
        engine = ServeEngine(_on(params, device), config, slots=2, page_size=4,
                             prompt_bucket=8, chunk=4, device=device, **mode)
        rids = [engine.submit(p, n) for p, n in requests]
        before = pa.paged_attention.launches
        served = engine.run()
        streams[device] = [served[r] for r in rids]
        assert engine.ctrl.used_pages == 0
    assert pa.paged_attention.launches - before == (
        config.n_layers * engine.chunks_run * engine.chunk)
    assert streams["cuda"] == streams["cpu"]


def test_engine_uploads_do_not_race_the_host_mirrors(cuda):
    """Host mirrors change right after a dispatch (positions advance,
    tables extend, slots retire).  With the stream busy, so that every
    upload queues behind device work, scribbling on the mirror an upload
    was made from until the device has caught up changes no token."""
    config = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
    params = init_params(config, torch.Generator("cuda").manual_seed(0))
    requests = [([3, 1, 4, 1, 5], 17), ([2, 7], 9), ([9] * 11, 13), ([6, 6], 20)]

    def serve(racing: bool):
        engine = ServeEngine(params, config, slots=2, page_size=4, prompt_bucket=8,
                             superstep_k=2, pipelined=True, prefill_budget=8)
        if racing:
            upload = engine._dev

            def racing_dev(mirror):
                torch.cuda._sleep(1_000_000)  # the upload queues behind this
                out = upload(mirror)
                kept = mirror.copy()
                mirror[...] = 1 if mirror.dtype == bool else 3
                torch.cuda.synchronize()
                mirror[...] = kept
                return out

            engine._dev = racing_dev
        rids = [engine.submit(p, n) for p, n in requests]
        served = engine.run()
        assert engine.ctrl.used_pages == 0
        return [served[r] for r in rids]

    assert serve(racing=True) == serve(racing=False)


def test_sampled_graph_stream_is_seeded(cuda):
    """Sampling inside the graph: one generator seed gives one stream,
    another seed another, and the draws change from step to step."""
    config = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
    params = init_params(config, torch.Generator("cuda").manual_seed(0))

    def serve(seed):
        engine = ServeEngine(params, config, slots=2, page_size=4, prompt_bucket=8,
                             superstep_k=2, pipelined=True, temperature=0.8, top_k=40,
                             generator=torch.Generator("cuda").manual_seed(seed))
        rids = [engine.submit([1 + i, 2], 24) for i in range(3)]
        served = engine.run()
        return [served[r] for r in rids]

    first = serve(5)
    assert serve(5) == first
    assert serve(6) != first
    assert all(len(s) == 24 and len(set(s)) > 4 for s in first)


def test_bf16_decode_step_at_two_rows_keeps_one_split_within_its_floor(cuda):
    """Two rows, where the shapes alone would cut each row's pages into
    several splits: bf16 pools keep one split (a split bf16 step lands
    outside the step's bf16 floor, ROADMAP Queue C), and the bf16 decode
    step through the kernel stays within that floor (plain bf16 against
    plain float32), by max and by rms, as chip_smoke.py holds it."""
    import chip_smoke
    from dataclasses import replace

    from workloads_torch import paged as tpaged

    config = ModelConfig(d_model=512, n_heads=8, n_layers=4, d_ff=2048, vocab_size=4096,
                         max_seq_len=512, dtype=torch.bfloat16)
    params = tmodel.cast_params(init_params(config, torch.Generator("cuda").manual_seed(0)),
                                torch.bfloat16)
    lengths, ps = [431, 250], 16
    width = -(-max(lengths) // ps) + 1
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    assert pa.choose_splits(2, config.kv_heads, width, sm_count) > 1
    assert pa.choose_splits(2, config.kv_heads, width, sm_count, torch.bfloat16) == 1
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        runs[dtype] = chip_smoke.teacher_forced_step(
            torch, tpaged, pa, tmodel.cast_params(params, dtype),
            replace(config, dtype=dtype), ps, lengths)
    (_, want32), (got16, want16) = runs[torch.float32], runs[torch.bfloat16]
    err, floor = (got16 - want16).abs(), (want16 - want32).abs()
    assert err.max() <= floor.max()
    assert err.square().mean().sqrt() <= floor.square().mean().sqrt()


# ---- the request lifecycle on the card -----------------------------------

_LIFE_REQUESTS = [([3, 1, 4, 1, 5], 30), ([2, 7], 40), ([9] * 11, 25), ([6, 6], 30)]


def _life_model():
    config = ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2, dtype=torch.float32)
    return config, init_params(config, torch.Generator("cuda").manual_seed(0))


def _life_engine(params, config, **kw):
    return ServeEngine(params, config, slots=2, page_size=4, prompt_bucket=8, chunk=4, **kw)


def _life_streams(engine, requests=_LIFE_REQUESTS):
    rids = [engine.submit(p, n) for p, n in requests]
    served = engine.run()
    assert engine.ctrl.used_pages == 0 and engine._committed_pages == 0
    return [served[r] for r in rids]


def test_quarantine_mid_superstep_replays_into_the_dropped_supersteps_pages(cuda):
    """A readback fault while the next superstep still runs (each graph
    run queued behind a 10 ms sleep): the quarantine drops it unread and
    releases its rows' pages, the replay's prefill writes some of those
    pages, queued on the same stream behind the dropped superstep, and
    the streams are those of the fault-free run.  K1's count includes the
    dropped superstep's steps.  (A prefill on a stream of its own would
    race the dropped superstep's writes.)"""
    from workloads_torch.faults import FaultInjector

    config, params = _life_model()
    kw = dict(superstep_k=4, pipelined=True)
    clean = _life_streams(_life_engine(params, config, **kw))
    engine = _life_engine(params, config, fault_injector=FaultInjector({"decode_readback": [2]}),
                          **kw)
    graph_run = engine._graph.run

    def slow_run(*args):
        torch.cuda._sleep(20_000_000)
        return graph_run(*args)

    engine._graph.run = slow_run
    quarantine, allocate = engine._quarantine_step, engine.ctrl.allocate
    seen, reused = {}, set()

    def watching(exc, extra=None, **kwargs):
        seen["in_flight"] = [not read.event.query() for read, _ in engine._pending_super]
        seen["pages"] = {p for slot, req in engine._slot_req.items()
                         for p in engine.ctrl.tables[engine._seq_id(slot, req)]}
        return quarantine(exc, extra, **kwargs)

    def recording_allocate(seq, n_tokens):
        pages = allocate(seq, n_tokens)
        if seen:
            reused.update(set(pages) & seen["pages"])
        return pages

    engine._quarantine_step = watching
    engine.ctrl.allocate = recording_allocate
    before = pa.paged_attention.launches
    assert _life_streams(engine) == clean
    assert engine.steps_quarantined == 1
    assert any(seen["in_flight"]), "no superstep was in flight at the quarantine"
    assert reused, "the replay reused none of the dropped rows' pages"
    assert pa.paged_attention.launches - before == (
        config.n_layers * engine.chunks_run * engine.chunk)


@pytest.mark.parametrize("mode", [{"pipelined": True}, {"superstep_k": 2, "pipelined": True}],
                         ids=["k1-pipelined", "k2-pipelined"])
def test_dispatches_after_a_quarantine_or_a_cancel_upload_every_row(cuda, mode):
    """After a quarantine, and after cancelling one row while the other
    stays chained, the next dispatch takes every row from the host
    mirrors: garbage written into the graph's carry buffers (tok, pos,
    live, budget) right then changes no token."""
    from workloads_torch.faults import FaultInjector

    config, params = _life_model()
    clean = _life_streams(_life_engine(params, config, **mode))

    def poison(engine):
        with torch.inference_mode():  # the graph's buffers are inference tensors
            for buf, value in ((engine._graph.tok, 7), (engine._graph.pos, 3),
                               (engine._graph.live, True), (engine._graph.budget, 1000)):
                buf.fill_(value)

    engine = _life_engine(params, config, fault_injector=FaultInjector({"decode_readback": [2]}),
                          **mode)
    quarantine = engine._quarantine_step

    def poisoning(exc, extra=None, **kwargs):
        out = quarantine(exc, extra, **kwargs)
        poison(engine)
        return out

    engine._quarantine_step = poisoning
    assert _life_streams(engine) == clean and engine.steps_quarantined == 1

    engine = _life_engine(params, config, **mode)
    rids = [engine.submit(p, n) for p, n in _LIFE_REQUESTS[:2]]
    for _ in range(3):
        engine.step()
    chained = engine._super_chained if mode.get("superstep_k") else engine._chained_tok
    assert chained is not None
    assert engine.cancel(rids[0])
    poison(engine)
    served = engine.run()
    assert served[rids[1]] == clean[1]
    assert served[rids[0]] == clean[0][: len(served[rids[0]])]
    assert engine.ctrl.used_pages == 0


def test_a_dropped_readback_block_is_not_handed_out_before_its_copy_lands(cuda):
    """A readback dropped before its event fires (a quarantine drops the
    ones in flight): the caching host allocator hands its pinned block
    to no new allocation, which an upload would fill on the host, until
    the copy into it has landed."""
    from workloads_torch.serve import _Readback

    toks = torch.arange(64, device="cuda").reshape(8, 8)
    torch.cuda._sleep(200_000_000)  # the copy queues behind ~0.1 s of sleep
    read = _Readback(toks)
    ptr, event = read.host.data_ptr(), read.event
    del read
    assert not event.query()
    fresh = [torch.empty((8, 8), dtype=toks.dtype, pin_memory=True) for _ in range(8)]
    assert ptr not in {t.data_ptr() for t in fresh}
    for t in fresh:
        t.fill_(-1)
    torch.cuda.synchronize()
    assert all(bool((t == -1).all()) for t in fresh)


def test_a_fault_inside_the_graphs_first_run_leaves_it_uncaptured(cuda):
    """The capture raises: the step quarantines, the graph stays
    uncaptured with K1's count as it was, and the replay captures afresh
    (once) and serves the fault-free streams."""
    config, params = _life_model()
    clean = _life_streams(_life_engine(params, config))
    engine = _life_engine(params, config)
    step, failed = engine._graph._step, []

    def failing_step():
        if torch.cuda.is_current_stream_capturing() and not failed:
            failed.append(True)
            raise RuntimeError("fault inside the capture")
        step()

    engine._graph._step = failing_step
    before = pa.paged_attention.launches
    rids = [engine.submit(p, n) for p, n in _LIFE_REQUESTS]
    engine.step()
    assert failed and engine.steps_quarantined == 1
    assert engine._graph.graph is None and engine._graph.captures == 0
    assert pa.paged_attention.launches == before
    served = engine.run()
    assert [served[r] for r in rids] == clean
    assert engine._graph.captures == 1
    assert pa.paged_attention.launches - before == (
        config.n_layers * engine.chunks_run * engine.chunk)


def test_retune_walk_replays_one_capture(cuda):
    """superstep_k 4 -> 1 -> 2 -> 4 mid-drain on the card: the graph is
    captured once, K1 launches n_layers a decode step, and the streams
    are the fault-free ones bit for bit."""
    config, params = _life_model()
    clean = _life_streams(_life_engine(params, config, superstep_k=4, pipelined=True))
    engine = _life_engine(params, config, superstep_k=4, pipelined=True)
    rids = [engine.submit(p, n) for p, n in _LIFE_REQUESTS]
    before = pa.paged_attention.launches
    served = {}
    for k in (1, 2, 4):
        for _ in range(2):
            for req in engine.step():
                served[req.rid] = req.tokens
        assert engine.retune(superstep_k=k)
    served.update(engine.run())
    assert [served[r] for r in rids] == clean
    assert engine.retunes == 3 and engine._graph.captures == 1
    assert pa.paged_attention.launches - before == (
        config.n_layers * engine.chunks_run * engine.chunk)


# ---- the KV-cache hierarchy on the card ----------------------------------


def _kv_engine(params, config, **kw):
    kw = {"slots": 2, "page_size": 4, "prompt_bucket": 8, "chunk": 4, "prefix_cache": True,
          "kv_offload": True, **kw}
    return ServeEngine(params, config, **kw)


def _random_pools(engine, seed=1):
    g = torch.Generator("cuda").manual_seed(seed)
    with torch.no_grad():
        for pool in engine.pools:
            pool.copy_(torch.randn(pool.shape, generator=g, device="cuda").to(pool.dtype))


def test_bf16_spill_and_reload_round_trip_bit_exactly(cuda):
    """bf16 pages spill to pinned host tensors each blob owns, a 4-page
    gathered spill equals 4 single spills bit for bit, and each page
    reloads into a fresh pool page with the same bits."""
    from workloads_torch.paged import read_page

    config = ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2, dtype=torch.bfloat16)
    params = tmodel.cast_params(init_params(config, torch.Generator("cuda").manual_seed(0)),
                                torch.bfloat16)
    engine = _kv_engine(params, config)
    _random_pools(engine)
    pages = [5, 2, 9, 7]
    gathered = engine._spill_pages(pages)
    singles = [engine._spill_page(p) for p in pages]
    for p, ((gk, gv), gd), ((sk, sv), sd) in zip(pages, gathered, singles):
        assert gd is None and sd is None
        for t in (gk, gv):
            assert t.is_pinned() and t._base is None and t.dtype == torch.bfloat16
        assert torch.equal(gk, sk) and torch.equal(gv, sv)
        k, v = read_page(engine.pools, p)
        assert torch.equal(gk, k.cpu()) and torch.equal(gv, v.cpu())
    for (gk, gv), _ in gathered:
        dst = engine._reload_page(((gk, gv), None))
        k, v = read_page(engine.pools, dst)
        assert torch.equal(k.cpu(), gk) and torch.equal(v.cpu(), gv)


def test_a_blob_dropped_right_after_its_reload_leaves_the_page_intact(cuda):
    """The reload's copy queues behind ~0.1 s of device work and the
    node drops its pinned blob at once: the caching host allocator hands
    the blob's block to no new allocation, which the host fills, until
    the copy has landed, so the page holds the blob's bytes."""
    from workloads_torch.paged import read_page

    config, params = _life_model()
    engine = _kv_engine(params, config)
    shape = engine.pools[0][:, 0].shape
    k = torch.randn(shape).pin_memory()
    v = torch.randn(shape).pin_memory()
    want = (k.clone(), v.clone())
    ptrs = {k.data_ptr(), v.data_ptr()}
    torch.cuda._sleep(200_000_000)
    page = engine._reload_page(((k, v), None))
    del k, v
    fresh = [torch.empty(shape, pin_memory=True) for _ in range(8)]
    assert not ptrs & {t.data_ptr() for t in fresh}
    for t in fresh:
        t.fill_(-1.0)
    torch.cuda.synchronize()
    got = read_page(engine.pools, page)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def _kv_turns(engine, rng_seed=71, conversations=4, turns=3, new=6):
    """Conversations behind a shared 16-token system prompt, each turn
    submitted after the last drains; returns the streams."""
    g = torch.Generator().manual_seed(rng_seed)
    system = torch.randint(0, 256, (16,), generator=g).tolist()
    prompts = [system + torch.randint(0, 256, (5,), generator=g).tolist()
               for _ in range(conversations)]
    streams = []
    for _ in range(turns):
        rids = [engine.submit(p, new) for p in prompts]
        served = engine.run()
        streams.append([served[r] for r in rids])
        prompts = [p + s + torch.randint(0, 256, (5,), generator=g).tolist()
                   for p, s in zip(prompts, streams[-1])]
    return streams


def test_a_reload_queued_behind_a_superstep_in_flight_changes_no_token(cuda):
    """Reloads during admission queue on the stream behind the pipelined
    superstep still running (each graph run queued behind a sleep); the
    streams are the CPU engine's, and some reload met a superstep in
    flight."""
    config = ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2, dtype=torch.float32)
    params = init_params(config, torch.Generator().manual_seed(0))
    kw = dict(superstep_k=2, pipelined=True, n_pages=20)
    want = _kv_turns(_kv_engine(params, config, device="cpu", **kw))
    engine = _kv_engine(_on(params, "cuda"), config, **kw)
    graph_run, reload = engine._graph.run, engine._reload_page
    in_flight = []

    def slow_run(*args):
        torch.cuda._sleep(5_000_000)
        return graph_run(*args)

    def watching_reload(blob):
        in_flight.append(any(not read.event.query() for read, _ in engine._pending_super))
        return reload(blob)

    engine._graph.run, engine._reload_page = slow_run, watching_reload
    assert _kv_turns(engine) == want
    assert engine.prefix.reloads > 0 and any(in_flight), in_flight


def test_pools_hold_their_addresses_across_spill_reload_and_copy(cuda):
    """Spills, reloads, disk demotions and reloads and fan-out tail
    copies update the pools in place: the engine's and the graph's pools
    keep their data_ptr, and the graph is captured once."""
    from workloads_torch.paged import copy_page

    config, params = _life_model()
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        engine = _kv_engine(params, config, n_pages=20, kv_host_pages=2, kv_disk_dir=d)
        ptrs = [p.data_ptr() for p in engine.pools]
        _kv_turns(engine)
        rids = engine.submit_fanout(list(range(2, 12)), 6, n_samples=2)
        engine.run()
        copy_page(engine.pools, 0, 1)
        engine._reload_page(engine._spill_page(3))
        assert engine.prefix.spills and engine.prefix.reloads and engine.prefix.demotions
        assert [p.data_ptr() for p in engine.pools] == ptrs
        assert [p.data_ptr() for p in engine._graph.pools] == ptrs
        assert engine._graph.captures == 1 and rids


_KV_CARD_RUNS = [("turns_hier", (1, False, None, True)), ("turns_hier", (2, True, None, True)),
                 ("turns_hier", (4, True, 12, False)), ("turns_flat", (1, True, None, True)),
                 ("fanout", (2, False, 12, True)), ("handoff", (2, True, None, True)),
                 ("park", (1, False, None, True)), ("fault_kv_disk_read_corrupt",
                                                     (2, True, None, True))]


@pytest.mark.parametrize("scenario, mode", _KV_CARD_RUNS,
                         ids=[f"{s}-{m[0]}-{m[1]}-{m[2]}-{m[3]}" for s, m in _KV_CARD_RUNS])
def test_card_kv_runs_equal_the_cpu_engine(cuda, scenario, mode):
    """float32: the scripted KV-hierarchy runs on the card give the CPU
    engine's streams, statuses and every step's counters, K1 launching
    n_layers a decode step (chunk 4)."""
    from tests.test_torch_golden import tiny_config
    from tests.test_torch_kv_hierarchy import KV_CASE, KV_COUNTERS, run_kv_scenario

    config = tiny_config(KV_CASE)
    params = init_params(config, torch.Generator().manual_seed(0))
    runs = {}
    for device in ("cpu", "cuda"):
        before = pa.paged_attention.launches
        runs[device] = run_kv_scenario(
            lambda **kw: ServeEngine(_on(params, device), config, device=device, **kw),
            mode, scenario)
    launches = pa.paged_attention.launches - before
    for got, want in zip(runs["cuda"][:3], runs["cpu"][:3]):
        assert got.shape == want.shape and (got == want).all()
    # The handoff's prefill engine never decodes (max_new_tokens 1), so the
    # last row's chunks are every scenario's.
    chunks = int(runs["cuda"][1][-1, KV_COUNTERS.index("chunks_run")])
    assert launches == config.n_layers * 4 * chunks


# ---- speculative decoding on the card -------------------------------------

def _spec_engine(dtype, device="cuda", slots=3, **kw):
    from workloads_torch.quant import quantize_params

    config = ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2, dtype=dtype)
    params = tmodel.cast_params(init_params(config, torch.Generator().manual_seed(0)), dtype)
    params = _on(params, device)
    return ServeEngine(params, config, slots=slots, page_size=4, prompt_bucket=8, chunk=4,
                       draft_params=quantize_params(params), draft_config=config, gamma=3,
                       device=device, **kw)


@pytest.mark.parametrize("sampling", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_spec_graph_round_equals_the_eager_round_at_two_covers(cuda, dtype, sampling):
    """One spec round through its captured graph and through
    ``paged.spec_chained_round`` eagerly from the same state (pools,
    inputs, generator), at two cover buckets: committed tokens, n, the
    carry and both pool pairs bit-identical (the trash page, which
    duplicate writes share, aside); K1's count moves (gamma+1) x layers
    a replay."""
    from workloads_torch.paged import spec_chained_round

    engine = _spec_engine(dtype, temperature=0.8 if sampling else 0.0,
                          top_k=40 if sampling else 0,
                          generator=torch.Generator("cuda").manual_seed(7))
    for i, n in enumerate((3, 11, 6)):
        engine.submit([(5 * i + j) % 256 for j in range(n)], 20)
    engine._admit()
    u = engine.gamma + 1
    for slot, req in engine._slot_req.items():
        table = engine._extend_evicting(engine._seq_id(slot, req),
                                        int(engine._positions[slot]) + u)
        engine._tables[slot, : len(table)] = table
    narrow = engine._spec_cover(int(engine._positions.max()) + u)
    covers = (narrow, min(engine.max_pages, narrow + 4))
    assert covers[0] < covers[1]
    tables, cur, pos, occ = (engine._dev(engine._tables), engine._dev(engine._tokens),
                             engine._dev(engine._positions), engine._dev(engine._occupied))
    budget = torch.full_like(pos, 50, dtype=torch.int32)
    eos = torch.full_like(budget, -1)
    pools = (*engine.pools, *engine.d_pools)
    graph = engine._spec_graph
    for cover in covers:
        graph.capture(cover)  # its warm-up writes the trash page: before the state is kept
        saved = [p.clone() for p in pools]
        state = engine.generator.get_state()
        before = pa.paged_attention.launches
        got = [t.clone() for t in graph.run(tables, cur, pos, occ, budget, eos, 1, cover)]
        torch.cuda.synchronize()
        assert pa.paged_attention.launches - before == u * engine.draft_config.n_layers
        got_pools = [p.clone() for p in pools]
        for p, s in zip(pools, saved):
            p.copy_(s)
        engine.generator.set_state(state)
        with torch.inference_mode():
            want = spec_chained_round(
                engine.params, engine.draft_params, engine.pools, engine.d_pools, tables, cur,
                pos, occ, budget, eos, engine.config, engine.draft_config, engine.gamma,
                cover, sampling=sampling, generator=engine.generator,
                temperature=engine.temperature, top_k=engine.top_k, top_p=engine.top_p)
        torch.cuda.synchronize()
        assert torch.equal(got[0][0], want[0]) and torch.equal(got[1][0], want[1])
        for g_, w in zip(got[3:], want[2:]):
            assert torch.equal(g_, w)
        for a, b in zip(got_pools, pools):
            assert torch.equal(a[:, :-1], b[:, :-1])
    assert graph.captures == 2 and graph.captures_by_cover == {c: 1 for c in covers}


def test_int8_weight_on_the_card_equals_the_cpu(cuda):
    """Quantization and the int8 read path on the card give the CPU's
    bits: q8, scale, and ``weight`` in bf16 and float32."""
    from workloads_torch.model import weight
    from workloads_torch.quant import quantize

    w = (0.02 * torch.randn((64, 3, 4, 16), generator=torch.Generator().manual_seed(1)))
    for dtype in (torch.float32, torch.bfloat16):
        cpu = quantize(w.to(dtype), 0)
        card = quantize(w.to(dtype).cuda(), 0)
        assert torch.equal(card["q8"].cpu(), cpu["q8"])
        assert torch.equal(card["scale"].cpu(), cpu["scale"])
        for out in (torch.bfloat16, torch.float32):
            assert torch.equal(weight(card, out).cpu(), weight(cpu, out))


def test_draft_spill_and_reload_equal_single_spills(cuda):
    """With a draft model a 4-page gathered spill equals 4 single spills
    bit for bit, draft halves included, in pinned tensors each blob owns;
    a reload writes both halves back."""
    from workloads_torch.paged import read_page

    engine = _spec_engine(torch.bfloat16, prefix_cache=True, kv_offload=True)
    g = torch.Generator("cuda").manual_seed(2)
    for pool in (*engine.pools, *engine.d_pools):
        pool.copy_(torch.randn(pool.shape, generator=g, device="cuda").to(pool.dtype))
    pages = [5, 2, 9, 7]
    gathered = engine._spill_pages(pages)
    for p, blob in zip(pages, gathered):
        one = engine._spill_page(p)
        assert blob[1] is not None
        for a, b in zip((*blob[0], *blob[1]), (*one[0], *one[1])):
            assert a.is_pinned() and a._base is None and torch.equal(a, b)
        for pools, half in ((engine.pools, blob[0]), (engine.d_pools, blob[1])):
            k, v = read_page(pools, p)
            assert torch.equal(half[0], k.cpu()) and torch.equal(half[1], v.cpu())
    for blob in gathered:
        dst = engine._reload_page(blob)
        for pools, half in ((engine.pools, blob[0]), (engine.d_pools, blob[1])):
            k, v = read_page(pools, dst)
            assert torch.equal(k.cpu(), half[0]) and torch.equal(v.cpu(), half[1])


def test_pipelined_spec_carry_survives_the_next_replay(cuda):
    """The pipelined spec superstep keeps its device carry for the next
    dispatch; a replay overwrites the graph's buffers in place, so the
    carry is a copy: another replay leaves it as it was."""
    engine = _spec_engine(torch.float32, spec_superstep_k=2, pipelined=True)
    for i in range(3):
        engine.submit([7 + i, 3, 9], 30)
    engine.step()
    engine.step()
    assert engine._pending_spec is not None and engine._spec_chained is not None
    kept = [t.clone() for t in engine._spec_chained]
    graph = engine._spec_graph
    for buf in (graph.cur, graph.pos, graph.live, graph.budget):
        assert all(t.data_ptr() != buf.data_ptr() for t in engine._spec_chained)
    trash = torch.full_like(graph.tables, engine.ctrl.trash)
    zeros = torch.zeros_like(graph.pos)
    off = torch.zeros_like(graph.live)
    graph.run(trash, zeros, zeros, off, graph.budget.clone(), graph.eos.clone(), 1,
              next(iter(graph.graphs)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(engine._spec_chained, kept))
    served = engine.run()
    assert all(len(t) == 30 for t in served.values())
    assert engine.ctrl.used_pages == 0


@pytest.mark.parametrize("mode", [{}, {"pipelined": True}, {"spec_lookahead": 2, "pipelined": True},
                                  {"spec_superstep_k": 3}, {"spec_superstep_k": 2, "pipelined": True},
                                  {"spec": "auto", "spec_breakeven": 1.0}],
                         ids=["on", "piped", "la2-piped", "ss3", "ss2-piped", "auto"])
def test_card_spec_streams_equal_the_cpu_engine(cuda, mode):
    """float32: the spec engine on the card (graph replays per cover,
    pinned uploads and readbacks) emits the CPU engine's greedy streams
    with the same rounds and rejections; K1 launched (gamma+1) x layers
    a round and n_layers a plain decode step."""
    requests = [([(3 * i + j) % 256 for j in range(n)], new)
                for i, (n, new) in enumerate(((3, 17), (19, 9), (11, 24), (1, 5), (26, 12)))]
    out = {}
    for device in ("cpu", "cuda"):
        engine = _spec_engine(torch.float32, device=device, slots=2, **mode)
        rids = [engine.submit(p, n) for p, n in requests]
        before = pa.paged_attention.launches
        served = engine.run()
        out[device] = ([served[r] for r in rids], engine.spec_rounds,
                       engine.spec_tokens_rejected, engine.chunks_run)
        assert engine.ctrl.used_pages == 0
    assert out["cuda"] == out["cpu"]
    rounds, chunks = out["cuda"][1], out["cuda"][3]
    assert pa.paged_attention.launches - before == 2 * (4 * rounds + 4 * chunks)


def test_auto_sampling_captures_both_graphs_on_one_generator(cuda):
    """spec="auto" with sampling: the decode graph and the spec graph both
    capture and draw from the engine's one generator; every request gets
    its budget and the pool drains."""
    engine = _spec_engine(torch.bfloat16, slots=2, spec="auto", spec_breakeven=1.0,
                          temperature=0.8, top_k=40,
                          generator=torch.Generator("cuda").manual_seed(3))
    rids = [engine.submit([4 + i, 8, 15], 14 + 3 * i) for i in range(3)]
    served = engine.run()
    assert [len(served[r]) for r in rids] == [14, 17, 20]
    assert engine._graph.captures == 1 and engine._spec_graph.captures >= 1
    assert engine.spec_mode_steps > 0 and engine.plain_mode_steps > 0
    assert engine.ctrl.used_pages == 0


# ---- multi-LoRA on the card ----------------------------------------------


def _lora_adapters(config, device):
    from workloads_torch.multi_lora import synthetic_adapters

    return synthetic_adapters(config, 2, rank=4, scale=0.3, seed=3, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_lora_graph_chunk_equals_the_eager_chunk_with_mixed_adapters(cuda, dtype):
    """One chunk through the adapter engine's graph and through the eager
    loop with ``lora=`` from the same state, rows under the base and both
    adapters: tokens and pools bit-identical; the graph holds one more
    static buffer, the adapter index, and K1 moves n_layers a replay."""
    config = ModelConfig(max_seq_len=64, n_layers=2, dtype=dtype)
    params = tmodel.cast_params(init_params(config, torch.Generator("cuda").manual_seed(0)),
                                dtype)
    adapters = _lora_adapters(config, "cuda")
    engine = ServeEngine(params, config, slots=3, page_size=4, prompt_bucket=8, chunk=4,
                         adapters=adapters)
    for i, name in enumerate([None] + sorted(adapters)):
        engine.submit([5 + i, 9, 13, 2, 40][: 1 + 2 * i], 12, adapter=name)
    engine._admit()
    engine._cover_chunk()
    assert sorted(engine._adapter_idx.tolist()) == [0, 1, 2]
    inputs = (engine._dev(engine._tables), engine._dev(engine._tokens),
              engine._dev(engine._positions), engine._dev(engine._occupied))
    aidx = engine._aidx_dev()
    engine._graph.capture()
    assert engine._graph.aidx is not None and engine._graph.aidx.dtype == torch.int32
    saved = [p.clone() for p in engine.pools]
    before = pa.paged_attention.launches
    graph_toks = engine._graph.run(*inputs, *engine._unbounded, engine.chunk,
                                   aidx=aidx)[0].clone()
    torch.cuda.synchronize()
    assert pa.paged_attention.launches - before == config.n_layers * engine.chunk
    graph_pools = [p.clone() for p in engine.pools]
    for pool, copy in zip(engine.pools, saved):
        pool.copy_(copy)
    with torch.inference_mode():
        eager_toks, _ = paged_decode_chunk(
            engine.params, engine.pools, *inputs, None, 0.0, 0, 1.0, config, engine.chunk,
            False, lora=engine._lora(aidx))
    torch.cuda.synchronize()
    assert torch.equal(graph_toks, eager_toks)
    for a, b in zip(graph_pools, engine.pools):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="aidx"):
        engine._graph.run(*inputs, *engine._unbounded, engine.chunk)


def test_a_graph_without_adapters_holds_no_index_buffer(cuda):
    """An engine without adapters captures the graph it captured before:
    no adapter buffer, and an index handed to it is refused."""
    config = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
    params = init_params(config, torch.Generator("cuda").manual_seed(0))
    engine = ServeEngine(params, config, slots=2, page_size=4, prompt_bucket=8, chunk=4)
    assert engine._graph.aidx is None and engine._stacked_adapters is None
    with pytest.raises(ValueError, match="aidx"):
        engine._graph.run(*(torch.zeros(1, device="cuda"),) * 6, 1,
                          aidx=torch.zeros(2, dtype=torch.int32, device="cuda"))


_LORA_MODES = [{}, {"pipelined": True}, {"superstep_k": 2, "pipelined": True},
               {"batched_admission": False}, {"prefill_budget": 8, "prefix_cache": True}]


@pytest.mark.parametrize("mode", _LORA_MODES,
                         ids=["defaults", "pipelined", "k2-pipelined", "serial", "budget-radix"])
def test_card_lora_streams_equal_the_cpu_engine_with_one_capture(cuda, mode):
    """float32: the adapter engine on the card emits the CPU engine's
    greedy streams for a stream whose adapter mix changes at every
    admission, and its graph is captured once: churn replays it."""
    config = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
    params = init_params(config, torch.Generator().manual_seed(0))
    adapters = _lora_adapters(config, "cpu")
    names = [None] + sorted(adapters)
    requests = [([(7 * i + j) % 256 for j in range(n)], new, names[i % 3])
                for i, (n, new) in enumerate(((3, 17), (19, 9), (11, 24), (1, 5), (26, 12),
                                              (9, 14), (4, 20)))]
    out = {}
    for device in ("cpu", "cuda"):
        ads = {k: [{t: {f: x.to(device) for f, x in ab.items()} for t, ab in e.items()}
                   for e in v] for k, v in adapters.items()}
        engine = ServeEngine(_on(params, device), config, slots=2, page_size=4,
                             prompt_bucket=8, chunk=4, adapters=ads, device=device, **mode)
        rids = [engine.submit(p, n, adapter=a) for p, n, a in requests]
        served = engine.run()
        out[device] = [served[r] for r in rids]
        if device == "cuda":
            assert engine._graph.captures == 1
        engine.close()
        assert engine.ctrl.used_pages == 0
    assert out["cuda"] == out["cpu"]


def test_card_lora_spec_streams_equal_the_cpu_engine_without_recapture(cuda):
    """float32 speculation over adapters (the target's verify adapted,
    the int8 self-draft not): the card's streams equal the CPU's, and
    each cover's round graph is captured once through the churn."""
    # One draw of the factors (on the CPU: a generator's numbers differ
    # by device), moved to each engine's device.
    adapters = _lora_adapters(ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2,
                                          dtype=torch.float32), "cpu")
    out = {}
    for device in ("cpu", "cuda"):
        ads = {k: [{t: {f: x.to(device) for f, x in ab.items()} for t, ab in e.items()}
                   for e in v] for k, v in adapters.items()}
        engine = _spec_engine(torch.float32, device=device, slots=3, adapters=ads,
                              spec_superstep_k=2, pipelined=True)
        names = [None] + sorted(engine._adapter_ids)
        rids = [engine.submit([(5 * i + j) % 256 for j in range(3 + i)], 12 + i,
                              adapter=names[i % 3]) for i in range(6)]
        served = engine.run()
        out[device] = ([served[r] for r in rids], engine.spec_rounds)
        if device == "cuda":
            assert set(engine._spec_graph.captures_by_cover.values()) == {1}
            assert engine._spec_graph.aidx is not None
        assert engine.ctrl.used_pages == 0
    assert out["cuda"] == out["cpu"]


def test_pipelined_adapter_index_is_snapshotted_at_dispatch(cuda):
    """Under pipelined supersteps admission rewrites the adapter mirror
    while a superstep is in flight.  The dispatch uploads its own pinned
    copy: scribbling on the mirror after each upload, while the device
    is still busy, changes no token of any row."""
    config = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
    params = init_params(config, torch.Generator("cuda").manual_seed(0))
    adapters = _lora_adapters(config, "cuda")
    names = [None] + sorted(adapters)
    requests = [([3, 1, 4, 1, 5], 17), ([2, 7], 9), ([9] * 11, 13), ([6, 6], 20),
                ([8, 1], 11)]

    def serve(racing: bool):
        engine = ServeEngine(params, config, slots=2, page_size=4, prompt_bucket=8,
                             superstep_k=2, pipelined=True, adapters=adapters)
        if racing:
            upload = engine._dev

            def racing_dev(mirror):
                torch.cuda._sleep(1_000_000)  # the upload queues behind this
                out = upload(mirror)
                if mirror is engine._adapter_idx:
                    kept = mirror.copy()
                    mirror[...] = 2
                    torch.cuda.synchronize()
                    mirror[...] = kept
                return out

            engine._dev = racing_dev
        rids = [engine.submit(p, n, adapter=names[i % 3]) for i, (p, n) in enumerate(requests)]
        served = engine.run()
        assert engine.ctrl.used_pages == 0
        return [served[r] for r in rids]

    assert serve(racing=True) == serve(racing=False)


def test_lora_products_do_not_run_in_tf32(cuda):
    """The factor products are float32 einsums: with TF32 off (the
    default this port keeps) a row's delta on the card matches a float64
    reference to float32 accuracy; TF32 would miss by ~1e-3."""
    from workloads_torch.multi_lora import _row_delta

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    g = torch.Generator("cuda").manual_seed(4)
    x = torch.randn((4, 3, 512), generator=g, device="cuda")
    ab = {"a": torch.randn((3, 512, 8), generator=g, device="cuda") / 512**0.5,
          "b": torch.randn((3, 8, 1536), generator=g, device="cuda")}
    idx = torch.tensor([0, 2, 1, 2], device="cuda")
    got = _row_delta(x, ab, idx).double()
    a, b = ab["a"][idx].double(), ab["b"][idx].double()
    want = torch.einsum("bsr,brf->bsf", torch.einsum("bsd,bdr->bsr", x.double(), a), b)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_lora_train_step_launches_the_flash_kernels_and_keeps_the_base(cuda, monkeypatch):
    """The LoRA fine-tune on the flash route: K2, K3, K4 once a layer a
    step, the base bit-unchanged and the loss falling on a fixed batch."""
    from workloads_torch.lora import lora_init, make_lora_train_step

    monkeypatch.setattr(tmodel, "flash_min_seq", lambda: 1)
    config = ModelConfig(max_seq_len=65, n_layers=2, n_heads=4, d_model=256,
                         attention_impl="flash")
    base = init_params(config, torch.Generator("cuda").manual_seed(0))
    kept = [t.clone() for t in ttrain.tree_leaves(base)]
    adapters = lora_init(config, 4, torch.Generator("cuda").manual_seed(1))
    optimizer = ttrain.AdamW(lr=1e-2, mu_dtype=torch.float32)
    state = optimizer.init(adapters)
    step = make_lora_train_step(config, optimizer, base)
    tokens = ttrain.synthetic_batch(config, 4, seed=0)
    losses = []
    counts = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    for _ in range(3):
        adapters, state, loss = step(adapters, state, tokens)
        losses.append(loss.item())
    now = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    assert [b - a for a, b in zip(counts, now)] == [3 * config.n_layers] * 3
    assert losses[-1] < losses[0]
    assert all(torch.equal(a, b) for a, b in zip(ttrain.tree_leaves(base), kept))


# ---- the fleet and its control plane on the card ----------------------------

_FLEET_REQUESTS = [([3, 1, 4, 1, 5], 18), ([2, 7], 25), ([9] * 11, 14), ([6, 6], 22),
                   ([8] * 17, 9), ([1, 2, 3, 4], 20)]


def _fleet_engine_kw(**kw):
    return dict(slots=2, page_size=4, prompt_bucket=8, chunk=4, **kw)


def _plain_streams(params, config, requests=_FLEET_REQUESTS, device="cuda"):
    engine = ServeEngine(params, config, device=device, **_fleet_engine_kw())
    rids = [engine.submit(p, n) for p, n in requests]
    served = engine.run()
    return [served[r] for r in rids]


def _fleet_leak_free(fleet):
    from workloads_torch.fleet import DEAD

    for rep in fleet.replicas:
        if rep.state == DEAD:
            continue
        e = rep.engine
        pinned = e.prefix.cached_pages if e.prefix is not None else 0
        assert not e._occupied.any() and e._committed_pages == 0 and not rep.rids
        assert e.ctrl.used_pages == pinned


def test_two_replica_fleet_on_the_card_equals_the_plain_engine(cuda):
    """float32: a two-replica fleet on the card, one capture a replica,
    emits the plain engine's greedy streams, K1 n_layers a decode step."""
    from workloads_torch.fleet import make_fleet

    config, params = _life_model()
    want = _plain_streams(params, config)
    fleet = make_fleet(params, config, 2, engine_kw=_fleet_engine_kw(), device="cuda",
                       hang_timeout_s=None)
    before = pa.paged_attention.launches
    rids = [fleet.submit(p, n) for p, n in _FLEET_REQUESTS]
    served = fleet.run()
    assert [served[r] for r in rids] == want
    chunks = sum(rep.engine.chunks_run for rep in fleet.replicas)
    assert pa.paged_attention.launches - before == config.n_layers * 4 * chunks
    assert all(rep.engine.requests_admitted > 0 for rep in fleet.replicas)
    assert [rep.engine._graph.captures for rep in fleet.replicas] == [1, 1]
    _fleet_leak_free(fleet)
    fleet.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_an_observed_engine_captures_and_streams_as_an_unobserved_one(cuda, dtype):
    """The observer's and the ledger's brackets read host counters only:
    the same decode and spec graph captures, bit-identical streams, in
    the plain, superstep and speculative modes."""
    from workloads_torch.ledger import ChipTimeLedger
    from workloads_torch.obs import EngineObserver
    from workloads_torch.quant import quantize_params

    config = ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2, dtype=dtype)
    params = tmodel.cast_params(init_params(config, torch.Generator("cuda").manual_seed(0)),
                                dtype)
    spec = dict(draft_params=quantize_params(params), draft_config=config, gamma=2)
    for mode in ({}, {"superstep_k": 2, "pipelined": True}, spec):
        out = []
        for observed in (False, True):
            kw = dict(observer=EngineObserver(), ledger=ChipTimeLedger()) if observed else {}
            engine = ServeEngine(params, config, device="cuda", **_fleet_engine_kw(**mode),
                                 **kw)
            rids = [engine.submit(p, n) for p, n in _FLEET_REQUESTS]
            served = engine.run()
            spec_caps = (dict(engine._spec_graph.captures_by_cover)
                         if engine._spec_graph is not None else None)
            out.append(([served[r] for r in rids], engine._graph.captures, spec_caps))
            if observed:
                assert engine.ledger.reconcile(expect_quiescent=True)["ok"]
                assert len(engine._obs.steps) > 0
        assert out[0] == out[1], sorted(mode)


def test_host_sync_grows_on_every_consume_path_and_not_in_a_spill(cuda):
    """``host_sync_s`` times the chunk, superstep and spec readbacks; a
    spill's event wait is ``kv_spill_s``, not a host sync."""
    from workloads_torch.quant import quantize_params

    config, params = _life_model()
    for kw in ({}, {"superstep_k": 2}, {"draft_params": quantize_params(params),
                                        "draft_config": config, "gamma": 2}):
        engine = ServeEngine(params, config, device="cuda", **_fleet_engine_kw(**kw))
        engine.submit([1, 2, 3], 12)
        engine.step()
        synced = engine.host_sync_s
        engine.run()
        assert synced > 0 and engine.host_sync_s > synced, kw
    engine = ServeEngine(params, config, device="cuda",
                         **_fleet_engine_kw(prefix_cache=True, kv_offload=True))
    engine.submit(list(range(1, 13)), 4)
    engine.run()
    synced, spilled = engine.host_sync_s, engine.kv_spill_s
    pages = engine._prefix_evict(engine.prefix.cached_pages)
    assert pages > 0 and engine.prefix.spills > 0 and engine.kv_spill_s > spilled
    assert engine.host_sync_s == synced


def test_a_roles_fleet_hands_off_on_the_card_without_leaks(cuda):
    """float32 prefill/decode roles: every prompt's KV crosses through
    export_kv/import_kv on the card, the streams are the plain engine's,
    and neither pool leaks a page."""
    from workloads_torch.fleet import make_fleet

    config, params = _life_model()
    requests = [([(5 * i + j) % 256 for j in range(9 + 3 * i)], 10 + i) for i in range(4)]
    want = _plain_streams(params, config, requests)
    fleet = make_fleet(params, config, 2, device="cuda", hang_timeout_s=None,
                       engine_kw=_fleet_engine_kw(prefix_cache=True, kv_offload=True),
                       roles=("prefill", "decode"))
    rids = [fleet.submit(p, n) for p, n in requests]
    served = fleet.run()
    assert [served[r] for r in rids] == want
    assert fleet.kv_handoffs == len(requests) and fleet.handoff_pages > 0
    assert fleet.replicas[1].engine.kv_handoff_pages_in > 0
    _fleet_leak_free(fleet)
    fleet.close()


def test_sse_over_a_cuda_fleet_while_it_captures(cuda):
    """Two SSE clients stream from the front end while the driver thread
    captures each replica's graph: handler threads touch host state only,
    and the streamed tokens are the fleet's record and the plain
    engine's."""
    import json
    import threading
    import urllib.request

    from workloads_torch.fleet import FleetServer, make_fleet

    config, params = _life_model()
    requests = _FLEET_REQUESTS[:2]
    want = _plain_streams(params, config, requests)
    fleet = make_fleet(params, config, 2, engine_kw=_fleet_engine_kw(), device="cuda",
                       hang_timeout_s=None)
    server = FleetServer(fleet, 0)
    port = server.start()
    got = {}

    def client(i, prompt, new):
        body = json.dumps({"prompt": prompt, "max_new_tokens": new}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        tokens, done = [], None
        with urllib.request.urlopen(req, timeout=120) as resp:
            for line in resp:
                if line.startswith(b"data: "):
                    ev = json.loads(line[6:])
                    tokens += ev.get("tokens", [])
                    done = ev if ev.get("done") else done
        got[i] = (tokens, done)

    threads = [threading.Thread(target=client, args=(i, p, n))
               for i, (p, n) in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    server.stop()
    for i, stream in enumerate(want):
        tokens, done = got[i]
        assert done["status"] == "ok" and tokens == stream
        assert fleet._reqs[done["rid"]].tokens == tokens
    # The router may send both requests to one replica (the first can
    # finish before the second arrives): each replica that served one
    # captured its graph once, under the streams.
    served = [rep.engine.requests_admitted > 0 for rep in fleet.replicas]
    assert any(served)
    assert [rep.engine._graph.captures for rep in fleet.replicas] == [int(x) for x in served]
    _fleet_leak_free(fleet)
    fleet.close()


# ---- device-time profiling and fast start on the card -------------------------


def _k1_in_trace(capture) -> int:
    import json
    import os

    with open(os.path.join(capture["dir"], "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events
               if e.get("cat") == "kernel" and "paged_decode_kernel" in e.get("name", ""))


def test_a_capture_started_and_stopped_on_other_threads_holds_the_drivers_k1(cuda, tmp_path):
    """The fleet's threads: a handler thread starts the capture, the
    driver thread serves (each decode step a replay of the engine's
    graph), another thread stops it.  The trace holds every K1 launch
    the driver made, graph replays included."""
    import threading

    from workloads_torch.profiler import ProfileSession

    config, params = _life_model()
    engine = ServeEngine(params, config, device="cuda", **_fleet_engine_kw())
    engine.submit([1, 2, 3], 2)
    engine.run()  # the graph's capture, before the window
    session = ProfileSession(str(tmp_path), max_secs=60.0)
    starter = threading.Thread(target=session.start)
    starter.start()
    starter.join(timeout=60)
    assert not starter.is_alive() and session.active
    counted = {}

    def drive():
        before = pa.paged_attention.launches
        for p, n in _FLEET_REQUESTS:
            engine.submit(p, n)
        engine.run()
        torch.cuda.synchronize()
        counted["k1"] = pa.paged_attention.launches - before

    driver = threading.Thread(target=drive)
    driver.start()
    driver.join(timeout=120)
    got = []
    stopper = threading.Thread(target=lambda: got.append(session.stop()))
    stopper.start()
    stopper.join(timeout=120)
    assert not driver.is_alive() and not stopper.is_alive() and not session.active
    assert engine._graph.captures == 1
    assert counted["k1"] > 0 and _k1_in_trace(got[0]) == counted["k1"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_an_engine_that_captures_under_an_active_profile_captures_once_and_streams(cuda, dtype,
                                                                                  tmp_path):
    """A respawn or scale-up during POST /profile: an engine built and
    served while a capture is active (started on another thread)
    captures its graph once and streams as one served with no capture,
    and the trace holds its K1 launches."""
    import threading

    from workloads_torch.profiler import ProfileSession

    config = ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2, dtype=dtype)
    params = tmodel.cast_params(init_params(config, torch.Generator("cuda").manual_seed(0)),
                                dtype)
    want = _plain_streams(params, config)
    session = ProfileSession(str(tmp_path), max_secs=60.0)
    starter = threading.Thread(target=session.start)
    starter.start()
    starter.join(timeout=60)
    before = pa.paged_attention.launches
    engine = ServeEngine(params, config, device="cuda", **_fleet_engine_kw())
    rids = [engine.submit(p, n) for p, n in _FLEET_REQUESTS]
    served = engine.run()
    torch.cuda.synchronize()
    counted = pa.paged_attention.launches - before
    capture = session.stop()
    assert engine._graph.captures == 1
    assert [served[r] for r in rids] == want
    # The warm-up and the capture launch nothing counted; every replay does.
    assert _k1_in_trace(capture) >= counted > 0


def test_a_primed_auto_engine_runs_no_calibration_dispatches(cuda):
    """float32 spec="auto": the cold engine's first decode times dead
    dispatches (K1 launches beyond its served steps and rounds); an
    engine primed from its snapshot launches exactly what it serves,
    counts the reuse and streams as the cold engine does."""
    from workloads_torch.faststart import EngineSnapshot
    from workloads_torch.quant import quantize_params

    config, params = _life_model()
    kw = dict(_fleet_engine_kw(), draft_params=quantize_params(params), draft_config=config,
              gamma=2, spec="auto")

    def serve(engine):
        before = {n: getattr(engine, n) for n in ("chunks_run", "spec_rounds")}
        k1 = pa.paged_attention.launches
        rids = [engine.submit(p, n) for p, n in _FLEET_REQUESTS]
        served = engine.run()
        torch.cuda.synchronize()
        launches = pa.paged_attention.launches - k1
        served_k1 = (config.n_layers * engine.chunk * (engine.chunks_run - before["chunks_run"])
                     + config.n_layers * 3 * (engine.spec_rounds - before["spec_rounds"]))
        return [served[r] for r in rids], launches, served_k1

    cold = ServeEngine(params, config, device="cuda", **kw)
    cold_streams, cold_k1, cold_served = serve(cold)
    snap = EngineSnapshot.capture(cold)
    primed = ServeEngine(params, config, device="cuda", **kw)
    assert snap.prime(primed)
    primed_streams, primed_k1, primed_served = serve(primed)
    assert cold.calibration_reused == 0 and primed.calibration_reused == 1
    assert primed.spec_calibration == cold.spec_calibration
    assert primed_streams == cold_streams
    assert cold_k1 > cold_served and primed_k1 == primed_served
    assert primed._graph.captures == 1


# ==== perfbench's chains on the card


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_graphed_attention_chain_equals_the_eager_chain(cuda, attn):
    """perfbench's attention chain replays one captured link (forward,
    backward, q's update) n times: bit-identical to n eager links, and a
    replay moves no wrapper's count (they count the warm-up and the
    capture)."""
    from workloads_torch.perfbench import _attention_chain, _dense_causal, _rand_qkv

    fn = fa.flash_attention if attn == "flash" else _dense_causal
    q, k, v = _rand_qkv(1024, 8, 128, device=cuda)
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [w.launches for w in wrappers]
    graphed = _attention_chain(fn, q, k, v)
    captured = [w.launches - b for w, b in zip(wrappers, before)]
    got = graphed(5).clone()
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == captured
    assert captured == ([4, 4, 4] if attn == "flash" else [0, 0, 0])
    want = _attention_chain(fn, q, k, v, graph=False)(5)
    assert torch.equal(got, want)
    assert not torch.equal(got, q)
    assert torch.equal(graphed(5), got)  # each run starts from q


def test_device_peak_flops_resolves_on_the_card(cuda):
    """On a card the peak table must know the card, or MFU silently
    vanishes from the bench."""
    from workloads_torch.perfbench import device_peak_flops

    assert device_peak_flops(), (
        f"{torch.cuda.get_device_name(0)!r} is missing from _PEAK_BF16_FLOPS")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_time_paged_chunks_graphed_tokens_equal_the_eager_chunks(cuda, dtype):
    """The decode program perfbench times on the card (DecodeGraph
    replays) emits paged_decode_chunk's tokens, chunk after chunk."""
    from workloads_torch.model import cast_params
    from workloads_torch.perfbench import _paged_chunk_runner

    config = ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2, dtype=dtype)
    params = cast_params(init_params(config, torch.Generator("cuda").manual_seed(0)), dtype)
    kw = dict(batch=3, prompt_len=5, page_size=4, chunk=4, n_hi=3, device=cuda)
    graphed = _paged_chunk_runner(params, config, **kw)(3)
    eager = _paged_chunk_runner(params, config, **kw, graph=False)(3)
    assert graphed.shape == (3, 12)
    assert torch.equal(graphed, eager)


# ---- the busy probe's bursts and the step's aot_compile -----------------


def test_aot_compile_on_the_card_launches_nothing_and_keeps_the_state(cuda, monkeypatch):
    """aot_compile touches no device: the profiler sees no device event,
    no wrapper counts a launch, and the state stays bit for bit; its run
    then takes the step through K2-K4."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(tmodel, "flash_min_seq", lambda: 1)
    config = ModelConfig(max_seq_len=65, n_layers=2, attention_impl="flash")
    (params, state), opt = ttrain.make_train_state(config, device="cuda")
    step = ttrain.make_train_step(config, opt)
    tokens = ttrain.synthetic_batch(config, 2, device="cuda")
    def leaves():
        return [t for t in ttrain.tree_leaves(params) + ttrain.tree_leaves(state)
                if isinstance(t, torch.Tensor)]

    before = [t.clone() for t in leaves()]
    counts = [fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches,
              pa.paged_attention.launches]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        run = step.aot_compile(params, state, tokens)
        torch.cuda.synchronize()
    assert sum(e.self_device_time_total for e in prof.key_averages()) == 0
    assert [fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches,
            pa.paged_attention.launches] == counts
    assert all(torch.equal(a, b) for a, b in zip(leaves(), before))
    assert state["count"] == 0
    _, _, loss = run(params, state, tokens)
    assert torch.isfinite(loss)
    assert fa.flash_fwd.launches == counts[0] + config.n_layers


def test_serve_burst_on_the_card_launches_k1(cuda):
    """The busy probe's serving burst runs the engine's decode through
    K1: building it (the warm request and the calibration) and each
    burst launch the kernel, n_layers a decode step."""
    from workloads_torch import busy_probe

    before = pa.paged_attention.launches
    burst, tokens = busy_probe.make_serve_burst_fn(0.1, device="cuda")
    built = pa.paged_attention.launches
    assert built > before
    burst()
    assert pa.paged_attention.launches > built
    assert tokens > 0 and tokens % 32 == 0
