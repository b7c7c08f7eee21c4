"""Card-only tests of the port: the CUDA kernels (paged attention K1,
flash attention K2-K4) against their plain PyTorch versions, their
launch counts and refusals, the engine on the card against generate()
and against the CPU engine in its scheduling modes, the decode step's
CUDA graph against the eager loop, the engine's uploads against its
host mirrors, K1's split route in a bf16 decode step, the training
step's kernel launches, and the request lifecycle on the card (a
quarantine mid-superstep, uploads after a quarantine or a cancel,
dropped readbacks, a fault inside the graph's capture, retune).  They
skip without a CUDA device.
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
