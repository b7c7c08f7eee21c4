"""The port's paged KV cache (workloads_torch.paged) and paged attention
(workloads_torch.ops.paged_attention), torch only on the CPU: paged
decode equals the contiguous cache, per-row positions equal lockstep,
ragged and chunked prefill, padding never writes another sequence's
pages, the length-0 row, page accounting and exhaustion, and the kernel
wrapper's refusals."""

import numpy as np
import pytest
import torch

from workloads_torch.generate import decode_step, init_kv_cache
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.ops import _build
from workloads_torch.ops import paged_attention as pa
from workloads_torch.paged import (
    PagePool,
    init_page_pools,
    paged_decode_chunk,
    paged_decode_step,
    paged_prefill,
    paged_prefill_chunk,
    table_array,
)

CONFIG = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
# float32 throughout: the paged and contiguous routes compute the same
# function and differ only in summation order.
ATOL = 2e-4


@pytest.fixture(scope="module")
def params():
    return init_params(CONFIG, torch.Generator().manual_seed(0))


def _tokens(shape, seed, vocab=256):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, shape))


def _lockstep_reference(params, config, tokens):
    """Contiguous-cache logits for a [batch, steps] token stream."""
    batch, steps = tokens.shape
    cache = init_kv_cache(config, batch, steps, device="cpu")
    out = []
    for pos in range(steps):
        logits, cache = decode_step(params, cache, tokens[:, pos], pos, config)
        out.append(logits)
    return out


@pytest.mark.parametrize(
    "config",
    [
        CONFIG,
        ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2, dtype=torch.float32),
        ModelConfig(max_seq_len=64, n_layers=2, attention_window=5,
                    dtype=torch.float32),
    ],
    ids=["mha", "gqa", "window"],
)
def test_paged_decode_matches_contiguous(config):
    """Token-by-token logits through the paged pools equal the contiguous
    cache, with tables grown on demand."""
    params = init_params(config, torch.Generator().manual_seed(0))
    batch, steps, page_size = 2, 12, 4
    tokens = _tokens((batch, steps), 1)
    ctrl = PagePool(n_pages=16, page_size=page_size)
    for b in range(batch):
        ctrl.allocate(b, 1)
    pools = init_page_pools(config, 16, page_size, device="cpu")
    want = _lockstep_reference(params, config, tokens)
    max_pages = ctrl.pages_needed(steps)
    for pos in range(steps):
        for b in range(batch):
            ctrl.extend(b, pos + 1)
        tables = table_array([ctrl.tables[b] for b in range(batch)], max_pages, device="cpu")
        got, pools = paged_decode_step(params, pools, tables, tokens[:, pos], pos, config)
        np.testing.assert_allclose(got.numpy(), want[pos].numpy(), atol=ATOL,
                                   err_msg=f"position {pos}")


def test_per_row_positions_match_lockstep(params):
    """Rows at different depths decode in one call with the logits each
    gets from its own lockstep run."""
    page_size, depths, steps = 4, [3, 9], 4
    tokens = _tokens((2, 16), 5)
    want = {}
    for r, d in enumerate(depths):
        for pos, lg in enumerate(_lockstep_reference(params, CONFIG,
                                                     tokens[r:r + 1, :d + steps])):
            want[(r, pos)] = lg
    ctrl = PagePool(n_pages=32, page_size=page_size)
    pools = init_page_pools(CONFIG, 32, page_size, device="cpu")
    for r, d in enumerate(depths):
        ctrl.allocate(r, d + steps)
    tables = table_array([ctrl.tables[0], ctrl.tables[1]],
                         ctrl.pages_needed(max(depths) + steps), device="cpu")
    for r, d in enumerate(depths):
        for pos in range(d):
            _, pools = paged_decode_step(params, pools, tables[r:r + 1],
                                         tokens[r:r + 1, pos], pos, CONFIG)
    positions = torch.tensor(depths)
    for _ in range(steps):
        tok = tokens[torch.arange(2), positions]
        logits, pools = paged_decode_step(params, pools, tables, tok, positions, CONFIG)
        for r in range(2):
            np.testing.assert_allclose(
                logits[r:r + 1].numpy(), want[(r, int(positions[r]))].numpy(),
                atol=ATOL, err_msg=f"row {r} position {int(positions[r])}",
            )
        positions = positions + 1


def test_decode_chunk_matches_steps_and_freezes_parked_rows(params):
    """A chunk equals the same greedy steps one by one; a parked row
    (occupancy False, all-trash table) keeps its position and token."""
    ctrl = PagePool(n_pages=16, page_size=4)
    pools = init_page_pools(CONFIG, 16, 4, device="cpu")
    ctrl.allocate("a", 12)
    tables = table_array([ctrl.tables["a"], []], 3, fill=ctrl.trash, device="cpu")
    prompt = _tokens((1, 5), 9)
    for pos in range(5):
        logits, pools = paged_decode_step(params, pools, tables[:1],
                                          prompt[:, pos], pos, CONFIG)
    first = torch.argmax(logits, -1)
    before = (pools[0].clone(), pools[1].clone())
    toks, pools = paged_decode_chunk(
        params, pools, tables, torch.tensor([int(first), 7]), torch.tensor([5, 0]),
        torch.tensor([True, False]), None, 0.0, 0, 1.0, CONFIG, 4, False,
    )
    # Replay the occupied row alone, step by step, on a copy of its state.
    pools2 = before
    tok = first
    want = []
    for pos in range(5, 9):
        lg, pools2 = paged_decode_step(params, pools2, tables[:1], tok, pos, CONFIG)
        tok = torch.argmax(lg, -1)
        want.append(int(tok))
    assert toks[0].tolist() == want
    # The parked row wrote only the trash page (index 16): every real
    # page holds what the occupied row alone writes.
    for got, want in zip(pools, pools2):
        np.testing.assert_allclose(got[:, :16].numpy(), want[:, :16].numpy(), atol=1e-6)


def test_ragged_prefill_matches_contiguous(params):
    """One prefill handles rows of different true lengths; decode
    continues per row from it."""
    page_size, bucket, lengths = 4, 12, [5, 12, 1]
    prompts = torch.zeros((3, bucket), dtype=torch.long)
    for r, n in enumerate(lengths):
        prompts[r, :n] = _tokens((n,), 10 + r)
    ctrl = PagePool(n_pages=32, page_size=page_size)
    pools = init_page_pools(CONFIG, 32, page_size, device="cpu")
    for r, n in enumerate(lengths):
        ctrl.allocate(r, n)
    tables = table_array([ctrl.tables[r] for r in range(3)],
                         ctrl.pages_needed(bucket), fill=ctrl.trash, device="cpu")
    logits, pools = paged_prefill(params, pools, tables, prompts,
                                  torch.tensor(lengths, dtype=torch.int32), CONFIG)
    for r, n in enumerate(lengths):
        want = _lockstep_reference(params, CONFIG, prompts[r:r + 1, :n])[-1]
        np.testing.assert_allclose(logits[r].numpy(), want[0].numpy(), atol=ATOL,
                                   err_msg=f"row {r} (true length {n})")
    tok = torch.argmax(logits, -1)
    for r, n in enumerate(lengths):
        ctrl.extend(r, n + 1)
    tables = table_array([ctrl.tables[r] for r in range(3)],
                         ctrl.pages_needed(bucket + 1), fill=ctrl.trash, device="cpu")
    step_logits, pools = paged_decode_step(params, pools, tables, tok,
                                           torch.tensor(lengths), CONFIG)
    for r, n in enumerate(lengths):
        seq = torch.cat([prompts[r, :n], tok[r:r + 1]])[None]
        want = _lockstep_reference(params, CONFIG, seq)[-1]
        np.testing.assert_allclose(step_logits[r].numpy(), want[0].numpy(), atol=ATOL)


def test_chunked_prefill_matches_single_prefill(params):
    """A ragged multi-row sweep in page-aligned chunks gives each row the
    logits (where its prompt ends) and the pages of a one-shot prefill."""
    ps, lengths = 4, [5, 19, 8]
    C, n_chunks = 8, 3
    prompts = torch.zeros((3, C * n_chunks), dtype=torch.long)
    for r, n in enumerate(lengths):
        prompts[r, :n] = _tokens((n,), 20 + r)
    lens = torch.tensor(lengths, dtype=torch.int32)

    def run(chunked):
        ctrl = PagePool(n_pages=24, page_size=ps)
        pools = init_page_pools(CONFIG, 24, ps, device="cpu")
        for r, n in enumerate(lengths):
            ctrl.allocate(r, n)
        tables = table_array([ctrl.tables[r] for r in range(3)],
                             C * n_chunks // ps, fill=ctrl.trash, device="cpu")
        if not chunked:
            logits, pools = paged_prefill(params, pools, tables, prompts, lens, CONFIG)
        else:
            logits = torch.zeros(3, CONFIG.vocab_size)
            for ci in range(n_chunks):
                lg, pools = paged_prefill_chunk(
                    params, pools, tables, prompts[:, ci * C:(ci + 1) * C], lens,
                    CONFIG, start_page=ci * C // ps, cover_pages=(ci + 1) * C // ps,
                    emit=True,
                )
                here = (lens > ci * C) & (lens <= (ci + 1) * C)
                logits = torch.where(here[:, None], lg, logits)
        real = [p for r in range(3) for p in ctrl.tables[r]]
        return logits, pools[0][:, real], pools[1][:, real]

    for got, want in zip(run(True), run(False)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_prefill_chunk_validates_geometry(params):
    pools = init_page_pools(CONFIG, 8, 4, device="cpu")
    tables = torch.zeros((1, 4), dtype=torch.int32)
    lens = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of page_size"):
        paged_prefill_chunk(params, pools, tables, torch.zeros((1, 6), dtype=torch.long),
                            lens, CONFIG, start_page=0, cover_pages=2, emit=True)
    with pytest.raises(ValueError, match="cover_pages"):
        paged_prefill_chunk(params, pools, tables, torch.zeros((1, 8), dtype=torch.long),
                            lens, CONFIG, start_page=0, cover_pages=3, emit=True)


@pytest.mark.parametrize("row_start", [None, 1])
def test_prefill_padding_never_writes_other_pages(params, row_start):
    """Padding columns (here the dangerous default 0, the victim's page)
    and, with ``row_start``, columns before the row's own start are
    redirected to the trash page: the victim keeps its bytes."""
    ctrl = PagePool(n_pages=16, page_size=4)
    k, v = init_page_pools(CONFIG, 16, 4, device="cpu")
    victim = ctrl.allocate("victim", 4)
    assert victim == [0]
    k[:, 0] = 7.25
    v[:, 0] = -3.5
    ctrl.allocate("row", 6)
    if row_start is None:
        # True length 2 (1 real page), bucket 8: column 1 pads with 0.
        tables = table_array([ctrl.tables["row"][:1]], 2, device="cpu")
        lens, start = torch.tensor([2], dtype=torch.int32), None
    else:
        # The row's first column is the victim's page, marked as already
        # written (a shared prefix page): reads use it, writes skip it.
        tables = table_array([[0, ctrl.tables["row"][0]]], 2, device="cpu")
        lens, start = torch.tensor([6], dtype=torch.int32), torch.tensor([row_start])
    prompts = torch.zeros((1, 8), dtype=torch.long)
    prompts[0, :2] = torch.tensor([5, 6])
    _, (k, v) = paged_prefill_chunk(params, (k, v), tables, prompts, lens, CONFIG,
                                    start_page=0, cover_pages=2, emit=True,
                                    row_start=start)
    assert torch.all(k[:, 0] == 7.25) and torch.all(v[:, 0] == -3.5)


def _attention_inputs(dtype=torch.float32, kv_heads=2, heads=4, hd=16, ps=4):
    rng = np.random.default_rng(3)
    shape = (2, 12, kv_heads, ps, hd)
    kp = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    vp = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    q = torch.from_numpy(rng.standard_normal((3, heads, hd)).astype(np.float32)).to(dtype)
    tables = torch.from_numpy(rng.permutation(12)[:9].reshape(3, 3).astype(np.int32))
    return q, kp, vp, tables


def test_length_zero_row_is_safe():
    """A length-0 row (an empty serve slot) gives zeros, and live rows
    are unaffected by it."""
    q, kp, vp, tables = _attention_inputs()
    lengths = torch.tensor([0, 6, 12], dtype=torch.int32)
    out = pa.paged_attention(q, kp, vp, tables, lengths, layer=1)
    assert torch.isfinite(out).all()
    assert torch.all(out[0] == 0)
    alone = pa.paged_attention(q[1:], kp, vp, tables[1:], lengths[1:], layer=1)
    np.testing.assert_allclose(out[1:].numpy(), alone.numpy(), atol=1e-6)


def test_paged_attention_matches_dense_masked_softmax():
    """The plain version against a direct softmax over each row's visible
    positions (GQA and window included)."""
    q, kp, vp, tables = _attention_inputs()
    lengths = torch.tensor([1, 7, 12], dtype=torch.int32)
    for window in (None, 5):
        out = pa.paged_attention(q, kp, vp, tables, lengths, layer=1, window=window)
        for b in range(3):
            n = int(lengths[b])
            lo = max(n - window, 0) if window else 0
            k = kp[1][tables[b]].permute(0, 2, 1, 3).reshape(-1, 2, 16)[lo:n]
            v = vp[1][tables[b]].permute(0, 2, 1, 3).reshape(-1, 2, 16)[lo:n]
            for h in range(4):
                s = (k[:, h // 2] @ q[b, h]) / 4.0
                want = torch.softmax(s, 0) @ v[:, h // 2]
                np.testing.assert_allclose(out[b, h].numpy(), want.numpy(), atol=1e-5)


def test_paged_attention_validates_and_counts_no_cpu_launch():
    q, kp, vp, tables = _attention_inputs()
    lengths = torch.tensor([1, 7, 12], dtype=torch.int32)
    before = pa.paged_attention.launches
    pa.paged_attention(q, kp, vp, tables, lengths)
    assert pa.paged_attention.launches == before  # the CPU runs the plain version
    with pytest.raises(ValueError, match="head_dim mismatch"):
        pa.paged_attention(q[..., :8], kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="disagree"):
        pa.paged_attention(q, kp, vp[:1], tables, lengths)
    with pytest.raises(ValueError, match="out of range"):
        pa.paged_attention(q, kp, vp, tables, lengths, layer=2)
    with pytest.raises(ValueError, match="do not match batch"):
        pa.paged_attention(q, kp, vp, tables[:2], lengths)
    with pytest.raises(ValueError, match="window"):
        pa.paged_attention(q, kp, vp, tables, lengths, window=0)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        pa.paged_attention(q[:, :3], kp, vp, tables, lengths)


@pytest.mark.parametrize(
    "change, match",
    [
        (dict(hd=48), "head_dim in"),
        (dict(heads=18, kv_heads=2), "at most 8"),
        (dict(dtype=torch.float16), "float32 or bfloat16"),
    ],
    ids=["head_dim", "group", "dtype"],
)
def test_kernel_refuses_shapes_it_does_not_take(change, match):
    """The wrapper's checks for the CUDA kernel raise ValueError (the
    kernel is never swapped for the plain version on a CUDA tensor)."""
    args = dict(dtype=torch.float32, kv_heads=2, heads=4, hd=16, ps=4)
    args.update(change)
    q, kp, vp, tables = _attention_inputs(**args)
    lengths = torch.tensor([1, 7, 12], dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        pa._check_kernel_inputs(q, kp, vp, tables, lengths)


def test_kernel_refuses_non_contiguous_and_wrong_index_types():
    q, kp, vp, tables = _attention_inputs()
    lengths = torch.tensor([1, 7, 12], dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        pa._check_kernel_inputs(q.transpose(0, 1).contiguous().transpose(0, 1),
                                kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="int32"):
        pa._check_kernel_inputs(q, kp, vp, tables.long(), lengths)
    pa._check_kernel_inputs(q, kp, vp, tables, lengths)  # the good case passes


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises a clear error (it never substitutes
    anything); the library name follows the source's hash."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("paged_attention")
    name = _build.library_path("paged_attention").name
    assert name.startswith("libpaged_attention-") and name.endswith(".so")
    assert _build.library_path("paged_attention") == _build.library_path("paged_attention")


def test_on_demand_allocation_and_recycling():
    ctrl = PagePool(n_pages=100, page_size=4)
    ctrl.allocate("a", 6)
    assert ctrl.used_pages == 2
    ctrl.extend("a", 9)
    assert ctrl.used_pages == 3
    ctrl.release("a")
    assert ctrl.used_pages == 0 and ctrl.peak_used == 3


def test_prefix_fork_shares_full_pages():
    ctrl = PagePool(n_pages=100, page_size=4)
    parent = ctrl.allocate("parent", 10)
    child = ctrl.fork("parent", "child", shared_tokens=8)
    assert child == parent[:2] and ctrl.used_pages == 3
    ctrl.extend("child", 12)
    assert ctrl.used_pages == 4
    ctrl.release("parent")
    assert ctrl.used_pages == 3
    ctrl.release("child")
    assert ctrl.used_pages == 0
    with pytest.raises(ValueError, match="page boundary"):
        ctrl.allocate("p", 10)
        ctrl.fork("p", "c", shared_tokens=10)


def test_adopt_and_retain_refcount_pages():
    ctrl = PagePool(n_pages=8, page_size=4)
    page = ctrl.take_page()
    ctrl.retain_page(page)
    ctrl.adopt("s", [page])
    ctrl.release("s")
    ctrl.release_page(page)
    assert ctrl.used_pages == 1
    ctrl.release_page(page)
    assert ctrl.used_pages == 0
    with pytest.raises(ValueError, match="not allocated"):
        ctrl.retain_page(page)
    with pytest.raises(ValueError, match="not allocated"):
        ctrl.adopt("t", [page])


def test_pool_exhaustion_and_double_allocate_fail_loud():
    ctrl = PagePool(n_pages=2, page_size=4)
    ctrl.allocate("a", 8)
    with pytest.raises(RuntimeError, match="exhausted"):
        ctrl.allocate("b", 4)
    with pytest.raises(RuntimeError, match="exhausted"):
        ctrl.extend("a", 9)
    with pytest.raises(ValueError, match="already holds"):
        ctrl.allocate("a", 4)
    ctrl.release("a")
    ctrl.allocate("a", 4)  # fine after release
    with pytest.raises(ValueError, match="exceeds"):
        table_array([[0, 1, 2]], 2, device="cpu")
