"""The paged-decode kernel's split over pages, on the CPU: its plain
specification (per-share float32 (m, l, acc), each share starting from
the max of the scores before it, merged in split order) against the
sequential plain version, with the arithmetic before that start (each
share from -1e30) as the control that must miss the bounds, and the
host's choice of the split count.  torch and numpy only."""

import numpy as np
import pytest
import torch

from workloads_torch.ops import paged_attention as pa

# As chip_smoke.py's KERNEL_ATOL: one bf16 ulp at magnitude 1 is 2^-8.
KERNEL_ATOL = {torch.bfloat16: 1e-2}
PAGE = 4
LENGTHS = [0, 1, 3, 4, 5, 17, 22, 9]


def _inputs(dtype, heads, kv_heads, hd=16, seed=0, lengths=LENGTHS, page=PAGE, q_dtype=None):
    rng = np.random.default_rng(seed)
    batch = len(lengths)
    max_pages = -(-max(lengths) // page) + 1  # one padding column, the trash page
    n_pages = batch * max_pages + 1
    shape = (2, n_pages, kv_heads, page, hd)
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    q = torch.from_numpy(rng.standard_normal((batch, heads, hd)).astype(np.float32))
    tables = rng.permutation(n_pages - 1)[: batch * max_pages].reshape(batch, max_pages)
    tables[:, -1] = n_pages - 1
    return (q.to(q_dtype or dtype), k, v, torch.from_numpy(tables.astype(np.int32)),
            torch.tensor(lengths, dtype=torch.int32))


def _per_share_max_split(q, k_pages, v_pages, tables, lengths, *, layer, window, splits):
    """The control: the split arithmetic before each share started from
    the max of the scores before it.  Every share starts from -1e30, so a
    later share rounds its p against the max of its own pages only."""
    batch, heads, head_dim = q.shape
    kv_heads, page_size = k_pages.shape[2], k_pages.shape[3]
    group = heads // kv_heads
    out = torch.zeros((batch, heads, head_dim))
    offsets = torch.arange(page_size)
    for b in range(batch):
        length = int(lengths[b])
        first = max(length - window, 0) // page_size if window else 0
        last = min((length - 1) // page_size, tables.shape[1] - 1) if length > 0 else -1
        qg = q[b].reshape(kv_heads, group, head_dim).float()
        parts = []
        for share in pa.split_shares(first, last, splits):
            m = torch.full((kv_heads, group, 1), pa.NEG_INF)
            l = torch.zeros_like(m)
            acc = torch.zeros((kv_heads, group, head_dim))
            for j in share:
                page = int(tables[b, j])
                ids = j * page_size + offsets
                mask = ids < length
                if window is not None:
                    mask &= ids >= length - window
                s = torch.einsum("ngk,ntk->ngt", qg, k_pages[layer, page].float())
                s = torch.where(mask, s / head_dim**0.5, pa.NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.where(mask, torch.exp(s - m_new), 0.0)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + torch.einsum(
                    "ngt,ntk->ngk", p.to(v_pages.dtype).float(), v_pages[layer, page].float())
                m = m_new
            parts.append((m, l, acc))
        m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l_all, acc_all = torch.zeros_like(m_all), torch.zeros_like(parts[0][2])
        for m, l, acc in parts:
            w = torch.exp(m - m_all)
            l_all, acc_all = l_all + l * w, acc_all + acc * w
        out[b] = (acc_all / torch.where(l_all > 0, l_all, 1.0)).reshape(heads, head_dim)
    return out.to(q.dtype)


def _bf16_ulp(a, b):
    """One bf16 ulp at the larger of |a| and |b|, elementwise."""
    larger = torch.maximum(a.float().abs(), b.float().abs())
    return torch.ldexp(torch.ones_like(larger), torch.frexp(larger).exponent - 8)


# The file's rows at page 4 (head_dim 16), and two long rows at page 16
# (head_dim 64), where a later share's own max often sits below the row's.
SPLIT_ROWS = {"short": dict(hd=16), "431-250": dict(hd=64, lengths=[431, 250], page=16)}


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("heads, kv_heads", [(4, 4), (8, 2), (8, 1)],
                         ids=["G1", "G4", "G8"])
@pytest.mark.parametrize("window", [None, 6], ids=["full", "window6"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_specification_matches_sequential_walk(dtype, window, heads, kv_heads, splits):
    """8 splits pass the 6 live pages of the longest row: its last shares
    are empty, as are all of a length-0 row's."""
    q, k, v, tables, lens = _inputs(dtype, heads, kv_heads)
    want = pa.paged_attention_reference(q, k, v, tables, lens, layer=1, window=window)
    got = pa.paged_attention_split_reference(q, k, v, tables, lens, layer=1, window=window,
                                             splits=splits)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.all(got[0] == 0)  # the length-0 row
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        # Only the order of float32 sums differs.
        assert err <= 1e-6 * want.abs().max().item()
    else:
        # p rounds as in the sequential walk; the float32 sums' order can
        # still flip the output's bf16 rounding.
        assert err <= KERNEL_ATOL[dtype]


def test_one_split_is_the_sequential_walk_bit_for_bit():
    q, k, v, tables, lens = _inputs(torch.bfloat16, 8, 2)
    want = pa.paged_attention_reference(q, k, v, tables, lens, layer=0, window=None)
    got = pa.paged_attention_split_reference(q, k, v, tables, lens, layer=0, window=None,
                                             splits=1)
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "first, last, splits, want",
    [
        (0, 8, 1, [range(0, 9)]),
        (0, 8, 2, [range(0, 5), range(5, 9)]),
        (0, 8, 3, [range(0, 3), range(3, 6), range(6, 9)]),
        (2, 4, 2, [range(2, 4), range(4, 5)]),
        (0, 1, 4, [range(0, 1), range(1, 2), range(2, 2), range(3, 2)]),
        (0, -1, 3, [range(0, 0), range(0, 0), range(0, 0)]),
    ],
)
def test_split_shares_cover_the_live_pages_once(first, last, splits, want):
    shares = pa.split_shares(first, last, splits)
    assert [list(s) for s in shares] == [list(w) for w in want]
    assert [j for s in shares for j in s] == list(range(first, last + 1))


@pytest.mark.parametrize(
    "batch, kv_heads, max_pages, sm_count, want",
    [
        (8, 16, 10, 132, 1),     # 128 CTAs on 132 SMs fill the card: no split
        (4, 16, 10, 132, 2),
        (1, 16, 10, 132, 8),     # batch 1: 128 CTAs again
        (1, 2, 64, 132, 64),     # one share a table column at most
        (1, 1, 1024, 132, 132),  # never more CTAs than SMs
        (32, 16, 10, 132, 1),
        (5, 16, 10, 132, 1),     # 80 CTAs pass half the SMs
        (1, 16, 1, 132, 1),      # one column: nothing to split
        (0, 16, 10, 132, 10),    # an empty batch launches nothing anyway
    ],
)
def test_choose_splits_is_a_function_of_shapes(batch, kv_heads, max_pages, sm_count, want):
    assert pa.choose_splits(batch, kv_heads, max_pages, sm_count) == want


@pytest.mark.parametrize("splits", [2, 3, 8])
@pytest.mark.parametrize("rows", list(SPLIT_ROWS))
def test_split_keeps_float32_precision_over_bf16_pools(rows, splits):
    """float32 queries over bf16 pools, so the output keeps float32
    precision: every p rounds to bf16 against the sequential walk's running
    max, and the split spec is within 2^-18 of the largest |output| of the
    one-split version.  Starting each share from -1e30 misses that bound."""
    q, k, v, tables, lens = _inputs(torch.bfloat16, 8, 2, seed=1, q_dtype=torch.float32,
                                    **SPLIT_ROWS[rows])
    want = pa.paged_attention_reference(q, k, v, tables, lens, layer=1, window=None)
    got = pa.paged_attention_split_reference(q, k, v, tables, lens, layer=1, window=None,
                                             splits=splits)
    control = _per_share_max_split(q, k, v, tables, lens, layer=1, window=None, splits=splits)
    assert got.dtype == torch.float32
    bound = 2.0**-18 * want.abs().max().item()
    assert (got - want).abs().max().item() <= bound
    assert (control - want).abs().max().item() > bound


@pytest.mark.parametrize("splits", [2, 3, 8])
@pytest.mark.parametrize("rows", list(SPLIT_ROWS))
def test_split_is_within_one_bf16_ulp_of_one_split(rows, splits):
    """All bf16: every output element of the split spec within one bf16
    ulp of the one-split version; the control breaks that bound."""
    q, k, v, tables, lens = _inputs(torch.bfloat16, 8, 2, seed=1, **SPLIT_ROWS[rows])
    want = pa.paged_attention_reference(q, k, v, tables, lens, layer=1, window=None)
    got = pa.paged_attention_split_reference(q, k, v, tables, lens, layer=1, window=None,
                                             splits=splits)
    control = _per_share_max_split(q, k, v, tables, lens, layer=1, window=None, splits=splits)
    assert got.dtype == torch.bfloat16
    assert torch.all((got.float() - want.float()).abs() <= _bf16_ulp(got, want))
    assert torch.any((control.float() - want.float()).abs() > _bf16_ulp(control, want))


@pytest.mark.parametrize("batch, kv_heads", [(2, 16), (1, 16), (4, 2)])
def test_bf16_pools_split_as_float32_pools(batch, kv_heads):
    """One rule for both dtypes: where the shapes leave SMs idle, bf16 pools
    split as float32 pools do."""
    assert pa.choose_splits(batch, kv_heads, 10, 132) > 1


def test_cpu_wrapper_ignores_the_split_count():
    q, k, v, tables, lens = _inputs(torch.float32, 4, 4)
    want = pa.paged_attention(q, k, v, tables, lens, layer=1)
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, k, v, tables, lens, layer=1, splits=3)
    assert torch.equal(got, want) and pa.paged_attention.launches == before


def test_wrapper_refuses_a_tile_that_is_no_multiple_of_16_bytes():
    """A 1-position page of head_dim 4 in bf16 is 8 bytes: refused before
    any library is loaded."""
    q = torch.zeros((1, 1, 4), dtype=torch.bfloat16)
    pool = torch.zeros((1, 2, 1, 1, 4), dtype=torch.bfloat16)
    tables = torch.zeros((1, 1), dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of\n? *16"):
        pa._check_kernel_inputs(q, pool, pool, tables, lens)
