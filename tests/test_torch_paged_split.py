"""The paged-decode kernel's split over pages, on the CPU: its plain
specification (per-share float32 (m, l, acc), merged in split order)
against the sequential plain version, and the host's choice of the split
count.  torch and numpy only."""

import numpy as np
import pytest
import torch

from workloads_torch.ops import paged_attention as pa

# As chip_smoke.py's KERNEL_ATOL: one bf16 ulp at magnitude 1 is 2^-8.
KERNEL_ATOL = {torch.bfloat16: 1e-2}
PAGE = 4
LENGTHS = [0, 1, 3, 4, 5, 17, 22, 9]


def _inputs(dtype, heads, kv_heads, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = len(LENGTHS)
    max_pages = -(-max(LENGTHS) // PAGE) + 1  # one padding column, the trash page
    n_pages = batch * max_pages + 1
    shape = (2, n_pages, kv_heads, PAGE, hd)
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    q = torch.from_numpy(rng.standard_normal((batch, heads, hd)).astype(np.float32)).to(dtype)
    tables = rng.permutation(n_pages - 1)[: batch * max_pages].reshape(batch, max_pages)
    tables[:, -1] = n_pages - 1
    return (q, k, v, torch.from_numpy(tables.astype(np.int32)),
            torch.tensor(LENGTHS, dtype=torch.int32))


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
        # Each share rounds p against its own running max.
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


@pytest.mark.parametrize("batch, kv_heads", [(2, 16), (1, 16), (4, 2)])
def test_bf16_pools_keep_one_split(batch, kv_heads):
    """bf16 split shares round p against their own max, which puts a bf16
    decode step outside its floor on the card: bf16 keeps one split where
    float32 takes several."""
    assert pa.choose_splits(batch, kv_heads, 10, 132) > 1
    assert pa.choose_splits(batch, kv_heads, 10, 132, torch.bfloat16) == 1
    assert pa.choose_splits(batch, kv_heads, 10, 132, torch.float32) > 1


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
