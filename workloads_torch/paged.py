"""Paged KV cache for serving, ported from ``workloads/paged.py``.

The cache is a POOL of fixed-size pages plus a per-sequence page table.
Page allocation is host-side Python (``PagePool``); the device side is
two tensors (k, v), each ``[layers, n_pages + 1, kv_heads, page_size,
head_dim]`` with the head axis inside the page, so one (page, kv head)
tile is contiguous.  The extra LAST page is the TRASH page: table
padding and parked rows point at it, so writes from padded prompt
positions or empty batch slots land somewhere harmless.

Where the JAX package returns new pools from jitted functions that
donate the old ones, the port updates the pools IN PLACE and returns the
same tensors.  Decode runs the paged-attention kernel
(``ops.paged_attention``) over each row's live pages; prefill gathers a
dense view of the prompt's pages, runs ``generate.decode_block`` over it
and scatters the pages back.

JAX clamps out-of-range gather indices; torch raises (CPU) or faults
(CUDA).  Every index the JAX code relied on clamping is made explicitly
in range here: the decode write column and the emitted-logits row.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from . import resolve_device
from .generate import decode_block, sample_logits
from .model import (
    ModelConfig,
    _mlp,
    _rmsnorm,
    project_qkv,
    rope_angles,
    weight,
)
from .ops.paged_attention import paged_attention


@dataclass
class PagePool:
    """Host-side control plane: which physical pages are free, and each
    sequence's page table.  Hands out indices 0 .. n_pages-1; the device
    pools' extra trash page at index ``n_pages`` is never allocated."""

    n_pages: int
    page_size: int
    free: list = field(init=False)
    tables: dict = field(init=False, default_factory=dict)  # seq_id -> [int]
    refcounts: dict = field(init=False, default_factory=dict)  # page -> int
    # High-water mark of concurrently held pages.
    peak_used: int = field(init=False, default=0)

    def __post_init__(self):
        self.free = list(range(self.n_pages - 1, -1, -1))

    @property
    def trash(self) -> int:
        """The sacrificial page index in the device pools (which hold
        n_pages + 1 pages): table padding should point here."""
        return self.n_pages

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def allocate(self, seq_id, n_tokens: int) -> list:
        """A fresh table covering ``n_tokens`` positions."""
        if seq_id in self.tables:
            raise ValueError(
                f"sequence {seq_id!r} already holds a table — release it "
                "first (silently replacing it would leak its pages)"
            )
        need = self.pages_needed(n_tokens)
        if len(self.free) < need:
            raise RuntimeError(
                f"page pool exhausted: need {need}, free {len(self.free)}"
            )
        table = [self.free.pop() for _ in range(need)]
        for p in table:
            self.refcounts[p] = 1
        self.tables[seq_id] = table
        self.peak_used = max(self.peak_used, self.used_pages)
        return table

    def extend(self, seq_id, n_tokens: int) -> list:
        """Grow ``seq_id``'s table to cover ``n_tokens`` positions."""
        table = self.tables[seq_id]
        while len(table) < self.pages_needed(n_tokens):
            if not self.free:
                raise RuntimeError("page pool exhausted")
            page = self.free.pop()
            self.refcounts[page] = 1
            table.append(page)
        self.peak_used = max(self.peak_used, self.used_pages)
        return table

    def fork(self, parent_id, child_id, shared_tokens: int) -> list:
        """A child sequence sharing the parent's full pages for the prefix
        of ``shared_tokens`` positions (read-only sharing); the fork point
        must be a page boundary."""
        if child_id in self.tables:
            raise ValueError(
                f"sequence {child_id!r} already holds a table — release it "
                "first (silently replacing it would leak its pages)"
            )
        if shared_tokens % self.page_size:
            raise ValueError(
                f"fork point {shared_tokens} is not a multiple of "
                f"page_size {self.page_size}: a partial tail page cannot "
                "be shared — fork at a page boundary (and replay the "
                "remainder into the child)"
            )
        shared = self.tables[parent_id][: shared_tokens // self.page_size]
        for p in shared:
            self.refcounts[p] += 1
        self.tables[child_id] = list(shared)
        return self.tables[child_id]

    def release(self, seq_id) -> None:
        for p in self.tables.pop(seq_id):
            self._unref(p)

    def take_page(self) -> int:
        """Claim one free page with no table attached (refcount 1, owned
        by the caller).  Pair with release_page."""
        if not self.free:
            raise RuntimeError("page pool exhausted: no free page to take")
        page = self.free.pop()
        self.refcounts[page] = 1
        self.peak_used = max(self.peak_used, self.used_pages)
        return page

    def retain_page(self, page: int) -> None:
        """Pin one allocated page independently of any table.  Pair with
        release_page."""
        if page not in self.refcounts:
            raise ValueError(f"page {page} is not allocated")
        self.refcounts[page] += 1

    def release_page(self, page: int) -> None:
        self._unref(page)

    def _unref(self, page: int) -> None:
        self.refcounts[page] -= 1
        if self.refcounts[page] == 0:
            del self.refcounts[page]
            self.free.append(page)

    def adopt(self, seq_id, pages: list) -> list:
        """A fresh table referencing already-allocated pages (read-only
        sharing from an explicit page list)."""
        if seq_id in self.tables:
            raise ValueError(
                f"sequence {seq_id!r} already holds a table — release it "
                "first (silently replacing it would leak its pages)"
            )
        for p in pages:
            if p not in self.refcounts:
                raise ValueError(f"page {p} is not allocated")
        for p in pages:
            self.refcounts[p] += 1
        self.tables[seq_id] = list(pages)
        return self.tables[seq_id]

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self.free)


def init_page_pools(
    config: ModelConfig, n_pages: int, page_size: int, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The device-side (k, v) pools, each [layers, n_pages + 1, kv_heads,
    page_size, head_dim]; the last page is the trash page.  ``device``
    None means ``cuda`` (``resolve_device``)."""
    device = resolve_device(device)
    shape = (
        config.n_layers, n_pages + 1, config.kv_heads, page_size,
        config.head_dim,
    )
    return (
        torch.zeros(shape, dtype=config.dtype, device=device),
        torch.zeros(shape, dtype=config.dtype, device=device),
    )


def table_array(
    tables: list[list[int]], max_pages: int, fill: int = 0, device=None
) -> torch.Tensor:
    """Stack host tables into a padded [batch, max_pages] int32 tensor on
    ``device`` (None means ``cuda``, ``resolve_device``).  ``fill`` pads
    short tables; rows PARKED with positions outside their table must
    fill with the pool's trash index."""
    out = []
    for t in tables:
        if len(t) > max_pages:
            raise ValueError(f"table length {len(t)} exceeds {max_pages}")
        out.append(list(t) + [fill] * (max_pages - len(t)))
    return torch.tensor(out, dtype=torch.int32, device=resolve_device(device))


def _page_index(page, device) -> torch.Tensor:
    """A page id (int or 0-d tensor) as a [1] int64 index on ``device``;
    a device tensor stays on the device (no host read)."""
    return torch.as_tensor(page, device=device).long().reshape(1)


def read_page(pools: tuple[torch.Tensor, torch.Tensor], src):
    """Copy ONE physical page (all layers, k and v) out of the pools:
    (k [L, Hkv, ps, hd], v [L, Hkv, ps, hd]), new tensors that later pool
    writes do not change."""
    idx = _page_index(src, pools[0].device)
    return tuple(pool.index_select(1, idx)[:, 0] for pool in pools)


def read_pages(pools: tuple[torch.Tensor, torch.Tensor], srcs):
    """Copy N physical pages out of the pools in one gather per pool:
    (k [L, n, Hkv, ps, hd], v [L, n, Hkv, ps, hd]); column ``i`` holds
    exactly ``read_page(srcs[i])``'s bytes."""
    idx = torch.as_tensor(srcs, device=pools[0].device).long().reshape(-1)
    return tuple(pool.index_select(1, idx) for pool in pools)


def write_page(
    pools: tuple[torch.Tensor, torch.Tensor], k_page, v_page, dst
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one page's k/v ([L, Hkv, ps, hd] each) into the pools at
    physical page ``dst``, IN PLACE; returns the same pool tensors (a
    captured CUDA graph holds their addresses, so they are never
    rebound).  ``read_page`` -> ``write_page`` round-trips bit-exactly."""
    idx = _page_index(dst, pools[0].device)
    for pool, page in zip(pools, (k_page, v_page)):
        pool.index_copy_(1, idx, page.to(pool.device, pool.dtype)[:, None])
    return pools


def copy_page(
    pools: tuple[torch.Tensor, torch.Tensor], src, dst
) -> tuple[torch.Tensor, torch.Tensor]:
    """Duplicate one physical page (all layers, k and v) onto ``dst``, IN
    PLACE; returns the same pool tensors."""
    device = pools[0].device
    src_idx, dst_idx = _page_index(src, device), _page_index(dst, device)
    for pool in pools:
        pool.index_copy_(1, dst_idx, pool.index_select(1, src_idx))
    return pools


def _rope_rows(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate x [batch, s, heads, head_dim] by per-row angles
    [batch, head_dim//2] (one position per row) or [batch, s,
    head_dim//2]."""
    half = x.shape[-1] // 2
    if angles.ndim == 2:
        angles = angles[:, None, :]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _write_slots(
    pool: torch.Tensor, layer: int, page: torch.Tensor, slot: torch.Tensor,
    new: torch.Tensor,
) -> None:
    """pool[layer, page[b], :, slot[b]] = new[b] for every row, as one
    in-place index_put_.  Parked rows all write the trash page's slot 0;
    which of those duplicate writes lands is unspecified, and only trash
    bytes depend on it."""
    pool[layer, page, :, slot] = new.to(pool.dtype)


def _decode_core(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    token: torch.Tensor,
    positions: torch.Tensor,
    config: ModelConfig,
    attention_fn=None,
):
    """One token per row through the paged cache: write the new k/v into
    each row's current page slot, then run paged attention over the
    row's live pages.  positions: [batch], each row's own position.
    ``attention_fn(q, k_pages, v_pages, tables, lengths, layer)``
    replaces the attention op (as in the JAX package), e.g. to hold the
    kernel against its plain version inside a whole step.  Returns
    (logits [batch, vocab], pools updated in place)."""
    k_pages, v_pages = pools
    batch = token.shape[0]
    page_size = k_pages.shape[3]
    positions = positions.long()
    row = torch.arange(batch, device=token.device)
    # jax clamps this gather column; say so explicitly.
    col = (positions // page_size).clamp(max=tables.shape[1] - 1)
    page = tables[row, col].long()
    slot = positions % page_size
    lengths = (positions + 1).to(torch.int32)
    angles = rope_angles(positions, config.head_dim)  # [batch, half]

    x = params["embed"].to(config.dtype)[token.long()][:, None]  # [b, 1, d]
    for i, layer in enumerate(params["layers"]):
        h = _rmsnorm(x, layer["ln1"])
        q, k, v = project_qkv(h, layer)  # [b, 1, H|Hkv, hd]
        q, k = _rope_rows(q, angles), _rope_rows(k, angles)
        _write_slots(k_pages, i, page, slot, k[:, 0])
        _write_slots(v_pages, i, page, slot, v[:, 0])
        if attention_fn is None:
            attn = paged_attention(
                q[:, 0].contiguous(), k_pages, v_pages, tables, lengths,
                layer=i, window=config.attention_window,
            )
        else:
            attn = attention_fn(q[:, 0].contiguous(), k_pages, v_pages, tables, lengths, i)
        proj = torch.einsum("bhk,hkd->bd", attn, weight(layer["wo"], x.dtype))
        x = x + proj[:, None]
        x = x + _mlp(_rmsnorm(x, layer["ln2"]), layer)
    logits = x[:, 0].float() @ weight(params["unembed"], torch.float32)
    return logits, (k_pages, v_pages)


@torch.inference_mode()
def paged_decode_step(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    token: torch.Tensor,
    positions,
    config: ModelConfig,
):
    """One token through the paged cache.  tables: [batch, max_pages]
    int32; token: [batch]; positions: an int (lockstep) or [batch]
    (each row at its own depth).  Returns (logits [batch, vocab],
    pools) with the pools updated in place."""
    positions = torch.as_tensor(positions, device=token.device)
    positions = torch.broadcast_to(positions, token.shape)
    return _decode_core(params, pools, tables, token, positions, config)


@torch.inference_mode()
def paged_decode_chunk(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    token: torch.Tensor,
    positions: torch.Tensor,
    occupancy: torch.Tensor,
    generator: torch.Generator | None,
    temperature: float,
    top_k: int,
    top_p: float,
    config: ModelConfig,
    chunk: int,
    sampling: bool,
):
    """``chunk`` decode steps (the JAX package's lax.scan, as a loop).
    token/positions: [batch], each row's current token and position.
    occupancy: [batch] bool; rows marked False are parked — their
    position and token freeze and their all-trash table swallows the
    dead write.  tables must cover positions + chunk for occupied rows.
    Returns (tokens [batch, chunk], pools updated in place)."""
    tok = token.long()
    pos = torch.broadcast_to(
        torch.as_tensor(positions, device=token.device), token.shape
    ).long()
    toks = []
    for _ in range(chunk):
        logits, pools = _decode_core(params, pools, tables, tok, pos, config)
        nxt = sample_logits(
            logits, generator if sampling else None, temperature, top_k, top_p
        )
        pos = torch.where(occupancy, pos + 1, pos)
        tok = torch.where(occupancy, nxt, tok)
        toks.append(nxt)
    return torch.stack(toks, dim=1), pools


def decode_superstep_step(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    tok: torch.Tensor,
    pos: torch.Tensor,
    live: torch.Tensor,
    budget: torch.Tensor,
    eos: torch.Tensor,
    generator: torch.Generator | None,
    temperature: float,
    top_k: int,
    top_p: float,
    config: ModelConfig,
    sampling: bool,
):
    """ONE decode step with device-side retirement, the body of
    ``paged_decode_superstep`` (and the step ``decode_graph`` captures):
    emit a token for every row, advance live rows, then retire a row on
    the step it emits ``eos`` or exhausts its ``budget``; retired and
    parked rows freeze their position and token.  Returns (emitted
    [batch], tok, pos, live, budget); the pools update in place."""
    logits, _ = _decode_core(params, pools, tables, tok, pos, config)
    nxt = sample_logits(
        logits, generator if sampling else None, temperature, top_k, top_p
    )
    pos = torch.where(live, pos + 1, pos)
    tok = torch.where(live, nxt, tok)
    budget = torch.where(live, budget - 1, budget)
    # Retire AFTER the emit: the terminal token is this step's output.
    live = live & (nxt != eos) & (budget > 0)
    return nxt, tok, pos, live, budget


@torch.inference_mode()
def paged_decode_superstep(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    token: torch.Tensor,
    positions: torch.Tensor,
    live: torch.Tensor,
    budget: torch.Tensor,
    eos: torch.Tensor,
    generator: torch.Generator | None,
    temperature: float,
    top_k: int,
    top_p: float,
    config: ModelConfig,
    chunk: int,
    k: int,
    sampling: bool,
):
    """``k`` chained decode chunks (``k * chunk`` steps) with device-side
    retirement, the JAX package's ``paged_decode_superstep`` as a loop.
    live: [batch] bool, False rows (empty slots, rows retired earlier)
    frozen like ``paged_decode_chunk``'s parked rows; budget: [batch]
    remaining tokens; eos: [batch] ids (-1 = none).  Draws come from
    ``generator`` in the order ``k`` chunk calls take them.  tables must
    cover each live row up to its retirement ceiling: a retired row keeps
    writing its frozen position.  Returns (tokens [batch, k*chunk], tok,
    pos, live, budget, pools): the carry after the last step, on the
    device, and the pools updated in place."""
    tok = token.long()
    pos = torch.broadcast_to(
        torch.as_tensor(positions, device=token.device), token.shape
    ).long()
    toks = []
    for _ in range(k * chunk):
        nxt, tok, pos, live, budget = decode_superstep_step(
            params, pools, tables, tok, pos, live, budget, eos, generator,
            temperature, top_k, top_p, config, sampling,
        )
        toks.append(nxt)
    return torch.stack(toks, dim=1), tok, pos, live, budget, pools


def _redirect_padding(
    tables_slice: torch.Tensor, covered_lengths: torch.Tensor, page_size: int,
    trash: int,
) -> torch.Tensor:
    """Table columns beyond each row's real coverage point at the trash
    page, so view scatters from padded positions never write another
    sequence's page."""
    real = (covered_lengths.long() + page_size - 1) // page_size
    col = torch.arange(tables_slice.shape[1], device=tables_slice.device)[None, :]
    return torch.where(col < real[:, None], tables_slice.long(), trash)


def _gather_view(pool: torch.Tensor, t_cov: torch.Tensor, page_size: int) -> torch.Tensor:
    """[L, pages, Hkv, ps, hd] pool -> dense [L, b, cover*ps, Hkv, hd]
    view of each row's t_cov-mapped pages (decode_block's cache layout)."""
    g = pool[:, t_cov]  # [L, b, cover, Hkv, ps, hd]
    g = g.permute(0, 1, 2, 4, 3, 5)
    return g.reshape(g.shape[0], g.shape[1], t_cov.shape[1] * page_size, *g.shape[4:])


def _scatter_view(
    pool: torch.Tensor, view: torch.Tensor, t_cov: torch.Tensor, page_size: int,
    start_col: int = 0,
) -> None:
    """Inverse of _gather_view, in place: write the view's pages from
    table column ``start_col`` on back into the pool.  Duplicate t_cov
    entries are trash padding only, whose bytes are garbage by
    contract."""
    pv = view.reshape(
        view.shape[0], view.shape[1], t_cov.shape[1], page_size, *view.shape[3:]
    )
    pv = pv.permute(0, 1, 2, 4, 3, 5)[:, :, start_col:]
    pool[:, t_cov[:, start_col:]] = pv


def _last_hidden_logits(params, hidden, idx):
    """Unembed the hidden row ``idx[b]`` of each row b (idx in range)."""
    batch = hidden.shape[0]
    h_last = hidden[torch.arange(batch, device=hidden.device), idx]
    return h_last.float() @ weight(params["unembed"], torch.float32)


@torch.inference_mode()
def paged_prefill(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    prompts: torch.Tensor,
    lengths: torch.Tensor,
    config: ModelConfig,
):
    """Prefill a batch of fresh prompts into the paged pools in one block
    forward.  prompts: [batch, P] right-padded; lengths: [batch] true
    lengths (1..P).  Rows start at position 0; their tables must cover
    their own ceil(length / page_size) pages within the first
    ceil(P / page_size) columns, and padding columns are redirected to
    the trash page.  Returns (next-token logits [batch, vocab] at each
    row's last true position, pools updated in place)."""
    k_pages, v_pages = pools
    P = prompts.shape[1]
    page_size = k_pages.shape[3]
    prefill_pages = -(-P // page_size)
    trash = k_pages.shape[1] - 1
    t_pp = _redirect_padding(tables[:, :prefill_pages], lengths, page_size, trash)
    view = torch.stack(
        [_gather_view(k_pages, t_pp, page_size), _gather_view(v_pages, t_pp, page_size)],
        dim=1,
    )
    hidden, view = decode_block(params, view, prompts, 0, config, unembed="hidden")
    logits = _last_hidden_logits(params, hidden, (lengths.long() - 1).clamp(0, P - 1))
    _scatter_view(k_pages, view[:, 0], t_pp, page_size)
    _scatter_view(v_pages, view[:, 1], t_pp, page_size)
    return logits, pools


@torch.inference_mode()
def paged_prefill_chunk(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    chunk_tokens: torch.Tensor,
    lengths: torch.Tensor,
    config: ModelConfig,
    start_page: int,
    cover_pages: int,
    emit: bool,
    row_start: torch.Tensor | None = None,
):
    """Chunked prefill: one page-aligned slice of the prompts through the
    paged pools.  chunk_tokens: [batch, C] at absolute positions
    ``start_page * page_size .. +C-1`` (C a multiple of page_size),
    right-padded past each row's true length; lengths: [batch] true
    total prompt lengths; tables cover ``cover_pages = start_page +
    C/page_size`` columns.  The chunk attends over all pages up to its
    end.

    ``emit`` returns logits at each row's true last position provided
    it falls inside this chunk (other rows get a clipped, meaningless
    row).  ``row_start`` ([batch] pages) marks columns before each row's
    own start as already written: reads see them, the scatter-back sends
    them to the trash page.  Returns (logits | None, pools updated in
    place)."""
    k_pages, v_pages = pools
    C = chunk_tokens.shape[1]
    page_size = k_pages.shape[3]
    if C % page_size:
        raise ValueError(
            f"chunk width {C} must be a multiple of page_size {page_size}"
        )
    if cover_pages != start_page + C // page_size:
        raise ValueError(
            f"cover_pages {cover_pages} must equal start_page {start_page} "
            f"+ chunk pages {C // page_size}"
        )
    start = start_page * page_size
    trash = k_pages.shape[1] - 1
    t_cov = _redirect_padding(tables[:, :cover_pages], lengths, page_size, trash)
    view = torch.stack(
        [_gather_view(k_pages, t_cov, page_size), _gather_view(v_pages, t_cov, page_size)],
        dim=1,
    )
    hidden, view = decode_block(
        params, view, chunk_tokens, start, config,
        unembed="hidden" if emit else "none",
    )
    logits = None
    if emit:
        idx = (lengths.long() - 1 - start).clamp(0, C - 1)
        logits = _last_hidden_logits(params, hidden, idx)
    t_write = t_cov
    if row_start is not None:
        col = torch.arange(t_cov.shape[1], device=t_cov.device)[None, :]
        t_write = torch.where(col < row_start.long()[:, None], trash, t_cov)
    _scatter_view(k_pages, view[:, 0], t_write, page_size, start_page)
    _scatter_view(v_pages, view[:, 1], t_write, page_size, start_page)
    return logits, pools
