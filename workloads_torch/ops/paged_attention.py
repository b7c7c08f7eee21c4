"""Paged decode attention: the hand-written CUDA kernel and its plain
PyTorch version.

The serving hot op: one new query token per sequence attends over that
sequence's KV history, stored in non-contiguous fixed-size pages of a
pool ``[layers, n_pages, kv_heads, page_size, head_dim]`` and mapped by
a block table.  Port of ``workloads/ops/paged_attention.py``.

``paged_attention`` launches the kernel ``csrc/paged_attention.cu``
(which replaces the TPU kernel ``_paged_decode_kernel``) on CUDA
tensors, and runs ``paged_attention_reference`` on CPU tensors.  There
is no other switch: a CUDA tensor of a shape the kernel does not take
raises ``ValueError``; it never goes to the plain version.
``paged_attention.launches`` counts kernel launches.

The kernel cuts each row's live pages into ``splits`` contiguous shares,
one CTA each, and merges the shares' float32 ``(m, l, acc)`` in split
order inside the same launch.  Each share starts its walk from the max
of the scores of the live pages before it (a first pass over its K
tiles and a look-back at the shares before it), so every ``p`` rounds
against the row's running max, as the Pallas kernel's one sequential
walk does: splitting changes only the order of float32 sums, in both
dtypes.  ``choose_splits`` picks the count on the host from shapes alone
(no device value is read), and ``paged_attention_split_reference`` is
that arithmetic in plain PyTorch: the tests hold it to
``paged_attention_reference``; nothing on the serving path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
# The kernel's compile-time limits (csrc/paged_attention.cu).
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_MAX_GROUP = 8
_MAX_SMEM_BYTES = 232_448  # what one H100 block may use (227 KB)
# The ring of page slots the kernel's bulk copies fill: as deep as this, or
# as shared memory allows (2, 3 and 4 slots read alike on an H100 at the
# serving shapes; deeper rings cost occupancy).
RING_STAGES = 3
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_gqa(heads: int, kv_heads: int) -> None:
    if heads % kv_heads:
        raise ValueError(
            f"q heads ({heads}) must be a multiple of kv heads ({kv_heads})"
        )


def paged_attention_reference(
    q, k_pages, v_pages, tables, lengths, *, layer: int, window: int | None
) -> torch.Tensor:
    """The plain PyTorch version, the kernel's specification: the Pallas
    kernel's online softmax, page by page over each row's table-mapped
    pages, masked by per-row length (and window), grouped-query heads.
    Scores and the running (m, l, acc) are float32; each page's weights
    ``p`` are rounded to the value dtype before the ``p·v`` product, as
    ``_paged_decode_kernel`` does (``p.astype(v.dtype)``), while ``l``
    sums them unrounded.  Dead pages change nothing; length-0 rows give
    zeros."""
    batch, heads, head_dim = q.shape
    kv_heads, page_size = k_pages.shape[2], k_pages.shape[3]
    group = heads // kv_heads
    max_pages = tables.shape[1]
    tables = tables.long()
    lengths = lengths.long()
    sm_scale = 1.0 / head_dim**0.5

    def view(pool):
        return pool[layer][tables]  # [b, maxp, Hkv, ps, hd]

    k, v = view(k_pages), view(v_pages)
    qg = q.reshape(batch, kv_heads, group, head_dim).float()
    m = torch.full((batch, kv_heads, group, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((batch, kv_heads, group, head_dim), device=q.device)
    offsets = torch.arange(page_size, device=q.device)
    for j in range(max_pages):
        ids = j * page_size + offsets
        mask = ids[None, :] < lengths[:, None]
        if window is not None:
            mask &= ids[None, :] >= (lengths - window)[:, None]
        mask = mask[:, None, None, :]
        s = torch.einsum("bngk,bntk->bngt", qg, k[:, j].float()) * sm_scale
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bngt,bntk->bngk", p.to(v.dtype).float(), v[:, j].float())
        acc = acc * alpha + pv
        m = m_new
    # Length-0 rows walk no live page: l == 0 and the kernel writes zeros.
    out = acc / torch.where(l > 0, l, 1.0)
    return out.reshape(batch, heads, head_dim).to(q.dtype)


def choose_splits(batch: int, kv_heads: int, max_pages: int, sm_count: int) -> int:
    """How many CTAs share one (row, kv head)'s page walk: as many as give
    every SM one CTA, at most one a table column, and 1 once batch x
    kv_heads CTAs pass half the SMs.  (On an H100 a second CTA an SM read
    slower than one at the serving shapes: the partials' round trip
    through the workspace costs more than the fuller card gains.)  A pure
    function of shapes, the same for both dtypes: ``lengths`` stays on
    the device."""
    ctas = max(batch * kv_heads, 1)
    return max(1, min(sm_count // ctas, max_pages))


def split_shares(first: int, last: int, splits: int) -> list[range]:
    """The contiguous share of the live pages [first, last] that each of
    ``splits`` CTAs walks, as the kernel cuts them; shares past the end
    are empty."""
    per = max(-(-(last - first + 1) // splits), 0)
    return [range(first + s * per, min(first + (s + 1) * per - 1, last) + 1)
            for s in range(splits)]


def paged_attention_split_reference(
    q, k_pages, v_pages, tables, lengths, *, layer: int, window: int | None,
    splits: int,
) -> torch.Tensor:
    """The split kernel's specification in plain PyTorch: each share of a
    row's live pages keeps its own float32 ``(m, l, acc)``, with ``m``
    starting from the max of the scores of the live pages before the
    share (``-1e30`` for the first), and walks its pages as
    ``paged_attention_reference`` walks them (``p`` rounded to the value
    dtype before ``p.v`` against ``max(that start, the share's pages so
    far)``, the sequential walk's running max; ``l`` unrounded; a share
    with nothing visible is ``(start, 0, 0)``).  The shares merge in split
    order, each weighed by ``exp(m - max m)``.  Row by row on the host: it
    reads ``lengths``, so it is for tests only."""
    batch, heads, head_dim = q.shape
    kv_heads, page_size = k_pages.shape[2], k_pages.shape[3]
    group = heads // kv_heads
    max_pages = tables.shape[1]
    sm_scale = 1.0 / head_dim**0.5
    out = torch.zeros((batch, heads, head_dim), device=q.device)
    offsets = torch.arange(page_size, device=q.device)
    for b in range(batch):
        length = int(lengths[b])
        first = max(length - window, 0) // page_size if window else 0
        last = min((length - 1) // page_size, max_pages - 1) if length > 0 else -1
        qg = q[b].reshape(kv_heads, group, head_dim).float()
        scores = {}  # live page -> its masked scores [kv_heads, group, page_size]
        for j in range(first, last + 1):
            ids = j * page_size + offsets
            mask = ids < length
            if window is not None:
                mask &= ids >= length - window
            s = torch.einsum("ngk,ntk->ngt", qg,
                             k_pages[layer, int(tables[b, j])].float()) * sm_scale
            scores[j] = torch.where(mask, s, NEG_INF)
        parts = []
        for share in split_shares(first, last, splits):
            m = torch.full((kv_heads, group, 1), NEG_INF, device=q.device)
            for j in range(first, min(share.start, last + 1)):
                m = torch.maximum(m, scores[j].amax(dim=-1, keepdim=True))
            l = torch.zeros_like(m)
            acc = torch.zeros((kv_heads, group, head_dim), device=q.device)
            for j in share:
                s = scores[j]
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.where(s != NEG_INF, torch.exp(s - m_new), 0.0)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                pv = torch.einsum("ngt,ntk->ngk", p.to(v_pages.dtype).float(),
                                  v_pages[layer, int(tables[b, j])].float())
                acc = acc * alpha + pv
                m = m_new
            parts.append((m, l, acc))
        m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l_all = torch.zeros_like(m_all)
        acc_all = torch.zeros_like(parts[0][2])
        for m, l, acc in parts:  # in split order
            w = torch.exp(m - m_all)
            l_all = l_all + l * w
            acc_all = acc_all + acc * w
        out[b] = (acc_all / torch.where(l_all > 0, l_all, 1.0)).reshape(heads, head_dim)
    return out.to(q.dtype)


def _kernel_library():
    lib = _build.load("paged_attention")
    if not getattr(lib, "_pa_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_fwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr,            # q, k, v, tables, lengths, out
            ptr, ptr,                                # workspace, sync
            i32, i32, i32, i32, i32, i32, i32, i32,  # dtype, B, H, Hkv, hd, ps, P, maxp
            i32, i32, i32, i32,                      # layer, window, splits, stages
            ctypes.c_float, ptr,                     # scale, stream
        ]
        lib.paged_attention_fwd.restype = i32
        lib.paged_attention_smem_bytes.argtypes = [i32] * 5
        lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
        lib.paged_attention_error_string.argtypes = [i32]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib._pa_typed = True
    return lib


def _check_kernel_inputs(q, k_pages, v_pages, tables, lengths) -> None:
    """What the CUDA kernel takes; anything else raises ValueError."""
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(
            f"q ({q.dtype}) and the pools ({k_pages.dtype}) must share a dtype"
        )
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("tables and lengths must be int32")
    head_dim = q.shape[2]
    tile_bytes = k_pages.shape[3] * head_dim * k_pages.element_size()
    if tile_bytes % 16:
        raise ValueError(
            f"a (page, kv head) tile of {tile_bytes} bytes is no multiple of "
            f"16: the kernel's bulk copies take whole 16-byte units"
        )
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {head_dim}"
        )
    group = q.shape[1] // k_pages.shape[2]
    if group > KERNEL_MAX_GROUP:
        raise ValueError(
            f"kernel takes at most {KERNEL_MAX_GROUP} query heads per kv "
            f"head, got {group}"
        )
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


_sm_counts: dict[int, int] = {}
_tickets: dict[tuple[int, int], torch.Tensor] = {}
_outgrown: list[torch.Tensor] = []


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def _ticket_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """int32 zeros kept per device and stream, ``splits + 2`` a (row, kv
    head): the ticket that counts the row's finished shares, the counter
    that hands out share indices, and one ready flag a share.  The
    merging CTA sets them back to 0, so launches on one stream share them
    and a CUDA graph replays over them.  From torch's caching allocator,
    like the workspace; a buffer outgrown is kept, not freed, since a
    graph captured over it still holds its address."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _outgrown.append(buf)
        buf = torch.zeros(max(n, 1 << 16), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def _launch(q, k_pages, v_pages, tables, lengths, layer, window, splits=None):
    _check_kernel_inputs(q, k_pages, v_pages, tables, lengths)
    lib = _kernel_library()
    batch, heads, head_dim = q.shape
    _, n_pages, kv_heads, page_size, _ = k_pages.shape
    max_pages = tables.shape[1]
    code = _DTYPE_CODES[q.dtype]
    group = heads // kv_heads
    stages = RING_STAGES
    while stages > 1 and lib.paged_attention_smem_bytes(
            code, page_size, head_dim, group, stages) > _MAX_SMEM_BYTES:
        stages -= 1
    smem = lib.paged_attention_smem_bytes(code, page_size, head_dim, group, stages)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"page_size {page_size} x head_dim {head_dim} in {q.dtype} needs "
            f"{smem} bytes of shared memory; one block holds {_MAX_SMEM_BYTES}"
        )
    if splits is None:
        splits = choose_splits(batch, kv_heads, max_pages, _sm_count(q.device))
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    out = torch.empty_like(q)
    if batch == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        workspace = sync = None
        if splits > 1:
            # Each share's (acc, m, l) and its pass-1 max.
            workspace = torch.empty((batch, heads, splits, head_dim + 3),
                                    dtype=torch.float32, device=q.device)
            sync = _ticket_buffer(q.device, stream, batch * kv_heads * (splits + 2))
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if workspace is None else workspace.data_ptr(),
            None if sync is None else sync.data_ptr(),
            code, batch, heads, kv_heads, head_dim, page_size, n_pages,
            max_pages, layer, window or 0, splits, stages,
            ctypes.c_float(1.0 / head_dim**0.5), stream,
        )
    if err:
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {err} "
            f"({lib.paged_attention_error_string(err).decode()})"
        )
    paged_attention.launches += 1
    return out


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    layer: int = 0,
    window: int | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """Decode attention over a paged KV cache.

    q: [batch, heads, head_dim], the current token's queries;
    k_pages/v_pages: [layers, n_pages, kv_heads, page_size, head_dim]
    (the whole pool, with ``layer`` selecting inside it — no per-layer
    copy); tables: [batch, max_pages] int32 physical page ids;
    lengths: [batch] int32 valid positions per row (the query's own k/v
    already written at position length-1).  kv_heads may be fewer than
    heads (grouped-query).  Returns [batch, heads, head_dim] in q's
    dtype.

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    ``splits`` forces the kernel's split count for tests (the engine never
    passes it: ``choose_splits`` picks it from shapes); the plain version
    takes no notice of it."""
    batch, heads, head_dim = q.shape
    layers, n_pages, kv_heads, page_size, hd2 = k_pages.shape
    if hd2 != head_dim:
        raise ValueError(
            f"head_dim mismatch: q has {head_dim}, pages have {hd2}"
        )
    if v_pages.shape != k_pages.shape:
        raise ValueError(
            f"k/v page pools disagree: {tuple(k_pages.shape)} vs "
            f"{tuple(v_pages.shape)}"
        )
    if not (0 <= layer < layers):
        raise ValueError(f"layer {layer} out of range [0, {layers})")
    if tables.ndim != 2 or tables.shape[0] != batch or lengths.shape != (batch,):
        raise ValueError(
            f"tables {tuple(tables.shape)} / lengths {tuple(lengths.shape)} "
            f"do not match batch {batch}"
        )
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    _check_gqa(heads, kv_heads)
    if q.is_cuda:
        return _launch(q, k_pages, v_pages, tables, lengths, layer, window, splits)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    return paged_attention_reference(
        q, k_pages, v_pages, tables, lengths, layer=layer, window=window
    )


paged_attention.launches = 0
