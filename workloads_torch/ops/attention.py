"""Flash attention: the hand-written CUDA kernels and their plain PyTorch
versions.  Port of ``workloads/ops/attention.py``.

The training path's attention: ``flash_attention`` never saves a
[seq, seq] tensor.  Its forward keeps per-row float32 log-sum-exp
values, and its backward recomputes the probabilities from
``(q, k, lse)``.  Three kernels in ``csrc/flash_attention.cu`` replace
the three TPU kernels:

* K2 ``flash_fwd``     <- ``_flash_kernel``          (out, lse)
* K3 ``flash_bwd_dq``  <- ``_flash_bwd_dq_kernel``   (dq)
* K4 ``flash_bwd_dkv`` <- ``_flash_bwd_dkv_kernel``  (dk, dv)

Each kernel has a bf16 version on tensor cores and a float32 version on
CUDA cores, picked by the input dtype.  In bf16 at head_dim 64 and 128
all three run Hopper's warpgroup products (``wgmma``) fed by TMA through
a shared-memory ring, warp-specialised; at head_dim 16 and 32 (narrower
than one 64-column TMA box) they run warp-level ``mma.sync``.  The route
is fixed at compile time by head_dim: no CUDA tensor reaches a plain
version.  Every route of K2 walks k in blocks of ``KERNEL_BLOCK`` keys.

``FlashAttention`` (a ``torch.autograd.Function``) launches them on
CUDA tensors and runs the plain versions on CPU tensors.  There is no
other switch: a CUDA tensor of a shape the kernels do not take raises
``ValueError`` and never goes to the plain version.  ``bwd_impl="xla"``
is the JAX package's own option of a dense backward; here it runs
``flash_backward_reference`` on either device.  Each launcher counts
its launches (``flash_fwd.launches``, ``flash_bwd_dq.launches``,
``flash_bwd_dkv.launches``).

Numerics, as the Pallas kernels: scores in float32 times
``1/sqrt(head_dim)``, masked entries at ``NEG_INF = -1e30``, an online
float32 softmax over k blocks whose weights are rounded to the input
dtype before each product with v (so in bf16 the result depends on the
k block size: the plain forward walks the same blocks as the kernel it
stands for), and in the backward ``p`` and ``ds`` rounded to the input
dtype before their products.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
# The CUDA kernels' compile-time limits and tile (csrc/flash_attention.cu).
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_MAX_GROUP = 8
KERNEL_BLOCK = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_gqa(heads: int, kv_heads: int) -> None:
    if heads % kv_heads:
        raise ValueError(
            f"q heads ({heads}) must be a multiple of kv heads ({kv_heads})"
        )


def _check_segment_ids(segment_ids, q) -> None:
    """Eager shape validation: a silently padded-or-clamped mismatch would
    produce wrong attention, not an error."""
    if segment_ids is None:
        return
    expected = (q.shape[0], q.shape[1])
    if tuple(segment_ids.shape) != expected:
        raise ValueError(
            f"segment_ids shape {tuple(segment_ids.shape)} must be "
            f"[batch, seq] = {expected}"
        )


def _check_window(window, causal: bool) -> None:
    """Sliding windows are a causal construct here (the serving pattern)."""
    if window is None:
        return
    if not causal:
        raise ValueError("window requires causal=True")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _check_bwd_impl(bwd_impl: str) -> None:
    if bwd_impl not in ("pallas", "xla"):
        raise ValueError(f"bwd_impl must be 'pallas' or 'xla', got {bwd_impl!r}")


def _clamp_block(block: int, seq: int) -> int:
    """The JAX package's block clamp: the requested block or the sequence
    rounded up to a multiple of 128, whichever is smaller."""
    return min(block, max(-(-seq // 128) * 128, 128))


def _mask(q_ids, k_ids, causal: bool, window, segment_ids):
    """Visible (query, key) pairs as a bool tensor that broadcasts to
    [batch, kv_heads, group, s_q, s_k]."""
    mask = torch.ones(len(q_ids), len(k_ids), dtype=torch.bool, device=q_ids.device)
    if causal:
        mask &= k_ids[None, :] <= q_ids[:, None]
        if window is not None:
            mask &= k_ids[None, :] > q_ids[:, None] - window
    mask = mask[None, None, None]
    if segment_ids is not None:
        segs = segment_ids.long()
        same = segs[:, q_ids][:, :, None] == segs[:, k_ids][:, None, :]
        mask = mask & same[:, None, None]
    return mask


def _grouped(q, kv_heads: int):
    """[batch, seq, heads, hd] -> float32 [batch, kv_heads, group, seq, hd]."""
    batch, seq, heads, hd = q.shape
    return q.float().reshape(batch, seq, kv_heads, heads // kv_heads, hd).permute(
        0, 2, 3, 1, 4
    )


def _ungrouped(x):
    """[batch, kv_heads, group, seq, hd] -> [batch, seq, heads, hd]."""
    batch, kv_heads, group, seq, hd = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(batch, seq, kv_heads * group, hd)


def flash_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    window: int | None = None, segment_ids: torch.Tensor | None = None,
    block_k: int = KERNEL_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: (out [batch, seq, heads, hd] in q's dtype,
    lse [batch*heads, seq] float32).

    The Pallas kernel's online softmax, walking k in blocks of
    ``block_k`` for every query at once: s = q.k * sm_scale in float32,
    masked to NEG_INF; m_new = max(m, rowmax s); p = exp(s - m_new);
    l = l * exp(m - m_new) + rowsum p; acc = acc * exp(m - m_new) +
    p.astype(v.dtype) @ v; out = acc / l, lse = m + log l (l == 0 taken
    as 1).  Blocks the kernels skip (past the diagonal or before the
    window) are exact no-ops here for every row that has seen a visible
    key, and every row sees at least itself, so skipping them changes
    nothing."""
    batch, seq, heads, hd = q.shape
    kv_heads = k.shape[2]
    _check_gqa(heads, kv_heads)
    sm_scale = 1.0 / hd**0.5
    qg = _grouped(q, kv_heads)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]  # [b, n, 1, t, hd]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    ids = torch.arange(seq, device=q.device)
    m = torch.full((*qg.shape[:-1], 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for start in range(0, seq, block_k):
        blk = slice(start, min(start + block_k, seq))
        s = qg @ kf[..., blk, :].transpose(-1, -2) * sm_scale
        s = torch.where(_mask(ids, ids[blk], causal, window, segment_ids), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vf[..., blk, :]
        m = m_new
    l_safe = torch.where(l > 0, l, 1.0)
    out = _ungrouped(acc / l_safe).to(q.dtype)
    lse = (m + torch.log(l_safe))[..., 0].reshape(batch * heads, seq)
    return out, lse


def flash_backward_reference(
    q, k, v, out, dout, lse, causal: bool = True, window: int | None = None,
    segment_ids=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward, the counterpart of ``_flash_backward_xla``:
    dense recompute of p from (q, k, lse) in float32, materialising
    [seq, seq] per head, with grouped-query dk/dv summed over each group.

    It also takes the Pallas kernels' roundings, which are elementwise
    and so need no blocking: p = exp(where(mask, s, NEG_INF) - lse) *
    mask, rounded to the input dtype before ``p^T.dout``; ds = p * (dp -
    delta) * sm_scale, rounded before ``ds.k`` and ``ds^T.q``.  In
    float32 the roundings do nothing and this is ``_flash_backward_xla``
    op for op."""
    batch, seq, heads, hd = q.shape
    kv_heads = k.shape[2]
    _check_gqa(heads, kv_heads)
    sm_scale = 1.0 / hd**0.5
    qg, dog, og = (_grouped(x, kv_heads) for x in (q, dout, out))
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    ids = torch.arange(seq, device=q.device)
    mask = _mask(ids, ids, causal, window, segment_ids)
    s = qg @ kf.transpose(-1, -2) * sm_scale
    lse_g = lse.reshape(batch, kv_heads, heads // kv_heads, seq, 1)
    p = torch.exp(torch.where(mask, s, NEG_INF) - lse_g) * mask
    del s
    dv = (p.to(dout.dtype).float().transpose(-1, -2) @ dog).sum(dim=2)
    dp = dog @ vf.transpose(-1, -2)
    delta = (dog * og).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * sm_scale).to(q.dtype).float()
    del p, dp
    dq = ds @ kf
    dk = (ds.transpose(-1, -2) @ qg).sum(dim=2)
    return (
        _ungrouped(dq).to(q.dtype),
        dk.permute(0, 2, 1, 3).to(k.dtype),
        dv.permute(0, 2, 1, 3).to(v.dtype),
    )


def _kernel_library():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_fa_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dims = [i32] * 8  # dtype, batch, seq, heads, kv_heads, hd, causal, window
        lib.flash_attention_fwd.argtypes = [ptr] * 6 + dims + [f32, ptr]
        lib.flash_attention_bwd_dq.argtypes = [ptr] * 8 + dims + [f32, ptr]
        lib.flash_attention_bwd_dkv.argtypes = [ptr] * 9 + dims + [f32, ptr]
        for fn in (lib.flash_attention_fwd, lib.flash_attention_bwd_dq,
                   lib.flash_attention_bwd_dkv):
            fn.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._fa_typed = True
    return lib


def _check_kernel_inputs(q, k, v, segment_ids) -> None:
    """What the CUDA kernels take; anything else raises ValueError."""
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"q ({q.dtype}) and {name} ({t.dtype}) must share a dtype")
    if segment_ids is not None and segment_ids.device != q.device:
        raise ValueError(f"segment_ids is on {segment_ids.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernels take float32 or bfloat16, got {q.dtype}")
    head_dim = q.shape[3]
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"kernels take head_dim in {KERNEL_HEAD_DIMS}, got {head_dim}"
        )
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != head_dim:
        raise ValueError(
            f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}"
        )
    group = q.shape[2] // k.shape[2]
    if group > KERNEL_MAX_GROUP:
        raise ValueError(
            f"kernels take at most {KERNEL_MAX_GROUP} query heads per kv head, "
            f"got {group}"
        )


def _launch(fn_name: str, tensors, q, k, causal, window):
    """One kernel launch on q's device and current stream; tensors are the
    pointer arguments in order.  (Every head_dim the kernels take fits
    their shared memory: at most 167,800 bytes, the bf16 K4 at head_dim
    128.)"""
    lib = _kernel_library()
    batch, seq, heads, head_dim = q.shape
    ptrs = [0 if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn_name)(
            *ptrs, _DTYPE_CODES[q.dtype], batch, seq, heads, k.shape[2], head_dim,
            int(causal), window or 0, ctypes.c_float(1.0 / head_dim**0.5), stream,
        )
    if err:
        raise RuntimeError(
            f"{fn_name} launch failed: CUDA error {err} "
            f"({lib.flash_attention_error_string(err).decode()})"
        )


def _operand(x):
    """x contiguous on a 16-byte boundary: the bf16 kernels load 16 bytes
    at a time, a TMA tensor map needs a 16-byte-aligned base, and a
    contiguous view may start anywhere in its storage."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _segments(segment_ids):
    return None if segment_ids is None else segment_ids.to(torch.int32).contiguous()


def flash_fwd(q, k, v, causal=True, window=None, segment_ids=None):
    """K2 on CUDA tensors: (out [batch, seq, heads, hd] in q's dtype,
    lse [batch*heads, seq] float32)."""
    _check_kernel_inputs(q, k, v, segment_ids)
    q, k, v = _operand(q), _operand(k), _operand(v)
    batch, seq, heads, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((batch * heads, seq), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    _launch("flash_attention_fwd", (q, k, v, _segments(segment_ids), out, lse),
            q, k, causal, window)
    flash_fwd.launches += 1
    return out, lse


def _delta(out, dout):
    """rowsum(dout * out) in float32, [batch*heads, seq]: the softmax
    Jacobian's diagonal term, outside any kernel as in the JAX package."""
    batch, seq, heads, _ = out.shape
    d = (dout.float() * out.float()).sum(dim=-1)  # [b, s, h]
    return d.permute(0, 2, 1).reshape(batch * heads, seq).contiguous()


def flash_bwd_dq(q, k, v, dout, lse, delta, causal=True, window=None,
                 segment_ids=None):
    """K3 on CUDA tensors: dq [batch, seq, heads, hd] in q's dtype."""
    _check_kernel_inputs(q, k, v, segment_ids)
    q, k, v, dout = (_operand(x) for x in (q, k, v, dout.to(q.dtype)))
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    _launch("flash_attention_bwd_dq",
            (q, k, v, dout, lse.contiguous(), delta.contiguous(),
             _segments(segment_ids), dq),
            q, k, causal, window)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal=True, window=None,
                  segment_ids=None):
    """K4 on CUDA tensors: (dk, dv) [batch, seq, kv_heads, hd] in k's
    dtype, each group's sum taken inside the kernel (no atomics)."""
    _check_kernel_inputs(q, k, v, segment_ids)
    q, k, v, dout = (_operand(x) for x in (q, k, v, dout.to(q.dtype)))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    _launch("flash_attention_bwd_dkv",
            (q, k, v, dout, lse.contiguous(), delta.contiguous(),
             _segments(segment_ids), dk, dv),
            q, k, causal, window)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash recipe's backward: saves
    (q, k, v, out, lse), never a [seq, seq] tensor, and recomputes the
    probabilities in the backward.  CUDA tensors run K2, then K3 and K4;
    CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_k, bwd_impl, window, segment_ids):
        if q.is_cuda:
            out, lse = flash_fwd(q, k, v, causal, window, segment_ids)
        else:
            out, lse = flash_forward_reference(
                q, k, v, causal, window, segment_ids,
                block_k=_clamp_block(block_k, q.shape[1]),
            )
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal, ctx.window, ctx.bwd_impl = causal, window, bwd_impl
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        args = (ctx.causal, ctx.window, segment_ids)
        if ctx.bwd_impl == "xla" or not q.is_cuda:
            dq, dk, dv = flash_backward_reference(q, k, v, out, dout, lse, *args)
        else:
            delta = _delta(out, dout)
            dq = flash_bwd_dq(q, k, v, dout, lse, delta, *args)
            dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, *args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = 256,
    block_k: int = 512,
    bwd_impl: str = "pallas",
    window: int | None = None,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scaled-dot-product attention, [batch, seq, heads, head_dim] layout.

    k/v may carry fewer heads than q (grouped-query attention): q head h
    reads kv head h // (heads // kv_heads), with no materialised repeat.
    ``bwd_impl`` picks the backward: "pallas" (the blocked recompute
    kernels, K3 and K4 on the card) or "xla" (the dense plain backward).
    ``block_q``/``block_k`` are the JAX signature's block sizes: the CUDA
    kernels use their own tiles (64 keys a softmax block), and the CPU's
    plain forward
    walks k in ``block_k`` blocks (clamped as the JAX package does), so
    its bf16 roundings follow the Pallas kernel's."""
    del block_q  # the q block changes no result
    _check_bwd_impl(bwd_impl)
    _check_window(window, causal)
    _check_segment_ids(segment_ids, q)
    _check_gqa(q.shape[2], k.shape[2])
    return FlashAttention.apply(q, k, v, causal, block_k, bwd_impl, window, segment_ids)
