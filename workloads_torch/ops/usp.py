"""Unified (2D) sequence parallelism: Ulysses over one mesh axis with
the ring over another.  Port of ``workloads/ops/usp.py``.

The sequence is cut over two axes, ring-major: ring shard r owns a
contiguous span, cut again over the Ulysses axis.  Per call, the
Ulysses all-to-all gives each rank its ring shard's whole span with
heads/u of the heads; ring attention circulates those spans over the
ring axis (the contiguous-span position arithmetic holds because the
ring axis is major); the reverse all-to-all restores the 2D cut.  It is
``ulysses._ulysses_local`` with ``ring._ring_local`` as its local
attention, as in the JAX package.

Takes this rank's span (index ``r * u + j`` of ``r * u``), where the JAX
function takes global arrays; the training step cuts it with two
``distributed.seq_slice`` calls, ring axis first.
"""

from __future__ import annotations

from ..model import _mesh_axis
from .ring import _ring_local
from .ulysses import _ulysses_local

_SEQ_DIM, _HEAD_DIM = 1, 2


def usp_attention(q, k, v, mesh, ring_axis: str = "seq_r", ulysses_axis: str = "seq_u",
                  causal: bool = True):
    """2D sequence-parallel attention over ``mesh``'s ``ring_axis`` x
    ``ulysses_axis``.

    q/k/v: [batch, seq/(r*u), heads, head_dim], this rank's span; heads
    must divide by the Ulysses axis.  Returns this rank's span of the
    output."""
    n_ring, r_index = _mesh_axis(mesh, ring_axis)
    n_uly, _ = _mesh_axis(mesh, ulysses_axis)
    if q.shape[_HEAD_DIM] % n_uly:
        raise ValueError(
            f"heads {q.shape[_HEAD_DIM]} not divisible by {ulysses_axis} "
            f"size {n_uly}"
        )
    ring_group = mesh.get_group(ring_axis) if n_ring > 1 else None

    def ring_as_local_attn(ql, kl, vl, causal_):
        return _ring_local(ql, kl, vl, ring_group, r_index, n_ring, causal_)

    if n_uly == 1:
        return ring_as_local_attn(q, k, v, causal)
    return _ulysses_local(q, k, v, mesh.get_group(ulysses_axis), causal,
                          ring_as_local_attn)


def seq_span(x, mesh, ring_axis: str = "seq_r", ulysses_axis: str = "seq_u"):
    """This rank's span of ``x`` [batch, seq, ...] under the ring-major 2D
    cut, where every rank of the two axes holds the same ``x``
    (``distributed.seq_slice`` over the ring axis, then the Ulysses
    axis).  Raises the JAX package's error when the sequence does not
    divide by both axes."""
    from ..distributed import seq_slice

    n_ring, _ = _mesh_axis(mesh, ring_axis)
    n_uly, _ = _mesh_axis(mesh, ulysses_axis)
    if x.shape[_SEQ_DIM] % (n_ring * n_uly):
        raise ValueError(
            f"seq {x.shape[_SEQ_DIM]} not divisible by "
            f"{ring_axis}*{ulysses_axis} = {n_ring}*{n_uly}"
        )
    for axis, n in ((ring_axis, n_ring), (ulysses_axis, n_uly)):
        if n > 1:
            x = seq_slice(x, mesh.get_group(axis), _SEQ_DIM, axis)
    return x


def seq_join(x, mesh, ring_axis: str = "seq_r", ulysses_axis: str = "seq_u"):
    """``seq_span``'s inverse: every rank's span joined in ring-major
    order (``distributed.seq_gather`` over the Ulysses axis, then the
    ring axis)."""
    from ..distributed import seq_gather

    for axis in (ulysses_axis, ring_axis):
        if _mesh_axis(mesh, axis)[0] > 1:
            x = seq_gather(x, mesh.get_group(axis), _SEQ_DIM)
    return x
