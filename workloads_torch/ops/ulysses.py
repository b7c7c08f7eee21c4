"""Ulysses sequence parallelism: all-to-all between sequence and heads.
Port of ``workloads/ops/ulysses.py``.

One all-to-all per tensor (``distributed.all_to_all``) turns a rank's
sequence span with every head into the whole sequence with heads/N of
the heads; each rank runs ordinary full-sequence attention over its
heads, and the reverse all-to-all restores the sequence span.  The
local attention is the port's flash attention
(``ops.attention.flash_attention``): the CUDA kernels K2 (forward) and
K3/K4 (backward) on a CUDA tensor, their plain versions on the CPU.

Differentiable end to end: the all-to-all's gradient is the inverse
all-to-all, and ``FlashAttention`` carries its own backward.

Unlike the JAX function, which takes global arrays, ``ulysses_attention``
takes this rank's span of the sequence (one process per device); the
training step cuts it with ``distributed.seq_slice``, which raises the
JAX package's "seq ... not divisible" error.
"""

from __future__ import annotations

from typing import Callable

from ..distributed import all_to_all
from ..model import _mesh_axis
from .attention import flash_attention

_SEQ_DIM, _HEAD_DIM = 1, 2


def _ulysses_local(q, k, v, group, causal: bool, local_attn):
    """Per-rank body: q/k/v [batch, seq/N, heads, d] -> same shape."""

    def seq_to_heads(x):  # -> [batch, seq, heads/N, d]
        return all_to_all(x, group, split_dim=_HEAD_DIM, concat_dim=_SEQ_DIM)

    def heads_to_seq(x):  # -> [batch, seq/N, heads, d]
        return all_to_all(x, group, split_dim=_SEQ_DIM, concat_dim=_HEAD_DIM)

    out = local_attn(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), causal)
    return heads_to_seq(out)


def ulysses_attention(q, k, v, mesh, axis: str = "seq", causal: bool = True,
                      local_attn: Callable | None = None):
    """Sequence-parallel attention over ``mesh``'s axis ``axis`` via the
    head/seq all-to-all.

    q/k/v: [batch, seq/N, heads, head_dim], this rank's span; heads must
    divide by the axis size.  Returns this rank's span of the output.
    ``local_attn(q, k, v, causal)`` overrides the per-rank full-sequence
    attention (default: ``flash_attention``)."""
    n_shards, _ = _mesh_axis(mesh, axis)
    if q.shape[_HEAD_DIM] % n_shards:
        raise ValueError(
            f"heads {q.shape[_HEAD_DIM]} not divisible by mesh axis {axis!r} "
            f"size {n_shards} (use ring attention for head counts the axis "
            f"cannot split)"
        )
    attn = local_attn if local_attn is not None else flash_attention
    if n_shards == 1:
        return attn(q, k, v, causal)
    return _ulysses_local(q, k, v, mesh.get_group(axis), causal, attn)
