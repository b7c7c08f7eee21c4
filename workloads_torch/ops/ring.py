"""Ring attention: sequence parallelism over a mesh axis.  Port of
``workloads/ops/ring.py``.

Each rank keeps its q span resident while the k/v spans travel the
axis' ring (``distributed.ppermute``), each visiting block merged into a
float32 online-softmax accumulator, so no rank holds the whole sequence's
keys at once.  The per-block products are torch products, as the JAX
package's are XLA einsums: no kernel of the TPU package computes them.

Differentiable end to end: ``ppermute``'s gradient runs the reverse
ring, and autograd takes the rest.

Unlike the JAX function, which takes global arrays and maps them over
the mesh with ``shard_map``, ``ring_attention`` takes this rank's local
span (one process per device): the training step cuts it from the full
sequence with ``distributed.seq_slice``, which raises the JAX package's
"not divisible" error.
"""

from __future__ import annotations

import torch

from ..distributed import ppermute
from ..model import _mesh_axis

NEG_INF = -1e30


def _ring_local(q, k, v, group, index: int, n_shards: int, causal: bool):
    """The per-rank body: q/k/v [batch, s_local, heads, d], this rank's
    span, ``index`` its place on the ring of ``group``."""
    batch, s_local, heads, head_dim = q.shape
    sm_scale = 1.0 / (head_dim**0.5)
    q32 = q.float() * sm_scale
    ids = torch.arange(s_local, device=q.device)
    q_pos = index * s_local + ids

    m = torch.full((batch, heads, s_local), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((batch, heads, s_local), dtype=torch.float32, device=q.device)
    acc = torch.zeros((batch, s_local, heads, head_dim), dtype=torch.float32, device=q.device)

    for step in range(n_shards):
        # After `step` rotations every rank holds span (index - step) mod N.
        src = (index - step) % n_shards
        k_pos = src * s_local + ids
        s = torch.einsum("bshk,bthk->bhst", q32, k.float())
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]  # [s_local_q, s_local_k]
            s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)  # [b, h, s]
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha.permute(0, 2, 1)[..., None] + torch.einsum(
            "bhst,bthk->bshk", p, v.float())
        m = m_new
        if step != n_shards - 1:
            k = ppermute(k, group)
            v = ppermute(v, group)

    l_safe = torch.where(l > 0, l, 1.0)
    out = acc / l_safe.permute(0, 2, 1)[..., None]
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh, axis: str = "seq", causal: bool = True):
    """Sequence-parallel attention over ``mesh``'s axis ``axis``.

    q/k/v: [batch, seq/N, heads, head_dim], this rank's span of the
    sequence (span i of N, contiguous); returns this rank's span of the
    attention output."""
    n_shards, index = _mesh_axis(mesh, axis)
    if n_shards == 1:
        return _ring_local(q, k, v, None, 0, 1, causal)
    return _ring_local(q, k, v, mesh.get_group(axis), index, n_shards, causal)
