"""Mixture-of-Experts FFN with expert parallelism, GShard-style: the
``workloads/moe.py`` of the JAX package, in PyTorch.

The transformer's FFN is replaced by N experts whose weights are cut
over an ``"expert"`` mesh axis.  Routing is top-1 with a fixed
per-expert capacity, as dense one-hot dispatch and combine einsums, in
float32 (argmax and softmax stability).  Capacity keeps every shape
static: each expert takes at most C = ceil(seq * capacity_factor /
n_experts) tokens of a sequence, first come first served; overflow
tokens skip the expert path (their residual passes through unchanged).
A load-balancing auxiliary loss (mean gate mass x token fraction per
expert, scaled by E) keeps the router from collapsing onto one expert.

The JAX package writes no collective here: XLA derives them from the
experts' ``P("expert", None, None)``.  The port runs one process per
device (``train.py``) and writes them out (``expert_hooks``): each rank
holds E/ep experts and dispatches to them alone, so its combine is a
partial ``y``, summed over the expert group by Megatron's ``g``; the
cotangents that flow through the rank's own experts, into the dispatch
einsum's ``x`` and the combine's ``gate``, are partial too and are
summed by ``f``.  The router's softmax and the aux loss are computed
whole on every rank, so nothing else is summed.  The aux loss is a
product of means over the global batch: under ``"data"`` > 1 the token
fraction and gate mass are averaged over the data group before the
product (``distributed.group_mean``).

``init_moe_model_params`` / ``moe_loss_fn`` swap the dense FFN of
``model.py`` for this layer, trained over a ``("data", "expert",
"model")`` mesh (``make_moe_mesh``): dp x ep x tp in one step, the
attention keeping the Megatron ``"model"`` cut.

The serving paths run another expert layer, ``expert_ffn``: dropless
top-k over SwiGLU experts (a config with ``n_routed_experts``; the layer's
``moe`` leaves are ``router`` [d, E], ``w_gate_up`` [E, d, 2f], the gate
then the up columns, and ``w_down`` [E, f, d]).  The router's logits and
softmax are float32; the top ``experts_per_token`` gates are divided by
their sum (HF's ``norm_topk_prob``) and cast to the compute dtype.  Every
(token, expert) pair is computed, as one grouped product over the rows
sorted by expert (``grouped_swiglu``: ``torch._grouped_mm`` on the card,
each expert's weights read once a call).  Shapes depend on the token
count alone and nothing is read back to the host, so the layer is
captured in the decode step's CUDA graph (``decode_graph.py``).
``ffn`` picks it or the dense MLP by the config.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from . import prng
from .model import (
    ModelConfig,
    _attention,
    _gelu_tanh,
    _mesh_axis,
    _mlp,
    _rmsnorm,
    cross_entropy,
    init_params,
    param_specs,
    weight,
)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 4
    capacity_factor: float = 2.0
    aux_loss_weight: float = 0.01


def init_moe_ffn_params(key: torch.Tensor, d_model: int, d_ff: int,
                        n_experts: int) -> dict:
    """Router ``[d, E]`` and experts ``w_up`` ``[E, d, f]``, ``w_down``
    ``[E, f, d]``, ``normal * 0.02`` float32 under ``split(key, 3)``, as
    the JAX package draws them, on the key's device."""
    k = prng.split(key, 3)
    scale = 0.02

    def dense(kk, *shape):
        return prng.normal(kk, shape) * scale

    return {
        "router": dense(k[0], d_model, n_experts),
        "w_up": dense(k[1], n_experts, d_model, d_ff),
        "w_down": dense(k[2], n_experts, d_ff, d_model),
    }


def moe_ffn_specs() -> dict:
    """Experts cut over the ``"expert"`` axis; the tiny router replicates."""
    return {
        "router": (),
        "w_up": ("expert", None, None),
        "w_down": ("expert", None, None),
    }


def expert_capacity(seq: int, n_experts: int, capacity_factor: float) -> int:
    return max(1, math.ceil(seq * capacity_factor / n_experts))


@dataclass(frozen=True)
class ExpertHooks:
    """What a rank of an expert-parallel mesh does beyond the one-device
    FFN: ``index``, its index on the ``"expert"`` axis (its experts are
    the ``index``-th block of E/ep); ``enter`` and ``reduce``, the
    ``"expert"`` axis' ``f`` and ``g`` (``distributed.axis_hooks``);
    ``mean``, the ``"data"`` group's mean of the aux loss's statistics
    (``distributed.group_mean``).  A None hook is the identity."""

    index: int = 0
    enter: Callable | None = None
    reduce: Callable | None = None
    mean: Callable | None = None


def expert_hooks(mesh) -> ExpertHooks:
    """The ``ExpertHooks`` of this rank of a ``make_moe_mesh`` mesh."""
    from .distributed import axis_hooks, group_mean

    enter, reduce = axis_hooks(mesh, "expert")
    mean = None
    if _mesh_axis(mesh, "data")[0] > 1:
        group = mesh.get_group("data")

        def mean(t):
            return group_mean(t, group)

    return ExpertHooks(index=_mesh_axis(mesh, "expert")[1], enter=enter, reduce=reduce,
                       mean=mean)


def moe_ffn(params: dict, x: torch.Tensor, moe: MoEConfig,
            hooks: ExpertHooks | None = None):
    """Top-1 MoE FFN.  x: ``[batch, seq, d_model]`` -> (y, aux_loss).

    Dense dispatch: gather and scatter are two einsums against one-hot
    masks, so the per-expert batch ``[E, batch, C, d]`` is a static-shape
    tensor.  ``params`` holds the whole router and this rank's experts;
    ``hooks`` (None: one device, every expert) says which and sums the
    partial products and cotangents over the expert group."""
    h = ExpertHooks() if hooks is None else hooks
    _, seq, _ = x.shape
    n_experts = params["router"].shape[1]
    cap = expert_capacity(seq, n_experts, moe.capacity_factor)

    # Route in float32: tiny tensors, and argmax/softmax stability matters.
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)  # [b, s, E]
    expert_idx = torch.argmax(probs, dim=-1)  # [b, s], the first of a tie
    gate = torch.amax(probs, dim=-1)  # [b, s]

    onehot = F.one_hot(expert_idx, n_experts).float()  # [b, s, E]
    # Position of each token within its expert's buffer (first-come order
    # along the sequence), and the capacity cut.
    pos = torch.cumsum(onehot, dim=1) * onehot - 1.0  # -1 if not routed
    kept = (pos >= 0) & (pos < cap)
    # jax.nn.one_hot gives a zero row where pos is -1 or >= cap; F.one_hot
    # raises there, so those rows take slot 0 and the mask zeroes them.
    dispatch = F.one_hot(torch.where(kept, pos, 0.0).long(), cap).float() * kept[..., None]
    # dispatch: [b, s, E, C], 1 where token (b, s) occupies slot (e, c).

    # Load-balancing aux loss (GShard eq. 4): E * sum_e fraction_e * gatemass_e,
    # each a mean over the global batch.
    fraction = onehot.mean(dim=(0, 1))
    gate_mass = probs.mean(dim=(0, 1))
    if h.mean is not None:
        fraction, gate_mass = h.mean(torch.stack([fraction, gate_mass])).unbind(0)
    aux = moe.aux_loss_weight * n_experts * torch.sum(fraction * gate_mass)

    # This rank's experts: its block of the dispatch and combine masks.
    n_local = params["w_up"].shape[0]
    lo = h.index * n_local
    dispatch = dispatch[:, :, lo:lo + n_local]
    gate_in = gate if h.enter is None else h.enter(gate)
    combine = dispatch * gate_in[..., None, None]
    compute_dtype = x.dtype
    x_in = x if h.enter is None else h.enter(x)
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(compute_dtype), x_in)
    hidden = _gelu_tanh(torch.einsum(
        "ebcd,edf->ebcf", expert_in, params["w_up"].to(compute_dtype)))
    expert_out = torch.einsum("ebcf,efd->ebcd", hidden, params["w_down"].to(compute_dtype))
    y = torch.einsum("bsec,ebcd->bsd", combine.to(compute_dtype), expert_out)
    return (y if h.reduce is None else h.reduce(y)), aux


def init_moe_model_params(config: ModelConfig, moe: MoEConfig, key: torch.Tensor) -> dict:
    """The model with its dense FFN swapped for MoE.  Router and expert
    weights come from a fresh stream, ``split(fold_in(key, 1), n_layers)``
    as in the JAX package: splitting ``key`` again would replay the keys
    ``init_params`` consumed."""
    params = init_params(config, key)
    keys = prng.split(prng.fold_in(key, 1), config.n_layers)
    for i, layer in enumerate(params["layers"]):
        del layer["w_up"], layer["w_down"]
        layer["moe"] = init_moe_ffn_params(keys[i], config.d_model, config.d_ff,
                                           moe.n_experts)
    return params


def moe_param_specs(config: ModelConfig) -> dict:
    """Attention keeps the Megatron ``"model"`` cut; experts cut on ``"expert"``."""
    specs = param_specs(config)
    for layer in specs["layers"]:
        del layer["w_up"], layer["w_down"]
        layer["moe"] = moe_ffn_specs()
    return specs


def moe_forward(params: dict, tokens: torch.Tensor, config: ModelConfig, moe: MoEConfig,
                mesh=None, hooks: ExpertHooks | None = None):
    """Logits + total aux loss for the MoE transformer.  With a ``mesh``
    (``make_moe_mesh``), this rank's ``moe_param_specs`` cut: attention
    through the model axis' hooks, the FFN through ``expert_hooks(mesh)``
    (or ``hooks``)."""
    from .distributed import model_hooks

    enter, reduce = (None, None) if mesh is None else model_hooks(mesh)
    if hooks is None and mesh is not None:
        hooks = expert_hooks(mesh)
    x = params["embed"].to(config.dtype)[tokens.long()]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params["layers"]):
        x = x + _attention(_rmsnorm(x, layer["ln1"]), layer, config, None, reduce, enter, i)
        ffn_out, aux = moe_ffn(layer["moe"], _rmsnorm(x, layer["ln2"]), moe, hooks)
        x = x + ffn_out
        aux_total = aux_total + aux
    return x.float() @ weight(params["unembed"], torch.float32), aux_total


def moe_loss_fn(params: dict, tokens: torch.Tensor, config: ModelConfig, moe: MoEConfig,
                mesh=None, hooks: ExpertHooks | None = None) -> torch.Tensor:
    """Causal LM cross-entropy + router load-balancing loss."""
    logits, aux = moe_forward(params, tokens[:, :-1], config, moe, mesh, hooks)
    return cross_entropy(logits, tokens[:, 1:]) + aux


def make_moe_mesh(n_devices: int, expert_parallel: int = 2, model_parallel: int = 1,
                  device_type: str | None = None):
    """A ``("data", "expert", "model")`` mesh over the first ``n_devices``
    ranks of the initialised world: dp x ep x tp.  ``device_type`` None
    means ``cuda``; pass ``"cpu"`` for a CPU world."""
    from .train import _data_led_mesh

    return _data_led_mesh(n_devices, {"expert": expert_parallel, "model": model_parallel},
                          device_type, divisor="ep*tp")


def make_moe_train_state(config: ModelConfig, moe: MoEConfig, mesh, seed: int = 0,
                         optimizer=None):
    """((params, opt_state), optimizer): this rank's cut of
    ``init_moe_model_params`` from ``PRNGKey(seed)`` on the mesh's
    device by ``moe_param_specs`` (default optimizer ``AdamW()``)."""
    from .distributed import mesh_device
    from .train import make_sharded_train_state

    device = mesh_device(mesh)
    return make_sharded_train_state(
        mesh,
        lambda: init_moe_model_params(config, moe, prng.PRNGKey(seed, device=device)),
        moe_param_specs(config),
        optimizer,
    )


def make_moe_train_step(config: ModelConfig, moe: MoEConfig, mesh, optimizer):
    """The full dp x ep x tp training step: forward (attention tensor-
    parallel, FFN expert-parallel), backward, AdamW update
    (``train.make_sharded_train_step``; ``mesh=None`` is one device)."""
    from .train import make_sharded_train_step

    return make_sharded_train_step(
        lambda p, t: moe_loss_fn(p, t, config, moe, mesh), mesh, optimizer
    )


# ---- the serving expert layer: dropless top-k SwiGLU -------------------


def route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """(gates [n, top_k] in x's dtype, experts [n, top_k] int64) of x [n,
    d]: float32 logits and softmax, the ``top_k`` largest, divided by
    their sum (HF's ``norm_topk_prob``)."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    top, experts = torch.topk(probs, top_k, dim=-1)
    return (top / top.sum(dim=-1, keepdim=True)).to(x.dtype), experts


def grouped_swiglu_reference(x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor,
                             offs: torch.Tensor) -> torch.Tensor:
    """``grouped_swiglu`` as a loop over the experts: rows ``offs[e-1] ..
    offs[e] - 1`` of x through expert e's ``down(silu(x W_gate) * (x
    W_up))``.  Reads ``offs`` on the host."""
    f = w_down.shape[1]
    out = x.new_zeros(x.shape[0], w_down.shape[2])
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            h = x[start:end] @ w_gate_up[e]
            out[start:end] = (F.silu(h[:, :f]) * h[:, f:]) @ w_down[e]
        start = end
    return out


def grouped_swiglu(x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its rows of x [R, d], the rows sorted by
    expert with ``offs`` [E] int32 the cumulative ends: [R, d].  On the
    card two grouped products (``torch._grouped_mm``, bf16) read each
    expert's weights once and take ``offs`` on the device; on the CPU
    the loop of ``grouped_swiglu_reference``."""
    if x.device.type == "cpu":
        return grouped_swiglu_reference(x, w_gate_up, w_down, offs)
    if x.dtype != torch.bfloat16 or w_gate_up.dtype != torch.bfloat16:
        raise ValueError(
            f"the grouped expert product on the card takes bf16, got {x.dtype} "
            f"rows and {w_gate_up.dtype} weights"
        )
    f = w_down.shape[1]
    h = torch._grouped_mm(x, w_gate_up, offs=offs)
    a = F.silu(h[:, :f]) * h[:, f:]
    del h
    return torch._grouped_mm(a, w_down, offs=offs)


def expert_ffn(x: torch.Tensor, params: dict, config: ModelConfig,
               offs_out: list | None = None) -> torch.Tensor:
    """The dropless top-k SwiGLU expert layer over x [..., d] (``params``
    a layer's ``moe`` leaves): route every token, sort its
    ``experts_per_token`` (token, expert) rows by expert (stable, so a
    run's order is fixed), one ``grouped_swiglu`` over them, back to
    token order, and each token's gate-weighted sum (one product a token,
    accumulated in float32).  ``offs_out`` (None: not kept), a list,
    gains the call's ``offs``: each expert's cumulative end of rows."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    n, k = x2.shape[0], config.experts_per_token
    with record_function("moe.route"):
        gates, experts = route(x2, params["router"], k)
        sorted_experts, order = torch.sort(experts.reshape(-1), stable=True)
        ids = torch.arange(config.n_routed_experts, device=x.device)
        offs = torch.searchsorted(sorted_experts, ids, right=True).to(torch.int32)
        if offs_out is not None:
            offs_out.append(offs)
    with record_function("moe.experts"):
        y_sorted = grouped_swiglu(x2[order // k], params["w_gate_up"], params["w_down"],
                                  offs)
        y = torch.empty_like(y_sorted)
        y[order] = y_sorted
        out = torch.bmm(gates[:, None, :], y.view(n, k, -1))[:, 0]
    return out.reshape(shape)


def ffn(x: torch.Tensor, layer: dict, config: ModelConfig, reduce=None,
        offs_out: list | None = None) -> torch.Tensor:
    """A layer's feed-forward block on the serving paths: the expert
    layer where the config has experts (``offs_out`` as ``expert_ffn``'s),
    else the dense MLP (``reduce`` as ``model._mlp``'s)."""
    if config.n_routed_experts:
        return expert_ffn(x, layer["moe"], config, offs_out)
    return _mlp(x, layer, reduce)
