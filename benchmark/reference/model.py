"""The port's decoder in float32, layer by layer: logits for serving,
the causal-LM loss and its gradients for training, and an AdamW step.

``params`` is the benchmark's tree (``weights.make_params``) in any
dtype: each layer is read in float32 when it runs, so the whole model is
never held twice.  ``cfg`` is a configuration file's dict.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def highest_precision() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (amax to the
    format's largest value), back in float32."""
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with every operand of the product and of its two gradient
    products rounded to float8 first (``b`` a matrix, or batched like
    ``a``)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g)
        grad_a = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            grad_b = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        else:
            grad_b = qa.transpose(-1, -2) @ qg
        return grad_a, grad_b


def matmul(a: torch.Tensor, b: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b) if fp8 else a @ b


def rmsnorm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6) * gain


def rope(x: torch.Tensor, positions: torch.Tensor, base: float) -> torch.Tensor:
    """Rotate [batch, seq, heads, hd] by position, the two halves of each
    head as the real and imaginary parts."""
    half = x.shape[-1] // 2
    freqs = 1.0 / base ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions.float()[:, None] * freqs[None, :]
    cos, sin = torch.cos(angles)[None, :, None, :], torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def block(x: torch.Tensor, layer: dict, cfg: dict, fp8: bool = False) -> torch.Tensor:
    """One layer over [batch, seq, d] at positions 0 .. seq-1, causal."""
    batch, seq, d = x.shape
    heads = cfg["num_attention_heads"]
    hd = d // heads
    f = {k: v.float() for k, v in layer.items()}

    def project(h, w):  # [b, s, d] by [d, ...] -> [b, s, ...]
        return matmul(h, w.reshape(d, -1), fp8).reshape(batch, seq, *w.shape[1:])

    h = rmsnorm(x, f["ln1"])
    if "wqkv" in f:
        qkv = project(h, f["wqkv"])
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:  # grouped-query: each kv head serves heads // kv_heads query heads
        q, kv = project(h, f["wq"]), project(h, f["wkv"])
        k, v = (t.repeat_interleave(heads // t.shape[2], dim=2) for t in (kv[:, :, 0], kv[:, :, 1]))
    positions = torch.arange(seq, device=x.device)
    base = float(cfg.get("rotary_emb_base", 10000))
    q, k = rope(q, positions, base), rope(k, positions, base)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [b, heads, s, hd]
    scores = matmul(q, k.transpose(-1, -2), fp8) / math.sqrt(hd)
    causal = torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril()
    window = cfg.get("sliding_window")
    if window is not None:
        causal &= ~torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril(-window)
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    attn = matmul(probs, v, fp8).transpose(1, 2).reshape(batch, seq, d)
    x = x + matmul(attn, f["wo"].reshape(d, d), fp8)
    h = rmsnorm(x, f["ln2"])
    up = gelu_tanh(matmul(h, f["w_up"], fp8))
    return x + matmul(up, f["w_down"], fp8)


def hidden(params: dict, tokens: torch.Tensor, cfg: dict, fp8: bool = False) -> torch.Tensor:
    """The last layer's output, [batch, seq, d] float32.  Under autograd
    the float8 control recomputes each layer in the backward pass, since
    its rounded copies would add to what a layer keeps."""
    x = params["embed"].float()[tokens]
    for layer in params["layers"]:
        if fp8 and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(block, x, layer, cfg, fp8, use_reentrant=False)
        else:
            x = block(x, layer, cfg, fp8)
    return x


def unembed(params: dict, h: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    return matmul(h, params["unembed"].float(), fp8)


@torch.no_grad()
def served_logits(params: dict, prompt: list[int], served: list[int], cfg: dict,
                  device, fp8: bool = False) -> torch.Tensor:
    """[len(served), vocab] float32 logits at the positions that chose each
    served token: the whole sequence in one causal pass (the prompt, then
    every served token but the last)."""
    seq = torch.tensor(prompt + served[:-1], dtype=torch.int64, device=device)[None]
    h = hidden(params, seq, cfg, fp8)[0, len(prompt) - 1:]
    return unembed(params, h, fp8)


def widest_gap(ref_logits: torch.Tensor, chosen: torch.Tensor) -> float:
    """The widest gap by which a chosen token's reference logit lies below
    the reference's best at its position."""
    best = ref_logits.max(dim=-1).values
    return float((best - ref_logits.gather(-1, chosen[:, None])[:, 0]).max())


def row_loss(params: dict, row: torch.Tensor, cfg: dict, fp8: bool = False) -> torch.Tensor:
    """Mean next-token NLL of one row [seq + 1]."""
    h = hidden(params, row[None, :-1], cfg, fp8)
    logits = unembed(params, h, fp8)[0]
    return torch.nn.functional.cross_entropy(logits, row[1:])


def loss_and_grads(params: dict, batch: torch.Tensor, cfg: dict, leaves: list,
                   fp8: bool = False, rows: list[int] | None = None):
    """(mean loss, gradients) of the batch's mean NLL over float32
    ``leaves``, a row at a time so that one row's activations are held at
    once.  ``rows`` picks the rows the mean is over (all by default)."""
    rows = list(range(batch.shape[0])) if rows is None else rows
    grads = [torch.zeros_like(p) for p in leaves]
    total = 0.0
    for r in rows:
        loss = row_loss(params, batch[r], cfg, fp8) / len(rows)
        for acc, g in zip(grads, torch.autograd.grad(loss, leaves)):
            acc += g
        total += float(loss.detach())
    return total, grads


class AdamW:
    """optax.adamw's update in float32: scale_by_adam, add the decayed
    weights, scale by -lr.  (The port stores the first moment in
    bfloat16; here it is float32.)"""

    def __init__(self, leaves: list, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, leaves: list, grads: list) -> None:
        self.count += 1
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        for p, g, mu, nu in zip(leaves, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * g * g)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.wd * p
            p.add_(-self.lr * update)
