"""Mixture-of-Experts FFN (the reference's ``layers/moe.py``), on one GPU.

Routing takes the top-k of float32 router logits (the router stays float32
whatever the model's type, as in the reference); tokens are dispatched into
per-expert capacity buffers of ``C = max(1, ceil(T * k / E *
capacity_factor))`` slots, slots over capacity are dropped (they contribute
zero), the experts run as one batched SwiGLU, and the kept slots are
combined with their gates.

With packed experts (``bnn_packed`` with ``"moe"`` in the quant targets)
each of the three batched contractions is two launches on a GPU: the
bit-pack kernel packs the (E * C, K) activations' signs, and
``bnn_matmul_packed_experts`` contracts them with the (E, O, Kw) expert
words (XNOR + popcount, the reference's jnp ``_packed_expert_mm``).

The reference also shards the experts over a mesh's ``model`` axis
(``_moe_shard_map``: expert parallelism with a ``psum`` of partial
outputs).  That has no meaning on one GPU: :func:`moe_apply` takes no
``mesh`` and runs the reference's single-device path, every expert local.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bnn_matmul import bnn_matmul_packed_experts
from repro_torch.layers.ffn import ffn_apply, ffn_init
from repro_torch.layers.linear import dense_init


def _pack_experts(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, out, in) latent -> ((E, out, ceil(in/32)) int32 word views,
    (E, out) float32 alpha).  Signs by ``bitops.sign_bit`` (``x >= 0`` as
    the reference computes it, subnormals flushed)."""
    e, o, i = w.shape
    packed = kops._pack_rows(w.reshape(e * o, i)).reshape(e, o, -1)
    return packed, w.abs().mean(-1)


def moe_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> dict:
    """Router (float32, (E, d)), the routed experts' ``w_gate``/``w_up``
    (E, f, d) and ``w_down`` (E, d, f) — packed {"packed", "alpha"} when the
    quantization packs ``"moe"`` — and a SwiGLU ``"shared"`` FFN of
    ``num_shared * f`` when the model has shared experts."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_ffn_dim, m.num_experts
    std = cfg.init_std
    packed = cfg.quant.packed and "moe" in cfg.quant.targets

    def experts(out: int, inn: int):
        w = torch.randn((e, out, inn), generator=generator, device=generator.device).mul_(std)
        if packed:
            pw, alpha = _pack_experts(w)
            return {"packed": pw, "alpha": alpha}
        return w.to(dtype)

    p = {
        "router": dense_init(generator, d, e, std=std, dtype=torch.float32),
        "w_gate": experts(f, d),
        "w_up": experts(f, d),
        "w_down": experts(d, f),
    }
    if m.num_shared:
        p["shared"] = ffn_init(generator, d, m.num_shared * f, "swiglu", std=std, dtype=dtype,
                               quant=cfg.quant)
    return p


def _top_k(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, equal values in
    ascending index order (``torch.topk`` promises no order among ties, so a
    stable descending sort picks them)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params: dict, x2: torch.Tensor, cfg: ModelConfig):
    """x2: (T, d) -> (idx (T, K), gates (T, K) float32, aux loss)."""
    m = cfg.moe
    logits = x2.float() @ params["router"]["w"].T.float()
    probs = torch.softmax(logits, dim=-1)
    top_vals, idx = _top_k(logits, m.top_k)
    gates = torch.softmax(top_vals, dim=-1)

    # Switch-style load-balance loss + router z-loss.
    e = m.num_experts
    me = probs.mean(0)                                              # (E,)
    assign = F.one_hot(idx, e).float().sum(1)                       # (T, E)
    ce = assign.mean(0) / m.top_k
    aux = e * torch.sum(me * ce) * m.aux_loss
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_loss
    return idx, gates, aux + z


def _packed_expert_mm(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Batched XNOR-popcount contraction against packed expert weights.

    x: (E, C, K) real; w["packed"]: (E, O, Kw) int32 views; -> (E, C, O) in
    x.dtype: ``dot * alpha * beta`` in float32, beta each row's mean |x|
    (as ``layers/linear.py::_packed_apply`` for one matrix).
    """
    e, c, k = x.shape
    beta = x.float().abs().mean(-1, keepdim=True)
    xp = kops._pack_rows(x.reshape(e * c, k)).reshape(e, c, -1)
    dot = bnn_matmul_packed_experts(xp, w["packed"], k_bits=k).float()
    return (dot * w["alpha"][:, None, :] * beta).to(x.dtype)


def _expert_compute(
    x2: torch.Tensor,
    idx: torch.Tensor,
    gates: torch.Tensor,
    w_gate,
    w_up,
    w_down,
    *,
    num_experts: int,
    capacity: int,
) -> torch.Tensor:
    """Capacity dispatch -> batched expert SwiGLU -> combine.

    x2: (T, d); idx/gates: (T, K); w_*: (E, ...), every expert local (the
    reference's ``e_lo = 0``).  Returns (T, d).  Slots are ordered token by
    token, then by k; a slot's position in its expert's buffer counts the
    earlier slots routed to that expert, and slots at ``capacity`` or beyond
    are dropped.  Kept slots have distinct buffer rows; a dropped one adds
    zero to row 0, as the reference's scatter-add does.
    """
    t, d = x2.shape
    k = idx.shape[1]
    dtype = x2.dtype

    slot_expert = idx.reshape(-1)                       # (T*K,) expert id per slot
    slot_gate = gates.reshape(-1)
    slot_token = torch.arange(t, device=x2.device).repeat_interleave(k)

    onehot = F.one_hot(slot_expert, num_experts)
    pos = (onehot.cumsum(0) - 1).gather(1, slot_expert[:, None])[:, 0]
    keep = pos < capacity

    flat_idx = torch.where(keep, slot_expert * capacity + pos, 0)
    contrib = torch.where(keep[:, None], x2[slot_token], 0).to(dtype)
    buf = torch.zeros((num_experts * capacity, d), dtype=dtype, device=x2.device)
    buf = buf.index_add_(0, flat_idx, contrib).reshape(num_experts, capacity, d)

    if isinstance(w_gate, dict):  # N2Net packed experts (XNOR-popcount FFN)
        g = _packed_expert_mm(buf, w_gate)
        u = _packed_expert_mm(buf, w_up)
        h = F.silu(g.float()).to(dtype) * u
        down = _packed_expert_mm(h, w_down).to(dtype)
    else:
        g = torch.bmm(buf, w_gate.to(dtype).transpose(1, 2))
        u = torch.bmm(buf, w_up.to(dtype).transpose(1, 2))
        h = F.silu(g.float()).to(dtype) * u
        down = torch.bmm(h, w_down.to(dtype).transpose(1, 2))

    slot_out = down.reshape(num_experts * capacity, d)[flat_idx]
    slot_out = torch.where(keep[:, None], slot_out, 0)
    slot_out = slot_out * slot_gate[:, None].to(dtype)
    return slot_out.reshape(t, k, d).sum(1)


def capacity_of(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``tokens`` routed tokens (the reference's
    formula, in its order of operations)."""
    m = cfg.moe
    return max(1, math.ceil(tokens * m.top_k / m.num_experts * m.capacity_factor))


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN.  x: (B, S, d) -> (y, aux_loss).

    Takes no ``mesh``: the reference's expert-parallel ``_moe_shard_map``
    has no one-GPU meaning, so this is its single-device path.  Every token
    of the call is routed together, so a decode step's empty slots take
    capacity too (the reference's behaviour)."""
    m = cfg.moe
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    idx, gates, aux = _route(params, x2, cfg)
    y = _expert_compute(
        x2, idx, gates, params["w_gate"], params["w_up"], params["w_down"],
        num_experts=m.num_experts, capacity=capacity_of(x2.shape[0], cfg),
    )
    y = y.reshape(b, s, d)
    if m.num_shared:
        y = y + ffn_apply(params["shared"], x, cfg)
    return y, aux
