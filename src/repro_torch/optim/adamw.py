"""AdamW on trees of tensors, with the reference's exact update
(``repro/optim/adamw.py``): global-norm clipping, bias corrections, ``eps``
outside the square root, decoupled weight decay, moments in
``moment_dtype``, and an optional float32 master copy of low-precision
parameters.

This is not ``torch.optim.AdamW``: that one has no global-norm clip, and its
state is not the reference's.  Here the state is a value
(:class:`AdamWState`) whose ``m``, ``v`` and ``master`` mirror the
parameter tree (lists and dicts of tensors), and :meth:`AdamW.update`
returns new parameters and a new state without touching its inputs, so a
checkpoint of the state lines up with the reference's leaf for leaf.
:meth:`AdamW.update_` writes the same results over its inputs, leaf by
leaf (the LM trainer's step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any
    v: Any
    master: Any  # f32 master params ((0,) leaves when use_master is off)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32   # bf16 moments fit the largest models
    use_master: bool = True                     # f32 master copy of bf16 params

    def init(self, params: Any) -> AdamWState:
        zeros = tree.map(lambda p: torch.zeros(p.shape, dtype=self.moment_dtype, device=p.device),
                         params)
        if self.use_master:
            master = tree.map(lambda p: p.detach().float().clone(), params)
        else:
            master = tree.map(lambda p: torch.zeros((0,), dtype=torch.float32, device=p.device),
                              params)
        step = torch.zeros((), dtype=torch.int32, device=tree.leaves(params)[0].device)
        return AdamWState(step, zeros, tree.map(torch.clone, zeros), master)

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    def _coefficients(self, grads: Any, state: AdamWState):
        """The step's shared numbers: (grad norm, clip scale, step, lr, b1c, b2c)."""
        gnorm = global_norm(grads)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-12), max=1.0)
        step = state.step + 1
        lr = self._lr(step)
        stepf = step.float()
        b1c = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32, device=step.device), stepf)
        b2c = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32, device=step.device), stepf)
        return gnorm, scale, step, lr, b1c, b2c

    def _leaf(self, g, m, v, master, p, scale, lr, b1c, b2c):
        """One leaf's update: (new param, new m, new v, new master)."""
        g = g.float() * scale
        mf = self.b1 * m.float() + (1 - self.b1) * g
        vf = self.b2 * v.float() + (1 - self.b2) * torch.square(g)
        upd = (mf / b1c) / (torch.sqrt(vf / b2c) + self.eps)
        ref = master if self.use_master else p.float()
        new_ref = ref - lr * (upd + self.weight_decay * ref)
        new_master = new_ref if self.use_master else master
        return (
            new_ref.to(p.dtype),
            mf.to(self.moment_dtype),
            vf.to(self.moment_dtype),
            new_master,
        )

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any):
        """Returns (new_params, new_state, metrics)."""
        gnorm, scale, step, lr, b1c, b2c = self._coefficients(grads, state)
        trees = (grads, state.m, state.v, state.master, params)
        out = [self._leaf(*a, scale, lr, b1c, b2c) for a in zip(*map(tree.leaves, trees))]
        parts = [tree.unflatten(params, [o[i] for o in out]) for i in range(4)]
        metrics = {"grad_norm": gnorm, "lr": lr}
        return parts[0], AdamWState(step, *parts[1:]), metrics

    @torch.no_grad()
    def update_(self, grads: Any, state: AdamWState, params: Any):
        """:meth:`update` in place: each leaf's new parameter, moments and
        master are computed by the same arithmetic and written over the old
        tensors before the next leaf, so the step holds one leaf's
        temporaries beside the state, never a second copy of it (the LM
        trainer's step: a full-width model's state fills most of one card).
        Returns (params, state with the new step, metrics), the same
        tensors as given; the results are the bits ``update`` returns."""
        gnorm, scale, step, lr, b1c, b2c = self._coefficients(grads, state)
        trees = (grads, state.m, state.v, state.master, params)
        for g, m, v, master, p in zip(*map(tree.leaves, trees)):
            new_p, new_m, new_v, new_master = self._leaf(g, m, v, master, p, scale, lr, b1c, b2c)
            m.copy_(new_m)
            v.copy_(new_v)
            if self.use_master:
                master.copy_(new_master)
            p.copy_(new_p)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return params, AdamWState(step, state.m, state.v, state.master), metrics


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32."""
    sums = [torch.sum(torch.square(x.float())) for x in tree.leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor * peak`` at ``total``: a function of the step tensor."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak * step / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return fn
