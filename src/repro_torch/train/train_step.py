"""Training step: loss, gradient accumulation (microbatching), optimizer
(the reference's ``train/train_step.py``).

Microbatching splits the global batch into ``k`` sequential slices and
accumulates their gradients in float32, in the reference's order, then
scales the sum by 1/k: the activation working set shrinks k-fold.
Gradients come from ``torch.autograd.grad`` over the parameter leaves.  The
reference's ``mesh`` arguments and the sharding constraint it puts on each
microbatch have no meaning on one card, so they are gone.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward
from repro_torch.optim.adamw import AdamW


def loss_fn(params: dict, batch: dict, cfg: ModelConfig):
    """Next-token (or masked-frame) cross entropy plus the model's aux loss.
    labels < 0 are masked; a VLM's logits over its patches are dropped.
    Returns (loss, {"loss": token loss, "aux": aux})."""
    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"]
    if cfg.input_mode == "tokens+patches":
        logits = logits[:, cfg.num_patches:, :]  # text positions only
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    token_loss = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return token_loss + aux, {"loss": token_loss, "aux": aux}


def _grads(params: dict, batch: dict, cfg: ModelConfig):
    """(gradients of ``loss_fn`` for every leaf of ``params``, as the
    leaves' dtypes, in their tree; the metrics, detached).  A leaf the loss
    does not reach gets zeros, as ``jax.grad`` gives it."""
    leaves = tree.leaves(params)
    if not all(t.is_floating_point() for t in leaves):
        raise ValueError(
            f"{cfg.name}: integer parameter leaves cannot be trained ({cfg.quant.mode} stores packed "
            "sign words); train in bnn_weight_only or bnn_xnor"
        )
    wrt = [t.detach().requires_grad_(True) for t in leaves]
    loss, metrics = loss_fn(tree.unflatten(params, wrt), batch, cfg)
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return tree.unflatten(params, grads), {k: v.detach() for k, v in metrics.items()}


def _accumulate_grads(params: dict, batch: dict, cfg: ModelConfig, microbatches: int):
    """(gradients, metrics) of the whole batch: one pass, or the mean of
    ``microbatches`` slices of its leading axis, summed in float32 into one
    accumulator, in place."""
    if microbatches <= 1:
        return _grads(params, batch, cfg)
    b = next(iter(batch.values())).shape[0]
    slices = {k: v.reshape(microbatches, b // microbatches, *v.shape[1:]) for k, v in batch.items()}
    acc = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    dev = tree.leaves(params)[0].device
    msum = {"loss": torch.zeros((), device=dev), "aux": torch.zeros((), device=dev)}
    for i in range(microbatches):
        grads, metrics = _grads(params, {k: v[i] for k, v in slices.items()}, cfg)
        acc = tree.map(lambda a, g: a.add_(g.float()), acc, grads)
        msum = {k: msum[k] + metrics[k] for k in msum}
        del grads
    inv = 1.0 / microbatches
    return tree.map(lambda g: g.mul_(inv), acc), {k: m * inv for k, m in msum.items()}


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *, microbatches: int = 1):
    """(params, opt_state, batch) -> (params', state', metrics).

    The optimizer steps in place (``AdamW.update_``): the returned params
    and state are the given tensors, updated, so a full-width model's step
    holds one copy of its state."""

    def train_step(params, opt_state, batch):
        grads, metrics = _accumulate_grads(params, batch, cfg, microbatches)
        params, opt_state, opt_metrics = optimizer.update_(grads, opt_state, params)
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step
