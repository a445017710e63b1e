"""LM continuous batching (the reference's ``serving/engine.py::Engine``).

``max_batch`` decode slots; requests are prefilled (cache seeded at prompt
length, right-padded to the decode budget) and inserted into free slots;
every step decodes ALL active slots in one batched ``decode_step`` call;
finished sequences free their slot for the next queued request.

As in the reference, the batched cache has one shared ``index``: installing
a prompt sets it to the largest slot position seen (``_install``), and a
shorter slot attends over its zero-padded positions.  This approximation is
kept so that the tokens equal the reference's.

Prefill and decode steps run under ``torch.inference_mode()``: serving
records no autograd graph (``models.forward`` is differentiable, and the
kernels refuse inputs that require grad in grad mode).

The engine also keeps its own clock: ``prefill_seconds`` and
``decode_seconds`` (host time of each call up to its sampled tokens on the
host, which waits for the device), ``decode_steps`` and ``decode_tokens``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers.attention import KVCache
from repro_torch.models import decode_step, init_cache, prefill


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        *,
        max_batch: int = 4,
        max_len: int = 256,
        sampler: Optional[Callable] = None,
        device="cuda",
    ):
        if cfg.encoder_only:
            raise ValueError("encoder-only architectures cannot be served")
        if cfg.attn_impl != "xla":
            raise ValueError(
                f"attn_impl={cfg.attn_impl!r} cannot seed a decode cache; serve with "
                "attn_impl='xla' (the flash kernel is for full-sequence forward)"
            )
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.sampler = sampler or (lambda logits: torch.argmax(logits, dim=-1))

        self.cache = init_cache(cfg, max_batch, max_len, device=self.device)
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)       # next write index
        self.slot_budget = np.zeros(max_batch, np.int32)
        self.last_token = np.zeros(max_batch, np.int32)
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.decode_steps = 0
        self.decode_tokens = 0

    # -- API -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Process until queue + slots drain (or step budget)."""
        for _ in range(max_steps):
            self._admit()
            if not any(s is not None for s in self.slots):
                if not self.queue:
                    break
                continue
            self._step()
        return self.completed

    # -- internals ---------------------------------------------------------

    @torch.inference_mode()
    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            s = len(req.prompt)
            t0 = time.perf_counter()
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :], device=self.device)
            logits, pcache = prefill(self.params, {"tokens": tokens}, self.cfg)
            tok = int(self.sampler(logits)[0])
            self.prefill_seconds += time.perf_counter() - t0
            req.output.append(tok)
            # EOS / budget may already hit on the prefill-sampled token
            if (req.eos_id is not None and tok == req.eos_id) or req.max_new_tokens <= 1:
                req.done = True
                self.completed.append(req)
                continue
            self._install(slot, pcache, s)
            self.slots[slot] = req
            self.slot_pos[slot] = s
            self.slot_budget[slot] = req.max_new_tokens - 1
            self.last_token[slot] = tok

    def _install(self, slot: int, pcache: KVCache, prompt_len: int) -> None:
        """Copy a prefilled (batch=1, len=S) cache into the slot axis of the
        batched cache, zero-filling the sequence axis up to max_len."""
        for dst, src in ((self.cache.k, pcache.k), (self.cache.v, pcache.v)):
            dst[:, slot].zero_()
            dst[:, slot, : src.shape[2]] = src[:, 0].to(dst.dtype)
        # one index for every slot: the largest position (see module doc)
        self.cache = _set_index(self.cache, int(max(self.slot_pos.max(), prompt_len)))

    @torch.inference_mode()
    def _step(self) -> None:
        t0 = time.perf_counter()
        tokens = torch.as_tensor(self.last_token.astype(np.int64), device=self.device)
        logits, self.cache = decode_step(self.params, tokens, self.cache, self.cfg)
        next_tok = self.sampler(logits).cpu().numpy()
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += 1
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self.decode_tokens += 1
            tok = int(next_tok[slot])
            req.output.append(tok)
            self.slot_pos[slot] += 1
            self.slot_budget[slot] -= 1
            if (req.eos_id is not None and tok == req.eos_id) or (
                self.slot_budget[slot] <= 0 or self.slot_pos[slot] >= self.max_len - 1
            ):
                req.done = True
                self.completed.append(req)
                self.slots[slot] = None


def _set_index(cache: KVCache, value: int) -> KVCache:
    return dataclasses.replace(cache, index=int(value))
