"""Fused attention with the online softmax: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (source: ``csrc/flash_attention.cu``).  q, k, v are
(BH, S, D) of one type, float32 or bf16 (batch and heads flattened by the
caller, as ``layers/attention.py::_flash_full`` does); the result is
(BH, S, D) in q's type.  Scores are float32, the probabilities are rounded
to v's type before the PV product, and the output is ``acc / max(l, 1e-30)``
— the reference kernel's roundings.  Any S and D from 1 to 128 are taken;
the reference's block-divides-S rule does not apply.

A CPU tensor runs :func:`flash_attention_plain`; a CUDA tensor launches one
of three kernels, chosen by :func:`route` from the type, the head dim and
the operands' alignment:

* ``"tma"``: bf16 with D a multiple of 8 and 16-byte aligned operands (the
  model's path): wgmma fed by TMA;
* ``"wmma"``: any other bf16 input (D % 8 != 0, or a misaligned operand);
* ``"f32"``: float32, on the CUDA cores.

Each launch is counted in ``flash_attention.launches``, by route in
``flash_attention.launches_by_route`` and by mask (``"causal"`` or
``"full"``) in ``flash_attention.launches_by_mask``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import kernels as costs, ops as op_counts

_P = ctypes.c_void_p
_I = ctypes.c_int
# One C entry point per route.
_ENTRY = {
    "tma": "flash_attention_bf16_tma",
    "wmma": "flash_attention_bf16",
    "f32": "flash_attention_f32",
}
_SIGNATURES = {name: ([_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P], _I) for name in _ENTRY.values()}
MAX_HEAD_DIM = 128
_MAX_BH = 65535  # grid.y of the wmma and f32 kernels
_TMA_ALIGN = 16  # bytes: TMA's rule for a tensor's base address


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a CUDA launch on these (contiguous) operands takes:
    ``"tma"``, ``"wmma"`` or ``"f32"``.  Pure: it reads dtype, head dim and
    ``data_ptr`` only, so it can be asked on any device."""
    if q.dtype == torch.float32:
        return "f32"
    d = q.shape[-1]
    if d % 8 == 0 and all(t.data_ptr() % _TMA_ALIGN == 0 for t in (q, k, v)):
        return "tma"
    return "wmma"


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with all keys in one tile."""
    s_len, d = q.shape[-2:]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones((s_len, s_len), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    live = torch.isfinite(m)
    p = torch.where(live, torch.exp(s - torch.where(live, m, 0.0)), 0.0)
    l = p.sum(-1, keepdim=True)
    acc = p.to(v.dtype).float() @ v.float()
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Fused attention.  q/k/v: (BH, S, D); returns (BH, S, D) in q.dtype."""
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (BH, S, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    bh, s_len, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, got {q.device}")
    _build.refuse_grad("flash_attention", q, k, v)
    if not 1 <= d <= MAX_HEAD_DIM or bh > _MAX_BH:
        raise ValueError(f"head dim {d} (1..{MAX_HEAD_DIM}) or BH={bh} beyond the kernel")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if bh == 0 or s_len == 0:
        return out
    path = route(q, k, v)
    lib = _build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = getattr(lib, _ENTRY[path])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s_len, d,
            float(scale), int(causal), _build.stream_of(q),
        )
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    op_counts.charge("flash_attention", costs.flash_attention, bh, s_len, d, causal)
    flash_attention.launches_by_route[path] += 1
    flash_attention.launches_by_mask["causal" if causal else "full"] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(_ENTRY, 0)
flash_attention.launches_by_mask = {"causal": 0, "full": 0}
