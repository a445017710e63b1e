"""Softmax attention over a whole prompt (prefill, and the forward of
serving and training): CUDA kernel + plain PyTorch version.

Replaces the jnp of the reference's ``layers/attention.py::
chunked_attention`` (source: ``csrc/chunked_attention.cu``).  q is
(B, S, H, Dqk), k (B, S, KVH, Dqk), v (B, S, KVH, Dv), all float32 or all
bf16, causal or full; query head h reads KV head h // (H // KVH).  Scores
are float32 sums times ``scale`` (or, with ``scores_dtype=bf16``, the sum
rounded to bf16, times bf16(scale), rounded again); the softmax is float32
with the row's final max and sum; p is rounded to q's type after it is
normalised, PV is summed in float32 and rounded to q's type.  ``q_chunk``
does not change the function: the kernel ignores it.

A CPU tensor runs :func:`chunked_attention_plain`; a CUDA tensor launches
the kernel or raises.  Two passes over the keys (the row's max and sum,
then p and PV), because p is rounded to bf16 after it is normalised with
the row's final max and sum.  What bounds it on the card: the tensor
cores' products (1.5 times the function's, for the second QK^T) and the
two exponentials a (query, key) pair on the exp2 unit.  Routes
(:func:`route`, a pure function of the operands):

* ``"tma"`` (bf16 with Dqk and Dv multiples of 8, Dqk <= 192, Dv <= 128,
  16-byte aligned operands and strides: every served prefill): one producer
  thread keeps TMA loads of K (and, in the second pass, V) tiles in flight
  into a ring of stages; two consumer warpgroups of 64 query rows run QK^T
  and PV on wgmma, the scores and P in registers, QK^T of the next tile on
  the tensor cores while the exponentials of this one run.  It reads the
  (B, S, heads, D) views as they are (no copy).
* ``"mma"`` (bf16 that TMA cannot take; the first design): mma.sync, cp.async
  copies (element copies for D % 8 != 0 or misaligned operands).
* ``"f32"`` (float32, CUDA cores).

Each launch is counted in ``chunked_attention.launches``, by route in
``launches_by_route`` and by mask (``"causal"``, ``"full"``) in
``launches_by_mask``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import kernels as costs, ops as op_counts

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ENTRY = {"tma": "chunked_attention_bf16_tma", "mma": "chunked_attention_bf16", "f32": "chunked_attention_f32"}
_SIGNATURES = {
    name: ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P], _I)
    for name in (_ENTRY["mma"], _ENTRY["f32"])
}
_SIGNATURES[_ENTRY["tma"]] = ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, *[_L] * 9, ctypes.c_float, _I, _I, _P],
                              _I)
MAX_HEAD_DIM = 256
TMA_MAX_DQK, TMA_MAX_DV = 192, 128   # csrc/chunked_attention.cu kMaxTmaDqk, kMaxTmaDv
TMA_QK_WIDTHS = (64, 96, 128, 192)   # Dqk padded to the QK product's depth
TMA_V_WIDTHS = (64, 96, 128)         # Dv padded to the PV product's N
TMA_BLOCK_ROWS, TMA_TILE_KEYS = 128, 128   # query rows a block, keys a tile (the TMA boxes' rows)
_MAX_GRID_YZ = 65535   # heads (grid.y) and batch (grid.z)
_ALIGN = 16


def grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, KVH, G, D), k: (B, Sk, KVH, D) -> (B, KVH, G, Sq, Sk) f32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())


def grouped_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, KVH, G, Sq, Sk), v: (B, Sk, KVH, D) -> (B, Sq, KVH, G, D) f32."""
    return torch.einsum("bhgqk,bkhd->bqhgd", p.float(), v.float())


def chunked_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, q_chunk: int,
    scale: float, scores_dtype=torch.float32,
) -> torch.Tensor:
    """Softmax attention over full K/V, looping over query chunks.

    q: (B, S, H, D); k, v: (B, S, KVH, D).  Returns (B, S, H, D).  Scores are
    float32 (or ``scores_dtype``); probabilities are rounded to q's type
    before the PV product, which sums in float32.
    """
    b, s, h, d = q.shape
    kvh = k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    q_chunk = min(q_chunk, s)
    kpos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for c0 in range(0, s, q_chunk):
        qc = q[:, c0:c0 + q_chunk]
        cq = qc.shape[1]
        scores = grouped_scores(qc.reshape(b, cq, kvh, g, d), k).to(scores_dtype)
        scores = scores * torch.tensor(scale, dtype=scores_dtype)
        if causal:
            qpos = c0 + torch.arange(cq, device=q.device)
            mask = kpos[None, :] <= qpos[:, None]                    # (Cq, Sk)
            scores = scores.masked_fill(~mask, float("-inf"))
        p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        outs.append(grouped_out(p, v).to(q.dtype).reshape(b, cq, h, dv))
    return torch.cat(outs, dim=1)


def _tma_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """The (batch, position, head) element strides a (B, S, heads, D) operand
    gives its tensor map: a dimension of one element takes the contiguous
    stride, which nothing reads."""
    inner = [t.shape[2] * t.shape[3] * t.shape[1], t.shape[2] * t.shape[3], t.shape[3]]
    return tuple(int(t.stride(i)) if t.shape[i] > 1 else inner[i] for i in range(3))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a CUDA launch on these operands takes: ``"tma"`` for bf16
    whose head dims are multiples of 8 (Dqk <= 192, Dv <= 128) with every
    operand and every stride 16-byte aligned and the head dim contiguous,
    else ``"mma"`` for bf16; ``"f32"`` for float32.  Pure: it reads type,
    shape, strides and ``data_ptr`` only, so it can be asked on any
    device."""
    if q.dtype != torch.bfloat16:
        return "f32"
    dqk, dv = q.shape[-1], v.shape[-1]
    if not (dqk % 8 == 0 and dv % 8 == 0 and dqk <= TMA_MAX_DQK and dv <= TMA_MAX_DV):
        return "mma"
    for t in (q, k, v):
        if (t.data_ptr() % _ALIGN or t.stride(3) != 1
                or any(s <= 0 or s * t.element_size() % _ALIGN for s in _tma_strides(t))):
            return "mma"
    return "tma"


def tma_widths(dqk: int, dv: int) -> tuple[int, int]:
    """(QK depth, PV width) the tma kernel pads (Dqk, Dv) to: the
    smallest of ``TMA_QK_WIDTHS`` and ``TMA_V_WIDTHS`` that holds each."""
    return (next(w for w in TMA_QK_WIDTHS if w >= dqk), next(w for w in TMA_V_WIDTHS if w >= dv))


def tma_boxes(dqk: int, dv: int) -> dict[str, tuple[int, int, int, int]]:
    """The tma kernel's TMA boxes (columns, heads, positions, batch) and
    how many of each a tile takes: 64-column boxes (128-byte rows under
    the 128B swizzle), one head and one batch, TMA_BLOCK_ROWS query rows or
    TMA_TILE_KEYS keys."""
    qk, pv = tma_widths(dqk, dv)
    return {"q": (64, 1, TMA_BLOCK_ROWS, 1), "k": (64, 1, TMA_TILE_KEYS, 1), "v": (64, 1, TMA_TILE_KEYS, 1),
            "q_boxes": -(-qk // 64), "k_boxes": -(-qk // 64), "v_boxes": -(-pv // 64)}


def kernel_scale(scale: float, scores_dtype) -> float:
    """The scale the kernel multiplies by: ``scale`` rounded to the scores'
    type, as the plain version's ``torch.tensor(scale, dtype=scores_dtype)``
    rounds it (a bf16 value is exact in the kernel's float32)."""
    return float(torch.tensor(scale, dtype=scores_dtype))


def chunked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, q_chunk: int,
    scale: float, scores_dtype=torch.float32,
) -> torch.Tensor:
    """Softmax attention of q (B, S, H, Dqk) over k (B, S_k, KVH, Dqk) and v
    (B, S_k, KVH, Dv); returns (B, S, H, Dv) in q's type."""
    if q.device.type == "cpu":
        return chunked_attention_plain(q, k, v, causal=causal, q_chunk=q_chunk, scale=scale,
                                       scores_dtype=scores_dtype)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be (B, S, heads, D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, dqk = q.shape
    s_k, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != dqk or v.shape[:3] != k.shape[:3] or h % kvh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if scores_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scores_dtype must be float32 or bf16, got {scores_dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if q.device.type != "cuda":
        raise ValueError(f"chunked_attention runs on CPU or CUDA tensors, got {q.device}")
    _build.refuse_grad("chunked_attention", q, k, v)
    if not (1 <= dqk <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM) or h > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"head dims {dqk}, {dv} (1..{MAX_HEAD_DIM}), {h} heads or batch {b} beyond the kernel")
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    if s_k == 0:
        raise ValueError("no keys: every row's softmax is empty")
    return _launch(q, k, v, out, route(q, k, v), causal=causal, scale=scale, scores_dtype=scores_dtype)


def _launch(q, k, v, out, path: str, *, causal: bool, scale: float, scores_dtype=torch.float32) -> torch.Tensor:
    """Launch route ``path``'s kernel on checked operands (the mma and f32
    kernels on contiguous copies, the tma kernel on the views as they
    are)."""
    b, s, h, dqk = q.shape
    s_k, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    lib = _build.library("chunked_attention", _SIGNATURES)
    common = (kernel_scale(scale, scores_dtype), int(scores_dtype == torch.bfloat16), int(causal))
    if path == "tma":
        strides = [x for t in (q, k, v) for x in _tma_strides(t)]
        args = (*strides, *common)
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        vec = (path == "mma" and dqk % 8 == 0 and dv % 8 == 0
               and all(t.data_ptr() % _ALIGN == 0 for t in (q, k, v)))
        args = (*common, int(vec))
    with torch.cuda.device(q.device):
        code = getattr(lib, _ENTRY[path])(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, s_k, h,
                                          kvh, dqk, dv, *args, _build.stream_of(q))
    _build.check(lib, code, "chunked_attention")
    chunked_attention.launches += 1
    op_counts.charge("chunked_attention", costs.chunked_attention, b, s, s_k, h, kvh, dqk, dv, causal,
                     q.element_size())
    chunked_attention.launches_by_route[path] += 1
    chunked_attention.launches_by_mask["causal" if causal else "full"] += 1
    return out


chunked_attention.launches = 0
chunked_attention.launches_by_route = dict.fromkeys(_ENTRY, 0)
chunked_attention.launches_by_mask = {"causal": 0, "full": 0}
