"""One decode position's GQA attention against a KV cache: CUDA kernel +
plain PyTorch versions.

Replaces the jnp of the reference's ``layers/attention.py``:
``decode_attention_incremental`` (the ``incremental`` mode: cache positions
``[0, index)`` plus the new token's ``k_new``/``v_new`` as an explicit
column, for models with ``decode_cache_carry``) and ``decode_attention``
(the ``in_cache`` mode: positions ``[0, index]`` after the caller wrote the
new token).  Source: ``csrc/decode_attention.cu``.  q is (B, 1, H, D), the
caches (B, S_max, KVH, D) and (B, S_max, KVH, Dv); scores, softmax and PV
are float32 (p is not rounded) and only the output is rounded to q's type.
Nothing here writes the cache.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.  What bounds it on the card: the bytes of the K and V rows up to
the index.  A block of four warps owns one (b, KV head, split of the
positions); each warp streams its own 16-key tiles into its own ring of
shared-memory stages (a bulk copy a row, completing on an mbarrier),
scores them on mma.sync with the G heads as rows (bf16; float32 on the
CUDA cores), keeps its own float32 (max, sum, output) and reads each v
pair once for all G heads, with no block-wide barrier inside the key loop.
The warps combine once at the block's end; with one split (a short cache,
:func:`splits_for`) the block writes the output, with more a second, short
launch combines the splits (both launches are one call).  Each call is
counted in ``decode_attention.launches``, by route (``"bf16"``, ``"f32"``:
the caches' type) in ``launches_by_route`` and by mode in
``launches_by_mode``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunked_attention import grouped_out, grouped_scores
from repro_torch.roofline import kernels as costs, ops as op_counts

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ENTRY = {"bf16": "decode_attention_bf16", "f32": "decode_attention_f32"}
_SIGNATURES = {
    name: ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _I, _I, _I, _I,
            ctypes.c_float, _I, _P], _I)
    for name in _ENTRY.values()
}
MAX_HEAD_DIM = 128
MAX_GROUP = 32        # query heads a KV head (csrc/decode_attention.cu kMaxG)
TILE = 16             # keys a warp's tile (csrc/decode_attention.cu kTile)
WARPS = 4             # warps a block, each on its own tiles (csrc/decode_attention.cu kWarps)
BLOCKS_PER_SM = 8     # blocks the splits aim at for each SM: four waves, so the last is a small share
RESIDENT_BLOCKS = 2   # blocks an SM holds at once (shared memory): a wave
MIN_SPLIT_TILES = 2 * WARPS     # tiles a split holds at least: two a warp, so a short cache takes one split
LONG_SPLIT_TILES = 16 * WARPS   # tiles a split holds once a wave is full: a warp's ring fills once a split
_ALIGN = 16


def decode_attention_incremental_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
    v_new: torch.Tensor, index: int, *, scale: float,
) -> torch.Tensor:
    """Decode attention WITHOUT writing the token into the cache first.

    The cache (positions < index) is read-only; the current token's k/v are
    attended as an explicit extra column, and the caller commits them.

    q: (B, 1, H, D); caches: (B, S, KVH, D); k_new/v_new: (B, 1, KVH, D).
    """
    b, _, h, d = q.shape
    kvh = k_cache.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, d)
    s_c = grouped_scores(qg, k_cache) * scale                        # (B, KVH, G, 1, S)
    mask = torch.arange(k_cache.shape[1], device=q.device) < index
    s_c = s_c.masked_fill(~mask, float("-inf"))
    s_n = grouped_scores(qg, k_new) * scale                          # (B, KVH, G, 1, 1)
    p = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1)
    out = grouped_out(p[..., :-1], v_cache) + grouped_out(p[..., -1:], v_new)
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


def decode_attention_in_cache_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, index: int, *, scale: float,
) -> torch.Tensor:
    """Single-position attention against a cache.

    q: (B, 1, H, D); caches: (B, S_max, KVH, D); ``index`` = position of the
    new token (attends to [0, index]).
    """
    b, _, h, d = q.shape
    kvh = k_cache.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, d)
    scores = grouped_scores(qg, k_cache) * scale
    mask = torch.arange(k_cache.shape[1], device=q.device) <= index
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return grouped_out(p, v_cache).reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


def decode_attention_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, index: int, *, scale: float,
    k_new: torch.Tensor | None = None, v_new: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the incremental mode when
    ``k_new`` is given, else the in-cache mode."""
    if k_new is None:
        return decode_attention_in_cache_plain(q, k_cache, v_cache, index, scale=scale)
    return decode_attention_incremental_plain(q, k_cache, v_cache, k_new, v_new, index, scale=scale)


def cache_keys(index: int, s_max: int, incremental: bool) -> int:
    """Cache positions a call reads: ``[0, index)`` incremental, ``[0,
    index]`` in the cache, never past its end (the plain versions' masks
    keep the same positions)."""
    return min(index, s_max) if incremental else min(index, s_max - 1) + 1


def splits_for(keys: int, pairs: int, sms: int) -> tuple[int, int]:
    """(tiles a split, splits) for ``keys`` keys of each of ``pairs``
    (batch, KV head) pairs: up to BLOCKS_PER_SM blocks for each of ``sms``
    SMs, but no more splits than keep LONG_SPLIT_TILES tiles each once one
    wave (RESIDENT_BLOCKS an SM) is full, since each block pays to fill and
    drain its warps' rings; and at least MIN_SPLIT_TILES tiles each (so a
    cache of fewer than twice that takes one split).  Whole tiles, no split
    empty."""
    tiles = -(-keys // TILE)
    wave = -(-RESIDENT_BLOCKS * sms // pairs)
    want = min(-(-BLOCKS_PER_SM * sms // pairs), max(wave, tiles // LONG_SPLIT_TILES))
    want = max(1, min(want, tiles // MIN_SPLIT_TILES))
    per_split = -(-tiles // want)
    return per_split, -(-tiles // per_split)


def _check(q, k_cache, v_cache, index, k_new, v_new) -> None:
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4 or v_cache.ndim != 4:
        raise ValueError(f"q must be (B, 1, H, D) and the caches (B, S_max, KVH, D), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, _, h, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or v_cache.shape[:3] != k_cache.shape[:3]:
        raise ValueError(f"caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)} do not fit q {tuple(q.shape)}")
    kvh = k_cache.shape[2]
    if h % kvh:
        raise ValueError(f"{h} query heads over {kvh} KV heads")
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new come together")
    tensors = [q, k_cache, v_cache]
    if k_new is not None:
        if k_new.shape != (b, 1, kvh, d) or v_new.shape != (b, 1, kvh, v_cache.shape[3]):
            raise ValueError(f"k_new {tuple(k_new.shape)}, v_new {tuple(v_new.shape)} do not fit the caches")
        tensors += [k_new, v_new]
    if q.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"q, the caches and the new column must all be float32 or all bf16, got "
                         f"{[t.dtype for t in tensors]}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, the caches and the new column must lie on one device")
    if int(index) < 0:
        raise ValueError(f"index {index} < 0")


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, index: int, *, scale: float,
    k_new: torch.Tensor | None = None, v_new: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention of one position's q (B, 1, H, D) over the cache up to
    ``index``: with ``k_new``/``v_new`` (B, 1, KVH, D) positions ``[0,
    index)`` and the new column (``incremental``), else ``[0, index]``
    (``in_cache``).  Returns (B, 1, H, Dv) in q's type."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, index, scale=scale, k_new=k_new, v_new=v_new)
    _check(q, k_cache, v_cache, index, k_new, v_new)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CPU or CUDA tensors, got {q.device}")
    incremental = k_new is not None
    _build.refuse_grad("decode_attention", q, k_cache, v_cache, *((k_new, v_new) if incremental else ()))
    b, _, h, d = q.shape
    s_max, kvh, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM and h // kvh <= MAX_GROUP):
        raise ValueError(f"head dims {d}, {dv} (1..{MAX_HEAD_DIM}) or group {h // kvh} (..{MAX_GROUP}) "
                         "beyond the kernel")
    for name, t, dim in (("k_cache", k_cache, d), ("v_cache", v_cache, dv)):
        if t.stride(3) != 1 or t.stride(2) != dim:
            raise ValueError(f"{name}: a position's (KVH, D) must be contiguous, strides {t.stride()}")
    n_cache = cache_keys(int(index), s_max, incremental)
    keys = n_cache + int(incremental)
    q = q.contiguous()
    if incremental:
        k_new, v_new = k_new.contiguous(), v_new.contiguous()
    path = "bf16" if q.dtype == torch.bfloat16 else "f32"
    per_chunk = 16 // q.element_size()
    vec = (d % per_chunk == 0 and dv % per_chunk == 0
           and all(t.stride(0) % per_chunk == 0 and t.stride(1) % per_chunk == 0 for t in (k_cache, v_cache))
           and all(t.data_ptr() % _ALIGN == 0
                   for t in (k_cache, v_cache, *((k_new, v_new) if incremental else ()))))
    per_split, splits = splits_for(keys, b * kvh, torch.cuda.get_device_properties(q.device).multi_processor_count)
    out = torch.empty((b, 1, h, dv), dtype=q.dtype, device=q.device)
    if b == 0 or h == 0:
        return out
    # The splits' (max, sum, unnormalised output), for the combine launch.
    part_acc = torch.empty((b, h, splits, dv), dtype=torch.float32, device=q.device) if splits > 1 else None
    part_ml = torch.empty((b, h, splits, 2), dtype=torch.float32, device=q.device) if splits > 1 else None
    lib = _build.library("decode_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = getattr(lib, _ENTRY[path])(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_new.data_ptr() if incremental else None, v_new.data_ptr() if incremental else None,
            out.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(), b, h, kvh, d, dv,
            k_cache.stride(0), k_cache.stride(1), v_cache.stride(0), v_cache.stride(1),
            n_cache, int(incremental), per_split, splits, float(scale), int(vec), _build.stream_of(q),
        )
    _build.check(lib, code, "decode_attention")
    decode_attention.launches += 1
    op_counts.charge("decode_attention", costs.decode_attention, b, keys, h, kvh, d, dv, q.element_size())
    decode_attention.launches_by_route[path] += 1
    decode_attention.launches_by_mode["incremental" if incremental else "in_cache"] += 1
    return out


decode_attention.launches = 0
decode_attention.launches_by_route = dict.fromkeys(_ENTRY, 0)
decode_attention.launches_by_mode = {"incremental": 0, "in_cache": 0}
