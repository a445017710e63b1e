"""XNOR-popcount-threshold layer of the packed backend: CUDA kernel + plain
PyTorch version.

The reference computes this layer in jnp (``repro/dataplane/executor.py``,
``_packed_fn`` and ``_packed_scan_fn``) with ``jax.lax.population_count``;
PyTorch has no popcount op, so the port has a kernel (source:
``csrc/packed_layer.cu``).  For packet ``b`` and neuron ``j``::

    count = sum_w popcount(~(words[b, w] ^ weights[j, w]) & mask[j, w])
    out[b, j] = count >= thresholds[j]      # unsigned, {0,1} int32

All operands are int32 bit views of uint32.  Pad neurons carry the threshold
``0xFFFFFFFF`` (``-1`` as a bit view) and must never fire, so the compare is
unsigned on both paths.  A CPU tensor runs :func:`packed_layer_plain`; a
CUDA tensor launches one of three kernels, chosen by :func:`route`:

* ``"quad"``: ``n_out`` a multiple of 4 (at most ``QUAD_MAX_OUT``) and
  ``n_words`` in ``QUAD_WORDS``, the words aligned to a packet's row: a
  thread holds 4 neurons' tables in registers and writes 16 bytes a packet;
* ``"general"``: every other layer (FIVE_TUPLE's 2-neuron output layer, wider
  layers, misaligned views) whose tables fit one block's shared memory, one
  thread per output, tables staged in shared memory;
* ``"tiled"``: tables past one block's shared memory (the block-diagonal
  layers of 32 and 128 merged tenants): a binary GEMM tile of 64 packets x
  64 neurons a block, K staged in shared memory, a 4 x 4 tile of counts a
  thread;
* ``"cached"`` (forced only): the general kernel without the staging, the
  tables read through the read-only cache; the design ``"tiled"`` replaced.

Each launch is counted in ``packed_layer.launches`` and, by route, in
``packed_layer.launches_by_route``.

:func:`packed_layer_routed` is the multi-tenant scheduler's per-tenant
layer (the reference's jnp in ``routed_packed_stacked_fn``): each packet
carries a tenant id and reads that tenant's block of ``(T, n_out, n_words)``
stacked tables.  It has two kernels in the same source, chosen by
:func:`routed_route`: ``"quad"`` (the shapes of ``route``'s quad, and
16-byte aligned tables: 4 neurons a thread, their table rows in vector
loads) and ``"general"`` (one thread per output).  Its launches are counted
in ``packed_layer_routed.launches`` and ``launches_by_route``.  The public
wrapper checks the ids' range, which reads it back from the device; the
scheduler's dispatch (``executor.routed_packed_stacked_fn``), whose ids are
checked on the host, calls the private ``_routed`` and reads nothing back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitops
from repro_torch.kernels import _build
from repro_torch.roofline import kernels as costs, ops as op_counts


_P = ctypes.c_void_p
_I = ctypes.c_int
ROUTES = ("quad", "general", "tiled", "cached")
ROUTED_ROUTES = ("quad", "general")
_ENTRY = {path: f"packed_layer_{path}" for path in ROUTES}
_ROUTED_ENTRY = {path: f"packed_layer_routed_{path}" for path in ROUTED_ROUTES}
_SIGNATURES = {name: ([_P] * 5 + [_I, _I, _I, _P], _I) for name in _ENTRY.values()}
_SIGNATURES.update({name: ([_P] * 6 + [_I] * 4 + [_P], _I) for name in _ROUTED_ENTRY.values()})

# The quad route's limits (csrc/packed_layer.cu): a thread's 4 neurons' words
# live in registers for these word counts, and a block of 256 threads holds
# at least one packet's n_out / 4 threads.
QUAD_WORDS = (1, 2, 4)
QUAD_MAX_OUT = 1024
# The kernels index with 32-bit integers.
_MAX_INDEX = 1 << 31


def route(words: torch.Tensor, weights: torch.Tensor) -> str:
    """The kernel a CUDA launch on these (contiguous) operands takes:
    ``"quad"``, else ``"general"`` where the weights, masks and thresholds
    fit one block's shared memory, else ``"tiled"``.  Pure: it reads shapes
    and ``data_ptr`` only, so it can be asked on any device."""
    n_out, n_words = weights.shape
    if (n_out % 4 == 0 and 0 < n_out <= QUAD_MAX_OUT and n_words in QUAD_WORDS
            and words.data_ptr() % (4 * n_words) == 0):
        return "quad"
    if (2 * n_out * n_words + n_out) * 4 <= _build.MAX_SHARED_BYTES:
        return "general"
    return "tiled"


def routed_route(words: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor,
                 thresholds: torch.Tensor) -> str:
    """The kernel a CUDA launch of :func:`packed_layer_routed` on these
    (contiguous) operands takes: ``"quad"`` where ``weights`` is (T, n_out,
    n_words) with n_out % 4 == 0 up to ``QUAD_MAX_OUT``, n_words in
    ``QUAD_WORDS``, a packet's words aligned to its row and the tables to 16
    bytes (4 neurons' rows are read as 16-byte vectors), else
    ``"general"``.  Pure: it reads shapes and ``data_ptr`` only."""
    _, n_out, n_words = weights.shape
    if (n_out % 4 == 0 and 0 < n_out <= QUAD_MAX_OUT and n_words in QUAD_WORDS
            and words.data_ptr() % (4 * n_words) == 0
            and all(t.data_ptr() % 16 == 0 for t in (weights, mask, thresholds))):
        return "quad"
    return "general"


def _check_args(words, weights, mask, thresholds) -> None:
    if words.ndim != 2 or weights.ndim != 2:
        raise ValueError("words must be (batch, n_words), weights (n_out, n_words)")
    n_out, n_words = weights.shape
    if words.shape[1] != n_words or mask.shape != weights.shape or thresholds.shape != (n_out,):
        raise ValueError(
            f"shape mismatch: words {tuple(words.shape)}, weights {tuple(weights.shape)}, "
            f"mask {tuple(mask.shape)}, thresholds {tuple(thresholds.shape)}"
        )
    for t in (words, weights, mask, thresholds):
        if t.dtype != torch.int32:
            raise ValueError(f"packed_layer operands are int32 bit views, got {t.dtype}")
        if t.device != words.device:
            raise ValueError(f"operand on {t.device}, words on {words.device}")


def packed_layer(
    words: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    thresholds: torch.Tensor,
) -> torch.Tensor:
    """One packed BNN layer: (batch, n_words) input words -> (batch, n_out)
    {0,1} int32 output bits."""
    _check_args(words, weights, mask, thresholds)
    if words.device.type == "cpu":
        return packed_layer_plain(words, weights, mask, thresholds)
    if words.device.type != "cuda":
        raise ValueError(f"packed_layer runs on CPU or CUDA tensors, got {words.device}")
    _build.refuse_grad("packed_layer", words, weights, mask, thresholds)
    n_out, n_words = weights.shape
    words, weights, mask, thresholds = (
        t.contiguous() for t in (words, weights, mask, thresholds)
    )
    batch = words.shape[0]
    out = torch.empty((batch, n_out), dtype=torch.int32, device=words.device)
    if batch == 0 or n_out == 0:
        return out
    if batch * max(n_out, n_words) >= _MAX_INDEX:
        raise ValueError(f"a batch of {batch} is beyond the kernels' 32-bit indices")
    return _launch(words, weights, mask, thresholds, out, route(words, weights))


def _launch(words, weights, mask, thresholds, out, path: str) -> torch.Tensor:
    """Launch route ``path``'s kernel on checked, contiguous operands."""
    n_out, n_words = weights.shape
    lib = _build.library("packed_layer", _SIGNATURES)
    with torch.cuda.device(words.device):
        code = getattr(lib, _ENTRY[path])(
            words.data_ptr(), weights.data_ptr(), mask.data_ptr(),
            thresholds.data_ptr(), out.data_ptr(), words.shape[0], n_out, n_words,
            _build.stream_of(words),
        )
    _build.check(lib, code, "packed_layer")
    packed_layer.launches += 1
    op_counts.charge("packed_layer", costs.packed_layer, words.shape[0], n_words, n_out)
    packed_layer.launches_by_route[path] += 1
    return out


packed_layer.launches = 0
packed_layer.launches_by_route = dict.fromkeys(ROUTES, 0)


def packed_layer_plain(
    words: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    thresholds: torch.Tensor,
) -> torch.Tensor:
    """The kernel's semantics in plain PyTorch (uint32 carriers), any device."""
    x = bitops.i32_to_u32(words)[:, None, :]
    w = bitops.i32_to_u32(weights)[None, :, :]
    m = bitops.i32_to_u32(mask)[None, :, :]
    count = bitops.hakmem_popcount(bitops.xnor(x, w) & m).sum(-1)
    return (count >= bitops.i32_to_u32(thresholds)[None, :]).to(torch.int32)


def _check_routed_args(words, tenant_ids, weights, mask, thresholds) -> None:
    if words.ndim != 2 or weights.ndim != 3 or tenant_ids.ndim != 1:
        raise ValueError(
            "words must be (batch, n_words), tenant_ids (batch,), weights (T, n_out, n_words)")
    n_tenants, n_out, n_words = weights.shape
    if (words.shape[1] != n_words or tenant_ids.shape[0] != words.shape[0]
            or mask.shape != weights.shape or thresholds.shape != (n_tenants, n_out)):
        raise ValueError(
            f"shape mismatch: words {tuple(words.shape)}, tenant_ids {tuple(tenant_ids.shape)}, "
            f"weights {tuple(weights.shape)}, mask {tuple(mask.shape)}, "
            f"thresholds {tuple(thresholds.shape)}"
        )
    for t in (words, tenant_ids, weights, mask, thresholds):
        if t.dtype != torch.int32:
            raise ValueError(f"packed_layer_routed operands are int32, got {t.dtype}")
        if t.device != words.device:
            raise ValueError(f"operand on {t.device}, words on {words.device}")
    if n_tenants == 0 or n_out == 0 or n_words == 0:
        raise ValueError(f"empty tables {tuple(weights.shape)}")


def _check_ids(tenant_ids, n_tenants: int) -> None:
    """Raise on an id outside [0, n_tenants) (a host sync on a CUDA tensor)."""
    if tenant_ids.numel():
        lo, hi = (int(v) for v in torch.aminmax(tenant_ids))
        if lo < 0 or hi >= n_tenants:
            raise ValueError(f"tenant ids span [{lo}, {hi}], outside [0, {n_tenants})")


def packed_layer_routed(
    words: torch.Tensor,
    tenant_ids: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    thresholds: torch.Tensor,
) -> torch.Tensor:
    """One packed layer whose tables each packet takes from its tenant's
    block: (batch, n_words) words and (batch,) int32 tenant ids against
    (T, n_out, n_words) weights and masks and (T, n_out) thresholds ->
    (batch, n_out) {0,1} int32.  Raises on a tenant id outside [0, T),
    before any launch (reading the ids' range back from the device)."""
    _check_routed_args(words, tenant_ids, weights, mask, thresholds)
    if words.device.type == "cuda":
        _check_ids(tenant_ids, weights.shape[0])
    return _routed(words, tenant_ids, weights, mask, thresholds)


def _routed(words, tenant_ids, weights, mask, thresholds) -> torch.Tensor:
    """The per-tenant layer on operands that passed
    :func:`_check_routed_args`: on the CPU the ids are checked and the plain
    version runs; on the card nothing is read back (the caller checked the
    ids, and an id outside [0, T) gives 0 bits) and :func:`routed_route`'s
    kernel is launched."""
    if words.device.type == "cpu":
        _check_ids(tenant_ids, weights.shape[0])
        return packed_layer_routed_plain(words, tenant_ids, weights, mask, thresholds)
    if words.device.type != "cuda":
        raise ValueError(f"packed_layer_routed runs on CPU or CUDA tensors, got {words.device}")
    _build.refuse_grad("packed_layer_routed", words, weights, mask, thresholds)
    words, tenant_ids, weights, mask, thresholds = (
        t.contiguous() for t in (words, tenant_ids, weights, mask, thresholds)
    )
    _, n_out, n_words = weights.shape
    batch = words.shape[0]
    if max(batch * max(n_out, n_words), weights.numel()) >= _MAX_INDEX:
        raise ValueError(f"a batch of {batch} or a {tuple(weights.shape)} stack is beyond "
                         "the kernels' 32-bit indices")
    out = torch.empty((batch, n_out), dtype=torch.int32, device=words.device)
    if batch == 0:
        return out
    path = routed_route(words, weights, mask, thresholds)
    return _launch_routed(words, tenant_ids, weights, mask, thresholds, out, path)


def _launch_routed(words, tenant_ids, weights, mask, thresholds, out, path: str) -> torch.Tensor:
    """Launch route ``path``'s per-tenant kernel on checked, contiguous
    operands."""
    n_tenants, n_out, n_words = weights.shape
    lib = _build.library("packed_layer", _SIGNATURES)
    with torch.cuda.device(words.device):
        code = getattr(lib, _ROUTED_ENTRY[path])(
            words.data_ptr(), tenant_ids.data_ptr(), weights.data_ptr(), mask.data_ptr(),
            thresholds.data_ptr(), out.data_ptr(), words.shape[0], n_out, n_words, n_tenants,
            _build.stream_of(words),
        )
    _build.check(lib, code, "packed_layer_routed")
    packed_layer_routed.launches += 1
    op_counts.charge("packed_layer_routed", costs.packed_layer_routed, words.shape[0], n_words, n_tenants, n_out)
    packed_layer_routed.launches_by_route[path] += 1
    return out


packed_layer_routed.launches = 0
packed_layer_routed.launches_by_route = dict.fromkeys(ROUTED_ROUTES, 0)


def packed_layer_routed_plain(
    words: torch.Tensor,
    tenant_ids: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    thresholds: torch.Tensor,
) -> torch.Tensor:
    """The per-tenant kernel's semantics in plain PyTorch (uint32 carriers),
    any device: each packet gathers its tenant's tables, then the packed
    layer's count and unsigned compare."""
    t = tenant_ids.long()
    x = bitops.i32_to_u32(words)[:, None, :]
    w = bitops.i32_to_u32(weights)[t]
    m = bitops.i32_to_u32(mask)[t]
    count = bitops.hakmem_popcount(bitops.xnor(x, w) & m).sum(-1)
    return (count >= bitops.i32_to_u32(thresholds)[t]).to(torch.int32)
