"""The attention kernels' plain versions against the reference, and the
dispatch in ``layers/attention.py``, on the CPU.

``kernels/chunked_attention.py::chunked_attention_plain`` and
``kernels/decode_attention.py``'s ``decode_attention_incremental_plain``
and ``decode_attention_in_cache_plain`` (the layer module's
``decode_attention_plain``) are held against the reference's
``chunked_attention``, ``decode_attention_incremental`` and
``decode_attention`` on one set of numpy inputs: G of 1, 2 and 4, Dqk !=
Dv, S odd and not a multiple of ``q_chunk``, causal and full, bf16 scores,
float32 and bf16 inputs, ``index`` 0, 1 and S_max - 1.  Tolerances as
``tests/test_torch_lm.py::_close`` (relative to the output's largest
magnitude): float32 within 1e-5 (the einsums sum in another order than
XLA); bf16 inputs, with the reference run eagerly (``jax.disable_jit()``,
as ``tests/test_torch_bf16.py`` runs it), within 2e-2, a few bf16 ulps (a
float32 sum taken in another order can round a score, a p or an output to
the neighbouring bf16 value).  The kernels themselves run only on a card
(``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import chunked_attention as tchunk
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.layers import attention as tattn
from test_torch_lm import _close, _jit

from repro.layers import attention as jattn

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    """The same values for both packages: float32, or rounded to bf16."""
    jt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tt = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(a, jt) for a in arrays], [torch.from_numpy(a).to(tt) for a in arrays])


def _as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _reference(fn, dtype, static, *args):
    """The reference jitted (float32), or eager under ``disable_jit`` (bf16)."""
    if dtype == "float32":
        return _jit(fn, **static)(*args)
    with jax.disable_jit():
        return fn(*args, **static)


# (H, KVH, Dqk, Dv): G 1, 2, 4; Dqk != Dv as MLA's.
HEADS = [(4, 4, 8, 8), (4, 2, 8, 8), (4, 1, 8, 8), (4, 2, 12, 8)]


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("scores", ["float32", "bf16"])
def test_chunked_attention_plain_matches_reference_f32(heads, causal, scores):
    h, kvh, dqk, dv = heads
    b, s = 2, 13   # odd, not a multiple of q_chunk
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs([(b, s, h, dqk), (b, s, kvh, dqk), (b, s, kvh, dv)], h + dqk),
                                       "float32")
    static = dict(causal=causal, q_chunk=5, scale=0.3,
                  scores_dtype=jnp.float32 if scores == "float32" else jnp.bfloat16)
    want = _reference(jattn.chunked_attention, "float32", static, jq, jk, jv)
    got = tattn.chunked_attention_plain(tq, tk, tv, causal=causal, q_chunk=5, scale=0.3,
                                        scores_dtype=torch.float32 if scores == "float32" else torch.bfloat16)
    assert got.shape == (b, s, h, dv) and got.dtype == torch.float32
    _close(got, _as_np(want), F32_TOL if scores == "float32" else BF16_TOL)


@pytest.mark.parametrize("heads", [(4, 2, 8, 8), (4, 4, 12, 8)])
@pytest.mark.parametrize("scores", ["float32", "bf16"])
def test_chunked_attention_plain_matches_reference_bf16(heads, scores):
    h, kvh, dqk, dv = heads
    b, s = 1, 7
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs([(b, s, h, dqk), (b, s, kvh, dqk), (b, s, kvh, dv)], 3),
                                       "bf16")
    static = dict(causal=True, q_chunk=4, scale=0.3,
                  scores_dtype=jnp.float32 if scores == "float32" else jnp.bfloat16)
    want = _reference(jattn.chunked_attention, "bf16", static, jq, jk, jv)
    got = tattn.chunked_attention_plain(tq, tk, tv, causal=True, q_chunk=4, scale=0.3,
                                        scores_dtype=torch.float32 if scores == "float32" else torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got.float(), _as_np(want), BF16_TOL)


def _decode_inputs(h, kvh, d, s_max, seed):
    b = 2
    return _inputs([(b, 1, h, d), (b, s_max, kvh, d), (b, s_max, kvh, d), (b, 1, kvh, d), (b, 1, kvh, d)], seed)


@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("index", [0, 1, 8])   # S_max - 1 = 8
@pytest.mark.parametrize("mode", ["incremental", "in_cache"])
def test_decode_attention_plain_matches_reference_f32(heads, index, mode):
    h, kvh = heads
    (jq, jkc, jvc, jkn, jvn), (tq, tkc, tvc, tkn, tvn) = _both(_decode_inputs(h, kvh, 8, 9, index), "float32")
    if mode == "incremental":
        want = _jit(jattn.decode_attention_incremental, scale=0.3)(jq, jkc, jvc, jkn, jvn, jnp.int32(index))
        got = tattn.decode_attention_incremental_plain(tq, tkc, tvc, tkn, tvn, index, scale=0.3)
    else:
        want = _jit(jattn.decode_attention, scale=0.3)(jq, jkc, jvc, jnp.int32(index))
        got = tattn.decode_attention_plain(tq, tkc, tvc, index, scale=0.3)
    assert got.shape == (2, 1, h, 8)
    _close(got, _as_np(want), F32_TOL)


@pytest.mark.parametrize("index", [0, 8])
@pytest.mark.parametrize("mode", ["incremental", "in_cache"])
def test_decode_attention_plain_matches_reference_bf16(index, mode):
    (jq, jkc, jvc, jkn, jvn), (tq, tkc, tvc, tkn, tvn) = _both(_decode_inputs(4, 2, 8, 9, 5), "bf16")
    with jax.disable_jit():
        if mode == "incremental":
            want = jattn.decode_attention_incremental(jq, jkc, jvc, jkn, jvn, jnp.int32(index), scale=0.3)
        else:
            want = jattn.decode_attention(jq, jkc, jvc, jnp.int32(index), scale=0.3)
    if mode == "incremental":
        got = tattn.decode_attention_incremental_plain(tq, tkc, tvc, tkn, tvn, index, scale=0.3)
    else:
        got = tattn.decode_attention_plain(tq, tkc, tvc, index, scale=0.3)
    assert got.dtype == torch.bfloat16
    _close(got.float(), _as_np(want), BF16_TOL)


def _launches():
    return tchunk.chunked_attention.launches, tdecode.decode_attention.launches


def test_dispatch_on_cpu_runs_the_plain_versions_without_launches():
    tq, tk, tv = (torch.from_numpy(a) for a in _inputs([(2, 13, 4, 8), (2, 13, 2, 8), (2, 13, 2, 8)], 0))
    q1, kc, vc, kn, vn = (torch.from_numpy(a) for a in _decode_inputs(4, 2, 8, 9, 0))
    before = _launches()
    kw = dict(causal=True, q_chunk=5, scale=0.3)
    assert torch.equal(tattn.chunked_attention(tq, tk, tv, **kw), tattn.chunked_attention_plain(tq, tk, tv, **kw))
    assert torch.equal(tattn.decode_attention_incremental(q1, kc, vc, kn, vn, 4, scale=0.3),
                       tattn.decode_attention_incremental_plain(q1, kc, vc, kn, vn, 4, scale=0.3))
    assert torch.equal(tattn.decode_attention(q1, kc, vc, 4, scale=0.3),
                       tattn.decode_attention_plain(q1, kc, vc, 4, scale=0.3))
    assert torch.equal(tdecode.decode_attention(q1, kc, vc, 4, scale=0.3, k_new=kn, v_new=vn),
                       tattn.decode_attention_incremental_plain(q1, kc, vc, kn, vn, 4, scale=0.3))
    assert _launches() == before


def test_the_plain_versions_are_the_kernel_modules():
    assert tattn.chunked_attention_plain is tchunk.chunked_attention_plain
    assert tattn.decode_attention_incremental_plain is tdecode.decode_attention_incremental_plain
    assert tattn.decode_attention_plain is tdecode.decode_attention_in_cache_plain


class _Launched(Exception):
    pass


@pytest.fixture
def no_kernels(monkeypatch):
    """Both wrappers replaced by a stub that raises: a call that reaches
    one raises ``_Launched``."""
    def stub(*args, **kw):
        raise _Launched
    monkeypatch.setattr(tchunk, "chunked_attention", stub)
    monkeypatch.setattr(tdecode, "decode_attention", stub)


@pytest.mark.parametrize("call", ["chunked", "incremental", "in_cache"])
def test_grad_recording_picks_the_plain_version(no_kernels, call):
    """Where autograd records (grad mode on and an input that requires
    grad) the dispatch runs the plain version, which stays differentiable;
    elsewhere it calls the kernel's wrapper."""
    tq, tk, tv = (torch.from_numpy(a) for a in _inputs([(1, 5, 2, 4), (1, 5, 1, 4), (1, 5, 1, 4)], 1))
    q1, kc, vc, kn, vn = (torch.from_numpy(a) for a in _decode_inputs(2, 1, 4, 6, 1))
    calls = {
        "chunked": lambda q: tattn.chunked_attention(q, tk, tv, causal=True, q_chunk=2, scale=0.5),
        "incremental": lambda q: tattn.decode_attention_incremental(q, kc, vc, kn, vn, 3, scale=0.5),
        "in_cache": lambda q: tattn.decode_attention(q, kc, vc, 3, scale=0.5),
    }
    q = (tq if call == "chunked" else q1).clone().requires_grad_(True)
    out = calls[call](q)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    with torch.no_grad(), pytest.raises(_Launched):
        calls[call](q)
    with pytest.raises(_Launched):
        calls[call](q.detach())


def test_splits_cover_the_keys_in_whole_tiles():
    tile = tdecode.TILE
    for keys, pairs in [(1, 16), (64, 16), (65, 16), (129, 128), (32768, 128), (32768, 16), (524288, 32), (7, 1),
                        (2048, 8), (300, 1)]:
        per_split, splits = tdecode.splits_for(keys, pairs, 132)
        tiles = -(-keys // tile)
        assert (splits - 1) * per_split < tiles <= splits * per_split   # every split holds a key
        assert splits <= min(tiles, max(1, -(-tdecode.BLOCKS_PER_SM * 132 // pairs)))
        assert splits == 1 or per_split >= tdecode.MIN_SPLIT_TILES   # two tiles a warp at least
        wave = -(-tdecode.RESIDENT_BLOCKS * 132 // pairs)
        assert splits <= wave or per_split >= tdecode.LONG_SPLIT_TILES   # long splits past one wave
    assert tdecode.splits_for(32768, 128, 132) == (228, 9)    # phi3 decode_32k: 4 x 32 pairs
    assert tdecode.splits_for(32768, 16, 132) == (64, 32)     # qwen3 decode_32k: 4 x 4 pairs
    assert tdecode.splits_for(2048, 8, 132) == (8, 16)        # chatglm3 at index 2047: 4 x 2 pairs
    assert tdecode.splits_for(129, 16, 132) == (9, 1)


@pytest.mark.parametrize("keys", [1, 16, 17, 129, (2 * tdecode.MIN_SPLIT_TILES - 1) * tdecode.TILE])
@pytest.mark.parametrize("pairs", [1, 8, 128])
def test_a_short_cache_takes_one_split(keys, pairs):
    """Fewer than 2 x MIN_SPLIT_TILES tiles make one split whatever the
    card: the block writes the output and no combine launch follows."""
    tiles = -(-keys // tdecode.TILE)
    assert tdecode.splits_for(keys, pairs, 132) == (tiles, 1)
    assert tdecode.splits_for(keys, pairs, 1) == (tiles, 1)


def test_cache_keys_are_the_plain_masks():
    for index, s_max in [(0, 9), (1, 9), (8, 9), (9, 9), (20, 9)]:
        assert tdecode.cache_keys(index, s_max, True) == int((torch.arange(s_max) < index).sum())
        assert tdecode.cache_keys(index, s_max, False) == int((torch.arange(s_max) <= index).sum())


def test_kernel_scale_rounds_as_the_plain_version():
    for scale in (1 / 96 ** 0.5, 1 / 192 ** 0.5, 0.3):
        assert tchunk.kernel_scale(scale, torch.bfloat16) == float(torch.tensor(scale, dtype=torch.bfloat16))
        assert tchunk.kernel_scale(scale, torch.float32) == float(torch.tensor(scale, dtype=torch.float32))
    q, k, v = _operands(2, 4, 2, 96, 96, torch.bfloat16)
    assert tchunk.route(q, k, v) == "tma"
    assert tchunk.route(q.float(), k.float(), v.float()) == "f32"


def _operands(b, h, kvh, dqk, dv, dtype, s=5):
    return (torch.zeros((b, s, h, dqk), dtype=dtype), torch.zeros((b, s, kvh, dqk), dtype=dtype),
            torch.zeros((b, s, kvh, dv), dtype=dtype))


# (Dqk, Dv): stablelm, phi3, qwen3 / chatglm3 / internvl2, deepseek-v2's and
# minicpm3's MLA, zamba2; then what TMA cannot take.
TMA_DIMS = [(80, 80), (96, 96), (128, 128), (192, 128), (96, 64), (64, 64), (8, 8), (184, 120)]
MMA_DIMS = [(13, 13), (96, 13), (20, 96), (200, 128), (256, 128), (128, 136)]


@pytest.mark.parametrize("dims", TMA_DIMS + MMA_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chunked_route_by_type_and_head_dims(dims, dtype):
    q, k, v = _operands(1, 4, 2, *dims, dtype)
    want = "f32" if dtype == torch.float32 else "tma" if dims in TMA_DIMS else "mma"
    assert tchunk.route(q, k, v) == want


def _shifted(t: torch.Tensor, elements: int) -> torch.Tensor:
    """``t``'s values in a buffer that starts ``elements`` elements on: a
    contiguous view whose data pointer is not 16-byte aligned."""
    flat = torch.zeros(t.numel() + elements, dtype=t.dtype)
    out = flat[elements:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("which", [0, 1, 2])
def test_chunked_route_takes_mma_for_misaligned_views(which):
    ops = list(_operands(2, 4, 2, 96, 96, torch.bfloat16))
    assert tchunk.route(*ops) == "tma"
    shifted = list(ops)
    shifted[which] = _shifted(ops[which], 1)
    assert shifted[which].data_ptr() % 16 and tchunk.route(*shifted) == "mma"
    # a position stride of 100 elements (200 bytes) is not a 16-byte multiple
    wide = torch.zeros((2, 5, ops[which].shape[2], 100), dtype=torch.bfloat16)[..., :96]
    strided = list(ops)
    strided[which] = wide
    assert tchunk.route(*strided) == "mma"
    # a head broadcast by stride 0
    expanded = list(ops)
    expanded[which] = ops[which][:, :, :1].expand(ops[which].shape)
    assert tchunk.route(*expanded) == "mma"


def test_chunked_route_takes_strided_views_it_can_map():
    """MLA's prefill passes v as a slice of the expanded (K nope, V) rows:
    aligned strides, no copy needed; a batch of one takes any batch
    stride."""
    b, s, h, nope, dv = 2, 5, 4, 128, 128
    kv = torch.zeros((b, s, h, nope + dv), dtype=torch.bfloat16)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q = torch.zeros((b, s, h, 192), dtype=torch.bfloat16)
    k = torch.zeros((b, s, h, 192), dtype=torch.bfloat16)
    assert not v.is_contiguous() and tchunk.route(q, k, v) == "tma"
    assert tchunk._tma_strides(v) == (s * h * (nope + dv), h * (nope + dv), nope + dv)
    one = torch.zeros((1, 7, 3, 96), dtype=torch.bfloat16).as_strided((1, 7, 3, 96), (5, 3 * 96, 96, 1))
    assert tchunk._tma_strides(one) == (7 * 3 * 96, 3 * 96, 96)
    assert k_nope.shape[-1] == nope


@pytest.mark.parametrize("dims,widths", [((80, 80), (96, 96)), ((96, 96), (96, 96)), ((128, 128), (128, 128)),
                                         ((192, 128), (192, 128)), ((96, 64), (96, 64)), ((64, 64), (64, 64)),
                                         ((8, 8), (64, 64)), ((136, 72), (192, 96)), ((184, 120), (192, 128))])
def test_tma_widths_and_boxes(dims, widths):
    """Dqk pads to the QK product's depth (64, 96, 128 or 192), Dv to the
    PV product's N (64, 96 or 128); tiles are 64-column boxes of one head
    and one batch, 128 query rows or 128 keys."""
    assert tchunk.tma_widths(*dims) == widths
    boxes = tchunk.tma_boxes(*dims)
    assert boxes["q"] == (64, 1, tchunk.TMA_BLOCK_ROWS, 1)
    assert boxes["k"] == boxes["v"] == (64, 1, tchunk.TMA_TILE_KEYS, 1)
    assert boxes["q_boxes"] == boxes["k_boxes"] == -(-widths[0] // 64)
    assert boxes["v_boxes"] == -(-widths[1] // 64)
    assert boxes["k_boxes"] * 64 >= dims[0] and boxes["v_boxes"] * 64 >= dims[1]
