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
    for keys, pairs in [(1, 16), (64, 16), (65, 16), (129, 128), (32768, 128), (32768, 16), (524288, 32), (7, 1)]:
        per_split, splits = tdecode.splits_for(keys, pairs, 132)
        tiles = -(-keys // tile)
        assert (splits - 1) * per_split < tiles <= splits * per_split   # every split holds a key
        assert splits <= min(tiles, max(1, -(-tdecode.BLOCKS_PER_SM * 132 // pairs)))
    assert tdecode.splits_for(32768, 128, 132) == (31, 17)    # phi3 decode_32k: 4 x 32 pairs
    assert tdecode.splits_for(129, 16, 132) == (1, 3)


def test_cache_keys_are_the_plain_masks():
    for index, s_max in [(0, 9), (1, 9), (8, 9), (9, 9), (20, 9)]:
        assert tdecode.cache_keys(index, s_max, True) == int((torch.arange(s_max) < index).sum())
        assert tdecode.cache_keys(index, s_max, False) == int((torch.arange(s_max) <= index).sum())


def test_kernel_scale_rounds_as_the_plain_version():
    for scale in (1 / 96 ** 0.5, 1 / 192 ** 0.5, 0.3):
        assert tchunk.kernel_scale(scale, torch.bfloat16) == float(torch.tensor(scale, dtype=torch.bfloat16))
        assert tchunk.kernel_scale(scale, torch.float32) == float(torch.tensor(scale, dtype=torch.float32))
    assert tchunk.route(torch.zeros(1, dtype=torch.bfloat16)) == "mma"
    assert tchunk.route(torch.zeros(1)) == "f32"
