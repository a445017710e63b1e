"""The port's Mamba2 mixer (``repro_torch.layers.mamba2``) against the
reference's ``repro.layers.mamba2``, at ``tests/conftest.py::tiny_config``
sizes of mamba2-1.3b (state 16, SSM head dim 16, chunk 8) in float32.

The same numpy inputs and the reference's weights go through both packages.
Tolerances are ``test_torch_lm._close``'s (relative to the output's largest
magnitude): 1e-5 for the convolution, the SSD scan and one mixer call, whose
float32 sums run in another order than XLA's.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm import _close, _jit, _t
from test_torch_moe import configs
from repro_torch.layers import mamba2 as tmamba

from repro.layers import mamba2 as jmamba

ARCH = "mamba2-1.3b"


@functools.lru_cache(maxsize=None)
def _layer():
    """(reference cfg, port cfg, reference params): one compile per file."""
    jcfg, tcfg = configs(ARCH)
    return jcfg, tcfg, _jit(jmamba.mamba2_init, cfg=jcfg)(jax.random.PRNGKey(5))


@functools.lru_cache(maxsize=None)
def _apply():
    jcfg = _layer()[0]
    return _jit(jmamba.mamba2_apply, cfg=jcfg)


def test_init_matches_the_reference_layout():
    """Keys and shapes as the reference's; ``A_log``, ``D`` and ``dt_bias``
    float32 in a bf16 model; nothing packed.  (The reference's ``out_proj``
    reuses ``z_proj``'s key, so its flattened weights equal z's; the port
    draws its own.)"""
    jcfg, tcfg, p = _layer()
    bf16 = dataclasses.replace(tcfg, dtype="bfloat16")
    tp = tmamba.mamba2_init(torch.Generator().manual_seed(0), bf16, torch.bfloat16)
    assert set(tp) == set(p)
    for name, leaf in tp.items():
        want = p[name]["w"] if isinstance(leaf, dict) and "w" in leaf else p[name]
        got = leaf["w"] if isinstance(leaf, dict) and "w" in leaf else leaf
        if isinstance(got, dict):
            got, want = got["scale"], want["scale"]
        assert tuple(got.shape) == want.shape, name
        assert got.dtype == (torch.float32 if name in ("A_log", "D", "dt_bias") else torch.bfloat16), name
    np.testing.assert_array_equal(np.asarray(p["out_proj"]["w"]).ravel(), np.asarray(p["z_proj"]["w"]).ravel())
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(p["A_log"]), rtol=1e-6)


@pytest.mark.parametrize("s", [1, 3, 12])
def test_causal_conv_matches_reference(s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = jax.jit(jmamba._causal_conv)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(tmamba._causal_conv(*(torch.from_numpy(a) for a in (x, w, b))), want, 1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [16, 13, 5])  # a multiple of the chunk, ragged, below it
def test_ssd_chunked_matches_reference(s, with_h0):
    rng = np.random.default_rng(s + 10 * with_h0)
    b, h, p, n, chunk = 2, 3, 4, 5, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_neg = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((b, h, n, p)).astype(np.float32) if with_h0 else None
    args = (x, dt, a_neg, bm, cm)
    wy, wh = jax.jit(functools.partial(jmamba._ssd_chunked, chunk=chunk))(
        *(jnp.asarray(a) for a in args), h0=None if h0 is None else jnp.asarray(h0))
    gy, gh = tmamba._ssd_chunked(*(torch.from_numpy(a) for a in args), chunk,
                                 h0=None if h0 is None else torch.from_numpy(h0))
    assert gy.shape == (b, s, h, p) and gh.shape == (b, h, n, p)
    _close(gy, wy, 1e-5)
    _close(gh, wh, 1e-5)


def test_ssd_chunked_masks_before_the_product():
    """A steep decay makes the upper triangle's exp(diff) overflow to inf;
    it is masked out before it meets the product, so no NaN appears."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 8, 1, 2)).astype(np.float32)
    dt = np.full((1, 8, 1), 30.0, np.float32)
    bm, cm = (rng.standard_normal((1, 8, 2)).astype(np.float32) for _ in range(2))
    a_neg = np.array([-10.0], np.float32)
    y, h = tmamba._ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, a_neg, bm, cm)), 8)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    wy, _ = jmamba._ssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_neg, bm, cm)), 8)
    _close(y, wy, 1e-5)


@pytest.mark.parametrize("s", [1, 2, 11])  # 1 and 2 tokens are shorter than W-1 = 3
def test_prefill_seeds_the_cache_and_decode_continues(s):
    """Prefill returns the final state and the raw x/bc projections' last
    W-1 rows (left-padded with zeros below W-1 tokens); three O(1) decode
    steps from that cache match the reference's outputs and caches."""
    jcfg, tcfg, p = _layer()
    apply = _apply()
    rng = np.random.default_rng(20 + s)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    want, wc = apply(p, jnp.asarray(x), cache_index=jnp.int32(0))
    got, gc = tmamba.mamba2_apply(_t(p), torch.from_numpy(x), tcfg, cache_index=0)
    _close(got, want, 1e-5)
    assert set(gc) == set(wc) == {"h", "conv_x", "conv_bc"}
    for name in gc:
        assert tuple(gc[name].shape) == wc[name].shape
        _close(gc[name], wc[name], 1e-5)
    if s < 3:
        assert not gc["conv_x"][:, : 3 - s].any()
    tp = _t(p)
    for step in range(3):
        xs = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        want, wc = apply(p, jnp.asarray(xs), layer_cache=wc, cache_index=jnp.int32(s + step))
        got, gc = tmamba.mamba2_apply(tp, torch.from_numpy(xs), tcfg, layer_cache=gc, cache_index=s + step)
        _close(got, want, 1e-5)
        for name in gc:
            _close(gc[name], wc[name], 1e-5)


@pytest.mark.parametrize("s", [2, 40])
def test_prefill_cache_tails_hold_only_their_rows(s):
    """The window tails a prefill returns own storage of their own size: a
    view of the padded projection would hold all S rows alive (per layer,
    until the model's prefill stacks the cache)."""
    _, tcfg, p = _layer()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, s, tcfg.d_model)).astype(np.float32))
    _, gc = tmamba.mamba2_apply(_t(p), x, tcfg, cache_index=0)
    for name in ("conv_x", "conv_bc"):
        t = gc[name]
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_prefill_without_a_cache_index_returns_none():
    jcfg, tcfg, p = _layer()
    x = np.random.default_rng(4).standard_normal((1, 9, jcfg.d_model)).astype(np.float32)
    want, wc = _apply()(p, jnp.asarray(x))
    got, gc = tmamba.mamba2_apply(_t(p), torch.from_numpy(x), tcfg)
    assert gc is None and wc is None
    _close(got, want, 1e-5)


def test_cache_init_shapes_and_types():
    jcfg, tcfg, _ = _layer()
    bf16 = dataclasses.replace(tcfg, dtype="bfloat16")
    want = jmamba.SsmCache.init(dataclasses.replace(jcfg, dtype="bfloat16"), 3, 5)
    got = tmamba.SsmCache.init(bf16, 3, 5, device="cpu")
    for name, dtype in (("h", torch.float32), ("conv_x", torch.bfloat16), ("conv_bc", torch.bfloat16)):
        assert tuple(getattr(got, name).shape) == getattr(want, name).shape
        assert getattr(got, name).dtype == dtype and not getattr(got, name).any()
    assert got.index == int(want.index) == 0
