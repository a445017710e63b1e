"""The port's error-feedback compressors (``repro_torch.optim.compression``)
against the reference's ``Compressor.compress_decompress`` on the same
numpy trees, over 3 rounds that carry the residual.

Tolerance: 1e-6 relative, 1e-7 absolute for ``int8`` and ``topk``; ``sign``'s
per-leaf scale is a ``mean`` that XLA and PyTorch sum in different orders,
so its values agree within a few float32 ulps of the scale (rtol 1e-5).
The signs, the kept top-k positions and the int8 codes are equal.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.optim.compression import Compressor

from repro.optim.compression import Compressor as JCompressor

RTOL = {"sign": 1e-5, "int8": 1e-6, "topk": 1e-6}


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((33, 17)) * scale).astype(np.float32),
            "b": [(rng.standard_normal(129) * scale).astype(np.float32),
                  (rng.standard_normal((4, 4, 5)) * scale).astype(np.float32)]}


def _map(fn, t):
    if isinstance(t, dict):
        return {k: _map(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_map(fn, v) for v in t]
    return fn(t)


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in _leaves(v)]
    return [t]


@pytest.mark.parametrize("kind,frac", [("sign", 0.01), ("int8", 0.01), ("topk", 0.01), ("topk", 0.25)])
def test_matches_reference_over_rounds(kind, frac):
    rng = np.random.default_rng(1)
    jc, tc = JCompressor(kind=kind, topk_frac=frac), Compressor(kind=kind, topk_frac=frac)
    g0 = _tree(rng)
    jerr = jc.init_error(_map(jnp.asarray, g0))
    terr = tc.init_error(_map(torch.from_numpy, g0))
    for _ in range(3):
        g = _tree(rng, scale=0.1)
        jdec, jerr, jratio = jc.compress_decompress(_map(jnp.asarray, g), jerr)
        tdec, terr, tratio = tc.compress_decompress(_map(torch.from_numpy, g), terr)
        assert tratio == jratio
        for got, want in zip(_leaves(tdec) + _leaves(terr), _leaves(jdec) + _leaves(jerr), strict=True):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL[kind], atol=1e-7)
        for got, want in zip(_leaves(tdec), _leaves(jdec)):
            np.testing.assert_array_equal(torch.sign(got).numpy(), np.sign(np.asarray(want)))


@pytest.mark.parametrize("kind", ["sign", "int8", "topk"])
def test_ef_identity(kind):
    """dec + new_err == g + old_err (nothing lost, only deferred)."""
    gen = torch.Generator().manual_seed(0)
    g = {"w": torch.randn(64, generator=gen)}
    e = {"w": torch.randn(64, generator=gen) * 0.1}
    dec, err, ratio = Compressor(kind=kind).compress_decompress(g, e)
    torch.testing.assert_close(dec["w"] + err["w"], g["w"] + e["w"], rtol=1e-5, atol=1e-6)
    assert 0 < ratio <= 1


def test_topk_keeps_ties_at_the_threshold():
    """Every |g| equal to the k-th largest is kept, as the reference keeps it."""
    g = {"w": torch.tensor([3.0, -1.0, 1.0, 1.0, -0.5, 0.0, 2.0, -1.0])}
    dec, _, _ = Compressor(kind="topk", topk_frac=0.5).compress_decompress(g, {"w": torch.zeros(8)})
    jdec, _, _ = JCompressor(kind="topk", topk_frac=0.5).compress_decompress(
        {"w": jnp.asarray(g["w"].numpy())}, {"w": jnp.zeros(8)})
    np.testing.assert_array_equal(dec["w"].numpy(), np.asarray(jdec["w"]))
    assert int((dec["w"] != 0).sum()) == 6


def test_none_passes_through():
    c = Compressor(kind="none")
    g = {"w": torch.ones(4, dtype=torch.bfloat16)}
    err = c.init_error(g)
    dec, err2, ratio = c.compress_decompress(g, err)
    assert dec is g and err2 is err and ratio == 1.0
    assert err["w"].dtype == torch.float32 and not err["w"].any()


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="bogus"):
        Compressor(kind="bogus").compress_decompress({"w": torch.ones(2)}, {"w": torch.zeros(2)})
