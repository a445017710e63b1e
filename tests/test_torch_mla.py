"""The port's Multi-head Latent Attention (``repro_torch.layers.mla``)
against the reference's ``repro.layers.mla``, at ``tests/conftest.py::
tiny_config`` sizes of minicpm3-4b in float32.

Tolerances are ``test_torch_lm._close``'s (relative to the output's largest
magnitude): 1e-5 for one layer, 1e-4 for a two-layer model's logits and
caches.
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
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.layers import mla as tmla

from repro import models as jm
from repro.layers import mla as jmla

MODES = ["none", "bnn_weight_only", "bnn_packed"]


@functools.lru_cache(maxsize=None)
def _layer(mode: str):
    jcfg, tcfg = configs("minicpm3-4b", mode=mode)
    return jcfg, tcfg, _jit(jmla.mla_init, cfg=jcfg)(jax.random.PRNGKey(3))


def test_mla_init_is_never_packed():
    _, tcfg, p = _layer("bnn_packed")
    tp = tmla.mla_init(torch.Generator().manual_seed(0), tcfg)
    assert set(tp) == set(p) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    for name in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
        assert set(tp[name]) == set(p[name]) == {"w"}
        assert tuple(tp[name]["w"].shape) == p[name]["w"].shape
    no_lora = dataclasses.replace(tcfg, mla=dataclasses.replace(tcfg.mla, q_lora_rank=0))
    assert "wq" in tmla.mla_init(torch.Generator().manual_seed(0), no_lora)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("causal", [True, False])
def test_mla_prefill_matches_reference(mode, causal):
    """Prefill expands K and V (``wkv_b`` binarized in the bnn modes that
    binarize) and seeds the latent cache."""
    jcfg, tcfg, p = _layer(mode)
    x = np.random.default_rng(3).standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    want, wc = _jit(jmla.mla_apply, cfg=jcfg, causal=causal)(
        p, jnp.asarray(x), positions=jnp.asarray(pos), cache_index=jnp.int32(0))
    got, gc = tmla.mla_apply(_t(p), torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
                             cache_index=0, causal=causal)
    _close(got, want, 1e-5)
    _close(gc["c_kv"], wc["c_kv"], 1e-5)
    _close(gc["k_rope"], wc["k_rope"], 1e-5)
    none, _ = tmla.mla_apply(_t(p), torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
                             causal=causal)
    _close(none, want, 1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_mla_absorbed_decode_matches_reference(mode):
    """One decode position against a read-only latent cache of 24 positions
    (index 9): the layer returns the new position's latents uncommitted.
    Decode reads ``wkv_b`` raw in every mode, as the reference does."""
    jcfg, tcfg, p = _layer(mode)
    m = jcfg.mla
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((2, 24, m.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((2, 24, m.qk_rope_dim)).astype(np.float32)
    pos = np.full((2, 1), 9, np.int32)
    want, wc = _jit(jmla.mla_apply, cfg=jcfg)(
        p, jnp.asarray(x), positions=jnp.asarray(pos),
        layer_cache={"c_kv": jnp.asarray(ckv), "k_rope": jnp.asarray(krope)},
        cache_index=jnp.int32(9),
    )
    cache = {"c_kv": torch.from_numpy(ckv.copy()), "k_rope": torch.from_numpy(krope.copy())}
    got, gc = tmla.mla_apply(_t(p), torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
                             layer_cache=cache, cache_index=9)
    _close(got, want, 1e-5)
    assert gc["c_kv"].shape == (2, 1, m.kv_lora_rank) and gc["k_rope"].shape == (2, 1, m.qk_rope_dim)
    _close(gc["c_kv"], wc["c_kv"], 1e-5)
    _close(gc["k_rope"], wc["k_rope"], 1e-5)
    np.testing.assert_array_equal(cache["c_kv"].numpy(), ckv)  # read only


@functools.lru_cache(maxsize=None)
def _model(carry: bool):
    jcfg, tcfg = configs("minicpm3-4b", num_layers=2, decode_cache_carry=carry)
    jp = _jit(jm.init_params, cfg=jcfg)(key=jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.mark.parametrize("carry", [True, False])
def test_mla_model_decode_with_and_without_the_carry(carry):
    """The model's MLA decode: ``decode_cache_carry`` picks the reference's
    carry path or its ys-rewrite path; both commit the same position, and
    the port's logits and latent caches follow the reference's over three
    steps from a zero-padded prefill cache."""
    jcfg, tcfg, jp, tp = _model(carry)
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    jlast, jcache = _jit(jm.prefill, cfg=jcfg)(jp, {"tokens": jnp.asarray(tokens)})
    tlast, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()}, tcfg)
    assert isinstance(tcache, tmla.MlaCache) and tcache.index == int(jcache.index) == 11
    _close(tlast, jlast, 1e-4)
    _close(tcache.c_kv, jcache.c_kv, 1e-4)
    _close(tcache.k_rope, jcache.k_rope, 1e-4)

    def pad(a):
        return np.pad(np.asarray(a), ((0, 0), (0, 0), (0, 5), (0, 0)))

    jc = jcache.__class__(jnp.asarray(pad(jcache.c_kv)), jnp.asarray(pad(jcache.k_rope)), jcache.index)
    tc = tmla.MlaCache(torch.from_numpy(pad(jcache.c_kv)), torch.from_numpy(pad(jcache.k_rope)), 11)
    tok = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    decode = _jit(jm.decode_step, cfg=jcfg)
    for _ in range(3):
        jl, jc = decode(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc, tcfg)
        _close(tl, jl, 1e-4)
        assert tc.index == int(jc.index)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _close(tc.c_kv, jc.c_kv, 1e-4)
    _close(tc.k_rope, jc.k_rope, 1e-4)


def test_mla_cache_init():
    _, tcfg = configs("minicpm3-4b")
    c = tm.init_cache(tcfg, 3, 17, device="cpu")
    assert isinstance(c, tmla.MlaCache) and c.index == 0
    assert c.c_kv.shape == (tcfg.num_layers, 3, 17, tcfg.mla.kv_lora_rank)
    assert c.k_rope.shape == (tcfg.num_layers, 3, 17, tcfg.mla.qk_rope_dim)
    assert c.c_kv.dtype == c.k_rope.dtype == torch.float32
