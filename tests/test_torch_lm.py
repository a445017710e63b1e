"""The port's LM slice against the reference: layers, the dense model and the
serving ``Engine``, at ``tests/conftest.py::tiny_config`` sizes in float32.

The same numpy inputs and the reference's own weights (carried across by
``repro_torch.convert.lm_params_from_jax``) go through both packages.
Layers agree within 1e-5, model logits within 1e-4 (both relative to the
output's largest magnitude), and the ``Engine`` serves the reference's tokens
exactly.  ``init_std=0.5`` makes the greedy
tokens depend on the cache (at the default 0.02 the tiny model repeats its
last input token).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.configs import base as tbase
from repro_torch.layers import attention as tattn
from repro_torch.layers import ffn as tffn
from repro_torch.layers import linear as tlinear
from repro_torch.layers import norms as tnorms
from repro_torch.layers import rope as trope
from repro_torch.serving import engine as tengine

from repro import models as jm
from repro.configs.base import QuantConfig as JQuant
from repro.layers import attention as jattn
from repro.layers import ffn as jffn
from repro.layers import linear as jlinear
from repro.layers import norms as jnorms
from repro.layers import rope as jrope
from repro.serving import engine as jengine

MODES = ["none", "bnn_packed"]


def _configs(mode="none", **kw):
    """The reference's tiny phi3 config and the port's equal one."""
    jcfg = tiny_config(
        "phi3-mini-3.8b", num_layers=2, dtype="float32", init_std=0.5,
        quant=JQuant(mode=mode), **kw,
    )
    fields = {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
        if f.name not in ("name", "quant", "mla", "moe", "ssm")
    }
    return jcfg, tbase.get_config(jcfg.name, quant=tbase.QuantConfig(mode=mode), **fields)


def _jit(fn, **static):
    """The reference function jitted with ``static`` bound (one compile
    instead of one per primitive keeps this file to seconds)."""
    return jax.jit(functools.partial(fn, **static))


def _t(tree):
    """A reference parameter dict -> the port's (uint32 -> int32 views)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.from_numpy(a.view(np.int32).copy() if a.dtype == np.uint32 else a.copy())


def _close(got: torch.Tensor, want, tol):
    """Agreement within ``tol`` relative to the output's scale: float32 sums
    of values near 30 (``init_std=0.5``) round at 1e-6 of that, and the
    jitted reference fuses its sums in another order than the port."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol * scale)


@functools.lru_cache(maxsize=None)
def _model(mode: str):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, tcfg = _configs(mode)
    jp = _jit(jm.init_params, cfg=jcfg)(key=jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(params=MODES)
def model(request):
    return _model(request.param)


# -- layers -----------------------------------------------------------------

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = _jit(jnorms.rmsnorm, eps=1e-5)({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    _close(tnorms.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-5), want, 1e-5)


@pytest.mark.parametrize("pct", [1.0, 0.5, 0.25])
def test_rope_matches_reference(pct):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 109, dtype=np.int32), (2, 9))
    want = _jit(jrope.rotate, theta=10_000.0, rotary_pct=pct)(jnp.asarray(x), jnp.asarray(pos))
    got = trope.rotate(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta=10_000.0, rotary_pct=pct)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("mode,k", [
    ("none", 64), ("bnn_packed", 64), ("bnn_packed", 100), ("bnn_weight_only", 100),
    ("bnn_xnor", 100),
])
def test_dense_apply_matches_reference(mode, k):
    quant = JQuant(mode=mode)
    p = _jit(jlinear.dense_init, in_dim=k, out_dim=48, quant=quant, tag="ffn")(jax.random.PRNGKey(k))
    assert ("w_packed" in p) == (mode == "bnn_packed")
    x = np.random.default_rng(k).standard_normal((2, 3, k)).astype(np.float32)
    want = _jit(jlinear.dense_apply, quant=quant, tag="ffn")(p, jnp.asarray(x))
    got = tlinear.dense_apply(_t(p), torch.from_numpy(x), quant=tbase.QuantConfig(mode=mode), tag="ffn")
    assert got.shape == (2, 3, 48)
    _close(got, want, 1e-5)


def test_dense_init_packs_its_own_weights():
    gen = torch.Generator().manual_seed(0)
    quant = tbase.QuantConfig(mode="bnn_packed")
    p = tlinear.dense_init(gen, 100, 24, quant=quant, tag="ffn")
    w = torch.randn((24, 100), generator=torch.Generator().manual_seed(0)) * 0.02
    assert p["w_packed"].shape == (24, 4) and p["w_packed"].dtype == torch.int32
    x = torch.randn((5, 100), generator=gen)
    want = (torch.where(x >= 0, 1.0, -1.0) @ torch.where(w >= 0, 1.0, -1.0).T
            * w.abs().mean(-1) * x.abs().mean(-1, keepdim=True))
    torch.testing.assert_close(tlinear.dense_apply(p, x), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("mode", MODES)
def test_ffn_matches_reference(act, mode):
    jcfg, tcfg = _configs(mode, act=act)
    p = _jit(jffn.ffn_init, d=64, f=128, act=act, std=0.5, quant=jcfg.quant)(jax.random.PRNGKey(2))
    x = np.random.default_rng(2).standard_normal((2, 7, 64)).astype(np.float32)
    want = _jit(jffn.ffn_apply, cfg=jcfg)(p, jnp.asarray(x))
    _close(tffn.ffn_apply(_t(p), torch.from_numpy(x), tcfg), want, 1e-5)


@pytest.mark.parametrize("mode,causal", [("none", True), ("bnn_packed", True), ("bnn_packed", False)])
def test_attention_prefill_matches_reference(mode, causal):
    jcfg, tcfg = _configs(mode)
    p = _jit(jattn.attention_init, cfg=jcfg)(jax.random.PRNGKey(3))
    x = np.random.default_rng(3).standard_normal((2, 20, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    want, wc = _jit(jattn.attention_apply, cfg=jcfg, causal=causal)(
        p, jnp.asarray(x), positions=jnp.asarray(pos), cache_index=jnp.int32(0))
    got, gc = tattn.attention_apply(_t(p), torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
                                    cache_index=0, causal=causal)
    _close(got, want, 1e-5)
    _close(gc["k"], wc["k"], 1e-5)
    _close(gc["v"], wc["v"], 1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("carry", [True, False])
def test_attention_decode_matches_reference(mode, carry):
    jcfg, tcfg = _configs(mode, decode_cache_carry=carry)
    p = _jit(jattn.attention_init, cfg=jcfg)(jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 24, 2, 16)).astype(np.float32) for _ in range(2))
    pos = np.full((2, 1), 9, np.int32)
    want, wc = _jit(jattn.attention_apply, cfg=jcfg)(
        p, jnp.asarray(x), positions=jnp.asarray(pos),
        layer_cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, cache_index=jnp.int32(9),
    )
    got, gc = tattn.attention_apply(
        _t(p), torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
        layer_cache={"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())},
        cache_index=9,
    )
    _close(got, want, 1e-5)
    _close(gc["k"], wc["k"], 1e-5)
    _close(gc["v"], wc["v"], 1e-5)


def test_chunked_attention_bf16_scores_match_reference():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 12, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 12, 2, 16)).astype(np.float32) for _ in range(2))
    want = jattn.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True, q_chunk=5,
                                   scale=0.25, scores_dtype=jnp.bfloat16)
    got = tattn.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, q_chunk=5,
                                  scale=0.25, scores_dtype=torch.bfloat16)
    _close(got, want, 2e-2)  # bf16 scores keep 8 bits


# -- the model --------------------------------------------------------------

def test_convert_carries_the_weights_exactly(model):
    jcfg, tcfg, jp, tp = model
    assert len(tp["layers"]) == jcfg.num_layers
    for name in ("wq", "wo"):
        leaf = jp["layers"]["attn"][name]
        for li in range(jcfg.num_layers):
            if "w_packed" in leaf:
                np.testing.assert_array_equal(
                    tp["layers"][li]["attn"][name]["w_packed"].numpy(),
                    np.asarray(leaf["w_packed"][li]).view(np.int32))
            else:
                np.testing.assert_array_equal(tp["layers"][li]["attn"][name]["w"].numpy(),
                                              np.asarray(leaf["w"][li]))
    np.testing.assert_array_equal(tp["embed"]["table"].numpy(), np.asarray(jp["embed"]["table"]))


def test_convert_restores_bf16_leaves():
    jcfg, tcfg = _configs("bnn_packed")
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in (jcfg, tcfg))
    jp = _jit(jm.init_params, cfg=jcfg)(key=jax.random.PRNGKey(1))
    as_f32 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), jp)
    tp = convert.lm_params_from_jax(as_f32, tcfg, device="cpu")
    assert tp["embed"]["table"].dtype == torch.bfloat16
    assert tp["layers"][0]["ffn"]["w_up"]["alpha"].dtype == torch.float32
    np.testing.assert_array_equal(tp["embed"]["table"].float().numpy(),
                                  np.asarray(jp["embed"]["table"], np.float32))


def test_forward_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    want, _ = _jit(jm.forward, cfg=jcfg)(jp, {"tokens": jnp.asarray(tokens)})
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(tokens).long()}, tcfg)
    assert got.shape == (2, 20, jcfg.vocab_size) and float(aux) == 0.0
    _close(got, want, 1e-4)


def test_forward_gradients_match_reference_grad():
    """``forward`` is the training forward, as the reference's: gradients of
    a two-layer phi3-shaped ``bnn_weight_only`` model (straight-through
    ``ste_sign`` in every projection) against ``jax.grad`` of the
    reference's ``forward``, leaf by leaf.  Tolerance 1e-4 of each
    gradient's largest magnitude: the float32 rounding that ``_close``
    allows the logits, carried back through two layers (measured gap about
    2e-5)."""
    jcfg, tcfg, jp, tp = _model("bnn_weight_only")
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    cot = np.random.default_rng(9).standard_normal((2, 12, jcfg.vocab_size)).astype(np.float32)

    def jloss(p):
        logits, _ = jm.forward(p, {"tokens": jnp.asarray(tokens)}, jcfg)
        return jnp.sum(logits * cot)

    want = jax.jit(jax.grad(jloss))(jp)
    leaves = {}

    def grad_leaf(path, t):
        leaves[path] = t.detach().clone().requires_grad_(True)
        return leaves[path]

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return grad_leaf(path, node)

    params = walk(tp)
    logits, _ = tm.forward(params, {"tokens": torch.from_numpy(tokens).long()}, tcfg)
    assert logits.requires_grad
    (logits * torch.from_numpy(cot)).sum().backward()
    for path, leaf in leaves.items():
        stacked = path[0] == "layers"  # the reference stacks layers on a leading axis
        node = want["layers"] if stacked else want
        for key in path[2:] if stacked else path:
            node = node[key]
        g = np.asarray(node)[path[1]] if stacked else np.asarray(node)
        assert leaf.grad is not None, path
        scale = float(np.abs(g).max())
        assert scale > 0, path
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=0, atol=1e-4 * scale, err_msg=str(path))


def test_forward_with_flash_matches_reference_xla(model):
    """``attn_impl="pallas_flash"`` runs the flash kernel's path; its logits
    match the reference's plain chunked attention."""
    jcfg, tcfg, jp, tp = model
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = _jit(jm.forward, cfg=jcfg)(jp, {"tokens": jnp.asarray(tokens)})
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(tokens).long()},
                        dataclasses.replace(tcfg, attn_impl="pallas_flash"))
    _close(got, want, 2e-3)


@pytest.mark.parametrize("carry", [True, False])
def test_prefill_and_decode_match_reference(model, carry):
    jcfg, tcfg, jp, tp = model
    jcfg, tcfg = (dataclasses.replace(c, decode_cache_carry=carry) for c in (jcfg, tcfg))
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    jlast, jcache = _jit(jm.prefill, cfg=jcfg)(jp, {"tokens": jnp.asarray(tokens)})
    tlast, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()}, tcfg)
    _close(tlast, jlast, 1e-4)
    assert tcache.index == int(jcache.index) == 11
    _close(tcache.k, jcache.k, 1e-4)
    _close(tcache.v, jcache.v, 1e-4)

    # three decode steps from a zero-padded cache of 16 positions
    def pad(a):
        return np.pad(np.asarray(a), ((0, 0), (0, 0), (0, 5), (0, 0), (0, 0)))

    jc = jcache.__class__(jnp.asarray(pad(jcache.k)), jnp.asarray(pad(jcache.v)), jcache.index)
    tc = tattn.KVCache(torch.from_numpy(pad(jcache.k)), torch.from_numpy(pad(jcache.v)), 11)
    tok = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    decode = _jit(jm.decode_step, cfg=jcfg)
    for _ in range(3):
        jl, jc = decode(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc, tcfg)
        _close(tl, jl, 1e-4)
        assert tc.index == int(jc.index)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _close(tc.k, jc.k, 1e-4)
    _close(tc.v, jc.v, 1e-4)


def test_engine_serves_the_reference_tokens():
    """On the packed model, the slice's serving path."""
    jcfg, tcfg, jp, tp = _model("bnn_packed")
    engines = (jengine.Engine(jcfg, jp, max_batch=2, max_len=64),
               tengine.Engine(tcfg, tp, max_batch=2, max_len=64, device="cpu"))
    request = (jengine.Request, tengine.Request)
    for eng, req in zip(engines, request):
        for i in range(3):
            prompt = ((np.arange(4 + 5 * i) * 7 + i) % 90).astype(np.int32)
            eng.submit(req(rid=i, prompt=prompt, max_new_tokens=3 + 2 * i))
    want, got = ([(r.rid, r.output) for r in eng.run()] for eng in engines)
    assert got == want
    assert len({t for _, out in got for t in out}) > 3  # tokens depend on the cache


# -- what the port refuses --------------------------------------------------

def test_flash_cannot_seed_a_cache(model):
    _, tcfg, _, tp = model
    flash = dataclasses.replace(tcfg, attn_impl="pallas_flash")
    with pytest.raises(ValueError, match="pallas_flash"):
        tm.prefill(tp, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, flash)
    with pytest.raises(ValueError, match="pallas_flash"):
        tengine.Engine(flash, tp, device="cpu")


def test_unported_families_and_missing_card_raise():
    """Every family of the reference is ported (``list_archs`` holds all
    ten archs); a family or an attention that the reference lacks either
    raises ``ValueError``, and the entry points raise without a card
    unless they are asked for the CPU."""
    _, tcfg = _configs()
    for bad in (dict(family="diffusion"), dict(attention="none"),
                dict(family="hybrid", attention="mla", hybrid_period=2)):
        with pytest.raises(ValueError):
            tm.init_params(dataclasses.replace(tcfg, **bad), device="cpu")
        with pytest.raises(ValueError):
            tm.init_cache(dataclasses.replace(tcfg, **bad), 1, 8, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.init_params(tcfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.init_cache(tcfg, 1, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tengine.Engine(tcfg, {})
    assert tbase.list_archs() == ["chatglm3-6b", "deepseek-v2-236b", "hubert-xlarge", "internvl2-2b",
                                  "mamba2-1.3b", "minicpm3-4b", "phi3-mini-3.8b", "qwen3-moe-30b-a3b",
                                  "stablelm-3b", "zamba2-1.2b"]
