"""The port's model families beyond phi3 against the reference, per model:
qwen3-moe-30b-a3b (MoE, GQA), deepseek-v2-236b (MoE with shared experts,
MLA), minicpm3-4b (dense, MLA), stablelm-3b (dense, head dim 16 here and
rotary share 0.25) and chatglm3-6b (dense, rotary share 0.5, no decode
carry).  Each runs at ``tests/conftest.py::tiny_config`` sizes with two
layers in float32, ``bnn_packed`` with the experts packed, the reference's
weights carried across by ``convert.lm_params_from_jax``.

Tolerances (``test_torch_lm._close``, relative to the output's largest
magnitude): 1e-4 for logits and caches, 1e-5 for the aux loss; the
``Engine`` serves the reference's tokens exactly.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm import _close, _jit
from test_torch_moe import configs
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.configs import base as tbase
from repro_torch.layers import mla as tmla
from repro_torch.serving import engine as tengine

from repro import models as jm
from repro.serving import engine as jengine

ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v2-236b", "minicpm3-4b", "stablelm-3b", "chatglm3-6b"]


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, tcfg = configs(arch, mode="bnn_packed", num_layers=2)
    jp = _jit(jm.init_params, cfg=jcfg)(key=jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _cache_arrays(cache):
    return {name: getattr(cache, name) for name in tm.model.cache_fields(cache)}


def test_configs_are_the_reference_configs():
    from repro.configs import get_config as jget

    assert set(ARCHS + ["phi3-mini-3.8b"]) <= set(tbase.list_archs())
    for arch in ARCHS:
        want, got = jget(arch), tbase.get_config(arch)
        for f in dataclasses.fields(want):
            w, g = getattr(want, f.name), getattr(got, f.name)
            if dataclasses.is_dataclass(w):
                assert dataclasses.asdict(g) == dataclasses.asdict(w), (arch, f.name)
            else:
                assert g == w, (arch, f.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    want, waux = _jit(jm.forward, cfg=jcfg)(jp, {"tokens": jnp.asarray(tokens)})
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(tokens).long()}, tcfg)
    assert got.shape == (2, 20, jcfg.vocab_size)
    _close(got, want, 1e-4)
    _close(aux, waux, 1e-5)
    assert (float(aux) > 0) == (jcfg.family == "moe")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_every_decode_step_match_reference(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    jlast, jcache = _jit(jm.prefill, cfg=jcfg)(jp, {"tokens": jnp.asarray(tokens)})
    tlast, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()}, tcfg)
    _close(tlast, jlast, 1e-4)
    assert isinstance(tcache, tmla.MlaCache) == (jcfg.attention == "mla")
    assert tcache.index == int(jcache.index) == 11
    for name, t in _cache_arrays(tcache).items():
        _close(t, getattr(jcache, name), 1e-4)

    def pad(a):
        a = np.asarray(a)
        return np.pad(a, [(0, 0), (0, 0), (0, 5)] + [(0, 0)] * (a.ndim - 3))

    jc = jcache.__class__(*(jnp.asarray(pad(a)) for a in _cache_arrays(jcache).values()), jcache.index)
    tc = tcache.__class__(*(torch.from_numpy(pad(a)) for a in _cache_arrays(jcache).values()), 11)
    tok = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    decode = _jit(jm.decode_step, cfg=jcfg)
    for _ in range(4):
        jl, jc = decode(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc, tcfg)
        _close(tl, jl, 1e-4)
        assert tc.index == int(jc.index)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for name, t in _cache_arrays(tc).items():
        _close(t, getattr(jc, name), 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_ports_own_forward(arch):
    """The serving path's contract (``tests/test_decode_equivalence.py``):
    prefill of 6 tokens and decode of the next ones give the full forward's
    logits, at a capacity factor of 16 so that no MoE slot drops."""
    _, tcfg, _, tp = _model(arch)
    if tcfg.moe is not None:
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=16.0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 10)))
    full, _ = tm.forward(tp, {"tokens": toks}, tcfg)
    last, cache = tm.prefill(tp, {"tokens": toks[:, :6]}, tcfg)
    _close(last, full[:, 5].detach().numpy(), 1e-4)
    padded = tm.init_cache(tcfg, 2, 16, device="cpu")
    for name, t in _cache_arrays(cache).items():
        getattr(padded, name)[:, :, :6] = t
    cache = dataclasses.replace(padded, index=6)
    for t in range(6, 10):
        logits, cache = tm.decode_step(tp, toks[:, t], cache, tcfg)
        _close(logits, full[:, t].detach().numpy(), 1e-4)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "minicpm3-4b"])
def test_engine_serves_the_reference_tokens(arch):
    """Slots of unequal prompts share one cache index, and an empty slot's
    stale token still takes expert capacity: both as in the reference."""
    jcfg, tcfg, jp, tp = _model(arch)
    engines = (jengine.Engine(jcfg, jp, max_batch=2, max_len=32),
               tengine.Engine(tcfg, tp, max_batch=2, max_len=32, device="cpu"))
    request = (jengine.Request, tengine.Request)
    for eng, req in zip(engines, request):
        for i, n in enumerate((4, 9, 4)):
            prompt = ((np.arange(n) * 7 + i) % 90).astype(np.int32)
            eng.submit(req(rid=i, prompt=prompt, max_new_tokens=3 + 2 * i))
    want, got = ([(r.rid, r.output) for r in eng.run()] for eng in engines)
    assert got == want
    assert len({t for _, out in got for t in out}) > 3  # tokens depend on the cache
