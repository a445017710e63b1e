"""``bnn_xnor`` (binarized activations and weights, latent float weights)
against the reference, at widths where no binarized contraction whose
output feeds a later sign can tie.

``binary_dense_train``'s ``ste_sign(x) @ (wb * alpha).T`` sums K terms of
±alpha.  Where the ±1 dot is 0, which happens only at even K, the float
result is 0 or a rounding residue whose sign depends on the order of the
sum, and XLA and PyTorch sum in different orders; that sign then decides the
next layer's ``ste_sign``.  With every such K odd no dot is 0, and the port
agrees with the reference within ``test_torch_lm._close``'s 1e-4 of the
output's largest magnitude.  The widths: ``d_model`` 65 and ``d_ff`` 129;
MLA's ``kv_lora_rank`` 33 and ``q_lora_rank`` 49; an SSM head dim of 13
(dividing ``expand * 65`` = 130).  The contractions left at even K (the
attention output over heads x head dim, an expert's down projection over
its 32 rows, Mamba2's ``out_proj`` over 130) feed only the residual sum.

Tiny float32 models (``tests/conftest.py::tiny_config``, two layers;
zamba2 five at period 2, with a tail), ``init_std=0.5``, the reference's
latent weights carried across by ``convert.lm_params_from_jax``.  This file
holds the dense models (phi3, chatglm3); ``tests/test_torch_xnor_moe.py``
the MoE (qwen3-moe) and MLA (minicpm3) ones and their ``Engine``s, and
``tests/test_torch_xnor_ssm.py`` the SSM and hybrid ones.
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
from test_torch_lm import _close, _jit
from test_torch_moe import port_config
from test_torch_ssm_families import batch_of, jax_cache_arrays, padded_caches, to_jax, to_torch
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.serving import engine as tengine

from repro import models as jm
from repro.configs import get_config as jget
from repro.configs.base import QuantConfig as JQuant
from repro.serving import engine as jengine

ARCHS = ["phi3-mini-3.8b", "chatglm3-6b"]
LAYERS = {"zamba2-1.2b": 5}


def xnor_configs(arch: str):
    """(reference cfg, port cfg) of a tiny ``bnn_xnor`` ``arch`` at the odd
    widths (module docstring)."""
    full = jget(arch)
    kw = dict(d_model=65, d_ff=129)
    targets = ("ffn", "attn_proj", "moe")
    if full.mla is not None:
        kw["mla"] = dataclasses.replace(full.mla, kv_lora_rank=33, q_lora_rank=49, qk_nope_dim=16,
                                        qk_rope_dim=8, v_head_dim=16)
    if full.ssm is not None:
        kw["ssm"] = dataclasses.replace(full.ssm, state_dim=16, head_dim=13, chunk=8)
        targets = ("ffn", "attn_proj", "ssm_proj")
    jcfg = tiny_config(arch, num_layers=LAYERS.get(arch, 2), dtype="float32", init_std=0.5,
                       quant=JQuant(mode="bnn_xnor", targets=targets), **kw)
    return jcfg, port_config(jcfg)


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    jcfg, tcfg = xnor_configs(arch)
    jp = _jit(jm.init_params, cfg=jcfg)(key=jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_no_binarized_contraction_that_feeds_a_sign_has_even_k(arch):
    check_odd_widths(arch)


def check_odd_widths(arch: str) -> None:
    jcfg, _ = xnor_configs(arch)
    ks = [jcfg.d_model, jcfg.d_ff]
    if jcfg.mla is not None:
        ks += [jcfg.mla.kv_lora_rank, jcfg.mla.q_lora_rank]
    assert all(k % 2 for k in ks), (arch, ks)
    if jcfg.ssm is not None:
        assert (jcfg.ssm.expand * jcfg.d_model) % jcfg.ssm.head_dim == 0
        assert "ssm_proj" in jcfg.quant.targets


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    check_forward(arch)


def check_forward(arch: str) -> None:
    jcfg, tcfg, jp, tp = _model(arch)
    batch = batch_of(jcfg, 6)
    want, waux = _jit(jm.forward, cfg=jcfg)(jp, to_jax(batch))
    got, aux = tm.forward(tp, to_torch(batch), tcfg)
    _close(got, want, 1e-4)
    _close(aux, waux, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    check_prefill_and_decode(arch)


def check_prefill_and_decode(arch: str) -> None:
    jcfg, tcfg, jp, tp = _model(arch)
    batch = batch_of(jcfg, 8)
    jlast, jcache = _jit(jm.prefill, cfg=jcfg)(jp, to_jax(batch))
    tlast, tcache = tm.prefill(tp, to_torch(batch), tcfg)
    _close(tlast, jlast, 1e-4)
    for got, want in zip(tm.model.cache_tensors(tcache), jax_cache_arrays(jcache), strict=True):
        _close(got, want, 1e-4)
    jc, tc = padded_caches(jcfg, tcfg, jcache, tcache)
    tok = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    decode = _jit(jm.decode_step, cfg=jcfg)
    for _ in range(3):
        jl, jc = decode(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc, tcfg)
        _close(tl, jl, 1e-4)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for got, want in zip(tm.model.cache_tensors(tc), jax_cache_arrays(jc), strict=True):
        _close(got, want, 1e-4)


def check_engine(arch: str) -> None:
    """Both ``Engine``s serve three prompts of unequal lengths into two
    slots: the same tokens."""
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
