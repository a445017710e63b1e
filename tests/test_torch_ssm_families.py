"""The port's SSM and hybrid families against the reference: mamba2-1.3b
(ssm) and zamba2-1.2b (hybrid, 5 layers at period 2: two groups and a
one-layer tail); ``tests/test_torch_vlm_audio.py`` holds internvl2-2b (vlm,
8 patch embeddings before the tokens, no decode carry) and hubert-xlarge
(audio, encoder-only over frames) with this file's checks.  Each runs at ``tests/conftest.py::tiny_config`` sizes in float32,
``bnn_packed`` on ``ffn``, ``attn_proj`` and ``moe`` (zamba2's shared block
packed; Mamba2 projections are never packed), the reference's weights
carried across by ``convert.lm_params_from_jax``.

Tolerances (``test_torch_lm._close``, relative to the output's largest
magnitude): 1e-4 for logits and caches; the ``Engine`` serves the
reference's tokens exactly.
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
from repro_torch.configs.archs import ASSIGNED_ARCHS
from repro_torch.layers.mamba2 import SsmCache
from repro_torch.serving import engine as tengine

from repro import models as jm
from repro.configs import get_config as jget
from repro.configs.archs import ASSIGNED_ARCHS as J_ARCHS
from repro.serving import engine as jengine

ARCHS = ["mamba2-1.3b", "zamba2-1.2b"]
LAYERS = {"zamba2-1.2b": 5}  # two groups of two and a tail of one


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, tcfg = configs(arch, mode="bnn_packed", num_layers=LAYERS.get(arch, 2))
    jp = _jit(jm.init_params, cfg=jcfg)(key=jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def batch_of(cfg, seed: int, s: int = 11) -> dict:
    """numpy inputs for ``cfg.input_mode``: tokens, tokens + patches, or frames."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "frames":
        return {"frames": rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)}
    if cfg.input_mode == "tokens+patches":
        batch["patches"] = rng.standard_normal((2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


def jax_cache_arrays(cache) -> list:
    """The reference cache's arrays in the port's ``cache_tensors`` order."""
    out = []
    for f in dataclasses.fields(cache):
        value = getattr(cache, f.name)
        if dataclasses.is_dataclass(value):
            out += jax_cache_arrays(value)
        elif f.name != "index":
            out.append(value)
    return out


def padded_caches(jcfg, tcfg, jcache, tcache, max_len: int = 24):
    """Both prefilled caches installed into fresh batched caches of
    ``max_len`` positions, as each package's ``Engine`` installs a slot."""
    def put(dst, src):
        if src.ndim >= 3 and dst.shape[2] != src.shape[2]:
            src = jnp.pad(src, [(0, 0), (0, 0), (0, dst.shape[2] - src.shape[2])] + [(0, 0)] * (src.ndim - 3))
        return src.astype(dst.dtype) if src.ndim else dst

    jc = jengine._set_index(jax.tree.map(put, jm.init_cache(jcfg, 2, max_len), jcache), int(jcache.index))
    tc = tm.init_cache(tcfg, 2, max_len, device="cpu")
    for dst, src in zip(tm.model.cache_tensors(tc), tm.model.cache_tensors(tcache)):
        dst[:, :, : src.shape[2]] = src
    return jc, tm.model.set_index(tc, tcache.index)


# -- configs and conversion -----------------------------------------------------

def test_every_reference_arch_is_registered_with_its_config():
    assert ASSIGNED_ARCHS == J_ARCHS
    assert tbase.list_archs() == sorted(J_ARCHS)
    for arch in ("mamba2-1.3b", "zamba2-1.2b", "internvl2-2b", "hubert-xlarge"):
        want, got = jget(arch), tbase.get_config(arch)
        for f in dataclasses.fields(want):
            w, g = getattr(want, f.name), getattr(got, f.name)
            if dataclasses.is_dataclass(w):
                assert dataclasses.asdict(g) == dataclasses.asdict(w), (arch, f.name)
            else:
                assert g == w, (arch, f.name)
    assert dataclasses.asdict(tbase.SsmConfig()) == dataclasses.asdict(jget("mamba2-1.3b").ssm.__class__())


def test_convert_unstacks_a_hybrid_tree():
    """Two-axis ``layers`` -> groups of layer dicts, a one-axis ``tail`` ->
    a list, ``shared`` as it is; every leaf bit for bit."""
    jcfg, tcfg, jp, tp = _model("zamba2-1.2b")
    assert len(tp["layers"]) == 2 and all(len(g) == 2 for g in tp["layers"]) and len(tp["tail"]) == 1
    for g in range(2):
        for i in range(2):
            np.testing.assert_array_equal(tp["layers"][g][i]["mamba"]["x_proj"]["w"].numpy(),
                                          np.asarray(jp["layers"]["mamba"]["x_proj"]["w"][g, i]))
    np.testing.assert_array_equal(tp["tail"][0]["mamba"]["A_log"].numpy(), np.asarray(jp["tail"]["mamba"]["A_log"][0]))
    np.testing.assert_array_equal(tp["shared"]["ffn"]["w_up"]["w_packed"].numpy(),
                                  np.asarray(jp["shared"]["ffn"]["w_up"]["w_packed"]).view(np.int32))


def test_convert_keeps_the_ssm_leaves_float32_in_a_bf16_model():
    """``A_log``, ``D`` and ``dt_bias`` stay float32, as the reference's
    ``mamba2_init`` builds them whatever the model's type; the other float
    leaves take the model's bf16."""
    _, tcfg, jp, _ = _model("zamba2-1.2b")
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), dataclasses.replace(tcfg, dtype="bfloat16"),
                                    device="cpu")
    for lp in (tp["layers"][0][1], tp["tail"][0]):
        for name in ("A_log", "D", "dt_bias"):
            assert lp["mamba"][name].dtype == torch.float32, name
        assert lp["mamba"]["x_proj"]["w"].dtype == torch.bfloat16
        assert lp["mamba"]["norm"]["scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["tail"][0]["mamba"]["A_log"].numpy(), np.asarray(jp["tail"]["mamba"]["A_log"][0]))
    assert tp["shared"]["attn"]["wq"]["alpha"].dtype == torch.float32


def test_init_params_lays_out_groups_a_tail_and_the_shared_block():
    _, tcfg, jp, _ = _model("zamba2-1.2b")
    tp = tm.init_params(tcfg, 0, device="cpu")
    assert [len(g) for g in tp["layers"]] == [2, 2] and len(tp["tail"]) == 1
    assert set(tp["shared"]) == set(jp["shared"]) and "w_packed" in tp["shared"]["attn"]["wq"]
    assert set(tp["layers"][0][0]["mamba"]) == set(jp["layers"]["mamba"])
    no_tail = tm.init_params(dataclasses.replace(tcfg, num_layers=4), 0, device="cpu")
    assert "tail" not in no_tail and len(no_tail["layers"]) == 2


# -- the models ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    check_forward(arch)


def check_forward(arch: str) -> None:
    jcfg, tcfg, jp, tp = _model(arch)
    batch = batch_of(jcfg, 6)
    want, _ = _jit(jm.forward, cfg=jcfg)(jp, to_jax(batch))
    got, aux = tm.forward(tp, to_torch(batch), tcfg)
    total = 11 + jcfg.num_patches
    assert got.shape == (2, total, jcfg.vocab_size) and float(aux) == 0.0
    _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_every_decode_step_match_reference(arch):
    check_prefill_and_every_decode_step(arch)


def check_prefill_and_every_decode_step(arch: str) -> None:
    jcfg, tcfg, jp, tp = _model(arch)
    batch = batch_of(jcfg, 8)
    jlast, jcache = _jit(jm.prefill, cfg=jcfg)(jp, to_jax(batch))
    tlast, tcache = tm.prefill(tp, to_torch(batch), tcfg)
    _close(tlast, jlast, 1e-4)
    assert tcache.index == int(jcache.index) == 11 + jcfg.num_patches
    for got, want in zip(tm.model.cache_tensors(tcache), jax_cache_arrays(jcache), strict=True):
        _close(got, want, 1e-4)
    jc, tc = padded_caches(jcfg, tcfg, jcache, tcache)
    tok = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    decode = _jit(jm.decode_step, cfg=jcfg)
    for _ in range(4):
        jl, jc = decode(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc, tcfg)
        _close(tl, jl, 1e-4)
        assert tc.index == int(jc.index)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for got, want in zip(tm.model.cache_tensors(tc), jax_cache_arrays(jc), strict=True):
        _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_ports_own_forward(arch):
    check_prefill_and_decode_against_forward(arch)


def check_prefill_and_decode_against_forward(arch: str) -> None:
    """Prefill of the first 6 tokens (after the patches) and decode of the
    next ones give the full forward's logits."""
    _, tcfg, _, tp = _model(arch)
    batch = to_torch(batch_of(tcfg, 1, s=10))
    full, _ = tm.forward(tp, batch, tcfg)
    p = tcfg.num_patches
    last, cache = tm.prefill(tp, {**batch, "tokens": batch["tokens"][:, :6]}, tcfg)
    _close(last, full[:, p + 5].detach().numpy(), 1e-4)
    padded = tm.init_cache(tcfg, 2, 24, device="cpu")
    for dst, src in zip(tm.model.cache_tensors(padded), tm.model.cache_tensors(cache)):
        dst[:, :, : src.shape[2]] = src
    cache = tm.model.set_index(padded, p + 6)
    for t in range(6, 10):
        logits, cache = tm.decode_step(tp, batch["tokens"][:, t], cache, tcfg)
        _close(logits, full[:, p + t].detach().numpy(), 1e-4)


def test_the_hybrid_cache_shares_its_index():
    _, tcfg, _, _ = _model("zamba2-1.2b")
    cache = tm.init_cache(tcfg, 3, 16, device="cpu")
    assert isinstance(cache, tm.model.HybridCache) and isinstance(cache.ssm, SsmCache)
    assert cache.kv.k.shape[0] == tcfg.num_layers // tcfg.hybrid_period == 2
    assert cache.ssm.h.shape[0] == tcfg.num_layers
    moved = tm.model.set_index(cache, 7)
    assert moved.index == moved.ssm.index == moved.kv.index == 7 and cache.index == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_the_reference_tokens(arch):
    """Slots of unequal prompts share one cache index (the hybrid's shared
    block attends over zero-padded positions), as in the reference."""
    jcfg, tcfg, jp, tp = _model(arch)
    engines = (jengine.Engine(jcfg, jp, max_batch=2, max_len=32),
               tengine.Engine(tcfg, tp, max_batch=2, max_len=32, device="cpu"))
    request = (jengine.Request, tengine.Request)
    for eng, req in zip(engines, request):
        for i, n in enumerate((4, 2, 4)):  # 2 tokens: shorter than W-1
            prompt = ((np.arange(n) * 7 + i) % 90).astype(np.int32)
            eng.submit(req(rid=i, prompt=prompt, max_new_tokens=3 + 2 * i))
    want, got = ([(r.rid, r.output) for r in eng.run()] for eng in engines)
    assert got == want
    assert len({t for _, out in got for t in out}) > 3  # tokens depend on the cache
