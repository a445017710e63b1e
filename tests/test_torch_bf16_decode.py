"""bf16 decode steps against the reference run eagerly, under
``jax.disable_jit()``: the Mamba2 mixer's and the tiny zamba2-1.2b model's
of ``tests/test_torch_bf16_models.py``.  Both packages start from the same
cache, the port's prefill's (bf16 tensors as they are, the float32 state
too), so each step is held on its own: the mixer's conv tails bit-exact in
``bnn_packed`` and its float32 state within 1e-6 of its largest
magnitude; its output and the model's logits and cache tensors within
``SSD_TOL`` of their largest magnitude.  Why eager, and why those
tolerances: ``tests/test_torch_bf16.py``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16 import MODES, NONE_TOL, SSD_TOL, bf16_pair, eager, near, port_tree, same
from test_torch_bf16_models import ARCH, SEQ, mixer_configs, model, near_cache
from test_torch_lm import _jit
from test_torch_ssm_families import batch_of, jax_cache_arrays, to_torch
from repro_torch import models as tm
from repro_torch.layers import mamba2 as tmamba

from repro import models as jm
from repro.layers import mamba2 as jmamba
from repro.serving import engine as jengine


def to_jax_array(t: torch.Tensor):
    """A port tensor as the reference's array, bf16 through float32 (exact)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def jax_cache_of(template, tensors):
    """``template`` (a reference cache) holding the port's cache tensors,
    taken in ``cache_tensors`` order."""
    changes = {}
    for f in dataclasses.fields(template):
        value = getattr(template, f.name)
        if dataclasses.is_dataclass(value):
            changes[f.name] = jax_cache_of(value, tensors)
        elif f.name != "index":
            changes[f.name] = to_jax_array(next(tensors))
    return dataclasses.replace(template, **changes)


@pytest.mark.parametrize("mode", MODES)
def test_mamba2_mixer_decode(mode):
    """Two decode steps from the port's prefilled cache; never packed, so
    ``bnn_packed`` is plain bf16 here."""
    jcfg, tcfg = mixer_configs(mode)
    p = _jit(jmamba.mamba2_init, cfg=jcfg, dtype=jnp.bfloat16)(jax.random.PRNGKey(5))
    tp = port_tree(p)
    _, tx = bf16_pair((2, SEQ, jcfg.d_model), 9)
    _, gc = tmamba.mamba2_apply(tp, tx, tcfg, cache_index=0)
    wc = {name: to_jax_array(t) for name, t in gc.items()}
    for step in range(2):
        jx1, tx1 = bf16_pair((2, 1, jcfg.d_model), 10 + step)
        want, wc = eager(jmamba.mamba2_apply, p, jx1, jcfg, layer_cache=wc, cache_index=jnp.int32(SEQ + step))
        got, gc = tmamba.mamba2_apply(tp, tx1, tcfg, layer_cache=gc, cache_index=SEQ + step)
        near(got, want, SSD_TOL if mode == "bnn_packed" else NONE_TOL)
        same(gc["conv_x"], wc["conv_x"], mode)
        same(gc["conv_bc"], wc["conv_bc"], mode)
        near(gc["h"], wc["h"])


@functools.lru_cache(maxsize=None)
def _steps(arch: str, max_len: int = 16):
    """Two decode steps of both packages from one cache (the port's
    prefill's, installed in a batched cache of ``max_len`` positions):
    [(port logits, reference logits)] and the final caches."""
    jcfg, tcfg, jp, tp = model(arch)
    tlast, tcache = tm.prefill(tp, to_torch(batch_of(jcfg, 8, s=SEQ)), tcfg)
    tc = tm.init_cache(tcfg, 2, max_len, device="cpu")
    for dst, src in zip(tm.model.cache_tensors(tc), tm.model.cache_tensors(tcache)):
        dst[:, :, : src.shape[2]] = src
    tc = tm.model.set_index(tc, tcache.index)
    jc = jengine._set_index(jax_cache_of(jm.init_cache(jcfg, 2, max_len), iter(tm.model.cache_tensors(tc))),
                            tcache.index)
    tok = tlast.argmax(-1).numpy().astype(np.int32)
    logits = []
    for _ in range(2):
        jl, jc = eager(jm.decode_step, jp, jnp.asarray(tok), jc, jcfg)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc, tcfg)
        logits.append((tl, jl))
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    return logits, (tm.model.cache_tensors(tc), jax_cache_arrays(jc))


@pytest.mark.parametrize("arch", [ARCH])
def test_decode_steps(arch):
    logits, caches = _steps(arch)
    for got, want in logits:
        near(got, want, SSD_TOL)
    near_cache(*caches)
