"""The bf16 Mamba2 mixer's prefill and a bf16 model's ``forward`` and
``prefill`` (zamba2-1.2b, three layers at period 2: a group of two Mamba2
layers, the shared GQA attention + SwiGLU block, a one-layer tail) against
the reference run eagerly, under ``jax.disable_jit()``: the mixer's conv
tails bit-exact in ``bnn_packed`` and its float32 state within 1e-6 of
its largest magnitude; its output and every output, logit and cache
tensor of the model within ``SSD_TOL`` of their largest magnitude, as
rounding after the SSD's float32 sums allows.  The mixer runs at the
model's own widths and (B, S), so the eager reference compiles each of its
ops once for both.  Decode steps: ``tests/test_torch_bf16_decode.py``.  Why
eager, and why those tolerances: ``tests/test_torch_bf16.py``.  The MoE and
MLA models' blocks are held in ``tests/test_torch_bf16_moe.py`` and
``tests/test_torch_bf16_mla.py``; their model-level float32 parity is in
``tests/test_torch_families.py``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import pytest

from test_torch_bf16 import MODES, NONE_TOL, SSD_TOL, bf16_configs, bf16_pair, eager, near, port_tree, same, to_f32
from test_torch_lm import _jit
from test_torch_ssm_families import batch_of, jax_cache_arrays, to_jax, to_torch
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.layers import mamba2 as tmamba

from repro import models as jm
from repro.layers import mamba2 as jmamba

ARCH = "zamba2-1.2b"
LAYERS = 3  # one group of two and a tail of one
SEQ = 11    # batch_of's positions: the mixer's input is the model's hidden state


def mixer_configs(mode: str):
    return bf16_configs(ARCH, mode, num_layers=LAYERS)


@pytest.mark.parametrize("mode", MODES)
def test_mamba2_mixer_prefill(mode):
    """Prefill seeding a cache: bf16 tails exact, float32 state near, the
    output within ``SSD_TOL``; never packed, so ``bnn_packed`` is plain bf16
    here."""
    jcfg, tcfg = mixer_configs(mode)
    p = _jit(jmamba.mamba2_init, cfg=jcfg, dtype=jnp.bfloat16)(jax.random.PRNGKey(5))
    jx, tx = bf16_pair((2, SEQ, jcfg.d_model), 9)
    want, wc = eager(jmamba.mamba2_apply, p, jx, jcfg, cache_index=jnp.int32(0))
    got, gc = tmamba.mamba2_apply(port_tree(p), tx, tcfg, cache_index=0)
    near(got, want, SSD_TOL if mode == "bnn_packed" else NONE_TOL)
    same(gc["conv_x"], wc["conv_x"], mode)
    same(gc["conv_bc"], wc["conv_bc"], mode)
    near(gc["h"], wc["h"])


@functools.lru_cache(maxsize=None)
def model(arch: str = ARCH):
    """(reference cfg, port cfg, reference params, port params) of the tiny
    bf16 ``bnn_packed`` model."""
    jcfg, tcfg = bf16_configs(arch, num_layers=LAYERS)
    jp = _jit(jm.init_params, cfg=jcfg)(key=jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, convert.lm_params_from_jax(to_f32(jp), tcfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _run(arch: str):
    """Both packages' forward and prefill (the reference eager, once per
    module): {name: (port, reference)}."""
    jcfg, tcfg, jp, tp = model(arch)
    batch = batch_of(jcfg, 8, s=SEQ)
    # remat only changes what a backward pass recomputes; without it the
    # eager forward compiles the ops prefill then reuses
    want, _ = eager(jm.forward, jp, to_jax(batch), jcfg, remat=False)
    out = {"forward": (tm.forward(tp, to_torch(batch), tcfg)[0], want)}
    jlast, jcache = eager(jm.prefill, jp, to_jax(batch), jcfg)
    tlast, tcache = tm.prefill(tp, to_torch(batch), tcfg)
    out["prefill"] = (tlast, jlast)
    out["prefill cache"] = (tm.model.cache_tensors(tcache), jax_cache_arrays(jcache))
    return out


def near_cache(got_tensors, want_arrays) -> None:
    """Every cache tensor (bf16 tails and KV, Mamba2's float32 state) of its
    reference dtype and within ``SSD_TOL`` of its largest magnitude."""
    for got, want in zip(got_tensors, want_arrays, strict=True):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        near(got, want, SSD_TOL)


@pytest.mark.parametrize("arch", [ARCH])
def test_forward(arch):
    got, want = _run(arch)["forward"]
    near(got, want, SSD_TOL)


@pytest.mark.parametrize("arch", [ARCH])
def test_prefill_and_its_cache(arch):
    run = _run(arch)
    near(*run["prefill"], SSD_TOL)
    near_cache(*run["prefill cache"])
