"""The port's bf16 LM path (the type the card serves) against the reference
run eagerly, under ``jax.disable_jit()``.

Jitted, the reference is not one answer to match: XLA's fusions keep float32
between bf16 ops, so its jitted blocks differ from its own eager blocks at
many elements, and ``lax.scan`` compiles its body even outside ``jax.jit``.
Under ``disable_jit()`` every op rounds to bf16 as it is written, as the
port's eager PyTorch does.  Then:

* every block (GQA attention and the SwiGLU and GELU FFNs here; MLA in
  ``tests/test_torch_bf16_mla.py``, the MoE FFN in
  ``tests/test_torch_bf16_moe.py``, the Mamba2 mixer in
  ``tests/test_torch_bf16_models.py`` and ``tests/test_torch_bf16_decode.py``)
  and the whole ``forward`` are bit-exact in ``bnn_packed``, the card's
  mode (``assert_array_equal``);
* the same blocks in ``none`` (plain bf16 products, where PyTorch's CPU
  matmul and XLA's sum in their own orders) within 2e-2 of the output's
  largest magnitude, a few bf16 ulps;
* except downstream of Mamba2's SSD: its float32 einsums sum in another
  order than XLA's (Mamba2's float32 state agrees within 1e-6 of its
  largest magnitude, measured up to 4e-7), and the result is rounded to
  bf16 before ``out_proj``.  Where a value lies within that difference of
  a bf16 rounding boundary the two packages round it apart (2 of 1,408
  elements of one layer in a 3-layer zamba2 with 4 KV heads and d_ff 64),
  and the step passes on to every later layer.  So a Mamba2 mixer's
  output, and every output, logit and cache tensor of a model with SSM
  layers (``tests/test_torch_bf16_models.py``,
  ``tests/test_torch_bf16_decode.py``), is held within ``SSD_TOL`` (one
  bf16 ulp, 2**-7) of its largest magnitude; the mixer's conv tails (raw
  projections of its input) stay bit-exact.

Tiny models (``tests/conftest.py::tiny_config``), ``init_std=0.5``,
``bnn_packed`` on ``ffn``, ``attn_proj`` and ``moe``; the reference's
weights carried across.  Eager JAX compiles every op at each new shape
(about 45 ms each on the CPU), so each file keeps to few shapes and one
block or model.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from test_torch_lm import _jit
from test_torch_moe import TARGETS, port_config
from repro_torch.layers import attention as tattn
from repro_torch.layers import ffn as tffn

from repro.configs.base import QuantConfig as JQuant
from repro.layers import attention as jattn
from repro.layers import ffn as jffn

MODES = ["bnn_packed", "none"]
NONE_TOL = 2e-2
SSD_TOL = 2.0 ** -7   # downstream of Mamba2's float32 SSD (module docstring)


def bf16_configs(arch: str, mode: str = "bnn_packed", **kw):
    jcfg = tiny_config(arch, dtype="bfloat16", init_std=0.5, quant=JQuant(mode=mode, targets=TARGETS), **kw)
    return jcfg, port_config(jcfg)


def to_f32(tree):
    """A reference pytree with bf16 leaves as float32 numpy (exact)."""
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), tree)


def port_tree(tree):
    """A reference layer's parameters as the port's: bf16 leaves stay bf16,
    uint32 words become int32 views, float32 leaves stay float32."""
    def leaf(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
        a = np.asarray(a)
        return torch.from_numpy(a.view(np.int32).copy() if a.dtype == np.uint32 else a.copy())
    return jax.tree.map(leaf, tree)


def bf16_pair(shape, seed: int):
    """The same bf16 values in both packages (numpy float32 rounded once)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def eager(fn, *args, **kw):
    with jax.disable_jit():
        return fn(*args, **kw)


def as_np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


def same(got, want, mode: str = "bnn_packed") -> None:
    """Bit-exact in ``bnn_packed``; within NONE_TOL of the scale in ``none``."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    if mode == "bnn_packed":
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=NONE_TOL * scale)


def near(got, want, tol: float = 1e-6) -> None:
    got, want = as_np(got), as_np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# -- blocks -----------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_gqa_attention_block(mode):
    """Prefill seeding a cache; the decode side runs in
    ``tests/test_torch_bf16_models.py``'s models."""
    jcfg, tcfg = bf16_configs("phi3-mini-3.8b", mode)
    p = _jit(jattn.attention_init, cfg=jcfg, dtype=jnp.bfloat16)(jax.random.PRNGKey(3))
    jx, tx = bf16_pair((2, 11, jcfg.d_model), 3)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    want, wc = eager(jattn.attention_apply, p, jx, jcfg, positions=jnp.asarray(pos), cache_index=jnp.int32(0))
    got, gc = tattn.attention_apply(port_tree(p), tx, tcfg, positions=torch.from_numpy(pos), cache_index=0)
    same(got, want, mode)
    same(gc["k"], wc["k"], mode)
    same(gc["v"], wc["v"], mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_ffn_block(act, mode):
    jcfg, tcfg = bf16_configs("phi3-mini-3.8b", mode, act=act)
    p = _jit(jffn.ffn_init, d=jcfg.d_model, f=jcfg.d_ff, act=act, std=0.5, dtype=jnp.bfloat16,
             quant=jcfg.quant)(jax.random.PRNGKey(2))
    jx, tx = bf16_pair((2, 11, jcfg.d_model), 8)
    same(tffn.ffn_apply(port_tree(p), tx, tcfg), eager(jffn.ffn_apply, p, jx, jcfg), mode)
