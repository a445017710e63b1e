"""The bf16 MoE FFN (deepseek-v2-236b's, tiny: routed experts and the
shared SwiGLU) against the reference run eagerly under
``jax.disable_jit()``: bit-exact in ``bnn_packed``, within ``NONE_TOL`` of
the output's scale in ``none``; the float32 aux loss within 1e-6.  Why
eager, and the tolerances: ``tests/test_torch_bf16.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest

from test_torch_bf16 import MODES, bf16_configs, bf16_pair, eager, near, port_tree, same
from test_torch_lm import _jit
from repro_torch.layers import moe as tmoe

from repro.layers import moe as jmoe


@pytest.mark.parametrize("mode", MODES)
def test_moe_block(mode):
    """deepseek-v2's MoE: routed experts (packed in ``bnn_packed``) and the
    shared SwiGLU; the router stays float32."""
    jcfg, tcfg = bf16_configs("deepseek-v2-236b", mode)
    p = _jit(jmoe.moe_init, cfg=jcfg, dtype=jnp.bfloat16)(jax.random.PRNGKey(4))
    jx, tx = bf16_pair((2, 11, jcfg.d_model), 7)
    want, waux = eager(jmoe.moe_apply, p, jx, jcfg)
    got, aux = tmoe.moe_apply(port_tree(p), tx, tcfg)
    same(got, want, mode)
    near(aux, waux, 1e-6)
