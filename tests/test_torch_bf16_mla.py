"""The bf16 MLA block (minicpm3-4b's, tiny) against the reference run
eagerly under ``jax.disable_jit()``: prefill seeding the latent cache, then
a decode step; bit-exact in ``bnn_packed``, within ``NONE_TOL`` of the
output's scale in ``none``.  Why eager, and the tolerances:
``tests/test_torch_bf16.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16 import MODES, bf16_configs, bf16_pair, eager, port_tree, same
from test_torch_lm import _jit
from repro_torch.layers import mla as tmla

from repro.layers import mla as jmla


@pytest.mark.parametrize("mode", MODES)
def test_mla_block(mode):
    """MLA's projections are never packed, so ``bnn_packed`` runs plain bf16
    products here, exact all the same."""
    jcfg, tcfg = bf16_configs("minicpm3-4b", mode)
    p = _jit(jmla.mla_init, cfg=jcfg, dtype=jnp.bfloat16)(jax.random.PRNGKey(3))
    jx, tx = bf16_pair((2, 11, jcfg.d_model), 5)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    want, wc = eager(jmla.mla_apply, p, jx, jcfg, positions=jnp.asarray(pos), cache_index=jnp.int32(0))
    got, gc = tmla.mla_apply(port_tree(p), tx, tcfg, positions=torch.from_numpy(pos), cache_index=0)
    same(got, want, mode)
    same(gc["c_kv"], wc["c_kv"], mode)
    jx1, tx1 = bf16_pair((2, 1, jcfg.d_model), 6)
    pos1 = np.full((2, 1), 11, np.int32)
    want, _ = eager(jmla.mla_apply, p, jx1, jcfg, positions=jnp.asarray(pos1),
                    layer_cache={"c_kv": wc["c_kv"], "k_rope": wc["k_rope"]}, cache_index=jnp.int32(11))
    got, _ = tmla.mla_apply(port_tree(p), tx1, tcfg, positions=torch.from_numpy(pos1),
                            layer_cache={"c_kv": gc["c_kv"], "k_rope": gc["k_rope"]}, cache_index=11)
    same(got, want, mode)
