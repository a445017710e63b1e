"""The port's MoE layer (``repro_torch.layers.moe``) against the reference's
``repro.layers.moe``, at ``tests/conftest.py::tiny_config`` sizes in float32.

Routing indices, capacity positions and packed dots are compared exactly;
float outputs within ``test_torch_lm._close``'s tolerance (relative to the
output's largest magnitude): 1e-5 for one layer.  The reference's weights
are carried across as numpy arrays.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from test_torch_lm import _close, _jit, _t
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.kernels import bnn_matmul, ref
from repro_torch.kernels import ops as kops
from repro_torch.layers import moe as tmoe

from repro.configs.base import QuantConfig as JQuant
from repro.layers import moe as jmoe
from test_layers import dense_moe_reference

TARGETS = ("ffn", "attn_proj", "moe")


def port_config(jcfg, **kw):
    """The port's config equal to the reference's ``jcfg`` (sub-configs and
    quantization rebuilt from the port's schema)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name not in ("name", "quant", "mla", "moe", "ssm")}
    for name, cls in (("moe", tbase.MoeConfig), ("mla", tbase.MlaConfig), ("ssm", tbase.SsmConfig)):
        sub = getattr(jcfg, name)
        if sub is not None:
            fields[name] = cls(**dataclasses.asdict(sub))
    quant = tbase.QuantConfig(mode=jcfg.quant.mode, targets=tuple(jcfg.quant.targets))
    return tbase.get_config(jcfg.name, quant=quant, **fields, **kw)


def configs(name="qwen3-moe-30b-a3b", mode="none", **kw):
    """(reference cfg, port cfg) of a tiny float32 ``name``."""
    jcfg = tiny_config(name, dtype="float32", init_std=0.5, quant=JQuant(mode=mode, targets=TARGETS),
                       **kw)
    return jcfg, port_config(jcfg)


@functools.lru_cache(maxsize=None)
def _layer(arch="qwen3-moe-30b-a3b", mode="none"):
    """(reference cfg, port cfg, reference params, jitted reference
    ``_route``) of one tiny MoE layer (one compile of each per file)."""
    jcfg, tcfg = configs(arch, mode=mode)
    p = _jit(jmoe.moe_init, cfg=jcfg)(jax.random.PRNGKey(4))
    return jcfg, tcfg, p, _jit(jmoe._route, cfg=jcfg)


def _x2(rng, t, d):
    return rng.standard_normal((t, d)).astype(np.float32)


# -- routing ------------------------------------------------------------------

def test_top_k_puts_the_lower_index_first_among_ties():
    logits = np.array([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0] * 5, [0.0, -1.0, 5.0, -1.0, -1.0]],
                      np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(logits), 4)
    gv, gi = tmoe._top_k(torch.from_numpy(logits), 4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_route_matches_reference_with_planted_ties():
    """Integer router weights and activations make every logit an exact
    integer in both packages, so equal logits are frequent; zero rows tie
    every expert.  Indices must be equal, ties resolved toward the lower
    expert index as ``jax.lax.top_k`` does."""
    jcfg, tcfg, p, route = _layer()
    rng = np.random.default_rng(0)
    p = jax.tree.map(np.asarray, p)
    e, d = jcfg.moe.num_experts, jcfg.d_model
    p["router"]["w"] = rng.integers(-1, 2, (e, d)).astype(np.float32)
    p["router"]["w"][5] = p["router"]["w"][2]  # two experts that always tie
    x2 = rng.integers(-1, 2, (200, d)).astype(np.float32)
    x2[:3] = 0.0
    idx, gates, aux = route(jax.tree.map(jnp.asarray, p), jnp.asarray(x2))
    tidx, tgates, taux = tmoe._route(_t(p), torch.from_numpy(x2), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tidx[:3].numpy(), np.tile(np.arange(jcfg.moe.top_k), (3, 1)))
    logits = x2 @ p["router"]["w"].T
    picked = np.take_along_axis(logits, np.asarray(idx), 1)
    assert (np.diff(picked, axis=1) == 0).sum() > 20  # ties inside the top k ...
    kth = picked[:, -1:]
    assert ((logits == kth).sum(1) > 1).sum() > 20    # ... and at its edge
    _close(tgates, gates, 1e-6)
    _close(taux, aux, 1e-5)


# -- packing and the expert kernel's plain version ----------------------------

@pytest.mark.parametrize("k", [64, 100])
def test_pack_experts_matches_reference(k):
    w = np.random.default_rng(k).standard_normal((3, 5, k)).astype(np.float32)
    w[0, 0, :4] = [-0.0, 0.0, -1e-40, 1e-40]
    jp, ja = jax.jit(jmoe._pack_experts)(jnp.asarray(w))
    tp, ta = tmoe._pack_experts(torch.from_numpy(w))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).view(np.int32))
    _close(ta, ja, 1e-6)


def test_moe_init_packs_its_own_weights():
    _, tcfg = configs(mode="bnn_packed")
    m = tcfg.moe
    p = tmoe.moe_init(torch.Generator().manual_seed(3), tcfg)
    assert p["router"]["w"].dtype == torch.float32 and "shared" not in p
    gen = torch.Generator().manual_seed(3)
    torch.randn((m.num_experts, tcfg.d_model), generator=gen)  # the router's draw
    shapes = {"w_gate": (m.expert_ffn_dim, tcfg.d_model), "w_up": (m.expert_ffn_dim, tcfg.d_model),
              "w_down": (tcfg.d_model, m.expert_ffn_dim)}
    for name, (o, i) in shapes.items():
        w = torch.randn((m.num_experts, o, i), generator=gen) * tcfg.init_std
        packed, alpha = tmoe._pack_experts(w)
        assert p[name]["packed"].shape == (m.num_experts, o, -(-i // 32))
        torch.testing.assert_close(p[name]["packed"], packed, rtol=0, atol=0)
        torch.testing.assert_close(p[name]["alpha"], alpha, rtol=0, atol=0)


@pytest.mark.parametrize("e,c,o,k", [(8, 3, 32, 64), (3, 1, 7, 100), (5, 16, 70, 33)])
def test_expert_kernel_plain_version_is_the_reference_dot(e, c, o, k):
    """With alpha = 1 and |x| = 1 everywhere (beta = 1), the reference's
    ``_packed_expert_mm`` returns its integer dot as a float, exactly; the
    expert kernel's plain version (the wrapper's CPU path) must equal it."""
    rng = np.random.default_rng(e * 100 + k)
    x = np.where(rng.random((e, c, k)) < 0.5, -1.0, 1.0).astype(np.float32)
    w = rng.standard_normal((e, o, k)).astype(np.float32)
    packed, _ = jax.jit(jmoe._pack_experts)(jnp.asarray(w))
    jw = {"packed": packed, "alpha": jnp.ones((e, o), jnp.float32)}
    want = np.asarray(jax.jit(jmoe._packed_expert_mm)(jnp.asarray(x), jw))
    tw = torch.from_numpy(np.asarray(packed).view(np.int32).copy())
    xp = kops._pack_rows(torch.from_numpy(x).reshape(e * c, k)).reshape(e, c, -1)
    got = bnn_matmul.bnn_matmul_packed_experts(xp, tw, k_bits=k)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(ref.bnn_matmul_packed_experts_ref(xp, tw, k).numpy(),
                                  got.numpy())
    for i in range(e):
        np.testing.assert_array_equal(got[i].numpy(), ref.bnn_matmul_packed_ref(xp[i], tw[i], k).numpy())


def test_expert_kernel_wrapper_checks_its_operands():
    f = bnn_matmul.bnn_matmul_packed_experts
    x = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="expert count"):
        f(x, torch.zeros((3, 5, 4), dtype=torch.int32), k_bits=128)
    with pytest.raises(ValueError, match="K mismatch"):
        f(x, torch.zeros((2, 5, 3), dtype=torch.int32), k_bits=96)
    with pytest.raises(ValueError, match="int32"):
        f(x.long(), torch.zeros((2, 5, 4), dtype=torch.int64), k_bits=128)
    with pytest.raises(ValueError, match="k_bits"):
        f(x, torch.zeros((2, 5, 4), dtype=torch.int32), k_bits=129)
    with pytest.raises(ValueError, match=r"\(E, C, Kw\)"):
        f(x[0], torch.zeros((5, 4), dtype=torch.int32), k_bits=128)
    assert bnn_matmul.experts_route(torch.zeros((2, 3, 4), dtype=torch.int32),
                                    torch.zeros((2, 5, 4), dtype=torch.int32)) == "stream"
    assert bnn_matmul.experts_route(torch.zeros((2, 17, 4), dtype=torch.int32),
                                    torch.zeros((2, 5, 4), dtype=torch.int32)) == "mma"


@pytest.mark.parametrize("k", [64, 100])
def test_packed_expert_mm_matches_reference(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((4, 6, k)).astype(np.float32)
    w = rng.standard_normal((4, 9, k)).astype(np.float32)
    packed, alpha = jax.jit(jmoe._pack_experts)(jnp.asarray(w))
    want = jax.jit(jmoe._packed_expert_mm)(jnp.asarray(x), {"packed": packed, "alpha": alpha})
    got = tmoe._packed_expert_mm(torch.from_numpy(x), _t({"packed": packed, "alpha": alpha}))
    _close(got, want, 1e-5)


# -- dispatch, experts, combine -----------------------------------------------

@pytest.mark.parametrize("mode", ["none", "bnn_packed"])
@pytest.mark.parametrize("capacity", [3, 40])
def test_expert_compute_matches_reference(mode, capacity):
    """Capacity 3 drops slots (40 tokens x top-2 over 8 experts: 10 a
    expert on average)."""
    jcfg, tcfg, p, route = _layer(mode=mode)
    rng = np.random.default_rng(capacity)
    x2 = _x2(rng, 40, jcfg.d_model)
    idx, gates, _ = route(p, jnp.asarray(x2))
    fn = _jit(jmoe._expert_compute, e_lo=0, num_experts=jcfg.moe.num_experts, capacity=capacity)
    want = fn(jnp.asarray(x2), idx, gates, p["w_gate"], p["w_up"], p["w_down"])
    tp = _t(p)
    got = tmoe._expert_compute(
        torch.from_numpy(x2), torch.from_numpy(np.array(idx)).long(),
        torch.from_numpy(np.array(gates)), tp["w_gate"], tp["w_up"], tp["w_down"],
        num_experts=tcfg.moe.num_experts, capacity=capacity,
    )
    _close(got, want, 1e-5)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=jcfg.moe.num_experts)
    assert (counts > capacity).any() == (capacity < 40)  # drops happen below 40


def test_expert_compute_without_drops_is_the_dense_formula():
    """With capacity for every slot, the dispatch is every token through its
    experts (``tests/test_layers.py::dense_moe_reference``'s formula)."""
    jcfg, tcfg, p, _ = _layer()
    x2 = _x2(np.random.default_rng(5), 12, jcfg.d_model)
    tp = _t(p)
    idx, gates, _ = tmoe._route(tp, torch.from_numpy(x2), tcfg)
    got = tmoe._expert_compute(torch.from_numpy(x2), idx, gates, tp["w_gate"], tp["w_up"],
                               tp["w_down"], num_experts=tcfg.moe.num_experts, capacity=24)
    want = dense_moe_reference(jax.tree.map(np.asarray, p), x2, idx.numpy(), gates.numpy())
    _close(got, want, 1e-5)


@pytest.mark.parametrize("mode", ["none", "bnn_packed"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_moe_apply_matches_reference(mode, arch):
    """deepseek-v2 adds the shared experts (a SwiGLU FFN, packed in
    ``bnn_packed``); the tiny config's capacity factor of 2 drops some."""
    jcfg, tcfg, p, _ = _layer(arch, mode)
    assert ("shared" in p) == (arch == "deepseek-v2-236b")
    x = np.random.default_rng(6).standard_normal((2, 13, jcfg.d_model)).astype(np.float32)
    want, waux = _jit(jmoe.moe_apply, cfg=jcfg)(p, jnp.asarray(x))
    got, aux = tmoe.moe_apply(_t(p), torch.from_numpy(x), tcfg)
    _close(got, want, 1e-5)
    _close(aux, waux, 1e-5)


def test_capacity_is_the_reference_formula():
    """Slots per expert as ``moe_apply`` computes them, at the token counts
    of a decode step of 4 slots, 16- and 128-token prompts and a 2048-token
    scoring pass (the counts that pick the expert kernel's route)."""
    for arch, want in (("qwen3-moe-30b-a3b", [1, 2, 10, 160]), ("deepseek-v2-236b", [1, 1, 6, 96])):
        cfg = tbase.get_config(arch)
        m = cfg.moe
        assert [tmoe.capacity_of(t, cfg) for t in (4, 16, 128, 2048)] == want == [
            max(1, math.ceil(t * m.top_k / m.num_experts * m.capacity_factor)) for t in (4, 16, 128, 2048)]


def test_convert_keeps_the_router_in_float32():
    """A bf16 model's router stays float32, as the reference keeps it
    (``moe_init`` makes it so); the other float leaves become bf16."""
    jcfg = tiny_config("qwen3-moe-30b-a3b", quant=JQuant(mode="bnn_packed", targets=TARGETS))
    tcfg = port_config(jcfg)
    assert tcfg.dtype == "bfloat16"
    p = _jit(jmoe.moe_init, cfg=jcfg, dtype=jnp.bfloat16)(jax.random.PRNGKey(2))
    assert p["router"]["w"].dtype == jnp.float32
    tree = jax.tree.map(np.asarray, {
        "embed": {"table": jnp.ones((jcfg.vocab_size, jcfg.d_model), jnp.bfloat16)},
        "layers": {"attn_norm": {"scale": jnp.ones((1, jcfg.d_model), jnp.bfloat16)},
                   "moe": jax.tree.map(lambda a: a[None], p)},
    })
    tp = convert.lm_params_from_jax(tree, tcfg, device="cpu")
    layer = tp["layers"][0]
    assert layer["moe"]["router"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(layer["moe"]["router"]["w"].numpy(), np.asarray(p["router"]["w"]))
    assert layer["moe"]["w_gate"]["alpha"].dtype == torch.float32
    assert layer["moe"]["w_gate"]["packed"].dtype == torch.int32
    assert layer["attn_norm"]["scale"].dtype == torch.bfloat16
    assert tp["embed"]["table"].dtype == torch.bfloat16
