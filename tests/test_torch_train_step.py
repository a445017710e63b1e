"""The port's LM training step (``repro_torch.train.train_step``, the
``remat`` forward and ``AdamW.update_``) against the reference's, at
``tests/conftest.py::tiny_config`` sizes in float32, the port's initial
weights carried into the reference's tree (``jax_params``).

Tolerances, each relative to the largest magnitude of what is compared:
  * ``loss_fn``: 1e-5 (float32 sums in another order);
  * every family's gradients, leaf by leaf: 1e-4 (measured 6e-7 to 1.0e-5,
    the most for mamba2: the SSD's float32 state sums);
  * three accumulated ``make_train_step`` steps: losses and grad norms
    1e-5; parameters within 1e-5 of 1 (AdamW's update is about ``lr`` an
    element whatever the gradient's size, so the float32 rounding of a
    gradient moves a parameter by at most a few ulps of it).
Bit for bit: ``forward`` with remat on and off (values and gradients) and
``AdamW.update_`` against ``AdamW.update``.

The reference's SSM gradients are NaN at any chunk of 32 or more
(``src/repro/layers/mamba2.py:117-119``: ``jnp.where`` keeps ``exp(diff)``
at inf in the masked upper triangle, and its VJP multiplies the zero
cotangent by it); the port keeps the formula, and the last test holds the
fact in both packages.  So the SSM families are tested at chunk 8.
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
from test_torch_moe import port_config
from test_torch_xnor import xnor_configs
from repro_torch import convert, tree
from repro_torch import models as tm
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.layers import mamba2 as tmamba
from repro_torch.optim.adamw import AdamW
from repro_torch.train import train_step as tts

from repro import models as jm
from repro.configs.base import QuantConfig as JQuant
from repro.layers import mamba2 as jmamba
from repro.optim.adamw import AdamW as JAdamW
from repro.train import train_step as jts

TARGETS = ("ffn", "attn_proj", "moe", "ssm_proj")
# (arch, quant mode): every family, in a training mode
FAMILIES = [
    ("phi3-mini-3.8b", "none"),
    ("phi3-mini-3.8b", "bnn_xnor"),             # at odd widths (test_torch_xnor)
    ("qwen3-moe-30b-a3b", "bnn_weight_only"),    # MoE, its aux loss
    ("minicpm3-4b", "bnn_weight_only"),          # MLA
    ("mamba2-1.3b", "bnn_weight_only"),          # SSM, chunk 8
    ("zamba2-1.2b", "bnn_weight_only"),          # hybrid: a group and a tail
    ("internvl2-2b", "bnn_weight_only"),         # VLM, 8 patches
    ("hubert-xlarge", "bnn_weight_only"),        # audio, frames, bidirectional
]


def configs(arch: str, mode: str):
    """(reference cfg, port cfg): tiny, float32, 2 layers (zamba2 3)."""
    if mode == "bnn_xnor":
        return xnor_configs(arch)
    jcfg = tiny_config(arch, num_layers=3 if arch.startswith("zamba2") else 2, dtype="float32",
                       quant=JQuant(mode=mode, targets=TARGETS))
    return jcfg, port_config(jcfg)


def _stack(nodes: list):
    """Per-layer port subtrees stacked on a leading axis, as the reference
    stacks its layers."""
    if isinstance(nodes[0], dict):
        return {k: _stack([n[k] for n in nodes]) for k in nodes[0]}
    if isinstance(nodes[0], list):
        return _stack([_stack(n) for n in nodes])
    return np.stack([np.asarray(n) for n in nodes])


def jax_params(tp: dict) -> dict:
    """The port's parameters as the reference's tree (``convert``'s inverse):
    ``layers`` stacked (a hybrid's on (groups, period)), ``tail`` stacked."""
    return {k: jax.tree.map(jnp.asarray, _stack(v) if k in ("layers", "tail") else tree.map(np.asarray, v))
            for k, v in tp.items()}


@functools.lru_cache(maxsize=None)
def _model(arch: str, mode: str):
    """(reference cfg, port cfg, reference params, port params): the port's
    ``init_params`` carried into the reference's tree (jitting the
    reference's ``init_params`` would take seconds a family)."""
    jcfg, tcfg = configs(arch, mode)
    tp = tm.init_params(tcfg, 0, device="cpu")
    return jcfg, tcfg, jax_params(tp), tp


@functools.lru_cache(maxsize=None)
def _reference_grads(arch: str, mode: str):
    """(batch, the reference's loss, metrics and gradients) on ``batch_of``'s
    seed-3 batch (remat off: ``jax.checkpoint`` changes no value and
    lengthens the compile)."""
    jcfg, _, jp, _ = _model(arch, mode)
    batch = batch_of(jcfg, 3)
    loss = functools.partial(jts.loss_fn, cfg=dataclasses.replace(jcfg, remat=False))
    (value, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp, to_jax(batch))
    return batch, value, metrics, grads


def batch_of(cfg, seed: int, s: int = 16, b: int = 2, masked: int = 3) -> dict:
    """numpy inputs and labels for ``cfg.input_mode``; the first row's first
    ``masked`` labels are -1."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.input_mode == "frames":
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        if cfg.input_mode == "tokens+patches":
            batch["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :masked] = -1
    batch["labels"] = labels
    return batch


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k in ("tokens", "labels") else torch.from_numpy(v)
            for k, v in batch.items()}


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def paths(node, path=()):
    """(path, leaf) of a port tree; a path's ints index the port's lists."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from paths(node[k], path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from paths(v, path + (i,))
    else:
        yield path, node


def ref_leaf(jtree, path) -> np.ndarray:
    """The reference leaf at a port path: the keys walk the tree, the list
    indices pick from its stacked leading axes."""
    node = jtree
    for key in (p for p in path if isinstance(p, str)):
        node = node[key]
    return np.asarray(node)[tuple(p for p in path if isinstance(p, int))]


def port_leaf(ttree, path) -> torch.Tensor:
    for key in path:
        ttree = ttree[key]
    return ttree


def close(got, want, tol: float, what=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(), want, rtol=tol, atol=tol * scale,
                               err_msg=str(what))


# -- loss -------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode", [FAMILIES[i] for i in (0, 2, 6)])
def test_loss_fn_matches_reference(arch, mode):
    """Dense, the MoE's aux loss and the VLM's patch offset, with masked
    labels."""
    jcfg, tcfg, _, tp = _model(arch, mode)
    batch, jloss, jmet, _ = _reference_grads(arch, mode)
    with torch.no_grad():
        loss, met = tts.loss_fn(tp, to_torch(batch), tcfg)
    close(loss, jloss, 1e-5)
    close(met["loss"], jmet["loss"], 1e-5)
    close(met["aux"], jmet["aux"], 1e-5)
    assert (float(met["aux"]) > 0) == (jcfg.family == "moe")


def test_loss_fn_masks_labels_below_zero():
    _, tcfg, _, tp = _model("phi3-mini-3.8b", "none")
    batch = to_torch(batch_of(tcfg, 2, masked=0))
    with torch.no_grad():
        logp = torch.log_softmax(tm.forward(tp, batch, tcfg)[0], -1)
        ll = torch.gather(logp, -1, batch["labels"][..., None])[..., 0]
        masked = dict(batch, labels=batch["labels"].clone())
        masked["labels"][:, ::2] = -100
        loss, _ = tts.loss_fn(tp, masked, tcfg)
        everything_masked = dict(batch, labels=torch.full_like(batch["labels"], -1))
        zero, _ = tts.loss_fn(tp, everything_masked, tcfg)
    torch.testing.assert_close(loss, -ll[:, 1::2].mean(), rtol=1e-6, atol=0)
    assert float(zero) == 0.0


# -- gradients ----------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode", FAMILIES)
def test_gradients_match_reference_grad(arch, mode):
    """``_accumulate_grads`` (remat on) against ``jax.grad`` of the
    reference's ``loss_fn``, every leaf within 1e-4 of its largest
    magnitude; the loss's metrics within 1e-5."""
    _, tcfg, _, tp = _model(arch, mode)
    batch, _, jmet, jgrads = _reference_grads(arch, mode)
    grads, met = tts._accumulate_grads(tp, to_torch(batch), tcfg, 1)
    close(met["loss"], jmet["loss"], 1e-5)
    close(met["aux"], jmet["aux"], 1e-5)
    n = 0
    for path, g in paths(grads):
        want = ref_leaf(jgrads, path)
        assert g.shape == want.shape and g.dtype == torch.float32, path
        scale = float(np.abs(want).max())
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4 * scale, err_msg=str(path))
        n += 1
    assert n == len(tree.leaves(tp))


@pytest.mark.parametrize("arch,mode", [FAMILIES[i] for i in (1, 2, 5, 7)])
def test_remat_gives_the_same_bits(arch, mode):
    """``forward(remat=True)`` under grad (one checkpoint a layer, a hybrid
    group with its shared block) against ``remat=False``: logits, aux and
    every gradient equal bit for bit; under ``inference_mode`` remat is off."""
    _, tcfg, _, tp = _model(arch, mode)
    batch = to_torch(batch_of(tcfg, 4))
    cot = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16 + tcfg.num_patches, tcfg.vocab_size)).astype(np.float32))
    out = {}
    for remat in (True, False):
        wrt = [t.detach().requires_grad_(True) for t in tree.leaves(tp)]
        logits, aux = tm.forward(tree.unflatten(tp, wrt), batch, tcfg, remat=remat)
        grads = torch.autograd.grad((logits * cot).sum() + aux, wrt)
        out[remat] = (logits.detach(), aux.detach(), grads)
    for a, b in zip([out[True][0], out[True][1], *out[True][2]], [out[False][0], out[False][1], *out[False][2]]):
        assert torch.equal(a, b)
    with torch.inference_mode():
        scored, _ = tm.forward(tp, batch, tcfg)
    assert torch.equal(scored, out[True][0])


def test_integer_leaves_cannot_be_trained():
    _, tcfg, _, tp = _model("phi3-mini-3.8b", "none")
    packed = dataclasses.replace(tcfg, quant=dataclasses.replace(tcfg.quant, mode="bnn_packed"))
    params = tm.init_params(packed, 0, device="cpu")
    with pytest.raises(ValueError, match="bnn_packed"):
        tts._accumulate_grads(params, to_torch(batch_of(tcfg, 0)), packed, 1)


# -- the step --------------------------------------------------------------------------

def test_three_accumulated_steps_match_reference():
    """``make_train_step`` with microbatches 2 and ``AdamW(lr=1e-3)`` (float32
    master) against the reference's jitted step, three steps on the port's
    ``SyntheticTokens`` batches (equal to the reference's,
    ``tests/test_torch_data.py``), from the reference's initial parameters
    carried across by ``convert.lm_params_from_jax``."""
    jcfg, tcfg = configs("phi3-mini-3.8b", "bnn_weight_only")
    jp = jax.jit(functools.partial(jm.init_params, jcfg))(jax.random.PRNGKey(0))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    params = tree.map(torch.clone, tp)
    jopt, topt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
    jstate, tstate = jopt.init(jp), topt.init(params)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt, microbatches=2))
    tstep = tts.make_train_step(tcfg, topt, microbatches=2)
    data = SyntheticTokens(tcfg, global_batch=4, seq_len=16, seed=0)
    for _ in range(3):
        batch = data.next_batch()
        jp, jstate, jmet = jstep(jp, jstate, to_jax(batch))
        params, tstate, met = tstep(params, tstate, to_torch(batch))
        for key in ("loss", "aux", "grad_norm", "lr"):
            close(met[key], jmet[key], 1e-5, key)
    assert int(tstate.step) == int(jstate.step) == 3
    moved = 0
    for path, p in paths(params):
        want = ref_leaf(jp, path)
        close(p, want, 1e-5, path)
        close(port_leaf(tstate.master, path), ref_leaf(jstate.master, path), 1e-5, path)
        moved += int(not torch.equal(p, port_leaf(tp, path)))
    assert moved == len(tree.leaves(tp))


@pytest.mark.parametrize("dtype,use_master,moments", [
    (torch.float32, True, torch.float32), (torch.bfloat16, True, torch.float32),
    (torch.bfloat16, False, torch.bfloat16), (torch.float32, False, torch.float32)])
def test_update_in_place_is_update(dtype, use_master, moments):
    """``AdamW.update_`` writes over its inputs the bits ``update`` returns,
    over three steps, with a float32 parameter aliasing its master as
    ``update`` leaves it."""
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn((7, 5), generator=gen).to(dtype), "b": [torch.randn(9, generator=gen).to(dtype)]}
    opt = AdamW(lr=1e-2, use_master=use_master, moment_dtype=moments)
    ref_p, ref_s = params, opt.init(params)
    p, s = tree.map(torch.clone, params), opt.init(params)
    for _ in range(3):
        grads = tree.map(lambda t: torch.randn(t.shape, generator=gen).to(dtype), params)
        ref_p, ref_s, ref_m = opt.update(grads, ref_s, ref_p)
        ids = [id(t) for t in tree.leaves((p, s.m, s.v, s.master))]
        p, s, m = opt.update_(grads, s, p)
        assert ids == [id(t) for t in tree.leaves((p, s.m, s.v, s.master))]
        for got, want in zip(tree.leaves((p, s, m)), tree.leaves((ref_p, ref_s, ref_m)), strict=True):
            assert got.dtype == want.dtype and torch.equal(got, want)


# -- the fact ------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_gradients_are_nan_from_chunk_32_in_both_packages(chunk):
    """``_ssd_chunked`` at the reference's initial decay rates (``A`` from 1
    to 16, ``dt`` = softplus(0)): at chunk 32 the masked ``exp(diff)``
    overflows (diff reaches 16 * 0.69 * 31 > 88) and both packages'
    gradients for ``dt`` (which ``dt_proj``, ``dt_bias`` and every layer
    below feed) are NaN, those for ``x`` finite; at chunk 8 (diff at most
    78) both are finite and agree within 1e-5 of their largest magnitude."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 32, 4, 3, 5
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), np.log1p(np.exp(0.0)), np.float32)
    a_neg = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    cot = rng.standard_normal((b, s, h, p)).astype(np.float32)

    def jloss(x, dt):
        y, _ = jmamba._ssd_chunked(x, dt, jnp.asarray(a_neg), jnp.asarray(bm), jnp.asarray(cm), chunk)
        return jnp.sum(y * cot)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(dt))
    xt, dtt = (torch.from_numpy(a).requires_grad_(True) for a in (x, dt))
    y, _ = tmamba._ssd_chunked(xt, dtt, *map(torch.from_numpy, (a_neg, bm, cm)), chunk)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), (xt, dtt))
    for g, w, nan in zip(got, want, (False, chunk == 32)):
        assert bool(np.isnan(np.asarray(w)).any()) == bool(g.isnan().any()) == nan
        if not nan:
            close(g, w, 1e-5)
