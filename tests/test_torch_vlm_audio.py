"""The port's VLM (internvl2-2b: 8 patch embeddings before the tokens, no
decode carry) and audio (hubert-xlarge: encoder-only over frames) families
against the reference, with ``tests/test_torch_ssm_families.py``'s checks,
sizes and tolerances: tiny float32 models, ``bnn_packed`` on ``ffn``,
``attn_proj`` and ``moe``, logits and caches within 1e-4 of the output's
largest magnitude (``test_torch_lm._close``).
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from test_torch_ssm_families import (_model, batch_of, check_forward, check_prefill_and_decode_against_forward,
                                     check_prefill_and_every_decode_step, to_torch)
from repro_torch import models as tm
from repro_torch.serving import engine as tengine

from repro import models as jm


@pytest.mark.parametrize("arch", ["internvl2-2b", "hubert-xlarge"])
def test_forward_matches_reference(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ["internvl2-2b"])
def test_prefill_and_every_decode_step_match_reference(arch):
    check_prefill_and_every_decode_step(arch)


@pytest.mark.parametrize("arch", ["internvl2-2b"])
def test_prefill_and_decode_match_the_ports_own_forward(arch):
    check_prefill_and_decode_against_forward(arch)


def test_hubert_is_encoder_only():
    """Bidirectional forward (checked above); no cache, and prefill,
    decode and the ``Engine`` refuse, as the reference's do."""
    jcfg, tcfg, jp, tp = _model("hubert-xlarge")
    assert tm.init_cache(tcfg, 1, 8, device="cpu") is None and jm.init_cache(jcfg, 1, 8) is None
    frames = to_torch(batch_of(tcfg, 2))
    with pytest.raises(ValueError, match="encoder-only"):
        tm.prefill(tp, frames, tcfg)
    with pytest.raises(ValueError, match="encoder-only"):
        tm.decode_step(tp, torch.zeros(2, dtype=torch.long), None, tcfg)
    with pytest.raises(ValueError, match="encoder-only"):
        tengine.Engine(tcfg, tp, device="cpu")
    causal, _ = tm.forward(tp, frames, dataclasses.replace(tcfg, encoder_only=False))
    full, _ = tm.forward(tp, frames, tcfg)
    assert not torch.allclose(causal[:, 0], full[:, 0])  # the first frame sees the rest
