"""``bnn_xnor`` parity of the MoE (qwen3-moe-30b-a3b) and MLA (minicpm3-4b)
models, and of their ``Engine``s' tokens.  Widths, tolerance and the tie
rule as in ``tests/test_torch_xnor.py``: ``d_model`` 65, ``d_ff`` 129,
MLA's ``kv_lora_rank`` 33 and ``q_lora_rank`` 49, within 1e-4 of the
output's largest magnitude; the ``Engine``s' tokens equal.
"""
from __future__ import annotations

import pytest

from test_torch_xnor import check_engine, check_forward, check_odd_widths, check_prefill_and_decode

ARCHS = ["qwen3-moe-30b-a3b", "minicpm3-4b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_no_binarized_contraction_that_feeds_a_sign_has_even_k(arch):
    check_odd_widths(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    check_prefill_and_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_the_reference_tokens(arch):
    check_engine(arch)
