"""``bnn_xnor`` parity of the SSM (mamba2-1.3b) and hybrid (zamba2-1.2b,
five layers at period 2: two groups and a tail) models, with ``ssm_proj``
among the binarized targets: the reference's Mamba2 binarizes its z, x, bc,
dt and out projections in this mode, though ``bnn_packed`` never packs
them.  Widths, tolerance and the tie rule as in
``tests/test_torch_xnor.py``: ``d_model`` 65, ``d_ff`` 129, SSM head dim
13, within 1e-4 of the output's largest magnitude.
"""
from __future__ import annotations

import pytest

from test_torch_xnor import check_forward, check_odd_widths, check_prefill_and_decode

ARCHS = ["mamba2-1.3b", "zamba2-1.2b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_no_binarized_contraction_that_feeds_a_sign_has_even_k(arch):
    check_odd_widths(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    check_prefill_and_decode(arch)
