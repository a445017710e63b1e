"""The port's data pipeline (``repro_torch.data.pipeline``, a numpy copy)
against the reference's: every batch equal, element for element, in the
three input modes over several steps; determinism across restarts; host
slicing.  Configs: ``tests/conftest.py::tiny_config``."""
from __future__ import annotations

import numpy as np
import pytest

from conftest import tiny_config
from test_torch_moe import port_config
from repro_torch.data.pipeline import PipelineState, SyntheticTokens

from repro.data.pipeline import SyntheticTokens as JSyntheticTokens

MODES = {"tokens": "phi3-mini-3.8b", "frames": "hubert-xlarge", "tokens+patches": "internvl2-2b"}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 11])
def test_batches_equal_the_reference(mode, seed):
    jcfg = tiny_config(MODES[mode])
    tcfg = port_config(jcfg)
    assert tcfg.input_mode == mode
    want = JSyntheticTokens(jcfg, global_batch=4, seq_len=24, seed=seed)
    got = SyntheticTokens(tcfg, global_batch=4, seq_len=24, seed=seed)
    np.testing.assert_array_equal(got.motifs, want.motifs)
    for _ in range(3):
        w, g = want.next_batch(), got.next_batch()
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert got.state == PipelineState(seed, 3) and want.state.to_dict() == got.state.to_dict()


def test_determinism_across_restarts():
    cfg = port_config(tiny_config("phi3-mini-3.8b"))
    a = SyntheticTokens(cfg, global_batch=4, seq_len=16, seed=3)
    b1 = a.next_batch()
    b2 = a.next_batch()
    b = SyntheticTokens(cfg, global_batch=4, seq_len=16, seed=3)
    b.state = PipelineState.from_dict(PipelineState(3, 1).to_dict())
    np.testing.assert_array_equal(b.next_batch()["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b2["tokens"])


@pytest.mark.parametrize("mode", MODES)
def test_host_slicing_partitions_the_global_batch(mode):
    jcfg = tiny_config(MODES[mode])
    tcfg = port_config(jcfg)
    full = SyntheticTokens(tcfg, global_batch=8, seq_len=16, seed=5).next_batch()
    for key in full:
        parts = [SyntheticTokens(tcfg, global_batch=8, seq_len=16, seed=5).next_batch(h, 4)[key]
                 for h in range(4)]
        want = JSyntheticTokens(jcfg, global_batch=8, seq_len=16, seed=5).next_batch(2, 4)[key]
        np.testing.assert_array_equal(parts[2], want)
        if key in ("tokens", "labels"):
            np.testing.assert_array_equal(np.concatenate(parts, 0), full[key])
        else:  # seeded per (seed, step): a host's rows are drawn for its slice alone
            assert parts[0].shape[0] == 2
