"""Deterministic, restartable synthetic data pipeline.

Production posture: every batch is a pure function of (seed, step), so
  * restart/resume needs only the step counter (stored in checkpoints);
  * every data-parallel host can materialize exactly its shard
    (``host_slice``) without coordination;
  * there is no filesystem or network dependency in this offline container —
    the token stream is a mixture of Zipf-distributed unigrams and repeated
    n-gram motifs so models have real structure to learn (loss decreases).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int

    def to_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d: dict) -> "PipelineState":
        return PipelineState(int(d["seed"]), int(d["step"]))


class SyntheticTokens:
    """Zipf unigrams + planted n-gram motifs; next-token labels."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        global_batch: int,
        seq_len: int,
        seed: int = 0,
        motif_len: int = 8,
        num_motifs: int = 64,
    ):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.state = PipelineState(seed, 0)
        rng = np.random.default_rng(seed)
        v = cfg.vocab_size
        self.motifs = rng.integers(0, v, size=(num_motifs, motif_len))
        self.motif_len = motif_len

    def _tokens(self, rng: np.random.Generator, b: int, s: int) -> np.ndarray:
        v = self.cfg.vocab_size
        # Zipf-ish unigram draw (bounded to vocab)
        toks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64) % v
        # plant motifs: ~25% of positions covered by repeated n-grams
        n_plants = max(1, s // (self.motif_len * 4))
        for i in range(b):
            ids = rng.integers(0, len(self.motifs), size=n_plants)
            pos = rng.integers(0, s + 1 - self.motif_len, size=n_plants)
            for m, p in zip(ids, pos):
                toks[i, p : p + self.motif_len] = self.motifs[m]
        return toks

    def next_batch(self, host_index: int = 0, host_count: int = 1) -> dict:
        """Materialize this host's slice of the global batch for the current
        step, then advance.  Deterministic in (seed, step, host)."""
        st = self.state
        rng = np.random.default_rng((st.seed, st.step))
        b, s = self.global_batch, self.seq_len
        assert b % host_count == 0, "global batch must divide host count"
        toks = self._tokens(rng, b, s)
        lo = host_index * (b // host_count)
        hi = lo + b // host_count
        self.state = PipelineState(st.seed, st.step + 1)

        cfg = self.cfg
        if cfg.input_mode == "frames":
            frng = np.random.default_rng((st.seed, st.step, 1))
            frames = frng.standard_normal((hi - lo, s, cfg.d_model)).astype(np.float32)
            return {
                "frames": frames,
                "labels": toks[lo:hi, 1:],
            }
        if cfg.input_mode == "tokens+patches":
            prng = np.random.default_rng((st.seed, st.step, 2))
            st_text = s - cfg.num_patches
            patches = prng.standard_normal(
                (hi - lo, cfg.num_patches, cfg.d_model)
            ).astype(np.float32)
            return {
                "tokens": toks[lo:hi, :st_text],
                "patches": patches,
                "labels": toks[lo:hi, 1 : st_text + 1],
            }
        return {"tokens": toks[lo:hi, :-1], "labels": toks[lo:hi, 1:]}
