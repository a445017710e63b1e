"""Input pipelines (the reference's ``data/``): ``SyntheticTokens``, a
numpy copy whose batches are a pure function of (seed, step, host)."""
from repro_torch.data.pipeline import PipelineState, SyntheticTokens

__all__ = ["PipelineState", "SyntheticTokens"]
