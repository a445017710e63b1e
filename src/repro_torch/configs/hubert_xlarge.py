"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504
— encoder-only, wav2vec2-style stack [arXiv:2106.07447; unverified].

The conv feature extractor is a STUB per the assignment: ``input_specs()``
supplies precomputed frame embeddings (B, S, d_model).  The 504-way output
head is the masked-prediction codebook.  Encoder-only -> no decode step:
``decode_32k`` and ``long_500k`` skipped.  GELU MLP (not gated), no RoPE
(HuBERT uses convolutional relative positions — absorbed into the stubbed
frontend embeddings).
"""
from repro_torch.configs.base import ModelConfig, register


@register("hubert-xlarge")
def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        encoder_only=True,
        input_mode="frames",
        act="gelu",
        rotary_pct=0.0,
    )
