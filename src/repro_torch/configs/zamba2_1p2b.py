"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf].  Shared transformer block (attention + MLP, one set
of weights) applied every ``hybrid_period`` SSM layers, Zamba-style.
Sub-quadratic majority -> runs ``long_500k``.
"""
from repro_torch.configs.base import ModelConfig, SsmConfig, register


@register("zamba2-1.2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        ssm=SsmConfig(state_dim=64, head_dim=64, expand=2),
        hybrid_period=6,
        sub_quadratic=True,
        max_seq_len=524_288,
    )
