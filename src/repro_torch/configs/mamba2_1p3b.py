"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified].
Attention-free -> runs all four shapes including ``long_500k``.
"""
from repro_torch.configs.base import ModelConfig, SsmConfig, register


@register("mamba2-1.3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=1,        # unused (attention-free)
        num_kv_heads=1,
        head_dim=64,
        d_ff=0,             # no MLP: the Mamba2 block is the mixer
        vocab_size=50280,
        attention="none",
        ssm=SsmConfig(state_dim=128, head_dim=64, expand=2),
        sub_quadratic=True,
        max_seq_len=524_288,
    )
