"""LM model configuration schema + registry (the reference's ``configs/base.py``).

One frozen dataclass tree describes an architecture; ``family`` selects the
block wiring in ``repro_torch.models``.  The paper's technique appears as
``QuantConfig`` — binary (XNOR-popcount) projection layers.  The port runs
every family of the reference: dense and MoE (GQA or MLA attention), SSM,
hybrid, VLM and audio.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """N2Net binary quantization of projection matrices.

    Modes:
      * ``bnn_weight_only`` / ``bnn_xnor`` — latent fp weights, binarized
        forward with STE (training-capable).
      * ``bnn_packed`` — inference-only: weights STORED as packed uint32 sign
        words (32 weights/word, int32 bit views in the port) + per-channel
        alpha; the contraction is the XNOR-popcount GEMM.
    """

    mode: str = "none"   # none | bnn_weight_only | bnn_xnor | bnn_packed
    targets: tuple[str, ...] = ("ffn", "attn_proj")

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    @property
    def packed(self) -> bool:
        return self.mode == "bnn_packed"

    @property
    def scale(self) -> str:
        return {
            "bnn_weight_only": "weight_only",
            "bnn_xnor": "xnor",
            "bnn_packed": "xnor",
        }.get(self.mode, "none")


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    num_experts: int               # routed experts
    top_k: int
    expert_ffn_dim: int
    num_shared: int = 0            # always-on shared experts
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MlaConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 = direct q projection
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    """Mamba2 / SSD block parameters."""

    state_dim: int = 128
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def num_ssm_heads(self, d_model: int) -> int:
        return self.expand * d_model // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    max_seq_len: int = 32768
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0        # fraction of head_dim that rotates
    norm_eps: float = 1e-5
    act: str = "swiglu"            # swiglu | gelu
    attention: str = "gqa"         # gqa | mla | none
    mla: Optional[MlaConfig] = None
    moe: Optional[MoeConfig] = None
    ssm: Optional[SsmConfig] = None
    hybrid_period: int = 0         # hybrid: shared attention every N ssm layers
    encoder_only: bool = False
    input_mode: str = "tokens"     # tokens | frames | tokens+patches
    num_patches: int = 0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    quant: QuantConfig = QuantConfig()
    fsdp: bool = False
    remat: bool = True
    attn_q_chunk: int = 1024       # chunked-attention query block
    attn_impl: str = "xla"         # xla (plain chunked attention) |
                                   # pallas_flash (the flash_attention kernel;
                                   # full-sequence forward only)
    attn_scores_dtype: str = "f32" # f32 | bf16
    decode_cache_carry: bool = True  # attend the read-only cache plus the new
                                   # token, then commit one position; False =
                                   # commit first, then attend mask <= index
    ar_bf16: bool = False
    sub_quadratic: bool = False
    init_std: float = 0.02
    microbatches: int = 8
    opt_half_moments: bool = False
    opt_master: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def param_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str, **overrides) -> ModelConfig:
    import repro_torch.configs.archs  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_archs() -> list[str]:
    import repro_torch.configs.archs  # noqa: F401

    return sorted(_REGISTRY)
