"""Model configuration (a copy of ``repro.configs.base.ModelConfig``, cut to
the fields the dense full-attention serving path reads)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # this port serves "dense"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    attn_type: str = "gqa"
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0

    norm_type: str = "rmsnorm"
    act: str = "swiglu"
    norm_eps: float = 1e-6

    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
