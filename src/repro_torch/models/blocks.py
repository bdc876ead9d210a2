"""Transformer block, full attention + dense FFN (counterpart of
``repro.models.blocks.block_apply`` and ``block_paged_cache_init``)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import GQA
from repro_torch.models.ffn import MLP


class Block(nn.Module):
    def __init__(self, norm1: torch.Tensor, attn: GQA, norm2: torch.Tensor,
                 ffn: MLP):
        super().__init__()
        self.attn, self.ffn = attn, ffn
        self.register_buffer("norm1", norm1)
        self.register_buffer("norm2", norm2)

    @classmethod
    def init(cls, gen, cfg: ModelConfig, **lin) -> "Block":
        ones = torch.ones((cfg.d_model,), dtype=lin["dtype"],
                          device=lin["device"])
        return cls(ones, GQA.init(gen, cfg, **lin), ones.clone(),
                   MLP.init(gen, cfg, **lin))

    def forward(self, x: torch.Tensor, *, cfg: ModelConfig, **attn_kw
                ) -> torch.Tensor:
        h = L.apply_norm(self.norm1, x, cfg.norm_eps)
        x = x + self.attn(h, cfg=cfg, **attn_kw)
        h = L.apply_norm(self.norm2, x, cfg.norm_eps)
        return x + self.ffn(h)


def block_paged_cache_init(cfg: ModelConfig, num_layers: int, num_pages: int,
                           page_size: int, *, dtype: torch.dtype,
                           device: torch.device, kv_quant=None) -> dict:
    """(num_layers, num_pages + 1, page_size, Hkv, D) K and V pools; page 0
    is the null page (see ``serving/kv_cache.py``).  With an int8
    ``kv_quant`` the pools are int8 and ``k_scales``/``v_scales`` of shape
    (num_layers, num_pages + 1, page_size, Hkv) in its scale dtype sit
    beside them."""
    shape = (num_layers, num_pages + 1, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    if kv_quant is not None and kv_quant.quantized:
        if kv_quant.granularity != "token":
            raise ValueError(
                "the fused paged write path is per-token; per-page scales "
                "are served by the PagedCache data-path API only")
        sdt = kv_quant.scale_torch_dtype
        return {"k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_pages": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scales": torch.zeros(shape[:-1], dtype=sdt, device=device),
                "v_scales": torch.zeros(shape[:-1], dtype=sdt, device=device)}
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
