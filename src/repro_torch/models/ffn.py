"""Dense SwiGLU feed-forward (counterpart of ``repro.models.ffn.ffn_apply``)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class MLP(nn.Module):
    def __init__(self, w_gate: L.Linear, w_up: L.Linear, w_down: L.Linear):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down

    @classmethod
    def init(cls, gen, cfg: ModelConfig, **lin) -> "MLP":
        if cfg.act != "swiglu":
            raise NotImplementedError(f"activation {cfg.act!r} is not ported")
        return cls(L.linear_init(gen, cfg.d_model, cfg.d_ff, **lin),
                   L.linear_init(gen, cfg.d_model, cfg.d_ff, **lin),
                   L.linear_init(gen, cfg.d_ff, cfg.d_model, **lin))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = L.swiglu(L.linear(self.w_gate, x), L.linear(self.w_up, x))
        return L.linear(self.w_down, h)
