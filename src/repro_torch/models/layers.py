"""Shared layer primitives (counterpart of ``repro.models.layers``): kernel
config, linear (fp or GPTQ), RMS norms, half-split RoPE, embeddings and
SwiGLU.  Weights are buffers of ``nn.Module`` containers (``.to(device)`` moves
a model); the port serves only, so nothing here needs autograd.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.gptq import QuantizedLinear, quantize_rtn
from repro_torch.core.opt_strategies import OPT4GPTQ, KernelStrategy
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Which kernel strategy quantized linears run.  Only OPT4GPTQ is
    ported; any other strategy raises until the ablation slice ports its
    kernels."""
    strategy: KernelStrategy = OPT4GPTQ

    def __post_init__(self):
        if self.strategy != OPT4GPTQ:
            raise NotImplementedError(
                f"strategy {self.strategy.name!r}: only the OPT4GPTQ lane is "
                f"ported; the ablation kernels come in a later slice")


DEFAULT_KERNELS = KernelConfig()


# ---------------------------------------------------------------------- linear
class Linear(nn.Module):
    """``y = x @ w + b`` where ``w`` is a (K, N) tensor or a
    ``QuantizedLinear``.  Every tensor is a buffer, so ``.to(device)``
    moves the layer."""

    def __init__(self, w, b: torch.Tensor | None = None):
        super().__init__()
        self.quantized = isinstance(w, QuantizedLinear)
        if self.quantized:
            self.shape, self.group_size = w.shape, w.group_size
            for name in ("qweight", "scales", "qzeros", "perm"):
                self.register_buffer(name, getattr(w, name))
            self.register_buffer("qbias", w.bias)
            self.register_buffer("w", None)
        else:
            self.register_buffer("w", w)
        self.register_buffer("b", b)

    @property
    def ql(self) -> QuantizedLinear:
        return QuantizedLinear(self.qweight, self.scales, self.qzeros,
                               self.perm, self.qbias, self.shape,
                               self.group_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self, x)


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    """Apply a linear layer; dispatches on the weight type."""
    if p.quantized:
        y = kops.gptq_linear(p.ql, x)
    else:
        y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(y.dtype)
    return y


def normal(gen: torch.Generator, shape, std: float,
           device: torch.device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * std


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                device: torch.device, dtype: torch.dtype,
                bias: bool = False, quant_group: int | None = None,
                scale_dtype: torch.dtype | None = None) -> Linear:
    """Seeded weight with ``repro``'s scale (``d_in ** -0.5``).  With
    ``quant_group`` the fp matrix is quantized (RTN) at once and dropped, so
    the fp weights of a whole model never coexist."""
    w = normal(gen, (d_in, d_out), d_in ** -0.5, device)
    b = torch.zeros((d_out,), dtype=dtype, device=device) if bias else None
    if quant_group is None:
        return Linear(w.to(dtype), b)
    ql = quantize_rtn(w, quant_group, scale_dtype=scale_dtype or dtype,
                      bias=b)
    return Linear(ql)


# ----------------------------------------------------------------------- norms
def apply_norm(scale: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, computed in float32."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMSNorm over the head_dim of (..., H, D)."""
    return apply_norm(scale, x, eps)


# ------------------------------------------------------------------------ RoPE
def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotary embedding.  x (B, S, H, D); positions (B, S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


# ------------------------------------------------------------------ embeddings
def embed_lookup(embedding: torch.Tensor, ids: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return embedding[ids.long()].to(dtype)


def embed_logits(embedding: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied output head: logits = x @ E^T in float32."""
    return x.to(torch.float32) @ embedding.to(torch.float32).T


# ------------------------------------------------------------------ activations
def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate.to(torch.float32)).to(gate.dtype) * up
