"""GPTQ weight container and the round-to-nearest quantizer (the part of
``repro.core.gptq`` the serving slice needs).

Layout is AutoGPTQ's (``core/packing.py``): ``qweight (K//8, N) int32``,
``scales (G, N)``, ``qzeros (G, N//8) int32`` and an optional act-order
``perm (K,)``.  The zero-point convention is the modern one: ``w = (q - z) *
s`` with no legacy ``z - 1`` bias.

``quantize_rtn`` reproduces ``repro.core.quantize_model.quantize_params``
with no Hessians bit for bit: with H = I the GPTQ error feedback is zero
(the damped inverse Hessian's upper Cholesky factor is diagonal, and the
feedback masks it to the strictly-upper part), which leaves exactly
round-to-nearest on the min/max grid below.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import packing


@dataclasses.dataclass
class QuantizedLinear:
    """One GPTQ-quantized (K, N) weight matrix (+ optional bias)."""
    qweight: torch.Tensor            # (K//8, N) int32, row-packed nibbles
    scales: torch.Tensor             # (G, N)
    qzeros: torch.Tensor             # (G, N//8) int32, col-packed nibbles
    perm: torch.Tensor | None        # (K,) act-order permutation or None
    bias: torch.Tensor | None        # (N,) or None
    shape: tuple[int, int]           # (K, N) logical
    group_size: int                  # rows per group (K for a single group)


def quant_grid(w_group: torch.Tensor, qmax: int):
    """Per-column asymmetric min/max grid over a (..., g, N) group of rows.
    Returns (scale, zero), each (..., N) float32."""
    wmax = torch.clamp(w_group.amax(dim=-2), min=0.0)
    wmin = torch.clamp(w_group.amin(dim=-2), max=0.0)
    rng = wmax - wmin
    # times the float32 reciprocal, not a division: what XLA compiles
    # ``rng / qmax`` (a constant divisor) to inside repro's jitted GPTQ core
    scale = torch.where(rng > 0, rng * (1.0 / qmax), torch.ones_like(rng))
    zero = torch.clamp(torch.round(-wmin / scale), 0, qmax)
    return scale, zero


def quantize_rtn(w: torch.Tensor, group_size: int = 128, *, bits: int = 4,
                 scale_dtype: torch.dtype = torch.bfloat16,
                 bias: torch.Tensor | None = None) -> QuantizedLinear:
    """Round-to-nearest quantization of ``w`` (K, N) into the AutoGPTQ
    layout.  ``group_size`` -1 (or one that does not divide K) means one
    group over the whole K axis, as ``quantize_params`` does."""
    k, n = w.shape
    if k % 8 or n % 8:
        raise ValueError(f"K, N must be multiples of 8, got {tuple(w.shape)}")
    g = group_size if group_size > 0 and k % group_size == 0 else k
    qmax = (1 << bits) - 1
    wg = w.to(torch.float32).reshape(k // g, g, n)
    scale, zero = quant_grid(wg, qmax)                       # (G, N)
    q = torch.clamp(torch.round(wg / scale[:, None, :]) + zero[:, None, :],
                    0, qmax)
    return QuantizedLinear(
        qweight=packing.pack_int4_rows(q.reshape(k, n).to(torch.int8)),
        scales=scale.to(scale_dtype),
        qzeros=packing.pack_int4_cols(zero.to(torch.int8)),
        perm=None, bias=bias, shape=(k, n), group_size=g)


def dequantize(ql: QuantizedLinear, dtype=torch.float32) -> torch.Tensor:
    """Full dequantization back to (K, N) in *original* row order."""
    k, n = ql.shape
    q = packing.unpack_int4_rows(ql.qweight, k).to(torch.float32)
    z = packing.unpack_int4_cols(ql.qzeros, n).to(torch.float32)
    s = ql.scales.to(torch.float32)
    g = ql.group_size
    w = ((q.reshape(k // g, g, n) - z[:, None, :]) * s[:, None, :]).reshape(k, n)
    if ql.perm is not None:
        w = w[torch.argsort(ql.perm)]
    return w.to(dtype)
