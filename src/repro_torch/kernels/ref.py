"""Plain PyTorch versions of the port's kernels (counterparts of
``repro.kernels.ref``).

They are the CPU lane of every kernel wrapper and the yardstick each CUDA
kernel is held against on the card.  The GPTQ product dequantizes in
float32 — the arithmetic of the Pallas kernels and of the CUDA kernels —
and the attention versions gather every sequence's pages into a contiguous
view (dequantized in float32 when the pools are int8), which is exactly
the copy the kernels exist to avoid.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import packing
from repro_torch.core.gptq import QuantizedLinear, dequantize
from repro_torch.serving import kv_quant

_NEG = -1e30     # finite mask value, as in repro's oracles
_Q_BLOCK = 128   # query rows of one prefill logits block (memory only)


def gptq_matmul_ref(x: torch.Tensor, qweight: torch.Tensor,
                    scales: torch.Tensor, qzeros: torch.Tensor, *,
                    group_size: int, out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(qweight) for x (M, K); float32 accumulation."""
    k = qweight.shape[0] * packing.NIBBLES_PER_WORD
    n = scales.shape[1]
    g = group_size if group_size > 0 else k
    w = dequantize(QuantizedLinear(qweight, scales, qzeros, None, None,
                                   (k, n), g))
    y = x.to(torch.float32) @ w
    return y.to(out_dtype or x.dtype)


def _gather(pages: torch.Tensor, block_tables: torch.Tensor,
            scales: torch.Tensor | None = None) -> torch.Tensor:
    """(P, ps, Hkv, D) pool + (B, maxp) table -> (B, maxp*ps, Hkv, D) f32.
    An int8 pool is dequantized in float32 with its (P, ps, Hkv) per-token
    or (P, Hkv) per-page ``scales``, gathered alongside."""
    b = block_tables.shape[0]
    _, _, hkv, d = pages.shape
    idx = block_tables.long()
    kv = pages[idx]                                   # (B, maxp, ps, Hkv, D)
    if scales is not None:
        kv = kv_quant.dequantize(kv, scales[idx])
    return kv.reshape(b, -1, hkv, d).to(torch.float32)


def _check_scales(k_scales, v_scales):
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor, *,
                        k_scales: torch.Tensor | None = None,
                        v_scales: torch.Tensor | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """One-token decode attention over a page pool.  q (B, H, D); pools
    (P, ps, Hkv, D), int8 with ``k_scales``/``v_scales`` (P, ps, Hkv) or
    (P, Hkv); block_tables (B, maxp); lengths (B,).  Keys at positions >=
    lengths are masked; a length-0 row yields exact zeros."""
    _check_scales(k_scales, v_scales)
    b, h, d = q.shape
    hkv = k_pages.shape[2]
    rep = h // hkv
    k = _gather(k_pages, block_tables, k_scales)
    v = _gather(v_pages, block_tables, v_scales)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, rep, d).to(torch.float32)
    logits = torch.einsum("bgrd,bkgd->bgrk", qg, k) * scale
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None, :] < lengths.to(q.device)[:, None]          # (B, L)
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, _NEG))
    p = torch.softmax(logits, dim=-1) * mask[:, None, None]
    out = torch.einsum("bgrk,bkgd->bgrd", p, v)
    return out.reshape(b, h, d).to(q.dtype)


def paged_prefill_ref(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_tables: torch.Tensor,
                      seq_start: torch.Tensor, lengths: torch.Tensor, *,
                      k_scales: torch.Tensor | None = None,
                      v_scales: torch.Tensor | None = None,
                      scale: float | None = None) -> torch.Tensor:
    """Chunked causal attention over a page pool.  q (B, S, H, D): query i
    of row b sits at ``seq_start[b] + i``; keys are visible when ``kpos <=
    qpos`` and ``kpos < lengths[b]``; int8 pools come with scales as in
    ``paged_attention_ref``.  Fully masked query rows yield exact zeros.
    Queries go in blocks of ``_Q_BLOCK`` rows to bound the logits' memory;
    the result does not depend on the block."""
    _check_scales(k_scales, v_scales)
    b, s, h, d = q.shape
    hkv = k_pages.shape[2]
    rep = h // hkv
    k = _gather(k_pages, block_tables, k_scales)
    v = _gather(v_pages, block_tables, v_scales)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kpos = torch.arange(k.shape[1], device=q.device)
    start = seq_start.to(q.device)
    length = lengths.to(q.device)
    out = torch.empty_like(q)
    for c0 in range(0, s, _Q_BLOCK):
        qc = q[:, c0:c0 + _Q_BLOCK].to(torch.float32)
        sc = qc.shape[1]
        qg = qc.reshape(b, sc, hkv, rep, d)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) * scale
        qpos = start[:, None] + torch.arange(c0, c0 + sc, device=q.device)
        mask = ((kpos[None, None, :] <= qpos[:, :, None])
                & (kpos[None, None, :] < length[:, None, None]))  # (B, Sc, L)
        logits = torch.where(mask[:, None, None], logits,
                             torch.full_like(logits, _NEG))
        p = torch.softmax(logits, dim=-1) * mask[:, None, None]
        o = torch.einsum("bgrqk,bkgd->bqgrd", p, v)
        out[:, c0:c0 + sc] = o.reshape(b, sc, h, d).to(q.dtype)
    return out
