"""Attention over a paged KV pool: decode and chunked prefill (counterparts
of ``repro.kernels.paged_attention.paged_attention`` / ``paged_prefill``,
fp pools).

Both wrappers launch ``csrc/paged_attention.cu`` for CUDA tensors and run
their plain versions for CPU tensors.  Each has its own launch counter
(``paged_attention.launches``, ``paged_prefill.launches``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

D_MAX = 128       # head_dim limit of the CUDA kernel (multiple of 32)
ROWS_MAX = 32     # query heads per kv head the kernel holds in one block


def _check(q, k_pages, v_pages, block_tables, h, d):
    _, _, hkv, dk = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) or dk != d:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match head_dim {d}")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if block_tables.dtype != torch.int32:
        raise TypeError("block_tables must be int32")
    if q.device.type == "cuda" and (d % 32 or d > D_MAX
                                    or h // hkv > ROWS_MAX):
        raise ValueError(f"the CUDA kernel takes head_dim a multiple of 32 "
                         f"up to {D_MAX} and at most {ROWS_MAX} query heads "
                         f"per kv head, got D={d}, rep={h // hkv}")
    return hkv


# the plain versions: the CPU lane and the yardstick of the CUDA kernels
paged_attention_plain = _ref.paged_attention_ref
paged_prefill_plain = _ref.paged_prefill_ref


def _fn(name: str, n_ptr: int):
    fn = getattr(_build.load("paged_attention"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        n_int = 7 if name == "paged_prefill" else 6
        fn.argtypes = ([p] * n_ptr + [i] * n_int
                       + [ctypes.c_float, i, i, p])
        fn.restype = ctypes.c_int
    return fn


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """One-token decode attention.  q (B, H, D); pools (P, ps, Hkv, D);
    block_tables (B, maxp) int32; lengths (B,) int32 keys each row sees.
    Returns (B, H, D)."""
    b, h, d = q.shape
    hkv = _check(q, k_pages, v_pages, block_tables, h, d)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     lengths, scale=scale)
    lengths = lengths.to(torch.int32)
    dev = _build.check_cuda_operands("paged_attention", q, k_pages, v_pages,
                                     block_tables, lengths)
    out = torch.empty_like(q)
    ps, maxp = k_pages.shape[1], block_tables.shape[1]
    rc = _fn("paged_attention", 6)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, hkv, d, ps, maxp, scale, _build.dtype_code(q.dtype),
        _build.dtype_code(k_pages.dtype), _build.stream_handle(dev))
    _build.check_launch(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, block_tables: torch.Tensor,
                  seq_start: torch.Tensor, lengths: torch.Tensor, *,
                  scale: float | None = None) -> torch.Tensor:
    """Chunked causal attention over the pool.  q (B, S, H, D): query i of
    row b sits at ``seq_start[b] + i`` (its KV already written); keys at or
    past ``lengths[b]`` are masked.  Returns (B, S, H, D)."""
    b, s, h, d = q.shape
    hkv = _check(q, k_pages, v_pages, block_tables, h, d)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_prefill_plain(q, k_pages, v_pages, block_tables,
                                   seq_start, lengths, scale=scale)
    seq_start = seq_start.to(torch.int32)
    lengths = lengths.to(torch.int32)
    dev = _build.check_cuda_operands("paged_prefill", q, k_pages, v_pages,
                                     block_tables, seq_start, lengths)
    out = torch.empty_like(q)
    ps, maxp = k_pages.shape[1], block_tables.shape[1]
    rc = _fn("paged_prefill", 7)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_start.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, s, h, hkv, d, ps, maxp, scale,
        _build.dtype_code(q.dtype), _build.dtype_code(k_pages.dtype),
        _build.stream_handle(dev))
    _build.check_launch(rc, "paged_prefill")
    paged_prefill.launches += 1
    return out


paged_prefill.launches = 0
