"""Attention over a paged KV pool: decode and chunked prefill (counterparts
of ``repro.kernels.paged_attention.paged_attention`` / ``paged_prefill``,
fp pools and int8 pools with scale pools).

Both wrappers launch ``csrc/paged_attention.cu`` for CUDA tensors and run
their plain versions for CPU tensors.  Each kernel has its own launch
counter: ``paged_attention.launches`` and ``paged_prefill.launches`` for fp
pools, ``paged_attention_int8.launches`` and ``paged_prefill_int8.launches``
for int8 pools (the functions ``paged_attention`` / ``paged_prefill`` hand
int8 pools to).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

D_MAX = 128       # head_dim limit of the CUDA kernel (multiple of 32)
ROWS_MAX = 32     # query heads per kv head the kernel holds in one block


def _check(q, k_pages, v_pages, block_tables, h, d, k_scales, v_scales):
    p, ps, hkv, dk = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) or dk != d:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match head_dim {d}")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if block_tables.dtype != torch.int32:
        raise TypeError("block_tables must be int32")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    quantized = k_pages.dtype == torch.int8 or v_pages.dtype == torch.int8
    if quantized != (k_scales is not None):
        raise ValueError("int8 pools need k_scales/v_scales and float pools "
                         "take none")
    if quantized:
        if k_pages.dtype != v_pages.dtype:
            raise TypeError("k_pages and v_pages must both be int8")
        shape = tuple(k_scales.shape)
        if tuple(v_scales.shape) != shape or shape not in ((p, ps, hkv),
                                                           (p, hkv)):
            raise ValueError(f"scale pools {shape} / "
                             f"{tuple(v_scales.shape)} must be (P, ps, Hkv) "
                             f"or (P, Hkv) for pools {tuple(k_pages.shape)}")
        if k_scales.dtype != v_scales.dtype:
            raise TypeError("k_scales and v_scales differ in dtype")
    if q.device.type == "cuda" and (d % 32 or d > D_MAX
                                    or h // hkv > ROWS_MAX):
        raise ValueError(f"the CUDA kernel takes head_dim a multiple of 32 "
                         f"up to {D_MAX} and at most {ROWS_MAX} query heads "
                         f"per kv head, got D={d}, rep={h // hkv}")
    return hkv


# the plain versions: the CPU lane and the yardstick of the CUDA kernels
paged_attention_plain = _ref.paged_attention_ref
paged_prefill_plain = _ref.paged_prefill_ref

# entry point -> (pointer arguments, int arguments before the float scale,
# int arguments after it), as declared in csrc/paged_attention.cu
_SIGNATURES = {"paged_attention": (6, 6, 2), "paged_prefill": (7, 7, 2),
               "paged_attention_int8": (8, 6, 3),
               "paged_prefill_int8": (9, 7, 3)}


def _fn(name: str):
    fn = getattr(_build.load("paged_attention"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        n_ptr, n_int, n_tail = _SIGNATURES[name]
        fn.argtypes = ([p] * n_ptr + [i] * n_int + [ctypes.c_float]
                       + [i] * n_tail + [p])
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, q, k_pages, v_pages, scales, block_tables, rows,
            dims, scale) -> torch.Tensor:
    """Launch entry point ``name``: ``rows`` are the int32 per-row tensors
    (lengths, or seq_start and lengths), ``dims`` the int arguments before
    ``scale``.  Scale pools, when given, go after the pools."""
    rows = [r.to(torch.int32) for r in rows]
    dev = _build.check_cuda_operands(name, q, k_pages, v_pages, *scales,
                                     block_tables, *rows)
    out = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, k_pages, v_pages, *scales,
                                   block_tables, *rows, out)]
    if scales:
        tail = (_build.dtype_code(q.dtype), _build.dtype_code(scales[0].dtype),
                int(scales[0].dim() == 2))
    else:
        tail = (_build.dtype_code(q.dtype), _build.dtype_code(k_pages.dtype))
    rc = _fn(name)(*ptrs, *dims, scale, *tail, _build.stream_handle(dev))
    _build.check_launch(rc, name)
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    k_scales: torch.Tensor | None = None,
                    v_scales: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """One-token decode attention.  q (B, H, D); pools (P, ps, Hkv, D);
    block_tables (B, maxp) int32; lengths (B,) int32 keys each row sees.
    Int8 pools come with ``k_scales``/``v_scales``, (P, ps, Hkv) per-token
    or (P, Hkv) per-page, float32 or bfloat16, dequantized inside the
    kernel (``paged_attention_int8``).  Returns (B, H, D)."""
    if k_scales is not None or v_scales is not None:
        return paged_attention_int8(q, k_pages, v_pages, k_scales, v_scales,
                                    block_tables, lengths, scale=scale)
    b, h, d = q.shape
    hkv = _check(q, k_pages, v_pages, block_tables, h, d, None, None)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     lengths, scale=scale)
    dims = (b, h, hkv, d, k_pages.shape[1], block_tables.shape[1])
    out = _launch("paged_attention", q, k_pages, v_pages, (), block_tables,
                  (lengths,), dims, scale)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_int8(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, k_scales: torch.Tensor,
                         v_scales: torch.Tensor, block_tables: torch.Tensor,
                         lengths: torch.Tensor, *,
                         scale: float | None = None) -> torch.Tensor:
    """``paged_attention`` over int8 pools: the kernel that replaces
    ``_kernel_quant``."""
    b, h, d = q.shape
    hkv = _check(q, k_pages, v_pages, block_tables, h, d, k_scales, v_scales)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     lengths, k_scales=k_scales,
                                     v_scales=v_scales, scale=scale)
    dims = (b, h, hkv, d, k_pages.shape[1], block_tables.shape[1])
    out = _launch("paged_attention_int8", q, k_pages, v_pages,
                  (k_scales, v_scales), block_tables, (lengths,), dims, scale)
    paged_attention_int8.launches += 1
    return out


paged_attention_int8.launches = 0


def paged_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, block_tables: torch.Tensor,
                  seq_start: torch.Tensor, lengths: torch.Tensor, *,
                  k_scales: torch.Tensor | None = None,
                  v_scales: torch.Tensor | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Chunked causal attention over the pool.  q (B, S, H, D): query i of
    row b sits at ``seq_start[b] + i`` (its KV already written); keys at or
    past ``lengths[b]`` are masked.  Int8 pools and their scales as in
    ``paged_attention`` (``paged_prefill_int8``).  Returns (B, S, H, D)."""
    if k_scales is not None or v_scales is not None:
        return paged_prefill_int8(q, k_pages, v_pages, k_scales, v_scales,
                                  block_tables, seq_start, lengths,
                                  scale=scale)
    b, s, h, d = q.shape
    hkv = _check(q, k_pages, v_pages, block_tables, h, d, None, None)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_prefill_plain(q, k_pages, v_pages, block_tables,
                                   seq_start, lengths, scale=scale)
    dims = (b, s, h, hkv, d, k_pages.shape[1], block_tables.shape[1])
    out = _launch("paged_prefill", q, k_pages, v_pages, (), block_tables,
                  (seq_start, lengths), dims, scale)
    paged_prefill.launches += 1
    return out


paged_prefill.launches = 0


def paged_prefill_int8(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, k_scales: torch.Tensor,
                       v_scales: torch.Tensor, block_tables: torch.Tensor,
                       seq_start: torch.Tensor, lengths: torch.Tensor, *,
                       scale: float | None = None) -> torch.Tensor:
    """``paged_prefill`` over int8 pools: the kernel that replaces
    ``_prefill_kernel_quant``."""
    b, s, h, d = q.shape
    hkv = _check(q, k_pages, v_pages, block_tables, h, d, k_scales, v_scales)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_prefill_plain(q, k_pages, v_pages, block_tables,
                                   seq_start, lengths, k_scales=k_scales,
                                   v_scales=v_scales, scale=scale)
    dims = (b, s, h, hkv, d, k_pages.shape[1], block_tables.shape[1])
    out = _launch("paged_prefill_int8", q, k_pages, v_pages,
                  (k_scales, v_scales), block_tables, (seq_start, lengths),
                  dims, scale)
    paged_prefill_int8.launches += 1
    return out


paged_prefill_int8.launches = 0
