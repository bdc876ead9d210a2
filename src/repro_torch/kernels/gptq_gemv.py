"""Fused W4A16 GEMV, the decode fast lane (counterpart of
``repro.kernels.gptq_gemv.gptq_gemv``).

``gptq_gemv`` launches ``csrc/gptq_gemv.cu`` for CUDA tensors (bias fused
into the single writeback) and runs ``gptq_gemv_plain`` for CPU tensors.
``gptq_gemv.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.gptq_matmul import check_gptq_operands

# M at or below this routes to the GEMV lane (ops.gptq_linear)
GEMV_M_MAX = 8


def gptq_gemv_plain(x, qweight, scales, qzeros, bias=None, *,
                    group_size: int):
    """Plain version: float32 product, bias added in float32, then cast."""
    y = _ref.gptq_matmul_ref(x, qweight, scales, qzeros,
                             group_size=group_size, out_dtype=torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def _lib():
    lib = _build.load("gptq_gemv")
    fn = lib.gptq_gemv
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def gptq_gemv(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
              qzeros: torch.Tensor, bias: torch.Tensor | None = None, *,
              group_size: int) -> torch.Tensor:
    """y = x @ dequant(qweight) + bias for x (M, K) with M <= GEMV_M_MAX."""
    m = x.shape[0]
    if not 1 <= m <= GEMV_M_MAX:
        raise ValueError(f"GEMV lane takes 1..{GEMV_M_MAX} rows, got {m}")
    g = check_gptq_operands(x, qweight, scales, qzeros, group_size)
    if x.device.type == "cpu":
        return gptq_gemv_plain(x, qweight, scales, qzeros, bias, group_size=g)
    operands = [x, qweight, scales, qzeros]
    if bias is not None:
        bias = bias.to(torch.float32)
        operands.append(bias)
    dev = _build.check_cuda_operands("gptq_gemv", *operands)
    k = x.shape[1]
    n = scales.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    rc = _lib()(x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                qzeros.data_ptr(), None if bias is None else bias.data_ptr(),
                y.data_ptr(), m, k, n, g, _build.dtype_code(x.dtype),
                _build.dtype_code(scales.dtype), _build.stream_handle(dev))
    _build.check_launch(rc, "gptq_gemv")
    gptq_gemv.launches += 1
    return y


gptq_gemv.launches = 0
