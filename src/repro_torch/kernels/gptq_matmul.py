"""Fused W4A16 GEMM, the OPT4GPTQ lane (counterpart of
``repro.kernels.gptq_matmul.gptq_matmul``).

``gptq_matmul`` launches ``csrc/gptq_matmul.cu`` for CUDA tensors and runs
the plain version ``gptq_matmul_plain`` for CPU tensors; there is no other
route.  ``gptq_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

NIB = packing.NIBBLES_PER_WORD


def check_gptq_operands(x: torch.Tensor, qweight: torch.Tensor,
                        scales: torch.Tensor, qzeros: torch.Tensor,
                        group_size: int) -> int:
    """Validate the packed layout for (M, K) x and return the resolved
    group (K for ``group_size`` -1).  Shared with the GEMV lane."""
    m, k = x.shape
    n = scales.shape[1]
    g = group_size if group_size > 0 else k
    if k % NIB or n % NIB:
        raise ValueError(f"K={k}, N={n} must be multiples of {NIB} for the "
                         f"int4 packing")
    if g % NIB or k % g:
        raise ValueError(f"group_size={group_size} must be a multiple of "
                         f"{NIB} that divides K={k}")
    if (tuple(qweight.shape) != (k // NIB, n)
            or tuple(scales.shape) != (k // g, n)
            or tuple(qzeros.shape) != (k // g, n // NIB)):
        raise ValueError(
            f"packed shapes qweight {tuple(qweight.shape)}, scales "
            f"{tuple(scales.shape)}, qzeros {tuple(qzeros.shape)} do not "
            f"match K={k}, N={n}, group={g}")
    if qweight.dtype != torch.int32 or qzeros.dtype != torch.int32:
        raise TypeError("qweight and qzeros must be int32")
    return g


# plain version: float32 dequantization, float32 product, x's dtype out
gptq_matmul_plain = _ref.gptq_matmul_ref


def _lib():
    lib = _build.load("gptq_matmul")
    fn = lib.gptq_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def gptq_matmul(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                qzeros: torch.Tensor, *, group_size: int) -> torch.Tensor:
    """y = x @ dequant(qweight, scales, qzeros) for x (M, K); y has x's
    dtype.  The caller applies the act-order gather and the bias
    (``ops.gptq_linear``)."""
    g = check_gptq_operands(x, qweight, scales, qzeros, group_size)
    if x.device.type == "cpu":
        return gptq_matmul_plain(x, qweight, scales, qzeros, group_size=g)
    dev = _build.check_cuda_operands("gptq_matmul", x, qweight, scales,
                                     qzeros)
    m, k = x.shape
    n = scales.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    rc = _lib()(x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                qzeros.data_ptr(), y.data_ptr(), m, k, n, g,
                _build.dtype_code(x.dtype), _build.dtype_code(scales.dtype),
                _build.stream_handle(dev))
    _build.check_launch(rc, "gptq_matmul")
    gptq_matmul.launches += 1
    return y


gptq_matmul.launches = 0
