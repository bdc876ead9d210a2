"""GPTQ linear dispatch (counterpart of ``repro.kernels.ops.gptq_linear``).

Two lanes of the OPT4GPTQ strategy, chosen by the number of rows M of the flattened input:

* M <= ``GEMV_M_MAX`` (decode steps): the fused GEMV, bias folded into its
  single writeback;
* larger M (prefill chunks, mixed steps): the fused GEMM, bias added after.

The act-order permutation is applied to the activations before either
lane.  The kernel wrappers take CUDA or CPU tensors alike; this module has
no switch of its own between the kernels and their plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.gptq import QuantizedLinear
from repro_torch.kernels import gptq_gemv as _gemv
from repro_torch.kernels import gptq_matmul as _gm
from repro_torch.kernels.gptq_gemv import GEMV_M_MAX


def gptq_linear(ql: QuantizedLinear, x: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(W) + bias for x of shape (..., K)."""
    k, n = ql.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if ql.perm is not None:
        x2 = x2.index_select(1, ql.perm.long())       # exllama-style b_q_perm
    x2 = x2.contiguous()
    if x2.shape[0] <= GEMV_M_MAX:
        y = _gemv.gptq_gemv(x2, ql.qweight, ql.scales, ql.qzeros, ql.bias,
                            group_size=ql.group_size)
        return y.reshape(*lead, n)
    y = _gm.gptq_matmul(x2, ql.qweight, ql.scales, ql.qzeros,
                        group_size=ql.group_size)
    if ql.bias is not None:
        y = y + ql.bias.to(y.dtype)
    return y.reshape(*lead, n)
