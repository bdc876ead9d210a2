"""Port parity: ``repro_torch.kernels.ops.gptq_linear`` on the CPU (the
plain versions of the GEMV and GEMM lanes) against ``repro``'s Pallas
``gptq_gemv`` / ``gptq_matmul`` (OPT4GPTQ, interpret mode).

Bound ``atol=1e-4, rtol=1e-5`` in fp32: the dequantization is the same
arithmetic, only the summation order of the product differs.  The JAX GEMM
runs with bk=128 so K=512 spans 4 tiles with tile > group — the case of
the group-row bug recorded at ``gptq_matmul.py:227``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gptq_gemv import gptq_gemv
from repro.kernels.gptq_matmul import gptq_matmul
from repro_torch.core.gptq import QuantizedLinear, quantize_rtn
from repro_torch.kernels import gptq_gemv as GV
from repro_torch.kernels import gptq_matmul as GM
from repro_torch.kernels import ops

CASES = [(m, k, n, g) for m in (1, 3, 8, 9, 40) for k in (64, 512)
         for n in (40, 128) for g in (32, 64, -1)]


def _operands(m, k, n, g, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    ql = quantize_rtn(torch.from_numpy(w), g, scale_dtype=torch.float32)
    # half the cases carry an act-order perm and a bias
    if seed % 2:
        ql.perm = torch.from_numpy(rng.permutation(k).astype(np.int32))
        ql.bias = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    return x, ql


def _jax_lane(x, ql: QuantizedLinear):
    xj = jnp.asarray(x)
    if ql.perm is not None:
        xj = jnp.take(xj, jnp.asarray(ql.perm.numpy()), axis=-1)
    args = (jnp.asarray(ql.qweight.numpy()), jnp.asarray(ql.scales.numpy()),
            jnp.asarray(ql.qzeros.numpy()))
    bias = None if ql.bias is None else jnp.asarray(ql.bias.numpy())
    if x.shape[0] <= GV.GEMV_M_MAX:
        return np.asarray(gptq_gemv(xj, *args, bias, group_size=ql.group_size,
                                    interpret=True))
    y = gptq_matmul(xj, *args, group_size=ql.group_size, bm=8, bn=128,
                    bk=128, interpret=True)
    return np.asarray(y if bias is None else y + bias)


@pytest.mark.parametrize("m,k,n,g", CASES)
def test_gptq_linear_cpu_matches_pallas(m, k, n, g):
    x, ql = _operands(m, k, n, g, seed=len(CASES) + CASES.index((m, k, n, g)))
    got = ops.gptq_linear(ql, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _jax_lane(x, ql), atol=1e-4, rtol=1e-5)


def test_lanes_route_by_rows(monkeypatch):
    """M <= 8 goes to the GEMV entry point, larger M to the GEMM."""
    calls = []
    real_gemv, real_gemm = GV.gptq_gemv, GM.gptq_matmul
    monkeypatch.setattr(GV, "gptq_gemv",
                        lambda *a, **k: calls.append("gemv")
                        or real_gemv(*a, **k))
    monkeypatch.setattr(GM, "gptq_matmul",
                        lambda *a, **k: calls.append("gemm")
                        or real_gemm(*a, **k))
    x, ql = _operands(9, 64, 40, 32, seed=1)
    ops.gptq_linear(ql, torch.from_numpy(x[:8]).reshape(2, 4, 64))
    ops.gptq_linear(ql, torch.from_numpy(x))
    assert calls == ["gemv", "gemm"]


def test_wrappers_validate_layout():
    x, ql = _operands(4, 64, 40, 32, seed=2)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="group_size"):
        GV.gptq_gemv(xt, ql.qweight, ql.scales, ql.qzeros, group_size=12)
    with pytest.raises(ValueError, match="GEMV lane"):
        GV.gptq_gemv(torch.zeros((9, 64)), ql.qweight, ql.scales, ql.qzeros,
                     group_size=32)
    with pytest.raises(ValueError, match="packed shapes"):
        GM.gptq_matmul(xt, ql.qweight[:4], ql.scales, ql.qzeros,
                       group_size=32)
