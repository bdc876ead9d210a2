"""The port's CUDA kernels on the card, held against their plain versions
(run on a machine with a CUDA card: ``PYTHONPATH=src python -m pytest -m
cuda tests/test_torch_cuda.py``).  Each test skips where there is no card:
the decision is taken in a fixture, never at import."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.gptq import quantize_rtn
from repro_torch.kernels import gptq_gemv as GV
from repro_torch.kernels import gptq_matmul as GM
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import LM
from repro_torch.serving import kv_quant as KQ
from repro_torch.serving.api import EngineConfig
from repro_torch.serving.engine import Engine

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _to(ql, device):
    fields = {f.name: getattr(ql, f.name) for f in dataclasses.fields(ql)}
    return type(ql)(**{k: v.to(device) if isinstance(v, torch.Tensor) else v
                       for k, v in fields.items()})


@pytest.mark.parametrize("m,k,n,g", [(1, 512, 40, 16), (8, 1024, 264, -1),
                                     (9, 512, 40, 16), (300, 2560, 1024, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gptq_lanes_match_plain(card, m, k, n, g, dtype):
    rng = np.random.default_rng(m + k)
    w = torch.from_numpy((rng.normal(size=(k, n)) / np.sqrt(k)).astype(
        np.float32))
    ql = quantize_rtn(w, g, scale_dtype=dtype)
    ql.perm = torch.from_numpy(rng.permutation(k).astype(np.int32))
    ql.bias = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dtype)
    before = GV.gptq_gemv.launches + GM.gptq_matmul.launches
    got = ops.gptq_linear(_to(ql, card), x.to(card))
    torch.cuda.synchronize()
    assert GV.gptq_gemv.launches + GM.gptq_matmul.launches == before + 1
    want = ops.gptq_linear(ql, x).float()
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-3, 1e-2)
    # the GEMM lane rounds x @ W to the activation dtype before it adds the
    # bias (as repro's does), so a bf16 error scales with |x @ W| and
    # |bias|, which may be far larger than |y| where the two cancel
    scale = (want - ql.bias).abs() + ql.bias.abs()
    err = (got.cpu().float() - want).abs()
    assert (err <= atol + rtol * scale).all(), float(err.max())


@pytest.mark.parametrize("h,hkv,d,ps", [(4, 4, 32, 4), (32, 8, 128, 16)])
def test_paged_attention_kernels_match_plain(card, h, hkv, d, ps):
    rng = np.random.default_rng(h)
    b, s, maxp = 3, 37, 8
    pages = b * maxp + 1
    kp = torch.from_numpy(rng.normal(size=(pages, ps, hkv, d)).astype(
        np.float32))
    vp = torch.from_numpy(rng.normal(size=(pages, ps, hkv, d)).astype(
        np.float32))
    bt = torch.from_numpy(rng.permutation(np.arange(1, pages)).reshape(
        b, maxp).astype(np.int32))
    i32 = dict(dtype=torch.int32)
    lens = torch.tensor([0, 3, maxp * ps], **i32)
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    args = [t.to(card) for t in (q, kp, vp, bt, lens)]
    got = PA.paged_attention(*args)
    torch.testing.assert_close(got.cpu(), PA.paged_attention(q, kp, vp, bt,
                                                             lens),
                               atol=1e-5, rtol=1e-4)
    assert (got[0] == 0).all()
    start = torch.tensor([0, ps + 3, 2], **i32)
    lens = start + torch.tensor([s, 20, 0], **i32)
    q = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
    args = [t.to(card) for t in (q, kp, vp, bt, start, lens)]
    got = PA.paged_prefill(*args)
    torch.testing.assert_close(
        got.cpu(), PA.paged_prefill(q, kp, vp, bt, start, lens),
        atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("h,hkv,d,ps,granularity,sdt,qdt", [
    (4, 4, 32, 4, "token", torch.float32, torch.float32),      # MHA
    (8, 2, 64, 8, "page", torch.float32, torch.float32),
    (8, 2, 64, 8, "token", torch.bfloat16, torch.float32),
    (32, 8, 128, 16, "page", torch.bfloat16, torch.bfloat16),
    (32, 8, 128, 16, "token", torch.float32, torch.bfloat16)])
def test_int8_paged_kernels_match_plain(card, h, hkv, d, ps, granularity,
                                        sdt, qdt):
    """Int8 pools with per-token or per-page, fp32 or bf16 scales: a
    length-0 row, seq_start > 0 over unwritten (zero-scale) cells past the
    length, a right-padded row; the int8 counters move, the fp ones do
    not."""
    rng = np.random.default_rng(h + d)
    b, s, maxp = 3, 37, 8
    pages = b * maxp + 1
    axes = (-1,) if granularity == "token" else (1, 3)
    pools = [KQ.quantize(torch.from_numpy(rng.normal(
        size=(pages, ps, hkv, d)).astype(np.float32)), axes=axes,
        scale_dtype=sdt) for _ in range(2)]
    (kq, ks), (vq, vs) = pools
    bt = torch.from_numpy(rng.permutation(np.arange(1, pages)).reshape(
        b, maxp).astype(np.int32))
    i32 = dict(dtype=torch.int32)
    start = torch.tensor([0, ps + 3, 2], **i32)
    lens = start + torch.tensor([s, 20, 0], **i32)
    if granularity == "token":
        for r in range(b):
            for kpos in range(int(lens[r]), maxp * ps):
                for t in (ks, vs):
                    t[bt[r, kpos // ps], kpos % ps] = 0
    atol, rtol = (1e-5, 1e-4) if qdt == torch.float32 else (1e-3, 1e-2)
    fp = (PA.paged_attention.launches, PA.paged_prefill.launches)
    n8 = (PA.paged_attention_int8.launches, PA.paged_prefill_int8.launches)
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32)).to(
        qdt)
    dec = torch.tensor([0, 3, maxp * ps], **i32)
    cpu = (q, kq, vq, bt, dec)
    got = PA.paged_attention(*[t.to(card) for t in cpu],
                             k_scales=ks.to(card), v_scales=vs.to(card))
    torch.testing.assert_close(
        got.cpu().float(),
        PA.paged_attention(*cpu, k_scales=ks, v_scales=vs).float(),
        atol=atol, rtol=rtol)
    assert (got[0] == 0).all()
    q = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32)
                         ).to(qdt)
    cpu = (q, kq, vq, bt, start, lens)
    got = PA.paged_prefill(*[t.to(card) for t in cpu], k_scales=ks.to(card),
                           v_scales=vs.to(card))
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.cpu().float(),
        PA.paged_prefill(*cpu, k_scales=ks, v_scales=vs).float(),
        atol=atol, rtol=rtol)
    assert (PA.paged_attention.launches, PA.paged_prefill.launches) == fp
    assert (PA.paged_attention_int8.launches,
            PA.paged_prefill_int8.launches) == (n8[0] + 1, n8[1] + 1)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_smoke_engine_tokens_match_cpu(card, kv_quant):
    cfg = smoke_config("qwen3_4b")
    cpu_model = LM.init(cfg, seed=0, device="cpu", quant_group=32,
                        scale_dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(card)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist()
               for n in (7, 13, 3, 11)]
    outs = []
    for model in (gpu_model, cpu_model):
        eng = Engine(model, EngineConfig(batch_slots=3, max_len=64,
                                         eos_id=-1, page_size=4,
                                         max_step_tokens=8,
                                         kv_quant=kv_quant))
        outs.append([o.output for o in eng.generate(prompts,
                                                    max_new_tokens=6)])
    assert outs[0] == outs[1]
