#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Usage: ``python3 chip_smoke.py`` from the root of a checkout.  It needs one
card and fails (exit code other than 0, no result line) without one.

Phases:

1. card identity, versions, and the build of every CUDA kernel from the
   sources in ``src/repro_torch/csrc``;
2. each kernel held against its plain PyTorch version at the full-width
   ``qwen3_4b`` shapes in bf16 (plus small edge shapes; the int8-KV
   attention kernels with fp32 per-token scales, and at the edges per-page
   and bf16 scales), with its median time (CUDA events, L2 flushed before
   each launch), its bound (the larger of bytes / 3.35 TB/s and operations
   / 989 TFLOP/s) and a library yardstick that the port never calls;
3. the fp32 ``qwen3_4b`` smoke model served by the port's ``Engine`` on the
   card (kernels) and on the CPU (plain versions), fp32 and int8 KV: greedy
   tokens must match;
4. the main path: ``qwen3_4b`` at full width (36 layers, bf16, int4 weights
   made on the card from a seed) serving 8 greedy requests through the
   paged engine on a bf16 KV pool, with every kernel's launch counter reset
   before and read after;
5. the same serve on an int8 KV pool (the int8 attention kernels' main
   path), reusing the weights; the share of its tokens equal to phase 4's
   is reported, not asserted (int8 rounding may flip a greedy choice);
6. capacity: the same workload, bf16 and then int8, under one page-pool
   byte budget of 240 bf16 pages — int8 must buy >= 1.9x the pages and
   batch deeper;
then one JSON line of per-kernel results, the card's name and power limit,
and the final ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core.gptq import dequantize, quantize_rtn  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import gptq_gemv as GV  # noqa: E402
from repro_torch.kernels import gptq_matmul as GM  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serving import kv_quant as KQ  # noqa: E402
from repro_torch.serving.api import EngineConfig  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
LAYER_SHAPES = (                   # (K, N, calls per layer) of qwen3_4b
    (2560, 4096, 1),               # wq
    (2560, 1024, 2),               # wk, wv
    (4096, 2560, 1),               # wo
    (2560, 9728, 2),               # w_gate, w_up
    (9728, 2560, 1),               # w_down
)
GROUP = 128


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Timer:
    """Median time of a callable with CUDA events; a 64 MiB buffer is
    rewritten before every launch so each one finds a cold L2, as a layer
    of the 36-layer model does."""

    def __init__(self, reps: int = 10, warmup: int = 2):
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol |want|
    everywhere and both are finite."""
    g, w = got.float(), want.float().to(got.device)
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    diff = (g - w).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    excess = float((diff - rtol * w.abs()).max()) if diff.numel() else 0.0
    if excess > atol:
        raise AssertionError(f"{name}: max |err| {err:.3e} beyond atol "
                             f"{atol} + rtol {rtol}*|plain|")
    return err


# ------------------------------------------------------------ phase 2: GPTQ
def gptq_operands(m, k, n, group, x_dtype, s_dtype, gen, perm=False,
                  bias=False):
    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    ql = quantize_rtn(w, group, scale_dtype=s_dtype)
    x = torch.randn((m, k), generator=gen, device="cuda").to(x_dtype)
    if perm:
        ql.perm = torch.randperm(k, generator=gen, device="cuda").to(
            torch.int32)
    if bias:
        ql.bias = torch.randn((n,), generator=gen, device="cuda").to(x_dtype)
    return x, ql


def check_gptq(timer: Timer, gen) -> tuple[dict, dict]:
    bf16 = torch.bfloat16
    tol = {torch.bfloat16: (1e-3, 1e-2), torch.float32: (1e-4, 1e-4)}

    # edge cases: tile > group with K over many tiles, ragged N, one
    # whole-K group, fp32 activations, act-order perm and bias
    edges = [(3, 512, 40, 16, torch.float32, torch.float32, True, True),
             (8, 1024, 264, -1, bf16, torch.float32, False, True),
             (40, 512, 40, 16, torch.float32, torch.float32, True, True),
             (200, 1024, 264, -1, bf16, bf16, True, False),
             (517, 384, 136, 32, bf16, bf16, False, True)]
    edge_err = {"gemv": 0.0, "gemm": 0.0}
    for m, k, n, g, xd, sd, perm, bias in edges:
        x, ql = gptq_operands(m, k, n, g, xd, sd, gen, perm, bias)
        got = ops.gptq_linear(ql, x)
        # the same dispatch on CPU copies runs the plain versions
        cpu = {f.name: getattr(ql, f.name) for f in dataclasses.fields(ql)}
        cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v
               for k, v in cpu.items()}
        want = ops.gptq_linear(type(ql)(**cpu), x.cpu())
        lane = "gemv" if m <= GV.GEMV_M_MAX else "gemm"
        err = compare(f"{lane} edge M={m} K={k} N={n} g={g}", got, want,
                      *tol[xd])
        edge_err[lane] = max(edge_err[lane], err)
        log(f"  edge {lane:4s} M={m:4d} K={k:5d} N={n:4d} group={g:4d} "
            f"x={str(xd)[6:]:8s} scales={str(sd)[6:]:8s} perm={perm} "
            f"bias={bias}: max|err| {err:.3e}")

    results = {}
    for lane, ms_list, main_m in (("gemv", (1, 8), 8),
                                  ("gemm", (512, 4096), 4096)):
        max_err = edge_err[lane]
        agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
               "flops": 0.0}
        for m in ms_list:
            for k, n, calls in LAYER_SHAPES:
                x, ql = gptq_operands(m, k, n, GROUP, bf16, bf16, gen)
                args = (x, ql.qweight, ql.scales, ql.qzeros)
                if lane == "gemv":
                    kern = lambda: GV.gptq_gemv(*args, group_size=GROUP)
                    plain = lambda: GV.gptq_gemv_plain(*args,
                                                       group_size=GROUP)
                else:
                    kern = lambda: GM.gptq_matmul(*args, group_size=GROUP)
                    plain = lambda: GM.gptq_matmul_plain(*args,
                                                         group_size=GROUP)
                err = compare(f"{lane} M={m} K={k} N={n}", kern(), plain(),
                              *tol[bf16])
                max_err = max(max_err, err)
                w_bf16 = dequantize(ql, bf16)
                ms = timer(kern)
                pms = timer(plain)
                lms = timer(lambda: torch.matmul(x, w_bf16))
                nbytes = (x.numel() * 2 + ql.qweight.numel() * 4
                          + ql.scales.numel() * 2 + ql.qzeros.numel() * 4
                          + m * n * 2)
                flops = 2.0 * m * k * n
                bms, by = bound_ms(nbytes, flops)
                log(f"  {lane} M={m:4d} K={k:5d} N={n:5d}: max|err| "
                    f"{err:.3e}  kernel {ms:.4f} ms  plain {pms:.4f} ms  "
                    f"bound {bms:.4f} ms ({by})  yardstick torch.matmul on "
                    f"dequantized bf16 W {lms:.4f} ms")
                if m == main_m:
                    agg["ms"] += calls * ms
                    agg["plain_ms"] += calls * pms
                    agg["library_ms"] += calls * lms
                    agg["bytes"] += calls * nbytes
                    agg["flops"] += calls * flops
                del x, ql, w_bf16
        bms, by = bound_ms(agg["bytes"], agg["flops"])
        results[lane] = dict(max_abs_err=max_err, tol="atol 1e-3 + rtol 1e-2 "
                             "(bf16), atol 1e-4 + rtol 1e-4 (fp32)",
                             ms=agg["ms"], plain_ms=agg["plain_ms"],
                             bound_ms=bms, bound_by=by,
                             library_ms=agg["library_ms"],
                             shape=f"one layer's 7 projections at M={main_m}, "
                                   f"group {GROUP}, bf16")
        log(f"  {lane} per layer at M={main_m}: kernel {agg['ms']:.4f} ms, "
            f"plain {agg['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"yardstick torch.matmul {agg['library_ms']:.4f} ms")
    return results["gemv"], results["gemm"]


# ------------------------------------------------------- phase 2: attention
def paged_operands(b, s, h, hkv, d, ps, starts, wls, dtype, gen):
    """Pools, a permuted block table covering start + write_len per row,
    queries.  Returns q, kp, vp, bt, seq_start, lengths."""
    lengths = [st + wl for st, wl in zip(starts, wls)]
    maxp = max(1, -(-max(lengths) // ps))
    pages = b * maxp + 1
    kp = torch.randn((pages, ps, hkv, d), generator=gen, device="cuda")
    vp = torch.randn((pages, ps, hkv, d), generator=gen, device="cuda")
    perm = torch.randperm(pages - 1, generator=gen, device="cuda") + 1
    bt = perm[:b * maxp].reshape(b, maxp).to(torch.int32)
    shape = (b, h, d) if s is None else (b, s, h, d)
    q = torch.randn(shape, generator=gen, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), bt,
            torch.tensor(starts, **i32), torch.tensor(lengths, **i32))


def sdpa_yardstick(q, kp, vp, bt, qpos, lengths):
    """Library time: scaled_dot_product_attention on a pre-gathered
    contiguous KV.  q (B, H, S, D); qpos (B, S) absolute positions."""
    b, h = q.shape[:2]
    hkv, d = kp.shape[2], kp.shape[3]

    def gather(pool):   # (B, H, L, D), kv heads repeated for the query heads
        kv = pool[bt.long()].reshape(b, -1, hkv, d).transpose(1, 2)
        return kv.repeat_interleave(h // hkv, dim=1).contiguous()

    k, v = gather(kp), gather(vp)
    kpos = torch.arange(k.shape[2], device="cuda")
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] < lengths[:, None, None]))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, attn_mask=mask)


def check_attention(timer: Timer, gen) -> tuple[dict, dict]:
    bf16 = torch.bfloat16
    tol = {bf16: (1e-3, 1e-2), torch.float32: (1e-5, 1e-4)}
    rng = np.random.default_rng(0)

    # edge cases: MHA and GQA, a length-0 row, seq_start > 0, right padding,
    # S not a multiple of the kernel's query tile
    edge = {"decode": 0.0, "prefill": 0.0}
    for h, hkv, d, ps, dt in ((4, 4, 32, 4, torch.float32),
                              (8, 2, 64, 8, torch.float32),
                              (32, 8, 128, 16, bf16)):
        lens = [0, 1, 5 * ps + 3, 2 * ps]
        q, kp, vp, bt, _, ln = paged_operands(4, None, h, hkv, d, ps,
                                              [0] * 4, lens, dt, gen)
        got = PA.paged_attention(q, kp, vp, bt, ln)
        err = compare("decode edge", got,
                      PA.paged_attention_plain(q, kp, vp, bt, ln), *tol[dt])
        if float(got[0].abs().max()) != 0.0:
            raise AssertionError("decode: a length-0 row must give zeros")
        edge["decode"] = max(edge["decode"], err)
        q, kp, vp, bt, st, ln = paged_operands(
            3, 37, h, hkv, d, ps, [0, 2 * ps + 1, 7], [37, 20, 0], dt, gen)
        got = PA.paged_prefill(q, kp, vp, bt, st, ln)
        err = compare("prefill edge", got,
                      PA.paged_prefill_plain(q, kp, vp, bt, st, ln),
                      *tol[dt])
        edge["prefill"] = max(edge["prefill"], err)
        log(f"  edge attention H={h} Hkv={hkv} D={d} ps={ps} {dt}: "
            f"decode/prefill max|err| {edge['decode']:.3e} / "
            f"{edge['prefill']:.3e}")

    b, h, hkv, d, ps = 8, 32, 8, 128, 16
    out = {}
    # decode: lengths up to 2048, one row empty
    lens = [0] + rng.integers(1, 2049, size=b - 1).tolist()
    lens[1] = 2048
    q, kp, vp, bt, _, ln = paged_operands(b, None, h, hkv, d, ps, [0] * b,
                                          lens, bf16, gen)
    kern = lambda: PA.paged_attention(q, kp, vp, bt, ln)
    plain = lambda: PA.paged_attention_plain(q, kp, vp, bt, ln)
    err = max(edge["decode"], compare("decode", kern(), plain(), *tol[bf16]))
    keys = sum(lens)
    nbytes = q.numel() * 2 * 2 + keys * hkv * d * 2 * 2 + bt.numel() * 4
    bms, by = bound_ms(nbytes, 4.0 * h * d * keys)
    lib = sdpa_yardstick(q[:, :, None], kp, vp, bt, (ln - 1)[:, None], ln)
    out["decode"] = dict(max_abs_err=err, tol="atol 1e-3 + rtol 1e-2 (bf16)",
                         ms=timer(kern), plain_ms=timer(plain), bound_ms=bms,
                         bound_by=by, library_ms=timer(lib),
                         shape=f"B={b} H={h} Hkv={hkv} D={d} ps={ps}, "
                               f"lengths up to 2048, bf16")
    del q, kp, vp, bt, ln
    # prefill: a 512-token chunk per row, seq_start up to 1024, padded rows
    s = 512
    starts = rng.integers(0, 1025, size=b).tolist()
    starts[0] = 0
    wls = rng.integers(1, s + 1, size=b).tolist()
    wls[1] = s
    q, kp, vp, bt, st, ln = paged_operands(b, s, h, hkv, d, ps, starts, wls,
                                           bf16, gen)
    kern = lambda: PA.paged_prefill(q, kp, vp, bt, st, ln)
    plain = lambda: PA.paged_prefill_plain(q, kp, vp, bt, st, ln)
    err = max(edge["prefill"], compare("prefill", kern(), plain(),
                                       *tol[bf16]))
    # work this run's data needs: keys visible to each query row
    qpos = st[:, None] + torch.arange(s, device="cuda")[None, :]
    visible = torch.minimum(qpos + 1, ln[:, None]).clamp(min=0)
    pairs = float(visible.sum())
    nbytes = q.numel() * 2 * 2 + float(ln.sum()) * hkv * d * 2 * 2
    bms, by = bound_ms(nbytes, 4.0 * h * d * pairs)
    lib = sdpa_yardstick(q.transpose(1, 2), kp, vp, bt, qpos, ln)
    out["prefill"] = dict(max_abs_err=err, tol="atol 1e-3 + rtol 1e-2 (bf16)",
                          ms=timer(kern), plain_ms=timer(plain), bound_ms=bms,
                          bound_by=by, library_ms=timer(lib),
                          shape=f"B={b} S={s} H={h} Hkv={hkv} D={d} ps={ps}, "
                                f"seq_start up to 1024, bf16")
    for name, r in out.items():
        log(f"  {name}: max|err| {r['max_abs_err']:.3e}  kernel "
            f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})  yardstick "
            f"scaled_dot_product_attention on gathered KV "
            f"{r['library_ms']:.4f} ms")
    return out["decode"], out["prefill"]


def int8_operands(b, s, h, hkv, d, ps, starts, wls, q_dtype, gen,
                  granularity="token", scale_dtype=torch.float32):
    """``paged_operands`` with the pools quantized by the port's
    ``quantize`` (per token or per page); per-token scale cells past each
    row's length are zeroed, as cells nobody wrote are in the engine."""
    q, kp, vp, bt, st, ln = paged_operands(b, s, h, hkv, d, ps, starts, wls,
                                           torch.float32, gen)
    axes = (-1,) if granularity == "token" else (1, 3)
    (kq, ks), (vq, vs) = (KQ.quantize(p, axes=axes, scale_dtype=scale_dtype)
                          for p in (kp, vp))
    if granularity == "token":
        kpos = torch.arange(bt.shape[1] * ps, device="cuda")
        dead = kpos[None, :] >= ln[:, None]                 # (B, maxp * ps)
        pages = bt.long().repeat_interleave(ps, dim=1)[dead]
        for t in (ks, vs):
            t[pages, (kpos % ps).expand_as(dead)[dead]] = 0
    return q.to(q_dtype), kq, vq, ks, vs, bt, st, ln


def check_attention_int8(timer: Timer, gen) -> tuple[dict, dict]:
    """The int8 kernels against their plain versions: small edge shapes,
    then the full-width shapes of ``check_attention`` with bf16 q and fp32
    per-token scales."""
    bf16 = torch.bfloat16
    tol = {bf16: (1e-3, 1e-2), torch.float32: (1e-5, 1e-4)}
    rng = np.random.default_rng(0)

    # per-page and bf16 scales, MHA and GQA, a length-0 row, seq_start > 0
    # and a right-padded row
    edge = {"decode": 0.0, "prefill": 0.0}
    for h, hkv, d, ps, gran, sdt, qdt in (
            (4, 4, 32, 4, "token", torch.float32, torch.float32),
            (8, 2, 64, 8, "page", torch.float32, torch.float32),
            (8, 2, 64, 8, "token", bf16, torch.float32),
            (32, 8, 128, 16, "page", bf16, bf16)):
        q, kq, vq, ks, vs, bt, _, ln = int8_operands(
            4, None, h, hkv, d, ps, [0] * 4, [0, 1, 5 * ps + 3, 2 * ps], qdt,
            gen, gran, sdt)
        sc = dict(k_scales=ks, v_scales=vs)
        got = PA.paged_attention(q, kq, vq, bt, ln, **sc)
        err = compare("int8 decode edge", got,
                      PA.paged_attention_plain(q, kq, vq, bt, ln, **sc),
                      *tol[qdt])
        if float(got[0].abs().max()) != 0.0:
            raise AssertionError("int8 decode: a length-0 row must give "
                                 "zeros")
        edge["decode"] = max(edge["decode"], err)
        q, kq, vq, ks, vs, bt, st, ln = int8_operands(
            3, 37, h, hkv, d, ps, [0, 2 * ps + 1, 7], [37, 20, 0], qdt, gen,
            gran, sdt)
        sc = dict(k_scales=ks, v_scales=vs)
        got = PA.paged_prefill(q, kq, vq, bt, st, ln, **sc)
        err = compare("int8 prefill edge", got,
                      PA.paged_prefill_plain(q, kq, vq, bt, st, ln, **sc),
                      *tol[qdt])
        edge["prefill"] = max(edge["prefill"], err)
        log(f"  edge int8 attention H={h} Hkv={hkv} D={d} ps={ps} {gran} "
            f"scales {str(sdt)[6:]} q {str(qdt)[6:]}: decode/prefill "
            f"max|err| {edge['decode']:.3e} / {edge['prefill']:.3e}")

    b, h, hkv, d, ps = 8, 32, 8, 128, 16
    out = {}

    def row(name, kern, plain, lib, err, nbytes, flops, shape):
        bms, by = bound_ms(nbytes, flops)
        out[name] = dict(max_abs_err=err,
                         tol="atol 1e-3 + rtol 1e-2 (bf16), atol 1e-5 + "
                             "rtol 1e-4 (fp32)",
                         ms=timer(kern), plain_ms=timer(plain), bound_ms=bms,
                         bound_by=by, library_ms=timer(lib), shape=shape)

    # decode: lengths up to 2048, one row empty (the bf16 row's recipe)
    lens = [0] + rng.integers(1, 2049, size=b - 1).tolist()
    lens[1] = 2048
    q, kq, vq, ks, vs, bt, _, ln = int8_operands(b, None, h, hkv, d, ps,
                                                 [0] * b, lens, bf16, gen)
    sc = dict(k_scales=ks, v_scales=vs)
    kern = lambda: PA.paged_attention(q, kq, vq, bt, ln, **sc)
    plain = lambda: PA.paged_attention_plain(q, kq, vq, bt, ln, **sc)
    err = max(edge["decode"], compare("int8 decode", kern(), plain(),
                                      *tol[bf16]))
    keys = sum(lens)
    # bytes read: int8 K and V plus their fp32 per-token scales
    nbytes = (q.numel() * 2 * 2 + keys * hkv * (d + 4) * 2
              + bt.numel() * 4)
    lib = sdpa_yardstick(q[:, :, None], KQ.dequantize(kq, ks, dtype=bf16),
                         KQ.dequantize(vq, vs, dtype=bf16), bt,
                         (ln - 1)[:, None], ln)
    row("decode", kern, plain, lib, err, nbytes, 4.0 * h * d * keys,
        f"B={b} H={h} Hkv={hkv} D={d} ps={ps}, lengths up to 2048, bf16 q, "
        f"int8 KV, fp32 per-token scales")
    del q, kq, vq, ks, vs, bt, ln, lib
    # prefill: a 512-token chunk per row, seq_start up to 1024, padded rows
    s = 512
    starts = rng.integers(0, 1025, size=b).tolist()
    starts[0] = 0
    wls = rng.integers(1, s + 1, size=b).tolist()
    wls[1] = s
    q, kq, vq, ks, vs, bt, st, ln = int8_operands(b, s, h, hkv, d, ps,
                                                  starts, wls, bf16, gen)
    sc = dict(k_scales=ks, v_scales=vs)
    kern = lambda: PA.paged_prefill(q, kq, vq, bt, st, ln, **sc)
    plain = lambda: PA.paged_prefill_plain(q, kq, vq, bt, st, ln, **sc)
    err = max(edge["prefill"], compare("int8 prefill", kern(), plain(),
                                       *tol[bf16]))
    qpos = st[:, None] + torch.arange(s, device="cuda")[None, :]
    pairs = float(torch.minimum(qpos + 1, ln[:, None]).clamp(min=0).sum())
    nbytes = q.numel() * 2 * 2 + float(ln.sum()) * hkv * (d + 4) * 2
    lib = sdpa_yardstick(q.transpose(1, 2), KQ.dequantize(kq, ks, dtype=bf16),
                         KQ.dequantize(vq, vs, dtype=bf16), bt, qpos, ln)
    row("prefill", kern, plain, lib, err, nbytes, 4.0 * h * d * pairs,
        f"B={b} S={s} H={h} Hkv={hkv} D={d} ps={ps}, seq_start up to 1024, "
        f"bf16 q, int8 KV, fp32 per-token scales")
    for name, r in out.items():
        log(f"  int8 {name}: max|err| {r['max_abs_err']:.3e}  kernel "
            f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})  yardstick "
            f"scaled_dot_product_attention on gathered dequantized KV "
            f"{r['library_ms']:.4f} ms")
    return out["decode"], out["prefill"]


# --------------------------------------------------- phase 3: engine parity
def prefix_workload(vocab: int, seed: int = 0):
    """Five prompts, the last two sharing an 8-token prefix (two 4-token
    pages) — the recipe of tests/test_torch_engine.py::prefix_workload."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, vocab, size=n).tolist() for n in (7, 13, 3)]
    base = rng.integers(2, vocab, size=8).tolist()
    prompts.append(base + rng.integers(2, vocab, size=5).tolist())
    prompts.append(base + rng.integers(2, vocab, size=3).tolist())
    return prompts


def min_margin(model, prompt, output, kv_quant=None) -> float:
    """Smallest top-2 logit gap over the positions that produced ``output``
    (teacher-forced, one row, the engine's KV storage)."""
    seq = prompt + output[:-1]
    n, ps = len(seq), 4
    pages = -(-n // ps)
    cache = model.init_paged_cache(
        pages, ps, kv_quant=kv_quant and KQ.KVQuantConfig(kv_quant))
    i32 = dict(dtype=torch.int32, device=model.device)
    logits, _ = model.forward_chunks(
        torch.tensor([seq], **i32), torch.tensor([n], **i32), cache,
        torch.zeros((1,), **i32),
        block_tables=torch.arange(1, pages + 1, **i32)[None])
    top2 = logits[0, len(prompt) - 1:].topk(2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def engine_parity(kv_quant=None) -> dict:
    cfg = smoke_config("qwen3_4b")
    cpu_model = LM.init(cfg, seed=0, device="cpu", quant_group=32,
                        scale_dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    prompts = prefix_workload(cfg.vocab_size)
    outs = {}
    for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        for budget in (None, 8):
            eng = Engine(model, EngineConfig(
                batch_slots=3, max_len=64, eos_id=-1, page_size=4,
                max_step_tokens=budget, kv_quant=kv_quant))
            res = eng.generate(prompts, max_new_tokens=8)
            outs[(name, budget)] = [r.output for r in res]
            if eng.pc.utilization != 0.0:
                raise AssertionError("page pool did not drain")
    for budget in (None, 8):
        if outs[("cuda", budget)] != outs[("cpu", budget)]:
            raise AssertionError(f"greedy tokens differ between the CUDA "
                                 f"kernels and the plain versions "
                                 f"(kv_quant={kv_quant}, max_step_tokens="
                                 f"{budget}): {outs[('cuda', budget)]} vs "
                                 f"{outs[('cpu', budget)]}")
    margin = min(min_margin(cpu_model, p, o, kv_quant)
                 for p, o in zip(prompts, outs[("cpu", None)]))
    return {"kv_quant": kv_quant, "requests": len(prompts),
            "tokens_identical": True, "min_top2_margin": margin}


# ------------------------------------------- phases 4-6: full-width serves
def serve_workload(vocab: int) -> list[list[int]]:
    """8 prompts of 64-1500 tokens, the last two sharing a 256-token
    prefix."""
    rng = np.random.default_rng(1)
    lens = rng.integers(64, 1501, size=6).tolist()
    prompts = [rng.integers(2, vocab, size=n).tolist() for n in lens]
    prefix = rng.integers(2, vocab, size=256).tolist()
    for extra in (300, 700):
        prompts.append(prefix + rng.integers(2, vocab, size=extra).tolist())
    return prompts


def serve(model, counted, **engine_kw) -> dict:
    """Serve ``serve_workload`` (64 greedy tokens each) through the paged
    engine; every counter in ``counted`` is set to 0 just before and read
    just after.  Fails on NaN logits, an unfinished request or an unused
    shared prefix."""
    eng = Engine(model, EngineConfig(batch_slots=8, max_len=2048,
                                     max_step_tokens=512, page_size=16,
                                     **engine_kw))
    prompts = serve_workload(model.cfg.vocab_size)
    # NaN watch on every step's logits, kept on the device until the end
    nan_flags = []
    forward = model.forward_chunks

    def watched(*a, **k):
        logits, cache = forward(*a, **k)
        nan_flags.append(torch.isnan(logits).any())
        return logits, cache

    model.forward_chunks = watched
    try:
        torch.cuda.reset_peak_memory_stats()
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.generate(prompts, max_new_tokens=64, ignore_eos=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
    finally:
        del model.forward_chunks
    if len(outs) != len(prompts) or any(len(o.output) != 64 for o in outs):
        raise AssertionError("not every request finished with 64 tokens")
    if bool(torch.stack(nan_flags).any()):
        raise AssertionError("NaN logits in the full-width serve")
    if eng.stats.prefix_hit_pages <= 0:
        raise AssertionError("the shared 256-token prefix was not reused")
    gen_tokens = sum(len(o.output) for o in outs)
    return {"layers": model.cfg.num_layers, "requests": len(outs),
            "kv": "int8" if eng.kv_quant is not None
                  else str(eng.cache_dtype)[6:],
            "pages": eng.pc.num_pages, "peak_active": eng.stats.peak_active,
            "prompt_lens": [len(p) for p in prompts],
            "generated_tokens": gen_tokens, "wall_s": wall,
            "tok_per_s": gen_tokens / wall,
            "ttft_p50_s": statistics.median(o.ttft for o in outs),
            "steps": eng.stats.steps,
            "prefix_hit_pages": eng.stats.prefix_hit_pages,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches, "outputs": [o.output for o in outs]}


def require_launched(serve_result: dict, names) -> None:
    for name in names:
        if serve_result["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")


def brief(r: dict) -> str:
    return json.dumps({k: v for k, v in r.items() if k != "outputs"})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 1: card and build")
    card = smi_line()
    log(f"  card: {card}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    _build.build_all()
    log(f"  kernel build: {_build.BUILD_INFO['seconds']:.1f} s into "
        f"{_build.BUILD_INFO['dir']}")
    log(_build.BUILD_INFO["log"])

    log("== phase 2: kernels vs their plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = Timer()
    gemv, gemm = check_gptq(timer, gen)
    dec, pre = check_attention(timer, gen)
    dec8, pre8 = check_attention_int8(timer, gen)
    del timer

    log("== phase 3: smoke engine, CUDA kernels vs CPU plain versions")
    for kv_quant in (None, "int8"):
        log(f"  {json.dumps(engine_parity(kv_quant))}")

    log("== phase 4: full-width qwen3_4b serve, bf16 KV (main path)")
    cfg = get_config("qwen3_4b")
    t0 = time.perf_counter()
    model = LM.init(cfg, seed=0, device="cuda", quant_group=GROUP)
    torch.cuda.synchronize()
    log(f"  weights made on the card in {time.perf_counter() - t0:.1f} s")
    fp_kernels = (GV.gptq_gemv, GM.gptq_matmul, PA.paged_attention,
                  PA.paged_prefill)
    int8_kernels = (PA.paged_attention_int8, PA.paged_prefill_int8)
    counted = fp_kernels + int8_kernels
    bf16_serve = serve(model, counted, cache_dtype=torch.bfloat16)
    require_launched(bf16_serve, [fn.__name__ for fn in fp_kernels])
    log(f"  {brief(bf16_serve)}")

    log("== phase 5: full-width qwen3_4b serve, int8 KV (main path)")
    int8_serve = serve(model, counted, kv_quant="int8")
    require_launched(int8_serve, [fn.__name__ for fn in
                                  (GV.gptq_gemv, GM.gptq_matmul,
                                   *int8_kernels)])
    for fn in (PA.paged_attention, PA.paged_prefill):
        if int8_serve["launches"][fn.__name__]:
            raise AssertionError(f"{fn.__name__} (fp pools) ran in the "
                                 f"int8 serve")
    same = sum(a == b for o4, o5 in zip(bf16_serve["outputs"],
                                        int8_serve["outputs"])
               for a, b in zip(o4, o5))
    int8_serve["tokens_equal_to_phase4"] = same / bf16_serve[
        "generated_tokens"]
    log(f"  {brief(int8_serve)}")

    log("== phase 6: capacity under one page-pool byte budget")
    budget = 240 * KQ.page_bytes(cfg.num_layers, cfg.num_kv_heads,
                                 cfg.head_dim, 16,
                                 kv_quant=KQ.KVQuantConfig("bf16"))
    cap = {kv: serve(model, counted, kv_quant=kv, page_pool_bytes=budget)
           for kv in ("bf16", "int8")}
    for kv, r in cap.items():
        log(f"  budget {budget} B, {kv}: {brief(r)}")
    if cap["int8"]["pages"] < 1.9 * cap["bf16"]["pages"]:
        raise AssertionError(f"int8 bought {cap['int8']['pages']} pages, "
                             f"bf16 {cap['bf16']['pages']}: under 1.9x")
    if cap["int8"]["peak_active"] <= cap["bf16"]["peak_active"]:
        raise AssertionError("int8 KV did not batch deeper under the same "
                             "byte budget")

    src = "src/repro_torch/csrc/"
    pa_src = "src/repro/kernels/paged_attention.py"
    rows = [
        ("gptq_gemv", gemv, src + "gptq_gemv.cu",
         "src/repro/kernels/gptq_gemv.py:82", "_kernel_gemv", bf16_serve),
        ("gptq_matmul", gemm, src + "gptq_matmul.cu",
         "src/repro/kernels/gptq_matmul.py:213", "_kernel_vmem", bf16_serve),
        ("paged_attention", dec, src + "paged_attention.cu", pa_src + ":144",
         "_kernel", bf16_serve),
        ("paged_prefill", pre, src + "paged_attention.cu", pa_src + ":281",
         "_prefill_kernel", bf16_serve),
        ("paged_attention_int8", dec8, src + "paged_attention.cu",
         pa_src + ":144", "_kernel_quant", int8_serve),
        ("paged_prefill_int8", pre8, src + "paged_attention.cu",
         pa_src + ":281", "_prefill_kernel_quant", int8_serve),
    ]
    kernels = []
    for name, r, source, replaces, tpu_kernel, path in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": path["launches"][name],
            "max_abs_err": r["max_abs_err"], "tol": r["tol"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
