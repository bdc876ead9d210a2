"""Port parity of the int8 KV cache: ``repro_torch.serving.kv_quant``, the
int8 paged attention plain versions, the quantize-on-write of one ``GQA``
layer, the int8 ``Engine`` and its config, each against ``repro``'s
counterpart on the same numpy inputs.  Quantization is bit-identical to
``jax.jit(repro.serving.kv_quant.quantize)``; attention is held to the
Pallas kernels in interpret mode at fp32, ``atol=1e-5``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.gptq import GPTQConfig
from repro.core.quantize_model import quantize_params
from repro.kernels import paged_attention as JPA
from repro.models import build_model
from repro.models.attention import gqa_apply
from repro.serving import kv_cache as JKV
from repro.serving import kv_quant as JKQ
from repro.serving.api import EngineConfig as JEngineConfig
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import LM
from repro_torch.models.blocks import block_paged_cache_init
from repro_torch.serving import kv_cache as KV
from repro_torch.serving import kv_quant as KQ
from repro_torch.serving.api import EngineConfig
from repro_torch.serving.engine import Engine
from test_torch_engine import prefix_workload

_SCALE_DTYPES = {"float32": (torch.float32, jnp.float32),
                 "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp_np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32)
                      if a.dtype == jnp.bfloat16 else a)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config("qwen3_4b")
    jmodel = build_model(jcfg)
    params = quantize_params(jmodel.init(jax.random.key(0)), None,
                             GPTQConfig(group_size=32))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                            smoke_config("qwen3_4b"), device="cpu")
    return jmodel, params, model


# ---------------------------------------------------------------- transform
@pytest.mark.parametrize("axes", [(-1,), (1, 3)])
@pytest.mark.parametrize("sdt", sorted(_SCALE_DTYPES))
def test_quantize_bit_identical_to_jax_jit(axes, sdt):
    """Per-token (reduce D) and per-page (reduce position and D) forms;
    rows of very different magnitude so the scales span many binades."""
    rng = np.random.default_rng(len(axes))
    x = (rng.normal(size=(4, 16, 8, 128))
         * rng.uniform(1e-3, 30.0, size=(4, 16, 8, 1))).astype(np.float32)
    tdt, jdt = _SCALE_DTYPES[sdt]
    jq, js = jax.jit(lambda a: JKQ.quantize(a, axes=axes, scale_dtype=jdt))(
        jnp.asarray(x))
    q, s = KQ.quantize(torch.from_numpy(x), axes=axes, scale_dtype=tdt)
    assert q.dtype == torch.int8 and s.dtype == tdt
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(s), _jnp_np(js))
    back = KQ.dequantize(q, s)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(JKQ.dequantize(jq, js)))


def test_quantize_zero_vector_matches_jax():
    x = np.zeros((2, 3, 8), np.float32)
    x[1, 2] = np.linspace(-1, 1, 8)
    jq, js = jax.jit(JKQ.quantize)(jnp.asarray(x))
    q, s = KQ.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert torch.isfinite(s).all() and (KQ.dequantize(q, s)[0] == 0).all()


def test_kv_quant_config_and_dequantize_validate():
    assert KQ.KVQuantConfig(dtype="float32").dtype == "fp32"
    assert KQ.KVQuantConfig().scale_torch_dtype == torch.float32
    for kw, match in ((dict(dtype="int3"), "dtype"),
                      (dict(granularity="tensor"), "granularity"),
                      (dict(scale_dtype="int8"), "scale_dtype")):
        with pytest.raises(ValueError, match=match):
            KQ.KVQuantConfig(**kw)
        with pytest.raises(ValueError, match=match):
            JKQ.KVQuantConfig(**kw)
    with pytest.raises(ValueError, match="rank"):
        KQ.dequantize(torch.zeros((4, 2, 8), dtype=torch.int8),
                      torch.zeros(()))
    assert KQ.paged_scale_shape(5, 4, 2, "token") == \
        JKQ.paged_scale_shape(5, 4, 2, "token")
    assert KQ.paged_scale_shape(5, 4, 2, "page") == \
        JKQ.paged_scale_shape(5, 4, 2, "page")


@pytest.mark.parametrize("kw", [
    dict(dtype="fp32"), dict(dtype="bf16"), dict(dtype="int8"),
    dict(dtype="int8", granularity="page"),
    dict(dtype="int8", scale_dtype="bfloat16")])
def test_byte_accounting_matches_jax(kw):
    tq, jq = KQ.KVQuantConfig(**kw), JKQ.KVQuantConfig(**kw)
    shape = (36, 8, 128, 16)
    assert KQ.page_bytes(*shape, kv_quant=tq) == \
        JKQ.page_bytes(*shape, kv_quant=jq)
    budget = 240 * KQ.page_bytes(*shape, kv_quant=KQ.KVQuantConfig("bf16"))
    assert KQ.num_pages_for_budget(budget, *shape, kv_quant=tq) == \
        JKQ.num_pages_for_budget(budget, *shape, kv_quant=jq)
    # without kv_quant the fp dtype decides, as in repro
    assert KQ.page_bytes(*shape, dtype=torch.bfloat16) == \
        JKQ.page_bytes(*shape, dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="zero pages"):
        KQ.num_pages_for_budget(1, *shape, kv_quant=tq)


# ------------------------------------------------------------------ kernels
def _int8_pools(rng, pages, ps, hkv, d, granularity, sdt):
    kp = rng.normal(size=(pages, ps, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(pages, ps, hkv, d)).astype(np.float32)
    axes = (-1,) if granularity == "token" else (1, 3)
    tdt, jdt = _SCALE_DTYPES[sdt]
    jk = JKQ.quantize(jnp.asarray(kp), axes=axes, scale_dtype=jdt)
    jv = JKQ.quantize(jnp.asarray(vp), axes=axes, scale_dtype=jdt)
    tk = KQ.quantize(torch.from_numpy(kp), axes=axes, scale_dtype=tdt)
    tv = KQ.quantize(torch.from_numpy(vp), axes=axes, scale_dtype=tdt)
    return (*jk, *jv), (*tk, *tv)


_CASES = [("token", 8, 2, "float32"), ("token", 4, 4, "float32"),
          ("page", 8, 2, "float32"), ("page", 4, 4, "bfloat16"),
          ("token", 8, 2, "bfloat16")]


@pytest.mark.parametrize("granularity,h,hkv,sdt", _CASES)
def test_int8_paged_attention_matches_pallas(granularity, h, hkv, sdt):
    """A length-0 row, a full row, a permuted block table."""
    rng = np.random.default_rng(h + hkv)
    b, d, ps, maxp, pages = 4, 32, 4, 5, 24
    (jkq, jks, jvq, jvs), (kq, ks, vq, vs) = _int8_pools(
        rng, pages, ps, hkv, d, granularity, sdt)
    bt = rng.permutation(np.arange(1, pages))[:b * maxp].reshape(
        b, maxp).astype(np.int32)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    lens = np.array([0, 1, 11, maxp * ps], np.int32)
    want = np.asarray(JPA.paged_attention(
        jnp.asarray(q), jkq, jvq, jnp.asarray(bt), jnp.asarray(lens),
        k_scales=jks, v_scales=jvs, interpret=True))
    got = PA.paged_attention(torch.from_numpy(q), kq, vq,
                             torch.from_numpy(bt), torch.from_numpy(lens),
                             k_scales=ks, v_scales=vs).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got[0] == 0).all()
    # the int8 wrapper itself computes the same on the CPU
    direct = PA.paged_attention_int8(torch.from_numpy(q), kq, vq, ks, vs,
                                     torch.from_numpy(bt),
                                     torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(direct, got)


@pytest.mark.parametrize("granularity,h,hkv,sdt", _CASES)
def test_int8_paged_prefill_matches_pallas(granularity, h, hkv, sdt):
    """seq_start > 0 over unwritten (zero-scale) cells past the length,
    right-padded queries, a row with no real token, a query chunk that does
    not divide S."""
    rng = np.random.default_rng(10 * h + hkv)
    b, s, d, ps, maxp, pages = 3, 13, 32, 4, 8, 32
    (jkq, jks, jvq, jvs), (kq, ks, vq, vs) = _int8_pools(
        rng, pages, ps, hkv, d, granularity, sdt)
    bt = rng.permutation(np.arange(1, pages))[:b * maxp].reshape(
        b, maxp).astype(np.int32)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    start = np.array([0, 9, 4], np.int32)
    lens = start + np.array([13, 7, 0], np.int32)
    if granularity == "token":     # cells past each length were never
        for r in range(b):         # written: their scales are zero
            for kpos in range(lens[r], maxp * ps):
                for t in (ks, vs):
                    t[bt[r, kpos // ps], kpos % ps] = 0
        jks, jvs = (jnp.asarray(_np(t)).astype(jks.dtype) for t in (ks, vs))
    want = np.asarray(JPA.paged_prefill(
        jnp.asarray(q), jkq, jvq, jnp.asarray(bt), jnp.asarray(start),
        jnp.asarray(lens), k_scales=jks, v_scales=jvs, q_chunk=5,
        interpret=True))
    got = PA.paged_prefill(torch.from_numpy(q), kq, vq, torch.from_numpy(bt),
                           torch.from_numpy(start), torch.from_numpy(lens),
                           k_scales=ks, v_scales=vs).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.isfinite(got).all()


def test_int8_attention_wrappers_validate():
    q = torch.zeros((2, 4, 32))
    pool = torch.zeros((5, 4, 2, 32), dtype=torch.int8)
    scales = torch.ones((5, 4, 2))
    bt = torch.ones((2, 2), dtype=torch.int32)
    ln = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="both"):
        PA.paged_attention(q, pool, pool, bt, ln, k_scales=scales)
    with pytest.raises(ValueError, match="int8 pools need"):
        PA.paged_attention(q, pool, pool, bt, ln)
    with pytest.raises(ValueError, match="int8 pools need"):
        PA.paged_attention(q, pool.float(), pool.float(), bt, ln,
                           k_scales=scales, v_scales=scales)
    with pytest.raises(ValueError, match="scale pools"):
        PA.paged_prefill(q[:, None], pool, pool, bt, ln, ln,
                         k_scales=scales[:, :2], v_scales=scales[:, :2])
    with pytest.raises(TypeError, match="dtype"):
        PA.paged_attention(q, pool, pool, bt, ln, k_scales=scales,
                           v_scales=scales.bfloat16())
    with pytest.raises(ValueError, match="both"):
        PA.paged_attention_plain(q, pool, pool, bt, ln, v_scales=scales)


# ------------------------------------------------------------ model / cache
def test_int8_cache_init_matches_jax_layout():
    cfg = smoke_config("qwen3_4b")
    for sdt in ("float32", "bfloat16"):
        kvq = KQ.KVQuantConfig(scale_dtype=sdt)
        c = block_paged_cache_init(cfg, 2, 6, 4, dtype=torch.float32,
                                   device=torch.device("cpu"), kv_quant=kvq)
        assert c["k_pages"].dtype == c["v_pages"].dtype == torch.int8
        assert c["k_pages"].shape == (2, 7, 4, cfg.num_kv_heads,
                                      cfg.head_dim)
        assert c["k_scales"].shape == c["v_scales"].shape == (
            2, 7, 4, cfg.num_kv_heads)
        assert c["k_scales"].dtype == kvq.scale_torch_dtype
    with pytest.raises(ValueError, match="per-token"):
        block_paged_cache_init(cfg, 2, 6, 4, dtype=torch.float32,
                               device=torch.device("cpu"),
                               kv_quant=KQ.KVQuantConfig(granularity="page"))


def test_gqa_layer_int8_write_matches_jax(smoke):
    """One layer call writing a ragged chunk (seq_start > 0, right padding
    routed to the null page) into int8 pools, against ``gqa_apply`` under
    ``jit``.  V goes through the GPTQ projection alone and its payloads and
    scales are bit-identical.  K passes qk-norm and RoPE, whose float32
    ``rsqrt``/``cos``/``sin`` XLA and PyTorch round apart by an ulp or two
    (the fp32 pools show it), so its scales agree to those ulps; fed
    ``repro``'s own K and V, the port's quantize-and-scatter is
    bit-identical."""
    jmodel, params, model = smoke
    cfg = model.cfg
    p0 = jax.tree_util.tree_map(lambda a: a[0], params["group0"]["attn"])
    b, s, ps, pages, maxp = 3, 9, 4, 24, 6
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    bt = rng.permutation(np.arange(1, pages + 1))[:b * maxp].reshape(
        b, maxp).astype(np.int32)
    seq = np.array([0, 5, 2], np.int32)
    wl = np.array([9, 4, 7], np.int32)
    pos = seq[:, None] + np.arange(s, dtype=np.int32)[None]
    shape = (pages + 1, ps, cfg.num_kv_heads, cfg.head_dim)
    kw = dict(positions=pos, seq_lens=seq, block_tables=bt, write_lens=wl)

    def run_jax(cache):
        fn = jax.jit(lambda p, x, c, a: gqa_apply(p, x, cfg=jmodel.cfg,
                                                  cache=c, **a))
        return fn(p0, jnp.asarray(x), cache,
                  {k: jnp.asarray(v) for k, v in kw.items()})[1]

    jfp = run_jax({"k_pages": jnp.zeros(shape), "v_pages": jnp.zeros(shape)})
    jq = run_jax({"k_pages": jnp.zeros(shape, jnp.int8),
                  "v_pages": jnp.zeros(shape, jnp.int8),
                  "k_scales": jnp.zeros(shape[:-1]),
                  "v_scales": jnp.zeros(shape[:-1])})
    tq = block_paged_cache_init(cfg, 1, pages, ps, dtype=torch.float32,
                                device=torch.device("cpu"),
                                kv_quant=KQ.KVQuantConfig())
    tq = {k: v[0] for k, v in tq.items()}
    model.layers[0].attn(torch.from_numpy(x), cfg=cfg, cache=tq,
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    got = {k: v.numpy()[1:] for k, v in tq.items()}      # null page excluded
    want = {k: np.asarray(v)[1:] for k, v in jq.items()}
    for name in ("v_pages", "v_scales", "k_pages"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_allclose(got["k_scales"], want["k_scales"], rtol=3e-7,
                               atol=0)
    # the same K/V in: every written cell bit-identical, scales included
    cells = [(int(bt[r, (seq[r] + i) // ps]), int((seq[r] + i) % ps))
             for r in range(b) for i in range(wl[r])]
    pg, off = (torch.tensor(c) for c in zip(*cells))
    for name in ("k", "v"):
        exact = torch.from_numpy(np.array(jfp[f"{name}_pages"]))[pg, off]
        qv, sc = KQ.quantize(exact)
        np.testing.assert_array_equal(
            qv.numpy(), np.asarray(jq[f"{name}_pages"])[pg, off])
        np.testing.assert_array_equal(
            sc.numpy(), np.asarray(jq[f"{name}_scales"])[pg, off])


# ------------------------------------------------------------------- engine
@pytest.mark.parametrize("budget", [None, 8])
def test_engine_int8_greedy_tokens_match_jax(smoke, budget, monkeypatch):
    """int8 tokens are held to repro's int8 tokens (never to bf16 ones:
    int8 rounding may flip a greedy choice of a random-weight model)."""
    jmodel, params, model = smoke
    prompts = prefix_workload(model.cfg.vocab_size)
    calls = {"decode": 0, "prefill": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            assert k.get("k_scales") is not None
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(PA, "paged_attention",
                        counting("decode", PA.paged_attention))
    monkeypatch.setattr(PA, "paged_prefill",
                        counting("prefill", PA.paged_prefill))
    jeng = JEngine(jmodel, params, JEngineConfig(
        batch_slots=3, max_len=64, eos_id=-1, cache="paged", page_size=4,
        max_step_tokens=budget, kv_quant="int8"))
    teng = Engine(model, EngineConfig(
        batch_slots=3, max_len=64, eos_id=-1, page_size=4,
        max_step_tokens=budget, kv_quant="int8"))
    for p in prompts:
        jeng.submit(p, max_new_tokens=4)
        teng.submit(p, max_new_tokens=4)
    want = {o.rid: o.output for o in jeng.run()}
    got = {o.rid: o.output for o in teng.run()}
    assert got == want
    assert teng.cache_dtype == torch.int8 and teng.kv_quant.quantized
    assert teng.cache["k_pages"].dtype == torch.int8
    assert set(teng.cache) == {"k_pages", "v_pages", "k_scales", "v_scales"}
    assert teng.stats.prefix_hit_pages == jeng.stats.prefix_hit_pages > 0
    assert teng.pc.utilization == 0.0
    assert all(n > 0 for n in calls.values()), calls


def test_prefix_keys_int8_tag_match_jax():
    tok = list(range(100, 119))
    assert KV.prefix_hash_seed(("int8", "token"), 4) == \
        JKV.prefix_hash_seed(("int8", "token"), 4)
    pc = KV.PagedCache(num_pages=8, page_size=4, kv_quant=KQ.KVQuantConfig())
    jpc = JKV.PagedCache(num_pages=8, page_size=4, n_layers=1, kv_heads=1,
                         head_dim=4, alloc_pools=False,
                         kv_quant=JKQ.KVQuantConfig())
    assert pc._prefix_keys(tok) == jpc._prefix_keys(tok)
    fp = KV.PagedCache(num_pages=8, page_size=4)
    assert set(pc._prefix_keys(tok)).isdisjoint(fp._prefix_keys(tok))


@pytest.mark.parametrize("kw", [
    dict(kv_quant="int4"), dict(kv_quant="int8", cache_dtype="bfloat16"),
    dict(kv_quant="bf16", cache_dtype="float32"),
    dict(kv_quant=KQ.KVQuantConfig(granularity="page")),
    dict(kv_quant=42)])
def test_engine_config_kv_quant_raises_where_jax_raises(kw):
    jkw = dict(kw)
    if isinstance(kw["kv_quant"], KQ.KVQuantConfig):
        jkw["kv_quant"] = JKQ.KVQuantConfig(
            **dataclasses.asdict(kw["kv_quant"]))
    if "cache_dtype" in kw:
        jkw["cache_dtype"] = getattr(jnp, kw["cache_dtype"])
    with pytest.raises(ValueError) as jerr:
        JEngineConfig(**jkw)
    with pytest.raises(ValueError) as terr:
        EngineConfig(**kw)
    assert str(terr.value).split()[:4] == str(jerr.value).split()[:4]
    assert EngineConfig(kv_quant="int8").kv_quant == KQ.KVQuantConfig("int8")
    assert EngineConfig(kv_quant="int8").cache_dtype is None


def test_engine_int8_budget_pool_capacity():
    """One page-pool byte budget: int8 derives >= 1.9x the bf16 pages and
    keeps a deeper batch.  The smoke model with qwen3_4b's head_dim 128,
    where int8 + fp32 scales take 132 bytes per token and head against
    bf16's 256 (at the smoke head_dim 32 the ratio is only 1.78).  Tokens
    are not compared across the two (int8 may flip greedy choices)."""
    cfg = dataclasses.replace(smoke_config("qwen3_4b"), head_dim=128)
    model = LM.init(cfg, seed=0, device="cpu", quant_group=32,
                    scale_dtype=torch.float32)
    ps = 4
    budget = 40 * KQ.page_bytes(cfg.num_layers, cfg.num_kv_heads,
                                cfg.head_dim, ps,
                                kv_quant=KQ.KVQuantConfig(dtype="bf16"))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab_size, size=28).tolist()
               for _ in range(12)]
    peaks, pages = {}, {}
    for mode in ("bf16", "int8"):
        eng = Engine(model, EngineConfig(
            batch_slots=12, max_len=64, eos_id=-1, page_size=ps,
            kv_quant=mode, page_pool_bytes=budget))
        outs = eng.generate(prompts, max_new_tokens=4)
        assert [len(o.output) for o in outs] == [4] * 12
        assert eng.pc.utilization == 0.0
        peaks[mode], pages[mode] = eng.stats.peak_active, eng.pc.num_pages
    assert pages["bf16"] == 40
    assert pages["int8"] >= 1.9 * pages["bf16"]
    assert peaks["int8"] > peaks["bf16"]
    assert KQ.page_bytes(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, ps,
                         kv_quant=KQ.KVQuantConfig()) * pages["int8"] \
        <= budget
