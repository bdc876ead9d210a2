"""Port parity: ``repro_torch``'s paged ``Engine`` on the CPU against
``repro``'s ``Engine(cache="paged")`` — identical greedy tokens on the
prefix workload of ``tests/test_paged.py`` — plus ``PagedCache``
bookkeeping invariants and the options this slice refuses."""
import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from repro.configs import smoke_config as jax_smoke_config
from repro.core.gptq import GPTQConfig
from repro.core.quantize_model import quantize_params
from repro.models import build_model
from repro.serving import kv_cache as JKV
from repro.serving.api import EngineConfig as JEngineConfig
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import gptq_gemv as GV
from repro_torch.kernels import gptq_matmul as GM
from repro_torch.kernels import paged_attention as PA
from repro_torch.serving import kv_cache as KV
from repro_torch.serving.api import EngineConfig
from repro_torch.serving.engine import Engine


def prefix_workload(vocab: int, seed: int = 0) -> list[list[int]]:
    """Five prompts of 7, 13 and 3 tokens plus a pair sharing an 8-token
    prefix (two full 4-token pages) — the recipe ``chip_smoke.py`` copies."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, vocab, size=n).tolist() for n in (7, 13, 3)]
    base = rng.integers(2, vocab, size=8).tolist()
    prompts.append(base + rng.integers(2, vocab, size=5).tolist())
    prompts.append(base + rng.integers(2, vocab, size=3).tolist())
    return prompts


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config("qwen3_4b")
    jmodel = build_model(jcfg)
    params = quantize_params(jmodel.init(jax.random.key(0)), None,
                             GPTQConfig(group_size=32))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                            smoke_config("qwen3_4b"), device="cpu")
    return jmodel, params, model


@pytest.mark.parametrize("budget", [None, 8])
def test_engine_greedy_tokens_match_jax(smoke, budget, monkeypatch):
    jmodel, params, model = smoke
    prompts = prefix_workload(model.cfg.vocab_size)
    calls = {"gemv": 0, "gemm": 0, "decode": 0, "prefill": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for mod, attr, name in ((GV, "gptq_gemv", "gemv"),
                            (GM, "gptq_matmul", "gemm"),
                            (PA, "paged_attention", "decode"),
                            (PA, "paged_prefill", "prefill")):
        monkeypatch.setattr(mod, attr, counting(name, getattr(mod, attr)))

    jeng = JEngine(jmodel, params, JEngineConfig(
        batch_slots=3, max_len=64, eos_id=-1, cache="paged", page_size=4,
        max_step_tokens=budget))
    teng = Engine(model, EngineConfig(
        batch_slots=3, max_len=64, eos_id=-1, page_size=4,
        max_step_tokens=budget))
    for p in prompts:
        jeng.submit(p, max_new_tokens=4)
        teng.submit(p, max_new_tokens=4)
    want = {o.rid: o.output for o in jeng.run()}
    got = {o.rid: o.output for o in teng.run()}
    assert got == want
    assert teng.stats.prefix_hit_pages == jeng.stats.prefix_hit_pages > 0
    assert teng.stats.prefix_hit_tokens == 4 * teng.stats.prefix_hit_pages
    assert teng.pc.utilization == 0.0             # the pool drained
    assert all(n > 0 for n in calls.values()), calls


def test_engine_stream_abort_and_generate(smoke):
    _, _, model = smoke
    prompts = prefix_workload(model.cfg.vocab_size, seed=1)
    eng = Engine(model, EngineConfig(batch_slots=2, max_len=32, eos_id=-1,
                                     page_size=4))
    outs = eng.generate(prompts[:2], max_new_tokens=3)
    assert [len(o.output) for o in outs] == [3, 3]
    rids = [eng.submit(p, max_new_tokens=5) for p in prompts[2:]]
    events = []
    for ev in eng.stream():
        events.append(ev)
        if ev.rid == rids[0] and ev.index == 1:
            assert eng.abort(rids[0]).finish_reason.value == "abort"
    done = {ev.rid: ev for ev in events if ev.finish_reason is not None}
    assert done[rids[0]].finish_reason.value == "abort"
    assert all(done[r].finish_reason.value == "length" for r in rids[1:])
    assert eng.pc.utilization == 0.0 and eng.abort(rids[0]) is None


def test_engine_refuses_options_of_later_slices():
    for kw in (dict(cache="slot"), dict(preemption=True), dict(speculation=object()),
               dict(mesh_shape=(2,)), dict(metrics=True),
               dict(max_queued=4), dict(prefix_cache_path="/nonexistent")):
        with pytest.raises(NotImplementedError, match="slice"):
            EngineConfig(**kw)
    assert EngineConfig(kv_quant="bf16").cache_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        EngineConfig(kv_quant="fp32", cache_dtype="bfloat16")


def test_engine_rejects_impossible_request(smoke):
    _, _, model = smoke
    eng = Engine(model, EngineConfig(batch_slots=2, max_len=16, page_size=4))
    with pytest.raises(ValueError, match="pages"):
        eng.submit(list(range(2, 14)), max_new_tokens=8)


def test_prefix_keys_match_jax():
    """The sha256 seed and the chain keys are byte-identical to repro's."""
    for dt, name in ((torch.float32, "float32"),
                     (torch.bfloat16, "bfloat16")):
        assert KV.prefix_hash_seed(("fp", name), 4) == \
            JKV.prefix_hash_seed(("fp", name), 4)
        tok = list(range(100, 119))
        pc = KV.PagedCache(num_pages=8, page_size=4, dtype=dt)
        jpc = JKV.PagedCache(num_pages=8, page_size=4, n_layers=1, kv_heads=1,
                             head_dim=4, dtype=getattr(jax.numpy, name),
                             alloc_pools=False)
        assert pc._prefix_keys(tok) == jpc._prefix_keys(tok)


def test_prefix_cache_reuse_and_eviction():
    pc = KV.PagedCache(num_pages=8, page_size=4)
    tokens = list(range(100, 111))                 # 2 full pages + 3
    assert pc.alloc_seq(0, len(tokens), tokens=tokens)
    assert pc.prefix_hits[0] == 0
    pc.register_prefix(0, tokens)
    assert pc.alloc_seq(1, len(tokens), tokens=tokens)
    assert pc.prefix_hits[1] == 2
    assert pc.tables[1][:2] == pc.tables[0][:2]
    assert pc.release_prefix(1, 1) == 1            # page 1 made private
    assert pc.tables[1][1] != pc.tables[0][1]
    pc.free_seq(0)
    pc.free_seq(1)
    assert pc.utilization == 0.0
    assert pc.alloc_seq(2, len(tokens), tokens=tokens)
    assert pc.prefix_hits[2] == 0                  # evicted with its pages


@settings(max_examples=12)
@given(st.integers(0, 2 ** 31 - 1))
def test_paged_cache_free_list_invariants(seed):
    """Randomized alloc/extend/free/share/register sequences keep the
    invariants of tests/test_paged.py::test_paged_cache_free_list_invariants:
    refcounts count the table references, the free list is disjoint from
    live pages, every page is free or referenced, the null page is never
    allocated and the device block table mirrors the host tables."""
    rng = np.random.default_rng(seed)
    pc = KV.PagedCache(num_pages=12, page_size=4)
    next_id = 0
    for _ in range(40):
        op = rng.integers(0, 4)
        live = list(pc.tables)
        if op == 0 or not live:
            share = int(rng.choice(live)) if live and rng.integers(2) else None
            toks = rng.integers(0, 3, size=int(rng.integers(1, 20))).tolist()
            pc.alloc_seq(next_id, len(toks), share_from=share,
                         tokens=None if share is not None else toks,
                         reserve=int(rng.integers(0, 4)))
            if next_id in pc.tables and share is None:
                pc.register_prefix(next_id, toks)
            next_id += 1
        elif op == 1:
            try:
                pc.extend_seq(int(rng.choice(live)), int(rng.integers(1, 6)))
            except RuntimeError:
                pass                    # would write a shared page: refused
        else:
            pc.free_seq(int(rng.choice(live)))
        refs = {}
        for t in pc.tables.values():
            for p in t:
                refs[p] = refs.get(p, 0) + 1
        assert 0 not in refs
        for p, n in refs.items():
            assert pc.refcount[p] == n, (p, n, pc.refcount[p])
        assert set(pc.free_list).isdisjoint(refs)
        assert len(pc.free_list) + len(refs) == pc.num_pages
        assert 0.0 <= pc.utilization <= 1.0
        for sid, t in pc.tables.items():
            row_bt = pc.block_tables[pc.row_of(sid)].numpy()
            assert list(row_bt[:len(t)]) == t
            assert (row_bt[len(t):] == 0).all()
