"""Port parity: ``repro_torch`` ``LM.forward_chunks`` on the CPU against
``repro``'s on a paged fp32 cache, with the same GPTQ-quantized
``qwen3_4b`` smoke weights (JAX init + ``quantize_params``, group 32)
carried across by ``convert.params_from_jax``.  ``atol=1e-4``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.gptq import GPTQConfig
from repro.core.quantize_model import quantize_params
from repro.models import build_model
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("qwen3_4b")
    jmodel = build_model(jcfg)
    params = quantize_params(jmodel.init(jax.random.key(0)), None,
                             GPTQConfig(group_size=32))
    cfg = smoke_config("qwen3_4b")
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, params_from_jax(tree, cfg, device="cpu")


def test_config_and_weights_carried_across(models):
    _, params, model = models
    wq = params["group0"]["attn"]["wq"]["w"]
    lin = model.layers[2].attn.wq
    assert lin.quantized and lin.group_size == 32
    np.testing.assert_array_equal(lin.qweight.numpy(),
                                  np.asarray(wq.qweight[2]))
    np.testing.assert_array_equal(lin.scales.numpy(), np.asarray(wq.scales[2]))


def test_forward_chunks_matches_jax(models):
    """A ragged prefill chunk (chunk_lens 9/5/7 in a width-9 block), then a
    width-1 decode chunk; logits and written KV pages agree."""
    jmodel, params, model = models
    cfg = model.cfg
    b, ps, num_pages, maxp = 3, 4, 24, 6
    rng = np.random.default_rng(0)
    bt = (rng.permutation(np.arange(1, num_pages + 1))[:b * maxp]
          .reshape(b, maxp).astype(np.int32))
    jcache = jmodel.init_paged_cache(num_pages, ps, dtype=jnp.float32)
    tcache = model.init_paged_cache(num_pages, ps, dtype=torch.float32)
    seq = np.zeros((b,), np.int32)
    for width, lens in ((9, [9, 5, 7]), (1, [1, 1, 1])):
        toks = rng.integers(2, cfg.vocab_size, size=(b, width)).astype(
            np.int32)
        cl = np.asarray(lens, np.int32)
        jlog, jcache = jmodel.forward_chunks(
            params, jnp.asarray(toks), jnp.asarray(cl), jcache,
            jnp.asarray(seq), block_tables=jnp.asarray(bt))
        tlog, tcache = model.forward_chunks(
            torch.from_numpy(toks), torch.from_numpy(cl), tcache,
            torch.from_numpy(seq), block_tables=torch.from_numpy(bt))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=0)
        seq = seq + cl
    for name in ("k_pages", "v_pages"):
        want = np.asarray(jcache["group0"]["attn"][name])[:, 1:]
        got = tcache[name].numpy()[:, 1:]          # null page 0 excluded
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_forward_chunks_logit_index_matches_jax(models):
    """With ``logit_index`` the port scores only the position each row
    reads (its last real token), as the engine asks; those logits agree
    with ``repro``'s full logits at the same positions."""
    jmodel, params, model = models
    cfg = model.cfg
    b, ps, num_pages, maxp = 3, 4, 12, 4
    bt = np.arange(1, b * maxp + 1, dtype=np.int32).reshape(b, maxp)
    rng = np.random.default_rng(1)
    toks = rng.integers(2, cfg.vocab_size, size=(b, 6)).astype(np.int32)
    cl = np.asarray([6, 2, 4], np.int32)
    seq = np.zeros((b,), np.int32)
    jlog, _ = jmodel.forward_chunks(
        params, jnp.asarray(toks), jnp.asarray(cl),
        jmodel.init_paged_cache(num_pages, ps, dtype=jnp.float32),
        jnp.asarray(seq), block_tables=jnp.asarray(bt))
    tlog, _ = model.forward_chunks(
        torch.from_numpy(toks), torch.from_numpy(cl),
        model.init_paged_cache(num_pages, ps, dtype=torch.float32),
        torch.from_numpy(seq), block_tables=torch.from_numpy(bt),
        logit_index=torch.from_numpy(cl - 1))
    assert tuple(tlog.shape) == (b, cfg.vocab_size)
    want = np.asarray(jlog)[np.arange(b), cl - 1]
    np.testing.assert_allclose(tlog.numpy(), want, atol=1e-4, rtol=0)
