"""Port parity: ``repro_torch`` paged decode / chunked prefill attention on
the CPU (plain versions) against ``repro``'s Pallas kernels in interpret
mode.  fp32, ``atol=1e-5``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as JPA
from repro_torch.kernels import paged_attention as PA


def _pool(rng, b, h, hkv, d, pages, ps, maxp):
    kp = rng.normal(size=(pages, ps, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(pages, ps, hkv, d)).astype(np.float32)
    # a permuted block table: logical pages scattered over the pool
    bt = rng.permutation(np.arange(1, pages))[:b * maxp]
    return kp, vp, bt.reshape(b, maxp).astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)])
def test_paged_attention_matches_pallas(h, hkv):
    rng = np.random.default_rng(h)
    b, d, ps, maxp = 4, 32, 4, 5
    kp, vp, bt = _pool(rng, b, h, hkv, d, 24, ps, maxp)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    lens = np.array([0, 1, 11, maxp * ps], np.int32)       # a length-0 row
    want = np.asarray(JPA.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), interpret=True))
    got = PA.paged_attention(*_t(q, kp, vp, bt, lens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got[0] == 0).all()                    # exact zeros, never NaN


@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)])
@pytest.mark.parametrize("q_chunk", [128, 5])
def test_paged_prefill_matches_pallas(h, hkv, q_chunk):
    """seq_start > 0, right-padded queries (write_lens < S), a row with no
    real token, and a query chunk that does not divide S."""
    rng = np.random.default_rng(10 * h + q_chunk)
    b, s, d, ps, maxp = 3, 13, 32, 4, 8
    kp, vp, bt = _pool(rng, b, h, hkv, d, 32, ps, maxp)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    start = np.array([0, 9, 4], np.int32)
    lens = start + np.array([13, 7, 0], np.int32)
    want = np.asarray(JPA.paged_prefill(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(start), jnp.asarray(lens), q_chunk=q_chunk,
        interpret=True))
    got = PA.paged_prefill(*_t(q, kp, vp, bt, start, lens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_attention_wrappers_validate():
    q = torch.zeros((2, 6, 32))
    pool = torch.zeros((4, 4, 4, 32))
    bt = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        PA.paged_attention(q, pool, pool, bt, torch.ones(2, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        PA.paged_attention(torch.zeros((2, 4, 32)), pool, pool,
                           bt.long(), torch.ones(2, dtype=torch.int32))
