"""Port parity: int4 packing and round-to-nearest quantization of
``repro_torch`` against ``repro`` (bit-exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro.core.gptq import GPTQConfig
from repro.core.quantize_model import quantize_params
from repro_torch.core import gptq as tgptq
from repro_torch.core import packing as tpack


@pytest.mark.parametrize("k,n", [(8, 8), (64, 40), (256, 136)])
def test_pack_unpack_rows_cols_bit_identical(k, n):
    rng = np.random.default_rng(k + n)
    nib = rng.integers(0, 16, size=(k, n)).astype(np.int8)
    words = np.asarray(jpack.pack_int4_rows(jnp.asarray(nib)))
    got = tpack.pack_int4_rows(torch.from_numpy(nib)).numpy()
    np.testing.assert_array_equal(got, words)
    np.testing.assert_array_equal(tpack.np_pack_int4_rows(nib), words)
    words = words.copy()
    # top nibble set: signed words must unpack without sign extension
    assert (words < 0).any()
    np.testing.assert_array_equal(
        tpack.unpack_int4_rows(torch.from_numpy(words), k).numpy(),
        np.asarray(jpack.unpack_int4_rows(jnp.asarray(words), k)))
    np.testing.assert_array_equal(tpack.np_unpack_int4_rows(words, k), nib)

    zw = np.asarray(jpack.pack_int4_cols(jnp.asarray(nib)))
    np.testing.assert_array_equal(
        tpack.pack_int4_cols(torch.from_numpy(nib)).numpy(), zw)
    np.testing.assert_array_equal(
        tpack.unpack_int4_cols(torch.from_numpy(zw), n).numpy(),
        np.asarray(jpack.unpack_int4_cols(jnp.asarray(zw), n)))


@pytest.mark.parametrize("group", [32, 64, -1])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_quantize_rtn_matches_quantize_params(group, scale_dtype):
    """H = I GPTQ (no Hessians) is RTN: qweight/qzeros bit-identical and
    scales equal.  ``quantize_params`` stores float32 scales whatever its
    ``scale_dtype`` argument (it quantizes with the GPTQConfig's own
    scale_dtype), so bf16 scales are compared after the same rounding."""
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(128, 48)) * 0.3).astype(np.float32)
    tree = quantize_params({"wq": {"w": jnp.asarray(w)}}, None,
                           GPTQConfig(group_size=group))
    jq = tree["wq"]["w"]
    tq = tgptq.quantize_rtn(torch.from_numpy(w), group,
                            scale_dtype=scale_dtype)
    assert tq.group_size == jq.group_size and tq.shape == tuple(jq.shape)
    np.testing.assert_array_equal(tq.qweight.numpy(), np.asarray(jq.qweight))
    np.testing.assert_array_equal(tq.qzeros.numpy(), np.asarray(jq.qzeros))
    want = torch.from_numpy(np.asarray(jq.scales, np.float32))
    np.testing.assert_array_equal(tq.scales.to(torch.float32).numpy(),
                                  want.to(scale_dtype).float().numpy())


def test_dequantize_inverts_act_order():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    ql = tgptq.quantize_rtn(w, 32, scale_dtype=torch.float32)
    perm = torch.from_numpy(rng.permutation(64).astype(np.int32))
    plain = tgptq.dequantize(ql)
    ql.perm = perm
    # qweight rows are in permuted order: row i holds original row perm[i]
    np.testing.assert_array_equal(tgptq.dequantize(ql)[perm.long()].numpy(),
                                  plain.numpy())
    assert float((plain - w).abs().max()) <= float(ql.scales.max()) / 2 + 1e-6
