"""The port's 2-bit SM codec against ``repro.core.bq``, on the CPU.

Inputs are made with numpy seeds and go through both packages.  Packing
and similarities are bit-exact; the encode's strong plane may differ only
where |x| lies within 4 ulp of tau (the threshold is a float sum taken in
another order), which ``strong_bit_flips`` checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bq as jbq
from repro_torch.core import bq
from repro_torch.kernels.binarize import strong_bit_flips

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

DIMS = [64, 100, 384, 768, 1536]


def _vecs(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _port_sig(words_u32: np.ndarray, dim: int) -> bq.Signature:
    words = np.array(words_u32, dtype=np.uint32).view(np.int32)
    return bq.Signature(words=torch.from_numpy(words), dim=dim)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("n", [4, 256, 300])
def test_encode_matches_reference(dim, n):
    x = _vecs(dim * 7 + n, n, dim)
    want = np.asarray(jbq.encode(jnp.asarray(x)).words)
    sig = bq.encode(torch.from_numpy(x))
    assert sig.dim == dim and sig.words.dtype == torch.int32
    assert sig.words.shape == (n, 2 * bq.n_words(dim))
    strong_bit_flips(_u32(sig.words), want, x)


@pytest.mark.parametrize("dim", DIMS)
def test_encode_keeps_leading_dims(dim):
    x = _vecs(dim, 6, dim).reshape(2, 3, dim)
    sig = bq.encode(torch.from_numpy(x))
    flat = bq.encode(torch.from_numpy(x.reshape(6, dim)))
    assert sig.words.shape == (2, 3, 2 * bq.n_words(dim))
    assert torch.equal(sig.words.reshape(6, -1), flat.words)


@pytest.mark.parametrize("dim", DIMS)
def test_pack_unpack_match_reference(dim):
    bits = np.random.default_rng(dim).random((5, dim)) < 0.5
    want = np.asarray(jbq.pack_bits(jnp.asarray(bits)))
    got = bq.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(bq.unpack_bits(got, dim).numpy(), bits)


@pytest.mark.parametrize("dim", DIMS)
def test_valid_mask_and_sizes_match_reference(dim):
    np.testing.assert_array_equal(_u32(bq.valid_mask(dim)),
                                  np.asarray(jbq.valid_mask(dim)))
    assert bq.n_words(dim) == jbq.n_words(dim)
    assert bq.signature_bytes(1000, dim) == jbq.signature_bytes(1000, dim)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("q,n", [(1, 64), (8, 512), (13, 777)])
def test_similarity_matches_reference(dim, q, n):
    jq = jbq.encode(jnp.asarray(_vecs(dim + q + n, q, dim)))
    jb = jbq.encode(jnp.asarray(_vecs(dim + q + n + 1, n, dim)))
    want = np.asarray(jax.jit(
        lambda a, b: jbq.pairwise_distance(jbq.Signature(a, dim),
                                           jbq.Signature(b, dim))
    )(jq.words, jb.words))
    got = bq.pairwise_distance(_port_sig(np.asarray(jq.words), dim),
                               _port_sig(np.asarray(jb.words), dim))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dim", [100, 768])
def test_decode_levels_match_reference(dim):
    js = jbq.encode(jnp.asarray(_vecs(dim, 9, dim)))
    got = bq.decode_levels(_port_sig(np.asarray(js.words), dim))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jbq.decode_levels(js)))


@pytest.mark.parametrize("dim", [100, 768])
def test_sign_magnitude_bits_match_encode(dim):
    x = torch.from_numpy(_vecs(dim + 5, 11, dim))
    pos, strong = bq.sign_magnitude_bits(x)
    words = torch.cat([bq.pack_bits(pos), bq.pack_bits(strong)], dim=-1)
    assert torch.equal(words, bq.encode(x).words)


def test_popcount_matches_numpy():
    v = np.random.default_rng(3).integers(0, 2**32, size=4096,
                                          dtype=np.uint64).astype(np.uint32)
    v[:3] = [0, 0xFFFFFFFF, 0x80000000]
    want = np.array([bin(int(x)).count("1") for x in v])
    got = bq.popcount(torch.from_numpy(v.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_strong_bit_flips_rejects_flips_outside_band():
    x = _vecs(1, 3, 64)
    words = np.asarray(jbq.encode(jnp.asarray(x)).words).copy()
    assert strong_bit_flips(words, words, x) == 0
    tau = np.abs(x[0]).mean()
    far = int(np.argmax(np.abs(np.abs(x[0]) - tau)))
    flipped = words.copy()
    flipped[0, 2 + far // 32] ^= np.uint32(1 << (far % 32))
    with pytest.raises(AssertionError, match="outside"):
        strong_bit_flips(flipped, words, x)
    signs = words.copy()
    signs[1, 0] ^= np.uint32(1)
    with pytest.raises(AssertionError, match="sign words"):
        strong_bit_flips(signs, words, x)
