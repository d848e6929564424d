"""The arithmetic of the port's ``hamming`` pool kernel, on the CPU.

The ``pairwise`` kernel decodes each valid sign bit to a level of +-1 and
each padding bit to 0, multiplies the levels on the tensor cores and writes
``(D - s) // 2`` (``kernels.hamming.hamming_from_levels``).  Here that
arithmetic is held bit for bit against the reference's
``repro.kernels.ref.hamming_distance_ref`` and the Pallas kernel in
interpret mode: one bit at every position of a two-word signature, the
dimension ending right after it, and seeded random words from D = 1 to
3072.  ``tests/test_torch_cuda.py`` holds the kernels themselves against
their plain versions on the card.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bq as jbq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import bq
from repro_torch.kernels import dispatch
from repro_torch.kernels import hamming as kh

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a).view(np.int32))


def _both(qa, qb, dim):
    """(the port's levels arithmetic, the reference) on (Q, W) and (N, W)
    uint32 sign words -> (Q, N)."""
    port = kh.hamming_from_levels(_t(qa)[:, None, :], _t(qb)[None, :, :],
                                  bq.valid_mask(dim))
    ref = jref.hamming_distance_ref(jnp.asarray(qa), jnp.asarray(qb), dim)
    return port.numpy(), np.asarray(ref)


@pytest.mark.parametrize("pa,pb", list(itertools.product((0, 1), repeat=2)))
def test_levels_every_bit_pair(pa, pb):
    """One sign bit pair at each position of a two-word signature; the
    dimension ends right after it, so every bit above is a masked padding
    bit (0 in both planes), and every bit below a valid pair of clear bits
    (level -1 each, their product +1)."""
    want = int(pa != pb)
    for pos in range(64):
        dim = pos + 1
        w = jbq.n_words(dim)

        def word(bit):
            v = np.zeros((1, w), dtype=np.uint32)
            v[0, pos // 32] = np.uint32(bit) << np.uint32(pos % 32)
            return v

        port, ref = _both(word(pa), word(pb), dim)
        assert int(ref[0, 0]) == want
        assert int(port[0, 0]) == want, (pos, int(port[0, 0]), want)


@pytest.mark.parametrize("dim", [1, 17, 31, 32, 33, 64, 100, 768, 3072])
def test_levels_random_words(dim):
    rng = np.random.default_rng(dim)
    w = jbq.n_words(dim)
    # encoded vectors: every pair of 24 rows, also through the Pallas
    # kernel in interpret mode
    x = rng.standard_normal((24, dim)).astype(np.float32)
    sign = np.asarray(jbq.encode(jnp.asarray(x)).words)[:, :w]
    port, ref = _both(sign, sign, dim)
    np.testing.assert_array_equal(port, ref)
    pallas = jops.hamming_distance(jnp.asarray(sign), jnp.asarray(sign),
                                   interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas), ref)
    assert (np.diag(port) == 0).all()
    # uniform random sign words, padding bits cleared
    mask = np.asarray(jbq.valid_mask(dim))
    a, b = (rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint64)
            .astype(np.uint32) & mask for n in (7, 33))
    port, ref = _both(a, b, dim)
    np.testing.assert_array_equal(port, ref)
    assert ref.shape == (7, 33) and ref.max() <= dim


@pytest.mark.parametrize("dim", [17, 100, 768])
@pytest.mark.parametrize("c", [1, 37, 72])
def test_pairwise_plain_matches_levels(dim, c):
    """The CPU route of ``pairwise`` (xor and popcount) against the pool
    kernel's arithmetic, with duplicate ids in a pool; symmetric, 0 on the
    diagonal, and through ``bq1_ops`` the negated distance."""
    rng = np.random.default_rng(dim + c)
    x = rng.standard_normal((300, dim)).astype(np.float32)
    table = _t(np.asarray(jbq.encode(jnp.asarray(x)).words))
    ids = torch.from_numpy(rng.integers(0, 300, (3, c), dtype=np.int32))
    ids[:, c // 2:] = ids[:, :c - c // 2].clone()
    mask = bq.valid_mask(dim)
    got = kh.pairwise(ids, table, mask)
    rows = table[ids.long(), :mask.shape[0]]
    want = kh.hamming_from_levels(rows[:, :, None, :], rows[:, None, :, :],
                                  mask)
    assert torch.equal(got, want)
    assert torch.equal(got, got.transpose(1, 2))
    assert (torch.diagonal(got, dim1=1, dim2=2) == 0).all()
    assert torch.equal(dispatch.bq1_ops(dim, "cpu").pairwise(ids, table),
                       -got)


@pytest.mark.parametrize("dim", [17, 100, 3071])
def test_pairwise_counts_only_bits_in_the_mask(dim):
    """Sign bits set outside the valid-bit mask change nothing: the CPU
    route masks them away, as the pool kernel decodes them to 0."""
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((200, dim)).astype(np.float32)
    words = np.asarray(jbq.encode(jnp.asarray(x)).words)
    mask = np.asarray(jbq.valid_mask(dim))
    w = mask.shape[0]
    dirty = words.copy()
    dirty[:, :w] |= rng.integers(0, 2 ** 32, size=(200, w),
                                 dtype=np.uint64).astype(np.uint32) & ~mask
    assert (dirty != words).any()
    ids = torch.from_numpy(rng.integers(0, 200, (3, 40), dtype=np.int32))
    got = kh.pairwise(ids, _t(dirty), _t(mask))
    assert torch.equal(got, kh.pairwise(ids, _t(words), _t(mask)))
    rows = _t(dirty)[ids.long(), :w]
    assert torch.equal(got, kh.hamming_from_levels(
        rows[:, :, None, :], rows[:, None, :, :], _t(mask)))


def test_pairwise_checks_the_mask():
    table = torch.zeros((10, 8), dtype=torch.int32)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="mask must be"):
        kh.pairwise(ids, table, bq.valid_mask(200))
    with pytest.raises(ValueError, match="mask must be int32"):
        kh.pairwise(ids, table, bq.valid_mask(100).long())

