"""The arithmetic of the port's ``bq_distance`` kernels, on the CPU.

The ``dist_rows`` kernel scores a word pair with three popcounts
(``kernels.bq_distance.similarity_three_popcounts``), not with Table 1's
six.  Here that identity is held against the reference's
``repro.core.bq.symmetric_similarity_words``: bit by bit over every
(sign, strong) combination of a valid bit pair at every position of a word,
with the padding bits above it masked, and over seeded random words.
``tests/test_torch_cuda.py`` holds the kernels themselves against their
plain versions on the card.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bq as jbq
from repro_torch.core import bq
from repro_torch.kernels import bq_distance as kd

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

BIT_PAIRS = list(itertools.product((0, 1), repeat=4))


def _both(pa, sa, pb, sb, dim):
    """(the port's identity, the reference) on uint32 word arrays."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))

    port = kd.similarity_three_popcounts(t(pa), t(sa), t(pb), t(sb),
                                         bq.valid_mask(dim))
    ref = jbq.symmetric_similarity_words(
        jnp.asarray(pa), jnp.asarray(sa), jnp.asarray(pb), jnp.asarray(sb),
        jbq.valid_mask(dim))
    return port.numpy(), np.asarray(ref)


@pytest.mark.parametrize("pa,sa,pb,sb", BIT_PAIRS)
def test_three_popcounts_every_bit_pair(pa, sa, pb, sb):
    """One bit pair at each position of a two-word signature; the
    dimension ends right after it, so every bit above is a masked padding
    bit (0 in every plane), and every bit below is a valid pair of weak
    bits of equal sign (0 in every plane), worth +1 each."""
    weight = (1 if pa == pb else -1) * (1 + sa) * (1 + sb)
    for pos in range(64):
        want = weight + pos
        dim = pos + 1
        w = jbq.n_words(dim)

        def word(bit):
            v = np.zeros(w, dtype=np.uint32)
            v[pos // 32] = np.uint32(bit) << np.uint32(pos % 32)
            return v

        port, ref = _both(word(pa), word(sa), word(pb), word(sb), dim)
        assert int(ref) == want
        assert int(port) == want, (pos, int(port), want)


@pytest.mark.parametrize("dim", [17, 64, 100, 768, 3072])
def test_three_popcounts_random_words(dim):
    rng = np.random.default_rng(dim)
    # encoded vectors: every pair of 40 rows
    x = rng.standard_normal((40, dim)).astype(np.float32)
    words = np.asarray(jbq.encode(jnp.asarray(x)).words)
    w = words.shape[1] // 2
    a, b = words[:, None, :], words[None, :, :]
    port, ref = _both(a[..., :w], a[..., w:], b[..., :w], b[..., w:], dim)
    np.testing.assert_array_equal(port, ref)
    # uniform random planes, padding bits cleared: every combination of
    # sign and strength in every word
    mask = np.asarray(jbq.valid_mask(dim))
    planes = rng.integers(0, 2 ** 32, size=(4, 300, w),
                          dtype=np.uint64).astype(np.uint32) & mask
    port, ref = _both(*planes, dim)
    np.testing.assert_array_equal(port, ref)
    assert ref.shape == (300,)


@pytest.mark.parametrize("w,vec", [(1, 1), (2, 1), (3, 1), (4, 4), (24, 4),
                                   (47, 1), (96, 4)])
def test_rows_vector_words(w, vec):
    # 16-byte vectors exactly where a plane's words split into them
    assert kd.rows_vector_words(w) == vec
