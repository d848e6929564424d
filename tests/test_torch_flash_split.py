"""The split-KV decode's arithmetic against ``repro.models.attention``, on
the CPU.

On the card a bf16 decode call (Tq = 1) of
``repro_torch.kernels.flash_attention`` runs two kernels: one block per
(split of 64 keys, KV head, batch) computes each split's partial (m, l, o)
and a second kernel merges the splits.  ``flash_decode_split_plain`` is the
plain float32 mirror of that arithmetic (the same splits, the same exp2 on
scores scaled by hd^-0.5 log2 e, the same m = -1e30, l = 0 of a split that
sees no key, the same merge).  Here it is held to the model layer's jnp
attention within 1e-5 (float32: the same products, summed in another order
and split), for split sizes that put ``kv_valid_len`` before, on and after
a boundary, fully masked splits, GQA and long caches; the kernel is held to
it on the card (``tests/test_torch_cuda.py``).  The wrapper's 16-byte rule
for the bf16 kernels is checked here too: it reads only pointers and
strides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as kflash

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

# (b, tk, h, kh, hd, q_offset, kv_valid_len, split_keys)
SPLIT_CASES = {
    "one_key": (2, 64, 4, 4, 64, 0, 1, 64),
    "before_boundary": (2, 128, 4, 2, 64, 62, 63, 64),
    "on_boundary": (2, 128, 4, 2, 64, 63, 64, 64),
    "after_boundary": (2, 128, 4, 2, 64, 64, 65, 64),
    "small_splits_after": (2, 96, 4, 2, 16, 32, 33, 16),
    "small_splits_on": (2, 96, 4, 2, 16, 47, 48, 16),
    # q_offset 5 hides keys 6..199 causally: splits 1..3 see no key
    "masked_splits": (2, 256, 8, 2, 64, 5, 200, 64),
    "masked_splits_small": (1, 80, 4, 1, 16, 3, 80, 16),
    "gqa_group4": (3, 256, 16, 4, 64, 200, 201, 64),
    "gqa_group4_hd16": (2, 100, 8, 2, 16, 70, 71, 32),
    "valid_below_cache": (2, 384, 8, 8, 64, 351, 352, 64),
    "long_cache": (1, 4096, 4, 1, 64, 4095, 4096, 64),
    "long_cache_gqa": (1, 4096, 8, 2, 16, 3000, 3001, 64),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_mirror_matches_model_layer(case):
    b, tk, h, kh, hd, q_offset, valid, split = SPLIT_CASES[case]
    rng = np.random.default_rng(len(case) + tk)
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, tk, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, tk, kh, hd)).astype(np.float32)
    want = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=q_offset, kv_valid_len=valid)
    got = kflash.flash_decode_split_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=q_offset, kv_valid_len=valid, split_keys=split)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_split_mirror_bidirectional_matches_model_layer():
    """Without the causal mask the visible keys are [0, kv_valid_len)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 150, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 150, 2, 32)).astype(np.float32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False,
                                 kv_valid_len=130)
    got = kflash.flash_decode_split_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=False, kv_valid_len=130)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_split_mirror_keeps_bf16_and_takes_one_row():
    q = torch.randn((1, 1, 2, 16)).to(torch.bfloat16)
    k = torch.randn((1, 70, 2, 16)).to(torch.bfloat16)
    got = kflash.flash_decode_split_plain(q, k, k, q_offset=69,
                                          kv_valid_len=70)
    want = kflash.flash_attention_plain(q, k, k, q_offset=69,
                                        kv_valid_len=70)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)
    with pytest.raises(ValueError, match="Tq = 1"):
        kflash.flash_decode_split_plain(q.expand(1, 2, 2, 16), k, k)


def test_vector_rule_takes_aligned_strided_views():
    """A layer's slice of a stacked cache and one half of a fused K/V
    buffer keep every row on a 16-byte boundary."""
    stack = torch.zeros((3, 2, 64, 2, 16), dtype=torch.bfloat16)
    fused = torch.zeros((2, 64, 2, 2, 16), dtype=torch.bfloat16)
    kflash._check_vectors(("k", stack[1]), ("v", stack[2]),
                          ("k", fused[:, :, 0]), ("v", fused[:, :, 1]))


def test_vector_rule_rejects_misaligned_pointers_and_strides():
    n = 2 * 64 * 2 * 16
    flat = torch.zeros(n + 1, dtype=torch.bfloat16)
    start = 1 if flat.data_ptr() % 16 == 0 else 0
    off = flat[start:start + n].view(2, 64, 2, 16)
    assert off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        kflash._check_vectors(("k", off))
    # a position stride of 36 elements (72 bytes)
    wide = torch.zeros((2, 64, 36), dtype=torch.bfloat16)
    view = wide[:, :, :32].unflatten(2, (2, 16))
    with pytest.raises(ValueError, match="multiple of 8 elements"):
        kflash._check_vectors(("v", view))
