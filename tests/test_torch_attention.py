"""The port's attention against ``repro.models.attention`` and the Pallas
flash kernel, on the CPU.

On CPU tensors ``repro_torch.kernels.flash_attention`` takes its plain
version (the naive masked softmax in float32); the CUDA kernel is held to
that plain version on the card (``tests/test_torch_cuda.py``).  Tolerances:
against the Pallas kernel in interpret mode rtol = atol = 2e-3, its own
tests' (it scales q before the product, the model layer the scores); bf16
outputs within 2e-2 (one bf16 rounding of values of order 1 is 2^-8); against
the model layer's jnp attention 1e-5 in float32 (the same products, summed
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as kflash
from repro_torch.models import attention as attn
from repro_torch.models.layers import Linear

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)


def _qkv(rng, b, tq, tk, h, kh, hd, dtype=np.float32):
    q = rng.standard_normal((b, tq, h, hd)).astype(dtype)
    k = rng.standard_normal((b, tk, kh, hd)).astype(dtype)
    v = rng.standard_normal((b, tk, kh, hd)).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("shape", [(2, 128, 2, 32), (1, 256, 4, 64),
                                   (1, 100, 2, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_pallas_kernel(shape, causal):
    """The reference kernel tests' shapes and blocks (interpret mode)."""
    b, t, h, hd = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = _qkv(rng, b, t, t, h, h, hd)
    want = ops.flash_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=64, block_kv=64, interpret=True)
    got = kflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_matches_pallas_kernel_bf16():
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, 1, 128, 128, 2, 2, 32)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = ops.flash_attention_tpu(jq, jk, jv, interpret=True, block_q=64,
                                   block_kv=64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = kflash.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), atol=2e-2)


# (b, tq, tk, h, kh, causal, q_offset, kv_valid_len, kv_chunk)
MODEL_CASES = {
    "gqa_train": (2, 40, 40, 4, 2, True, 0, None, 16),
    "gqa_bidirectional": (2, 40, 40, 4, 2, False, 0, None, 16),
    "mha_ragged_chunks": (1, 50, 50, 4, 4, True, 0, None, 16),
    "prefill_longer_cache": (2, 40, 64, 4, 2, True, 0, 40, 16),
    "decode": (2, 1, 64, 4, 2, True, 45, 46, 16),
    "short_query_block": (1, 4, 64, 4, 2, True, 20, 24, 1024),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_matches_model_layer(case):
    b, tq, tk, h, kh, causal, q_offset, valid, chunk = MODEL_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = _qkv(rng, b, tq, tk, h, kh, 16)
    want = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_offset, kv_valid_len=valid, kv_chunk=chunk)
    got = attn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=q_offset, kv_valid_len=valid, kv_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mixed_dtypes_keep_q_dtype():
    """float32 queries over a bf16 cache (float32 parameters with the
    reference's bf16 KV cache): float32 out, as the reference."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 1, 32, 4, 2, 16)
    kb = jnp.asarray(k, jnp.bfloat16)
    vb = jnp.asarray(v, jnp.bfloat16)
    want = jattn.flash_attention(jnp.asarray(q), kb, vb, q_offset=20,
                                 kv_valid_len=21)
    got = attn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(torch.bfloat16),
        torch.from_numpy(v).to(torch.bfloat16), q_offset=20,
        kv_valid_len=21)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kw", [{"kv_valid_len": 0}, {"kv_valid_len": 33},
                                {"q_offset": -1}])
def test_bad_arguments_raise(kw):
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 32, 2, 16))
    with pytest.raises(ValueError):
        kflash.flash_attention(q, k, k, **kw)


def test_unported_variants_raise():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(NotImplementedError, match="item 14"):
        attn.flash_attention(q, q, q, sliding_window=8)
    with pytest.raises(NotImplementedError, match="item 14"):
        attn.cross_attention_forward(None, q, None, n_heads=2, head_dim=16)


@pytest.fixture(scope="module")
def layer():
    """One GQA attention layer (d = 64, H = 4, K = 2, hd = 16) with the
    reference's parameters, in float32, in both packages."""
    d, h, kh, hd = 64, 4, 2, 16
    jp = jattn.init_attention(jax.random.PRNGKey(0), d, h, kh, hd,
                              dtype=jnp.float32)
    port = attn.Attention(d, h, kh, hd, device="cpu", dtype=torch.float32)
    for name in ("wq", "wk", "wv", "wo"):
        setattr(port, name,
                Linear(torch.from_numpy(np.array(jp[name]["w"]))))
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=hd, rope_theta=1e4,
              kv_chunk=16)
    return jp, port, kw


def test_attention_forward_train(layer):
    jp, port, kw = layer
    x = np.random.default_rng(1).standard_normal((2, 24, 64)) \
        .astype(np.float32)
    want, _ = jattn.attention_forward(jp, jnp.asarray(x), **kw)
    got, cache = attn.attention_forward(port, torch.from_numpy(x), **kw)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_attention_forward_prefill_then_decode(layer):
    """Prefill writes cache[:, :T] in place; decode writes one row at
    cache_pos and attends over cache[:, :pos + 1]; outputs and caches match
    the reference's (bf16 caches, as the model keeps them)."""
    jp, port, kw = layer
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, 64)).astype(np.float32)
    steps = rng.standard_normal((3, 2, 1, 64)).astype(np.float32)
    s = 32
    jcache = jattn.make_kv_cache(2, s, 2, 16)
    cache = attn.KVCache(torch.zeros((2, s, 2, 16), dtype=torch.bfloat16),
                         torch.zeros((2, s, 2, 16), dtype=torch.bfloat16))
    want, jcache = jattn.attention_forward(jp, jnp.asarray(x), cache=jcache,
                                           cache_pos=0, **kw)
    got, out_cache = attn.attention_forward(port, torch.from_numpy(x),
                                            cache=cache, cache_pos=0, **kw)
    assert out_cache is cache
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for i, step in enumerate(steps):
        pos = 20 + i
        want, jcache = jattn.attention_forward(
            jp, jnp.asarray(step), cache=jcache, cache_pos=pos, **kw)
        got, _ = attn.attention_forward(port, torch.from_numpy(step),
                                        cache=cache, cache_pos=pos, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    for mine, theirs in ((cache.k, jcache.k), (cache.v, jcache.v)):
        np.testing.assert_allclose(mine.float().numpy(),
                                   np.asarray(theirs, dtype=np.float32),
                                   atol=2e-2)
        assert not mine[:, 23:].any()
