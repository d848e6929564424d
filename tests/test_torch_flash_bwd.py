"""The flash-attention backward's arithmetic against the reference, on the
CPU.

``flash_attention_backward_plain`` is what the float32 CUDA backward
(``csrc/flash_attention_bwd.cu``, CUDA cores) computes: P recomputed from
each row's log-sum-exp, ``D = rowsum(dO * O)`` from the forward's output,
``dS = P * (dP - D)``, dK and dV summed over each KV head's group.  It is
held here to ``jax.vjp`` of the model layer (``repro.models.attention.
flash_attention``, chunked scan and the one-pass ``Tq <= 8`` path) and of
``repro.kernels.ref.flash_attention_ref``, and to ``torch.autograd`` of the
port's plain forward.  ``flash_attention_backward_mma_plain`` is the bf16
(tensor-core) backward's arithmetic: the same, with P taken from the
forward's log-sum-exp in log2 units (``flash_attention_lse_plain``) and P
and dS rounded to bf16 before their products; it is held to ``jax.vjp`` of
the model layer in bf16.  The kernels are held to both on the card
(``tests/test_torch_cuda.py``).

Tolerances.  float32: every gradient within 1e-5 of the reference's
(absolute, on gradients of order 1; the same float32 products summed in
another order).  bf16 (inputs, output and cotangent in bf16; the
reference differentiates in float32 and rounds the gradient once to bf16,
the plain version does the same but takes D from the bf16 output): within
one bf16 rounding of the gradient's magnitude, 2^-7 * max|grad|; the
mirror of the bf16 kernel rounds P and dS to bf16 as well, and is held to
the same bound.  The log-sum-exp (log2 units): within 1e-5 (absolute, on
values of order 10) of a float64 numpy reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as kflash

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_ULP = 2.0 ** -7

# (b, tq, tk, h, kh, hd, causal, q_offset, kv_valid_len)
CASES = [
    (2, 70, 70, 4, 4, 16, True, 0, None),
    (2, 70, 70, 4, 4, 16, False, 0, None),
    (1, 37, 100, 4, 2, 32, True, 20, 57),
    (2, 65, 130, 4, 2, 64, True, 50, 115),
    (1, 45, 45, 4, 2, 64, False, 0, 40),
    (2, 3, 90, 4, 2, 32, True, 60, 63),      # the layer's Tq <= 8 path
]


def _inputs(case, dtype, seed=0):
    b, tq, tk, h, kh, hd = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, tk, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, tk, kh, hd)).astype(np.float32)
    do = rng.standard_normal((b, tq, h, hd)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = [jnp.asarray(a, jdt) for a in (q, k, v, do)]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)
          for a in jx]
    return jx, tx


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), want, atol=F32_TOL, rtol=0)
    else:
        tol = BF16_ULP * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_matches_vjp_of_model_layer(case, dtype):
    causal, q_offset, valid = case[6:]
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(case, dtype)

    def f(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, causal=causal,
                                     q_offset=q_offset, kv_valid_len=valid,
                                     kv_chunk=32)

    jout, vjp = jax.vjp(f, jq, jk, jv)
    want = vjp(jdo)
    out = kflash.flash_attention_plain(q, k, v, causal=causal,
                                       q_offset=q_offset, kv_valid_len=valid)
    got = kflash.flash_attention_backward_plain(
        q, k, v, out, do, causal=causal, q_offset=q_offset,
        kv_valid_len=valid)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_matches_vjp_of_kernel_reference(causal):
    """``flash_attention_ref``'s layout (B H, T, hd), MHA, q_offset 0."""
    b, t, h, hd = 2, 70, 4, 32
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(
        (b, t, t, h, h, hd), torch.float32, seed=1)

    def fold(x):
        return jnp.transpose(x, (0, 2, 1, 3)).reshape(b * h, t, hd)

    def f(q_, k_, v_):
        return flash_attention_ref(fold(q_), fold(k_), fold(v_),
                                   causal=causal)

    _, vjp = jax.vjp(f, jq, jk, jv)
    want = vjp(fold(jdo))
    out = kflash.flash_attention_plain(q, k, v, causal=causal)
    got = kflash.flash_attention_backward_plain(q, k, v, out, do,
                                                causal=causal)
    for g, w in zip(got, want):
        _close(g, w, torch.float32)


@pytest.mark.parametrize("case", CASES)
def test_matches_autograd_of_plain_forward(case):
    causal, q_offset, valid = case[6:]
    _, (q, k, v, do) = _inputs(case, torch.float32, seed=2)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = kflash.flash_attention(*leaves, causal=causal, q_offset=q_offset,
                                 kv_valid_len=valid)
    assert out.grad_fn is not None
    out.backward(do)
    got = kflash.flash_attention_backward(
        q, k, v, out.detach(), do, causal=causal, q_offset=q_offset,
        kv_valid_len=valid)
    for g, leaf in zip(got, leaves):
        np.testing.assert_allclose(_np(g), _np(leaf.grad), atol=F32_TOL,
                                   rtol=0)


def test_backward_checks():
    q = torch.zeros((1, 8, 4, 64))
    k = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="one dtype"):
        kflash._check_backward(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="head width"):
        kflash._check_backward(torch.zeros((1, 8, 4, 48)),
                               torch.zeros((1, 8, 2, 48)),
                               torch.zeros((1, 8, 2, 48)))
    with pytest.raises(ValueError, match="multiple of 4 elements"):
        kflash._check_backward(q, k, torch.zeros((1, 8, 2, 66))[..., :64])
    with pytest.raises(ValueError, match="must be q's"):
        kflash.flash_attention_backward(q, k, k, q[:, :4], q)
    kflash._check_backward(q, k, k)


@pytest.mark.parametrize("case", CASES)
def test_mma_mirror_matches_vjp_of_model_layer(case):
    """The bf16 kernel's arithmetic (P and dS rounded to bf16 before their
    products, P from the log2 log-sum-exp) against ``jax.vjp`` of the model
    layer in bf16, within 2^-7 of the largest gradient."""
    causal, q_offset, valid = case[6:]
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(case, torch.bfloat16, seed=3)

    def f(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, causal=causal,
                                     q_offset=q_offset, kv_valid_len=valid,
                                     kv_chunk=32)

    _, vjp = jax.vjp(f, jq, jk, jv)
    want = vjp(jdo)
    out = kflash.flash_attention_plain(q, k, v, causal=causal,
                                       q_offset=q_offset, kv_valid_len=valid)
    got = kflash.flash_attention_backward_mma_plain(
        q, k, v, out, do, causal=causal, q_offset=q_offset,
        kv_valid_len=valid)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, torch.bfloat16)


@pytest.mark.parametrize("case", CASES)
def test_lse_matches_float64_reference(case):
    """``flash_attention_lse`` on the CPU: the plain output and each row's
    log2 log-sum-exp of the scores scaled by hd^-0.5 log2 e."""
    causal, q_offset, valid = case[6:]
    b, tq, tk, h, kh, hd = case[:6]
    _, (q, k, v, _) = _inputs(case, torch.float32, seed=4)
    out, lse = kflash.flash_attention_lse(q, k, v, causal=causal,
                                          q_offset=q_offset,
                                          kv_valid_len=valid)
    assert lse.shape == (b, h, tq) and lse.dtype == torch.float32
    assert torch.equal(out, kflash.flash_attention_plain(
        q, k, v, causal=causal, q_offset=q_offset, kv_valid_len=valid))
    qn = q.double().numpy()
    kn = np.repeat(k.double().numpy(), h // kh, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", qn, kn) * hd ** -0.5 / np.log(2.0)
    valid = tk if valid is None else valid
    mask = np.arange(tk)[None, :] < valid
    if causal:
        mask = mask & (np.arange(tk)[None, :]
                       <= q_offset + np.arange(tq)[:, None])
    s = np.where(mask, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    want = (m + np.log2(np.exp2(s - m).sum(axis=-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(_np(lse), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_backward_takes_the_plain_version_of_its_route(dtype):
    """On the CPU ``flash_attention_backward`` is the plain version of the
    kernel the card would take: bf16 the tensor-core mirror, float32 the
    CUDA-core kernel's arithmetic."""
    case = CASES[2]
    causal, q_offset, valid = case[6:]
    _, (q, k, v, do) = _inputs(case, dtype, seed=5)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=valid)
    out = kflash.flash_attention(q, k, v, **kw)
    plain = (kflash.flash_attention_backward_mma_plain
             if dtype == torch.bfloat16
             else kflash.flash_attention_backward_plain)
    for g, w in zip(kflash.flash_attention_backward(q, k, v, out, do, **kw),
                    plain(q, k, v, out, do, **kw)):
        assert torch.equal(g, w)


# (b, tq, tk, h, kh, hd, causal, q_offset, kv_valid_len, window)
WINDOW_CASES = [
    (2, 70, 70, 4, 2, 16, True, 0, None, 9),
    (1, 37, 100, 4, 2, 32, True, 20, 57, 30),
    (1, 45, 45, 4, 2, 16, False, 0, None, 12),
    (2, 3, 90, 4, 2, 32, True, 60, 63, 5),   # the layer's Tq <= 8 path
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_windowed_matches_vjp_of_model_layer(case, dtype):
    """Both backward routes' arithmetic under a sliding window against
    ``jax.vjp`` of the model layer's ``flash_attention(sliding_window=w)``:
    the float32 plain backward and, in bf16, the tensor-core mirror."""
    causal, q_offset, valid, w = case[6:]
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(case, dtype, seed=w)

    def f(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, causal=causal,
                                     q_offset=q_offset, kv_valid_len=valid,
                                     sliding_window=w, kv_chunk=32)

    _, vjp = jax.vjp(f, jq, jk, jv)
    want = vjp(jdo)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=valid,
              sliding_window=w)
    out = kflash.flash_attention_plain(q, k, v, **kw)
    plain = (kflash.flash_attention_backward_mma_plain
             if dtype == torch.bfloat16
             else kflash.flash_attention_backward_plain)
    got = plain(q, k, v, out, do, **kw)
    for g, wt, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, wt, dtype)
