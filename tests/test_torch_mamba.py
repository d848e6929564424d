"""The port's mamba layer (``repro_torch.models.mamba``) against
``repro.models.mamba`` on the CPU, at smoke size.

Inputs are drawn by numpy from a seed; the layer's parameters are the
reference's ``init_mamba`` draws, carried across leaf by leaf.
Tolerances, with the difference measured at these inputs in parentheses:

* ``causal_conv`` in float32: outputs within 1e-5 (0: the same shifted
  adds in the same order), the carried inputs exactly;
* ``ssm_scan`` in float32, with and without an incoming state: outputs and
  the last state within 1e-5 (the port's sequential loop sums in another
  order than the reference's ``associative_scan``; 3.8e-6 measured);
* the whole layer in float32, a prefill of 12 tokens then 4 one-token
  decode steps with both states carried: outputs, conv and ssm states
  within 1e-5 (1.2e-6 measured, the conv states equal); in bf16 outputs
  within 2^-5 of the largest |y| (four bf16 ulps of it: the bf16 products
  and activations round at other places in the two frameworks, and the
  reference runs jitted, where XLA may fuse a bf16 chain in float32; 0.031
  measured against a bound of 0.13), the conv states equal (the layer's
  inputs, rounded alike) and the float32 ssm state within 0.05 (0.021
  measured, of values up to 3.3);
* the port's own prefill-then-decode against its one pass over the whole
  sequence, in float32: within 1e-5.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro_torch.models import mamba

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

D_MODEL, D_STATE, D_INNER = 64, 8, 128


@pytest.fixture(autouse=True)
def _inference():
    with torch.no_grad():
        yield


def _np(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv(carry):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    w = rng.standard_normal((4, 1, 32)).astype(np.float32)
    prev = rng.standard_normal((2, 3, 32)).astype(np.float32) if carry \
        else None
    want, want_prev = jmamba._causal_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if prev is None else jnp.asarray(prev))
    got, got_prev = mamba.causal_conv(
        torch.from_numpy(x), torch.from_numpy(w),
        None if prev is None else torch.from_numpy(prev))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_prev.numpy(), _np(want_prev))
    # the carried state is the last three inputs
    np.testing.assert_array_equal(got_prev.numpy(), x[:, -3:])


def _scan_inputs(seed, b=2, t=24, d=32, s=8):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, t, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, d)))).astype(np.float32)
    a = -np.tile(np.arange(1, s + 1, dtype=np.float32), (d, 1))
    bm = rng.standard_normal((b, t, s)).astype(np.float32)
    cm = rng.standard_normal((b, t, s)).astype(np.float32)
    dsk = rng.standard_normal(d).astype(np.float32)
    h0 = rng.standard_normal((b, d, s)).astype(np.float32)
    return u, dt, a, bm, cm, dsk, h0


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_scan(with_h0):
    u, dt, a, bm, cm, dsk, h0 = _scan_inputs(1)
    args = (u, dt, a, bm, cm, dsk)
    want, want_h = jmamba._ssm_scan(
        *map(jnp.asarray, args), h0=jnp.asarray(h0) if with_h0 else None)
    got, got_h = mamba.ssm_scan(
        *map(torch.from_numpy, args),
        h0=torch.from_numpy(h0) if with_h0 else None)
    assert got.dtype == torch.float32 and got_h.shape == h0.shape
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_h.numpy(), _np(want_h), atol=1e-5,
                               rtol=0)


def _layer_pair(dtype):
    jp = jmamba.init_mamba(jax.random.PRNGKey(3), D_MODEL, d_state=D_STATE,
                           dtype=jnp.float32 if dtype == torch.float32
                           else jnp.bfloat16)
    p = mamba.Mamba(D_MODEL, d_state=D_STATE, device="cpu", dtype=dtype)
    for name, t in p.named_parameters():
        leaf = jp
        for part in name.split("."):
            leaf = leaf[part]
        assert tuple(leaf.shape) == tuple(t.shape), name
        t.copy_(torch.from_numpy(np.array(leaf, np.float32)))
        assert t.dtype == (torch.float32 if name in ("dt_bias", "a_log",
                                                     "d_skip") else dtype)
    return jp, p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_prefill_then_decode(dtype):
    """A prefill of 12 tokens from zero states, then 4 one-token decode
    steps, each carrying both states, against the reference's
    ``mamba(..., return_state=True)``."""
    jp, p = _layer_pair(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    f32 = dtype == torch.float32
    x = np.random.default_rng(4).standard_normal((2, 16, D_MODEL)) \
        .astype(np.float32)
    jconv, jssm = jmamba.init_mamba_state(2, D_MODEL, d_state=D_STATE,
                                          dtype=jdt)
    conv, ssm = mamba.init_mamba_state(2, D_MODEL, d_state=D_STATE,
                                       device="cpu", dtype=dtype)
    assert conv.shape == jconv.shape and ssm.shape == jssm.shape
    assert ssm.dtype == torch.float32
    # jitted: eager, every op of the layer compiles again at each new shape
    step = jax.jit(partial(jmamba.mamba, return_state=True))
    for lo, hi in ((0, 12), (12, 13), (13, 14), (14, 15), (15, 16)):
        want, (jconv, jssm) = step(jp, jnp.asarray(x[:, lo:hi], jdt),
                                   conv_state=jconv, ssm_state=jssm)
        got, (conv, ssm) = mamba.mamba(
            p, torch.from_numpy(x[:, lo:hi]).to(dtype), conv, ssm)
        assert got.dtype == dtype and conv.dtype == dtype
        want = _np(want)
        tol = 1e-5 if f32 else 2 ** -5 * np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=0)
        np.testing.assert_array_equal(conv.float().numpy(), _np(jconv))
        np.testing.assert_allclose(ssm.numpy(), _np(jssm),
                                   atol=1e-5 if f32 else 0.05, rtol=0)


def test_prefill_then_decode_is_one_pass():
    """The port's states carry exactly what one pass over the sequence
    sees: a prefill of 12 then 4 single steps equals the whole 16."""
    _, p = _layer_pair(torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16, D_MODEL)).astype(np.float32))
    whole, (c_all, s_all) = mamba.mamba(p, x)
    out, (conv, ssm) = mamba.mamba(p, x[:, :12])
    outs = [out]
    for i in range(12, 16):
        out, (conv, ssm) = mamba.mamba(p, x[:, i:i + 1], conv, ssm)
        outs.append(out)
    torch.testing.assert_close(torch.cat(outs, dim=1), whole, atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(ssm, s_all, atol=1e-5, rtol=0)
    assert torch.equal(conv, c_all)


def test_init_mamba_distributions():
    """The reference's distributions (not its draws), seeded: normal /
    sqrt(d_in) projections, normal / sqrt(d_conv) conv, S4D-real a_log,
    zero dt_bias, unit d_skip; leaf shapes as the reference's."""
    jp = jmamba.init_mamba(jax.random.PRNGKey(0), 256, d_state=16)
    runs = []
    for _ in range(2):
        p = mamba.Mamba(256, d_state=16, device="cpu")
        mamba.init_mamba(p, generator=torch.Generator().manual_seed(7))
        runs.append(p)
    for (name, a), (_, b) in zip(runs[0].named_parameters(),
                                 runs[1].named_parameters()):
        assert torch.equal(a, b), name
    p = runs[0]
    for name, t in p.named_parameters():
        leaf = jp
        for part in name.split("."):
            leaf = leaf[part]
        assert tuple(leaf.shape) == tuple(t.shape), name
        assert str(leaf.dtype) == str(t.dtype).replace("torch.", ""), name
    for lin in (p.in_proj, p.x_proj, p.dt_proj, p.out_proj):
        std = lin.w.float().std().item() * lin.w.shape[0] ** 0.5
        assert abs(std - 1.0) < 0.05
    assert abs(p.conv_w.float().std().item() * 2.0 - 1.0) < 0.05
    # torch's and XLA's float32 log may differ in the last bit
    np.testing.assert_array_max_ulp(p.a_log.numpy(), _np(jp["a_log"]),
                                    maxulp=1)
    assert not p.dt_bias.any() and bool((p.d_skip == 1).all())
    assert mamba.dt_rank_of(256) == p.dt_proj.w.shape[0] == 16
    assert mamba.dt_rank_of(64) == 16 and mamba.dt_rank_of(4096) == 256
