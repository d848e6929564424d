"""Mamba (S6) selective state-space layer: Jamba's recurrent block.

Counterpart of ``repro/models/mamba.py``.  The reference runs the scan over
time with ``jax.lax.associative_scan`` (a parallel prefix over the diagonal
recurrence ``h_t = exp(dt_t a) h_{t-1} + dt_t u_t b_t``), which
materialises ``(B, T, d_inner, d_state)`` float32 tensors: 1.34 GB each a
layer at jamba's served prefill (B 8, T 320, d_inner 8 192).  Here
:func:`ssm_scan` is a sequential loop over T that keeps one ``h (B,
d_inner, d_state)`` in float32 and emits ``y_t = h_t . c_t + u_t D`` at
each step; the sums run in another order than the prefix's, so the two
agree to float32 rounding (``tests/test_torch_mamba.py`` states the
tolerance).  The scan is plain torch (the reference's is jnp, outside any
Pallas kernel), run as the custom op ``repro_torch::ssm_scan``
(``models/recurrence.py``): :func:`ssm_scan_plain` is its implementation.
The causal depthwise conv (width 4) is shifted adds in float32, as the
reference's.

Under a mesh the scan runs over local shards: it is independent for each
batch row and each ``d_inner`` channel, so u, dt, ``a``, ``d_skip`` and the
state are split over dp (the batch) and tp (``d_inner``), and ``b_mat`` and
``c_mat``, which ``x_proj`` makes as a sum over the tp shards of
``d_inner``, are whole on tp; the output comes back split as u is.

State for serving: :class:`MambaState` ``(conv (B, d_conv - 1, d_inner),
ssm (B, d_inner, d_state) float32)``; the conv state holds the layer's last
``d_conv - 1`` inputs, in their dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.dist.sharding import shard
from repro_torch.models import recurrence
from repro_torch.models.layers import Linear, linear, silu


class MambaState(NamedTuple):
    """A mamba layer's serving state; ``LAYOUT`` gives each field's logical
    dims under a mesh (``dist/cache_sharding.py``): the conv state as the
    layer's input (``d_inner`` on tp), the ssm state as the scan's."""

    conv: torch.Tensor          # (B, d_conv - 1, d_inner)
    ssm: torch.Tensor           # (B, d_inner, d_state) float32

    LAYOUT = (("dp", None, "tp"), ("dp", "tp", None))


class Mamba(nn.Module):
    """The reference's leaves: ``in_proj`` (d, 2 d_inner), ``conv_w``
    (d_conv, 1, d_inner), ``x_proj`` (d_inner, dt_rank + 2 d_state),
    ``dt_proj`` (dt_rank, d_inner) and ``out_proj`` (d_inner, d) in
    ``dtype``; ``dt_bias`` (d_inner,), ``a_log`` (d_inner, d_state) and
    ``d_skip`` (d_inner,) in float32.  ``dt_rank`` defaults to
    :func:`dt_rank_of`, as the reference's."""

    def __init__(self, d_model: int, *, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank: int | None = None, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        d_inner = expand * d_model
        dt_rank = dt_rank or dt_rank_of(d_model)

        def mat(d_in, d_out):
            return Linear(torch.empty((d_in, d_out), device=device,
                                      dtype=dtype))

        def f32(*shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=torch.float32))

        self.in_proj = mat(d_model, 2 * d_inner)
        self.conv_w = nn.Parameter(torch.empty((d_conv, 1, d_inner),
                                               device=device, dtype=dtype))
        self.x_proj = mat(d_inner, dt_rank + 2 * d_state)
        self.dt_proj = mat(dt_rank, d_inner)
        self.dt_bias = f32(d_inner)
        self.a_log = f32(d_inner, d_state)
        self.d_skip = f32(d_inner)
        self.out_proj = mat(d_inner, d_model)


def dt_rank_of(d_model: int) -> int:
    """The reference's default ``dt_rank``: ``max(16, d // 16)``."""
    return max(16, d_model // 16)


@torch.no_grad()
def init_mamba(p: Mamba, *, generator: torch.Generator) -> Mamba:
    """The reference's distributions (``init_mamba``; not its draws):
    ``in_proj``, ``x_proj``, ``dt_proj`` and ``out_proj`` normal /
    sqrt(d_in), ``conv_w`` normal / sqrt(d_conv), drawn in float32 from
    ``generator`` in that order (the conv second) and cast to their dtype;
    ``dt_bias`` zeros, ``a_log`` the S4D-real ``log(1..d_state)`` on every
    row, ``d_skip`` ones."""
    for w, fan_in in ((p.in_proj.w, p.in_proj.w.shape[0]),
                      (p.conv_w, p.conv_w.shape[0]),
                      (p.x_proj.w, p.x_proj.w.shape[0]),
                      (p.dt_proj.w, p.dt_proj.w.shape[0]),
                      (p.out_proj.w, p.out_proj.w.shape[0])):
        x = torch.randn(w.shape, generator=generator, device=w.device,
                        dtype=torch.float32)
        w.copy_(x / math.sqrt(fan_in))
    d_state = p.a_log.shape[1]
    p.dt_bias.zero_()
    p.a_log.copy_(torch.log(torch.arange(
        1, d_state + 1, dtype=torch.float32, device=p.a_log.device))
        .expand_as(p.a_log))
    p.d_skip.fill_(1.0)
    return p


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                prev: torch.Tensor | None = None) -> tuple:
    """Depthwise causal conv by shifted adds, summed in float32.

    x: (B, T, d_inner); w: (width, 1, d_inner); prev: (B, width - 1,
    d_inner), the carry-in (zeros when None).  Returns (y in ``x``'s dtype,
    the last ``width - 1`` inputs, in the promoted dtype of ``prev`` and
    ``x`` as the reference's concatenation gives it)."""
    width = w.shape[0]
    b, t, d = x.shape
    if prev is None:
        prev = x.new_zeros((b, width - 1, d))
    xp = torch.cat([prev, x], dim=1)
    y = torch.zeros((b, t, d), dtype=torch.float32, device=x.device)
    for i in range(width):
        y = y + xp[:, i:i + t].float() * w[i, 0]
    new_prev = xp[:, t:] if width > 1 else prev
    return y.to(x.dtype), new_prev


def ssm_scan_plain(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_mat: torch.Tensor, c_mat: torch.Tensor,
                   d_skip: torch.Tensor,
                   h0: torch.Tensor | None = None) -> tuple:
    """The selective scan, one step of T at a time, in float32.

    u, dt: (B, T, d_inner); a: (d_inner, d_state); b_mat, c_mat: (B, T,
    d_state); h0: (B, d_inner, d_state), the state before the first step
    (zeros when None).  ``h_t = exp(dt_t a) h_{t-1} + (dt_t u_t) b_t`` and
    ``y_t = h_t c_t + u_t D``.  Returns (y (B, T, d_inner), h_T)."""
    bsz, t, d_inner = u.shape
    h = h0.float() if h0 is not None else u.new_zeros(
        (bsz, d_inner, a.shape[1]), dtype=torch.float32)
    dtu = dt * u
    ys = []
    for i in range(t):
        h = torch.exp(dt[:, i, :, None] * a) * h \
            + dtu[:, i, :, None] * b_mat[:, i, None, :]
        ys.append(torch.bmm(h, c_mat[:, i, :, None]))
    y = torch.cat(ys, dim=2).transpose(1, 2)
    return y + u * d_skip, h


SSM_SCAN = recurrence.define(recurrence.Recurrence(
    name="ssm_scan",
    call=lambda xs, ints: ssm_scan_plain(*xs),
    shapes=lambda xs, ints: [
        (tuple(xs[0].shape), torch.float32),
        ((xs[0].shape[0], xs[0].shape[2], xs[2].shape[1]), torch.float32)],
    t_axes={0: 1, 1: 1, 3: 1, 4: 1},
    trips=lambda t, ints: t,
    length=lambda t, ints, n: n,
), "Tensor u, Tensor dt, Tensor a, Tensor b_mat, Tensor c_mat, "
   "Tensor d_skip, Tensor? h0")


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, d_skip: torch.Tensor,
             h0: torch.Tensor | None = None) -> tuple:
    """:func:`ssm_scan_plain` as the op ``repro_torch::ssm_scan``; under a
    mesh over local shards (the module docstring).  Returns (y (B, T,
    d_inner), h_T)."""
    return tuple(recurrence.apply(
        SSM_SCAN, [u, dt, a, b_mat, c_mat, d_skip, h0], [],
        dims=[("dp", None, "tp"), ("dp", None, "tp"), ("tp", None),
              ("dp", None, None), ("dp", None, None), ("tp",),
              ("dp", "tp", None)],
        out_dims=[("dp", None, "tp"), ("dp", "tp", None)]))


def mamba(p: Mamba, x: torch.Tensor, conv_state: torch.Tensor | None = None,
          ssm_state: torch.Tensor | None = None) -> tuple:
    """The layer over x (B, T, d_model), from the given states (zeros when
    None).  Returns (out (B, T, d_model) in ``x``'s dtype, the new
    :class:`MambaState`)."""
    d_state = p.a_log.shape[-1]
    dt_rank = p.x_proj.w.shape[-1] - 2 * d_state
    xin, z = linear(p.in_proj, x).chunk(2, dim=-1)
    xin = shard(xin, "dp", None, "tp")
    xin, new_conv = causal_conv(xin, p.conv_w, conv_state)
    xin = silu(xin)
    # whole on tp: every d_inner channel reads dt_in, b_mat and c_mat (the
    # sum over x_proj's tp shards; a no-op outside a mesh)
    dt_in, b_mat, c_mat = shard(linear(p.x_proj, xin), "dp", None, None) \
        .split([dt_rank, d_state, d_state], dim=-1)
    dt = torch.nn.functional.softplus(
        linear(p.dt_proj, dt_in).float() + p.dt_bias)
    a = -torch.exp(p.a_log)
    y, last = ssm_scan(xin.float(), dt, a, b_mat.float(), c_mat.float(),
                       p.d_skip, h0=ssm_state)
    y = shard(y.to(x.dtype) * silu(z), "dp", None, "tp")
    return linear(p.out_proj, y), MambaState(new_conv, last)


def init_mamba_state(b: int, d_model: int, *, d_state: int = 16,
                     d_conv: int = 4, expand: int = 2, device=None,
                     dtype=torch.bfloat16) -> tuple:
    """Zeroed :class:`MambaState` ``(conv (B, d_conv - 1, d_inner) in
    dtype, ssm (B, d_inner, d_state) float32)``, as the reference's."""
    d_inner = expand * d_model
    return MambaState(
        torch.zeros((b, d_conv - 1, d_inner), dtype=dtype, device=device),
        torch.zeros((b, d_inner, d_state), dtype=torch.float32,
                    device=device))
