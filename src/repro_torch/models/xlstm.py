"""xLSTM blocks: chunkwise-parallel mLSTM and sequential sLSTM.

Counterpart of ``repro/models/xlstm.py``.  The mLSTM (matrix memory,
exponential gating) runs in the chunkwise-parallel form
(:func:`mlstm_chunkwise`): within a chunk of L steps its contribution is an
attention-like lower-triangular product with log-space decay weights, and
a Python loop over the chunks carries the ``(C, n, m)`` state, as the
reference's ``lax.scan`` does.  The single-token decode and the tests take
the step-by-step recurrence (:func:`mlstm_sequential`).  The sLSTM (scalar
memory, block-diagonal recurrence through h_{t-1}) is a loop over T with
its input projection hoisted out of it (:func:`slstm_block`).  Both cells
are plain torch: the reference's are jnp, outside any Pallas kernel.

Every state is float32, whatever the parameters' dtype: the mLSTM's ``C``
(B, H, hd, hd), ``n`` (B, H, hd) and stabiliser ``m`` (B, H); the sLSTM's
``(c, n, m, h)``, each (B, H, hd).  ``m`` starts at the float32 sentinel
-1e30, and a padded step's input gate is -1e30 too, so its decay weights
are 0.  The chunk's state update ``sum_s w_s k_s v_s^T`` (the reference's
three-operand einsum) is one product ``(w k)^T v``, which never forms the
(B, H, L, hd, hd) tensor: 8.6 GB at B = 8 on xlstm-1.3b's hd of 1 024.

The three loops run as custom ops (``models/recurrence.py``):
``repro_torch::mlstm_chunkwise``, ``mlstm_sequential`` and ``slstm_scan``,
whose implementations are :func:`mlstm_chunkwise_plain`,
:func:`mlstm_sequential_plain` and :func:`slstm_scan_plain`.  Under a mesh
each runs over local shards, the batch on dp:

* the mLSTM cell is separable over v's head dim (``dv``): q, k, the gates
  and the state's ``n`` and ``m`` are whole on tp, v, ``C``'s value dim and
  h split over it.  Each tp rank computes the whole ``n`` and ``m``; a
  gradient taken through the returned state would be summed over tp once
  a rank, so none is (training starts every sequence from zeros and drops
  the final state);
* the sLSTM's ``r_kernel`` mixes every hd of a head at each step, so the
  cell is whole on every tp rank: one gather in, no collective a step, and
  the work tp times over (``tools/op_cost.py`` counts it on each device).

Each cell's serving state is a NamedTuple (:class:`MLSTMState`,
:class:`SLSTMState`) whose ``LAYOUT`` gives those placements to
``dist/cache_sharding.py``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.sharding import shard, split_heads
from repro_torch.models import recurrence
from repro_torch.models.layers import Linear, linear, silu

NEG = -1e30


class MLSTMState(NamedTuple):
    """An mLSTM layer's state, float32; ``LAYOUT``: each field's logical
    dims under a mesh (the cell's placements, the module docstring)."""

    c: torch.Tensor             # (B, H, dk, dv)
    n: torch.Tensor             # (B, H, dk)
    m: torch.Tensor             # (B, H)

    LAYOUT = (("dp", None, None, "tp"), ("dp", None, None), ("dp", None))


class SLSTMState(NamedTuple):
    """An sLSTM layer's state, each (B, H, hd) float32, whole on tp."""

    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor

    LAYOUT = (("dp", None, None),) * 4


def _mat(d_in: int, d_out: int, device, dtype) -> Linear:
    return Linear(torch.empty((d_in, d_out), device=device, dtype=dtype))


def _f32(*shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device,
                                    dtype=torch.float32))


class MLSTM(nn.Module):
    """The reference's mLSTM leaves: ``up`` and ``gate_proj`` (d, d_inner),
    the per-head block-diagonal ``wq``, ``wk`` and ``wv`` (H, hd, hd),
    ``w_if`` (d_inner, 2 H), ``down`` (d_inner, d) in ``dtype``, and the
    float32 ``norm_scale`` (d_inner,); d_inner = ``int(expand * d)``, hd =
    d_inner / H."""

    def __init__(self, d_model: int, *, n_heads: int, expand: float = 2.0,
                 device=None, dtype=torch.bfloat16):
        super().__init__()
        d_inner = int(expand * d_model)
        hd = d_inner // n_heads

        def heads():
            return nn.Parameter(torch.empty((n_heads, hd, hd), device=device,
                                            dtype=dtype))

        self.up = _mat(d_model, d_inner, device, dtype)
        self.gate_proj = _mat(d_model, d_inner, device, dtype)
        self.wq, self.wk, self.wv = heads(), heads(), heads()
        self.w_if = _mat(d_inner, 2 * n_heads, device, dtype)
        self.norm_scale = _f32(d_inner, device=device)
        self.down = _mat(d_inner, d_model, device, dtype)


class SLSTMFF(nn.Module):
    """The sLSTM block's GeGLU: ``w1`` (d, 2 d) and ``w2`` (d, d)."""

    def __init__(self, d_model: int, *, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.w1 = _mat(d_model, 2 * d_model, device, dtype)
        self.w2 = _mat(d_model, d_model, device, dtype)


class SLSTM(nn.Module):
    """The reference's sLSTM leaves: ``w_in`` (d, 4 d), the recurrent
    ``r_kernel`` (4, H, hd, hd) and ``w_ff`` in ``dtype``, and the float32
    ``norm_scale`` (d,); hd = d / H."""

    def __init__(self, d_model: int, *, n_heads: int, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        hd = d_model // n_heads
        self.w_in = _mat(d_model, 4 * d_model, device, dtype)
        self.r_kernel = nn.Parameter(torch.empty((4, n_heads, hd, hd),
                                                 device=device, dtype=dtype))
        self.norm_scale = _f32(d_model, device=device)
        self.w_ff = SLSTMFF(d_model, device=device, dtype=dtype)


def _draw(w: torch.Tensor, generator: torch.Generator, scale: float) -> None:
    x = torch.randn(w.shape, generator=generator, device=w.device,
                    dtype=torch.float32)
    w.copy_(x * scale)


@torch.no_grad()
def init_mlstm(p: MLSTM, *, generator: torch.Generator) -> MLSTM:
    """The reference's distributions (not its draws): the linears normal /
    sqrt(d_in), the head blocks normal / sqrt(hd), drawn in float32 from
    ``generator`` in the order up, gate_proj, wq, wk, wv, w_if, down and
    cast to their dtype; ``norm_scale`` ones."""
    for w in (p.up.w, p.gate_proj.w, p.wq, p.wk, p.wv, p.w_if.w, p.down.w):
        _draw(w, generator, 1 / math.sqrt(w.shape[-2]))
    p.norm_scale.fill_(1.0)
    return p


@torch.no_grad()
def init_slstm(p: SLSTM, *, generator: torch.Generator) -> SLSTM:
    """The reference's distributions: ``w_in``, ``w_ff.w1`` and ``w_ff.w2``
    normal / sqrt(d_in), ``r_kernel`` normal / sqrt(hd), drawn in float32
    from ``generator`` in the order w_in, r_kernel, w1, w2; ``norm_scale``
    ones."""
    for w in (p.w_in.w, p.r_kernel, p.w_ff.w1.w, p.w_ff.w2.w):
        _draw(w, generator, 1 / math.sqrt(w.shape[-2]))
    p.norm_scale.fill_(1.0)
    return p


def _headwise_rmsnorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS over each head's last axis, in float32, back in ``x``'s dtype;
    the scale is applied by the caller, as the reference's."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype)


def _zero_state(b: int, nh: int, dk: int, dv: int, device) -> tuple:
    """``(C (B, H, dk, dv), n (B, H, dk), m (B, H))`` float32: zeros, and
    ``m`` the -1e30 sentinel."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((b, nh, dk, dv), **f32),
            torch.zeros((b, nh, dk), **f32),
            torch.full((b, nh), NEG, **f32))


def init_mlstm_state(b: int, d_model: int, *, n_heads: int,
                     expand: float = 2.0, device=None) -> tuple:
    """The mLSTM's state before any step: ``(C, n, m)`` of hd =
    ``int(expand * d_model) / n_heads`` (:func:`_zero_state`)."""
    hd = int(expand * d_model) // n_heads
    return MLSTMState(*_zero_state(b, n_heads, hd, hd, device))


def mlstm_chunkwise_plain(q, k, v, i_gate, f_gate, *, chunk: int = 64,
                          state: tuple | None = None) -> tuple:
    """The stabilised chunkwise-parallel mLSTM.

    q, k: (B, H, T, dk); v: (B, H, T, dv); i_gate, f_gate: (B, H, T)
    pre-activations (the forget gate in log space through ``logsigmoid``).
    T is padded up to a multiple of ``chunk`` (padded steps: input gate
    -1e30, forget gate 0).  Returns (h (B, H, T, dv) float32, (C, n, m))."""
    b, nh, t, dk = q.shape
    dv = v.shape[-1]
    pad = (-t) % chunk
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        i_gate = F.pad(i_gate, (0, pad), value=NEG)
        f_gate = F.pad(f_gate, (0, pad))
    tt = t + pad
    scale = dk ** -0.5
    logf = F.logsigmoid(f_gate.float())
    c, n, m = _zero_state(b, nh, dk, dv, q.device) if state is None \
        else state
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    outs = []
    for lo in range(0, tt, chunk):
        sl = slice(lo, lo + chunk)
        qj, kj, vj = (x[:, :, sl].float() for x in (q, k, v))
        ij, fj = i_gate[:, :, sl].float(), logf[:, :, sl]
        cum_f = fj.cumsum(dim=-1)                                # (B,H,L)
        # log weight of source s at step t: cum_f_t - cum_f_s + i_s
        src = ij - cum_f
        run_max = torch.cummax(src, dim=-1).values
        m_new = torch.maximum(cum_f + m[..., None], cum_f + run_max)
        inter_scale = torch.exp(cum_f + m[..., None] - m_new)
        logw = cum_f[..., :, None] + src[..., None, :] \
            - m_new[..., :, None]                                # (B,H,L,L)
        w = torch.where(tri, torch.exp(logw), 0.0)

        scores = (qj @ kj.transpose(-1, -2)) * scale
        num = (scores * w) @ vj \
            + (qj @ c) * scale * inter_scale[..., None]
        n_t = w @ kj + n[..., None, :] * inter_scale[..., None]
        denom = torch.abs((qj * n_t).sum(dim=-1) * scale)
        denom = torch.maximum(denom, torch.exp(-m_new))
        outs.append(num / denom[..., None])

        # end-of-chunk state update
        last_scale = torch.exp(cum_f[..., -1:] + m[..., None]
                               - m_new[..., -1:])                # (B,H,1)
        src_w = torch.exp(cum_f[..., -1:] + src - m_new[..., -1:])
        wk = src_w[..., None] * kj                               # (B,H,L,dk)
        c = c * last_scale[..., None] + wk.transpose(-1, -2) @ vj
        n = n * last_scale + wk.sum(dim=-2)
        m = m_new[..., -1]
    h = torch.cat(outs, dim=2)[:, :, :t]
    return h, (c, n, m)


def mlstm_sequential_plain(q, k, v, i_gate, f_gate, *,
                           state: tuple | None = None) -> tuple:
    """The step-by-step recurrence (decode and tests), float32; shapes as
    :func:`mlstm_chunkwise_plain`'s."""
    b, nh, t, dk = q.shape
    scale = dk ** -0.5
    c, n, m = _zero_state(b, nh, dk, v.shape[-1], q.device) \
        if state is None else state
    outs = []
    for s in range(t):
        qt, kt, vt = (x[:, :, s].float() for x in (q, k, v))
        it = i_gate[:, :, s].float()
        logf = F.logsigmoid(f_gate[:, :, s].float())
        m_new = torch.maximum(logf + m, it)
        fp = torch.exp(logf + m - m_new)
        ip = torch.exp(it - m_new)
        c = c * fp[..., None, None] \
            + (ip[..., None] * kt)[..., :, None] * vt[..., None, :]
        n = n * fp[..., None] + ip[..., None] * kt
        num = (qt[..., None, :] @ c)[..., 0, :] * scale
        den = torch.maximum(torch.abs((qt * n).sum(dim=-1)) * scale,
                            torch.exp(-m_new))
        outs.append(num / den[..., None])
        m = m_new
    return torch.stack(outs, dim=2), (c, n, m)


def _state(xs: list) -> tuple | None:
    return None if xs[0] is None else tuple(xs)


def _mlstm_shapes(xs, ints):
    b, nh, t, dk = xs[0].shape
    dv = xs[2].shape[-1]
    return [((b, nh, t, dv), torch.float32), ((b, nh, dk, dv), torch.float32),
            ((b, nh, dk), torch.float32), ((b, nh), torch.float32)]


_MLSTM_ARGS = ("Tensor q, Tensor k, Tensor v, Tensor i_gate, Tensor f_gate, "
               "Tensor? c0, Tensor? n0, Tensor? m0")
# q, k, v (B, H, T, ·) and the gates (B, H, T): T on dim 2
_MLSTM_T = {0: 2, 1: 2, 2: 2, 3: 2, 4: 2}


def _flat(out) -> tuple:
    h, state = out
    return (h, *state)


MLSTM_CHUNKWISE = recurrence.define(recurrence.Recurrence(
    name="mlstm_chunkwise",
    call=lambda xs, ints: _flat(mlstm_chunkwise_plain(
        *xs[:5], chunk=ints[0], state=_state(xs[5:]))),
    shapes=_mlstm_shapes,
    t_axes=_MLSTM_T,
    # T padded up to whole chunks: -(-t // chunk) trips
    trips=lambda t, ints: -(-t // ints[0]),
    length=lambda t, ints, n: t - (-(-t // ints[0]) - n) * ints[0],
), _MLSTM_ARGS)

MLSTM_SEQUENTIAL = recurrence.define(recurrence.Recurrence(
    name="mlstm_sequential",
    call=lambda xs, ints: _flat(mlstm_sequential_plain(
        *xs[:5], state=_state(xs[5:]))),
    shapes=_mlstm_shapes,
    t_axes=_MLSTM_T,
    trips=lambda t, ints: t,
    length=lambda t, ints, n: n,
), _MLSTM_ARGS)

# q and k whole on tp, v and h split on their last dim (the module docstring)
_MLSTM_DIMS = [("dp", None, None, None), ("dp", None, None, None),
               ("dp", None, None, "tp"), ("dp", None, None),
               ("dp", None, None), *MLSTMState.LAYOUT]
_MLSTM_OUT = [("dp", None, None, "tp"), *MLSTMState.LAYOUT]


def _mlstm(rec, q, k, v, i_gate, f_gate, ints, state) -> tuple:
    state = (None,) * 3 if state is None else tuple(state)
    h, c, n, m = recurrence.apply(rec, [q, k, v, i_gate, f_gate, *state],
                                  ints, _MLSTM_DIMS, _MLSTM_OUT)
    return h, MLSTMState(c, n, m)


def mlstm_chunkwise(q, k, v, i_gate, f_gate, *, chunk: int = 64,
                    state: tuple | None = None) -> tuple:
    """:func:`mlstm_chunkwise_plain` as the op
    ``repro_torch::mlstm_chunkwise``; under a mesh over local shards.
    Returns (h (B, H, T, dv) float32, :class:`MLSTMState`)."""
    return _mlstm(MLSTM_CHUNKWISE, q, k, v, i_gate, f_gate, [chunk], state)


def mlstm_sequential(q, k, v, i_gate, f_gate, *,
                     state: tuple | None = None) -> tuple:
    """:func:`mlstm_sequential_plain` as the op
    ``repro_torch::mlstm_sequential``; under a mesh over local shards."""
    return _mlstm(MLSTM_SEQUENTIAL, q, k, v, i_gate, f_gate, [], state)


def mlstm_block(p: MLSTM, x: torch.Tensor, *, n_heads: int, chunk: int = 64,
                state: tuple | None = None) -> tuple:
    """The mLSTM block over x (B, T, d) from ``state`` (zeros and the
    sentinel when None): a one-token step with a state takes the
    sequential form, anything else the chunkwise form with ``min(chunk,
    T)`` steps a chunk.  The heads are projected in ``x``'s dtype, the
    gates and the cell run in float32, the head-wise norm and
    ``norm_scale`` in float32, and ``h`` returns to ``x``'s dtype before
    the SiLU gate.  Returns (out (B, T, d), the new state)."""
    b, t, _ = x.shape
    inner = linear(p.up, x)
    gate = linear(p.gate_proj, x)
    d_inner = inner.shape[-1]
    inner_h = split_heads(inner, b, t, n_heads, d_inner // n_heads)
    q, k, v = (torch.einsum("bthd,hde->bhte", inner_h, w)
               for w in (p.wq, p.wk, p.wv))
    v = shard(v, "dp", None, None, "tp")
    if_gates = linear(p.w_if, inner).float()
    i_gate = if_gates[..., :n_heads].transpose(1, 2)             # (B,H,T)
    f_gate = if_gates[..., n_heads:].transpose(1, 2)
    if t == 1 and state is not None:
        h, new_state = mlstm_sequential(q, k, v, i_gate, f_gate, state=state)
    else:
        h, new_state = mlstm_chunkwise(q, k, v, i_gate, f_gate,
                                       chunk=min(chunk, max(t, 1)),
                                       state=state)
    # h whole on tp from here to the down projection: DTensor cannot
    # flatten heads whose dim is split, nor split ``norm_scale`` into heads
    # that do not divide tp (no-ops outside a mesh)
    h = shard(h, "dp", None, None, None)
    h = _headwise_rmsnorm(h.transpose(1, 2))                    # (B,T,H,hd)
    h = h.reshape(b, t, d_inner) * shard(p.norm_scale, None)
    h = shard(h, "dp", None, "tp")
    return linear(p.down, h.to(x.dtype) * silu(gate)), new_state


def init_slstm_state(b: int, d_model: int, *, n_heads: int,
                     device=None) -> SLSTMState:
    """``(c, n, m, h)``, each (B, H, hd) float32: 0, 1e-6, -1e30, 0."""
    zeros = torch.zeros((b, n_heads, d_model // n_heads), device=device)
    return SLSTMState(zeros, zeros + 1e-6, zeros + NEG, zeros.clone())


def slstm_scan_plain(wx: torch.Tensor, r: torch.Tensor,
                     state: tuple | None = None) -> tuple:
    """The sLSTM recurrence one step at a time in float32: wx (B, T, 4, H,
    hd), the input projection of every step; r (4, H, hd, hd), the
    recurrent kernel; ``state`` ``(c, n, m, h)`` (:func:`init_slstm_state`
    when None).  Returns (h of every step (B, T, H, hd), (c, n, m, h))."""
    b, t, _, n_heads, hd = wx.shape
    if state is None:
        state = init_slstm_state(b, n_heads * hd, n_heads=n_heads,
                                 device=wx.device)
    c, n, m, h = state
    hs = []
    for s in range(t):
        xt = wx[:, s]                                            # (B,4,H,hd)
        rec = torch.einsum("bhd,ghde->gbhe", h, r)               # (4,B,H,hd)
        zt = torch.tanh(xt[:, 0] + rec[0])
        it = xt[:, 1] + rec[1]
        ft = xt[:, 2] + rec[2]
        ot = torch.sigmoid(xt[:, 3] + rec[3])
        logf = F.logsigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        fp = torch.exp(logf + m - m_new)
        ip = torch.exp(it - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        h = ot * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h)


SLSTM_SCAN = recurrence.define(recurrence.Recurrence(
    name="slstm_scan",
    call=lambda xs, ints: _flat(slstm_scan_plain(xs[0], xs[1],
                                                 _state(xs[2:]))),
    shapes=lambda xs, ints: [
        ((*xs[0].shape[:2], *xs[0].shape[3:]), torch.float32)] + [
        ((xs[0].shape[0], *xs[0].shape[3:]), torch.float32)] * 4,
    t_axes={0: 1},
    trips=lambda t, ints: t,
    length=lambda t, ints, n: n,
), "Tensor wx, Tensor r, Tensor? c0, Tensor? n0, Tensor? m0, Tensor? h0")


def slstm_scan(wx: torch.Tensor, r: torch.Tensor,
               state: tuple | None = None) -> tuple:
    """:func:`slstm_scan_plain` as the op ``repro_torch::slstm_scan``;
    under a mesh whole on every tp rank, the batch on dp (the module
    docstring).  Returns (h of every step, :class:`SLSTMState`)."""
    state = (None,) * 4 if state is None else tuple(state)
    hs, *new = recurrence.apply(
        SLSTM_SCAN, [wx, r, *state], [],
        [("dp", None, None, None, None), (None,) * 4, *SLSTMState.LAYOUT],
        [("dp", None, None, None), *SLSTMState.LAYOUT])
    return hs, SLSTMState(*new)


def slstm_block(p: SLSTM, x: torch.Tensor, *, n_heads: int,
                state: tuple | None = None) -> tuple:
    """The sLSTM block over x (B, T, d): the recurrence
    (:func:`slstm_scan`) in float32 (``w_in`` applied to every step first,
    ``r_kernel`` in float32), ``norm_scale``, back to ``x``'s dtype, then
    the GeGLU ``w_ff``.  Returns (out (B, T, d), the new
    :class:`SLSTMState`)."""
    b, t, d = x.shape
    hd = d // n_heads
    # whole on tp (the cell is): the one gather in (a no-op outside a mesh)
    wx = shard(linear(p.w_in, x).float(), "dp", None, None) \
        .reshape(b, t, 4, n_heads, hd)
    hs, new_state = slstm_scan(wx, p.r_kernel.float(), state)
    out = (hs.reshape(b, t, d) * shard(p.norm_scale, None)).to(x.dtype)
    # post-up-projection GeGLU FFN, its activations whole on tp
    g1, g2 = shard(linear(p.w_ff.w1, out), "dp", None, None).chunk(2, dim=-1)
    return linear(p.w_ff.w2, shard(silu(g1) * g2, "dp", None, None)), \
        new_state
