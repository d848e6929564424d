"""Mixture-of-Experts with capacity-based sort/gather dispatch.

Counterpart of ``repro/models/moe.py``, both paths.  Outside a mesh the
reference vmaps one row's dispatch over the batch, so sort, rank, capacity
drop and combine are row-local, with a capacity computed from the row's
length ``T`` alone (:func:`capacity`).  Here every row is dispatched at once on batched
tensors, with the same row-local ranks and caps; the expert products then
run as one ``bmm`` per weight over ``(E, B cap, d)``.  Nothing here is a
hand-written kernel: the reference's routing, sorts and gathers are jnp and
its expert products ``jnp.einsum``, outside any Pallas kernel, so the port
keeps them plain torch.

Semantics kept exactly (the tests hold them to the reference):

* the router in float32 (``h.float() @ router.w``, softmax), top-k with the
  lower expert index first on a tie (``lax.top_k``), taken as the first k
  of a stable descending sort; gates divided by ``max(sum, 1e-9)``;
* a stable sort of the row's (token, k) pairs by expert, so a pair's rank
  within its expert follows token order, then k position; a pair of rank
  ``>= cap`` is dropped (the shared experts still see its token);
* the combine casts each gate to the expert output's dtype before the
  multiply and sums the k terms in float32 before one rounding to that
  dtype, as ``jnp.sum`` of a bf16 array computes (it upcasts 16-bit
  floats); the shared experts are added after it;
* aux: ``load_balance_loss = E * sum(mean probs * counts / P)`` over every
  pair, dropped ones included, and ``dropped_fraction = 1 - mean(keep)``,
  each averaged over rows.

Under a mesh (``dist.sharding.use_mesh``) the layer is the reference's
``shard_map`` branch as a ``local_map`` (:func:`_moe_mesh`): dispatch stays
local to the dp token shard, as ONE flat row over the local tokens with a
capacity of ``capacity((B / dp) T)`` (which differs from the per-row
path's, as in the reference); the expert weights are all-gathered over dp
explicitly (``w1``/``w3`` on axis 1, ``w2`` on axis 2, the shared experts
likewise) unless ``serving`` (the serving layout replicates them over dp),
and the only activation collective is one all-reduce of y over tp, whose
shards of d_ff make y partial; aux is averaged over tp and dp.  A batch
that dp does not divide drops dp (the weights are then taken whole).  The
router is taken whole: the reference's in_specs give it its leaf's (dp, tp)
spec (its leaf is named ``w``) and use the shard as if whole, which fails
wherever d divides dp (``dot_general`` of d against d / dp on a 2x2 host
mesh; ROADMAP queue 3).

Parameters keep the reference's layout: ``router.w`` (d, E) in float32,
``w1``/``w3`` (E, d, f) and ``w2`` (E, f, d) in the model's dtype, and an
optional ``shared`` SwiGLU of width ``n_shared * f``.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.dist.sharding import _axis_size, active_ctx, is_dtensor, \
    placements
from repro_torch.models.layers import Linear, silu


class SharedExperts(nn.Module):
    """The shared experts fused into one dense SwiGLU: ``w1``, ``w3`` (d,
    ds) and ``w2`` (ds, d), plain tensors as in the reference's leaf."""

    def __init__(self, d_model: int, d_shared: int, *, device=None,
                 dtype=torch.bfloat16):
        super().__init__()

        def mat(*shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype))

        self.w1 = mat(d_model, d_shared)
        self.w3 = mat(d_model, d_shared)
        self.w2 = mat(d_shared, d_model)


class MoE(nn.Module):
    """``router`` (a float32 :class:`Linear` of (d, E)), ``w1``, ``w3``
    (E, d, f), ``w2`` (E, f, d) and, with ``n_shared_experts``, ``shared``
    (:class:`SharedExperts` of width ``n_shared_experts * d_ff``)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, *,
                 n_shared_experts: int = 0, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.router = Linear(torch.empty((d_model, n_experts), device=device,
                                         dtype=torch.float32))

        def mat(*shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype))

        self.w1 = mat(n_experts, d_model, d_ff)
        self.w3 = mat(n_experts, d_model, d_ff)
        self.w2 = mat(n_experts, d_ff, d_model)
        if n_shared_experts:
            self.shared = SharedExperts(d_model, n_shared_experts * d_ff,
                                        device=device, dtype=dtype)

    def leaves(self) -> list:
        """The parameters in their draw order (:func:`init_moe`): router,
        w1, w3, w2, then the shared experts' w1, w3, w2."""
        out = [self.router.w, self.w1, self.w3, self.w2]
        if hasattr(self, "shared"):
            out += [self.shared.w1, self.shared.w3, self.shared.w2]
        return out


@torch.no_grad()
def init_moe(p: MoE, *, generator: torch.Generator) -> MoE:
    """The reference's distributions (``init_moe``; not its draws): each
    leaf normal / sqrt(its d_in), so the router and ``w1``, ``w3`` by
    1/sqrt(d), ``w2`` by 1/sqrt(f) and the shared experts' ``w2`` by
    1/sqrt(n_shared f); drawn in float32 from ``generator`` (on the
    parameters' device) in the order of :meth:`MoE.leaves` and cast to
    each leaf's dtype (the router stays float32)."""
    for w in p.leaves():
        x = torch.randn(w.shape, generator=generator, device=w.device,
                        dtype=torch.float32)
        w.copy_(x * w.shape[-2] ** -0.5)
    return p


def capacity(tokens: int, n_experts: int, top_k: int,
             capacity_factor: float = 1.25) -> int:
    """Slots an expert holds for one row of ``tokens``: ``ceil(tokens k / E
    cf)`` rounded up to a multiple of 8, at least 8 (the reference's
    ``_cap_for``)."""
    cap = int(math.ceil(tokens * top_k / n_experts * capacity_factor))
    return max(8, ((cap + 7) // 8) * 8)


class Routing(NamedTuple):
    probs: torch.Tensor        # (B, T, E) float32 softmax of the router
    gate: torch.Tensor         # (B, T, k) float32 gates (normalised)
    expert_idx: torch.Tensor   # (B, T, k) int64, best first


class Dispatch(NamedTuple):
    """One capacity dispatch, row by row; pairs in (token, k) order."""
    rank: torch.Tensor     # (B, P) a pair's rank within its expert
    keep: torch.Tensor     # (B, P) rank < cap
    slot: torch.Tensor     # (B, P) e cap + rank where kept, else E cap
    src_tok: torch.Tensor  # (B, E, cap) the token each slot reads, T if empty
    counts: torch.Tensor   # (B, E) pairs routed to each expert


def route(p: MoE, x: torch.Tensor, *, top_k: int,
          norm_topk: bool = True) -> Routing:
    """The float32 router over ``x`` (B, T, d)."""
    logits = x.float() @ p.router.w
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :top_k], idx[..., :top_k]
    if norm_topk:
        gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return Routing(probs, gate, idx)


def dispatch(expert_idx: torch.Tensor, n_experts: int,
             cap: int) -> Dispatch:
    """Ranks, drops and slots of ``expert_idx`` (B, T, k), each row on its
    own: a stable sort of the row's pairs by expert, a pair's rank its
    position within its expert's run."""
    b, t, k = expert_idx.shape
    n_pairs = t * k
    dev = expert_idx.device
    pairs_e = expert_idx.reshape(b, n_pairs)
    order = torch.argsort(pairs_e, dim=1, stable=True)
    e_s = torch.gather(pairs_e, 1, order)
    counts = torch.zeros((b, n_experts), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, pairs_e, torch.ones_like(pairs_e))
    starts = counts.cumsum(dim=1) - counts        # first sorted pair of e
    idx = torch.arange(n_pairs, device=dev)
    rank_s = idx - torch.gather(starts, 1, e_s)
    rank = torch.empty_like(rank_s).scatter_(1, order, rank_s)
    keep = rank < cap
    slot = torch.where(keep, pairs_e * cap + rank,
                       torch.full_like(rank, n_experts * cap))
    # slot (e, r) reads sorted pair starts[e] + r while r < counts[e]
    r = torch.arange(cap, device=dev)
    pos = (starts[:, :, None] + r).clamp_max(n_pairs - 1)
    tok_s = order // k
    src_tok = torch.where(
        r < counts[:, :, None],
        torch.gather(tok_s, 1, pos.reshape(b, -1)).reshape(pos.shape),
        torch.full_like(pos, t))
    return Dispatch(rank, keep, slot, src_tok, counts)


def experts(p: MoE, x: torch.Tensor, routing: Routing,
            disp: Dispatch) -> torch.Tensor:
    """The routed experts of ``x`` (B, T, d) through ``disp``'s slots,
    combined with ``routing``'s gates, plus the shared experts; (B, T, d)
    in ``x``'s dtype."""
    b, t, d = x.shape
    e, cap = disp.src_tok.shape[1:]
    k = routing.expert_idx.shape[-1]
    rows = torch.arange(b, device=x.device)
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    buf = x_pad[rows[:, None, None], disp.src_tok]           # (B, E, cap, d)
    buf = buf.transpose(0, 1).reshape(e, b * cap, d)
    h = silu(torch.bmm(buf, p.w1)) * torch.bmm(buf, p.w3)
    out = torch.bmm(h, p.w2)                                  # (E, B cap, d)
    out = out.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)
    out = torch.cat([out, out.new_zeros((b, 1, d))], dim=1)
    y_pairs = out[rows[:, None], disp.slot] \
        * routing.gate.reshape(b, t * k, 1).to(out.dtype)
    y = y_pairs.reshape(b, t, k, d).float().sum(dim=2).to(out.dtype)
    if hasattr(p, "shared"):
        sh = p.shared
        hs = silu(x @ sh.w1) * (x @ sh.w3)
        y = y + (hs @ sh.w2).to(y.dtype)
    return y.to(x.dtype)


def aux_losses(routing: Routing, disp: Dispatch) -> dict:
    """The reference's auxiliary metrics, averaged over rows (float32)."""
    e = routing.probs.shape[-1]
    n_pairs = disp.rank.shape[1]
    me = routing.probs.mean(dim=1)                            # (B, E)
    ce = disp.counts.float() / n_pairs
    return {
        "load_balance_loss": (e * (me * ce).sum(dim=-1)).mean(),
        "dropped_fraction": (1.0 - disp.keep.float().mean(dim=1)).mean(),
    }


def moe(p: MoE, x: torch.Tensor, *, top_k: int,
        capacity_factor: float = 1.25, norm_topk: bool = True,
        serving: bool = False) -> tuple[torch.Tensor, dict]:
    """The MoE layer over ``x`` (B, T, d): (y, aux), y in ``x``'s dtype.
    Under a mesh with DTensor activations, the reference's ``shard_map``
    branch (:func:`_moe_mesh`); ``serving`` skips its FSDP gathers."""
    ctx = active_ctx()
    if ctx is not None and is_dtensor(x):
        return _moe_mesh(ctx, p, x, top_k=top_k,
                         capacity_factor=capacity_factor,
                         norm_topk=norm_topk, serving=serving)
    t = x.shape[1]
    n_experts = p.w1.shape[0]
    routing = route(p, x, top_k=top_k, norm_topk=norm_topk)
    disp = dispatch(routing.expert_idx, n_experts,
                    capacity(t, n_experts, top_k, capacity_factor))
    return experts(p, x, routing, disp), aux_losses(routing, disp)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose ranks each hold a partial result (y over the
    tp shards of d_ff); the gradient of the replicated sum reaches every
    partial unchanged (the reference's psum under shard_map)."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _all_gather(x: torch.Tensor, dim: int, mesh, axes: tuple):
    """``x`` all-gathered along ``dim`` over the mesh dimensions ``axes``
    (major first), with the reduce-scatter of its gradient: the innermost
    axis gathers first, so the blocks land in the order a tuple entry
    ``(major, minor)`` lays them out."""
    from repro_torch.dist.compat import all_gather_autograd

    for a in reversed(axes):
        x = all_gather_autograd(x, dim, mesh.get_group(a))
    return x


def _group_mean(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """The mean of ``x`` over the mesh dimensions ``axes`` (gloo has no
    average: a sum, then a division)."""
    for a in axes:
        x = _AllReduceSum.apply(x, mesh.get_group(a)) / _axis_size(mesh, (a,))
    return x


def _moe_mesh(ctx, p: MoE, x, *, top_k: int, capacity_factor: float,
              norm_topk: bool, serving: bool) -> tuple:
    """The reference's ``shard_map`` branch (``repro/models/moe.py:185-248``)
    as a ``local_map`` over the layer's DTensors."""
    from repro_torch.dist.compat import local_map
    from repro_torch.dist.sharding import _spec_for, param_pspecs_of

    mesh, lmap = ctx
    b, t, d = x.shape
    e = p.w1.shape[0]
    dp_axes = tuple(lmap.get("dp", ()))
    tp_axes = tuple(lmap.get("tp", ()))
    dp = _axis_size(mesh, dp_axes)
    if b % dp != 0:
        dp_axes, dp = (), 1
    cap = capacity((b // dp) * t, e, top_k, capacity_factor)
    gather = bool(dp_axes) and not serving
    # the weights' layouts as local_fn takes them: un-dp-sharded when the
    # gathers are skipped (serving, or a batch dp does not divide)
    lmap_eff = {"dp": dp_axes if gather else (), "tp": tp_axes}
    leaves = p.leaves()
    names = ["router", "w1", "w3", "w2"] + (
        ["w1", "w3", "w2"] if hasattr(p, "shared") else [])
    w_pl = [placements(mesh, param_pspecs_of(mesh, lmap_eff, name,
                                             tuple(w.shape)))
            for name, w in zip(names, leaves)]
    x_pl = placements(mesh, _spec_for(mesh, {"dp": dp_axes}, (b, t, d),
                                      ("dp", None, None)))
    from torch.distributed.tensor import Replicate

    scalar_pl = tuple(Replicate() for _ in mesh.mesh_dim_names)

    def local_fn(x_l, router, w1, w3, w2, *shared):
        if gather:
            w1 = _all_gather(w1, 1, mesh, dp_axes)
            w3 = _all_gather(w3, 1, mesh, dp_axes)
            w2 = _all_gather(w2, 2, mesh, dp_axes)
        full = SimpleNamespace(router=SimpleNamespace(w=router), w1=w1,
                               w3=w3, w2=w2)
        if shared:
            s1, s3, s2 = shared
            if gather:
                s1 = _all_gather(s1, 0, mesh, dp_axes)
                s3 = _all_gather(s3, 0, mesh, dp_axes)
                s2 = _all_gather(s2, 1, mesh, dp_axes)
            full.shared = SimpleNamespace(w1=s1, w3=s3, w2=s2)
        flat = x_l.reshape(1, -1, x_l.shape[-1])
        routing = route(full, flat, top_k=top_k, norm_topk=norm_topk)
        disp = dispatch(routing.expert_idx, e, cap)
        y = experts(full, flat, routing, disp)
        aux = aux_losses(routing, disp)
        if tp_axes:
            # the expert outputs are partial over the d_ff shard
            for a in tp_axes:
                y = _AllReduceSum.apply(y, mesh.get_group(a))
            aux = {k: _group_mean(v, mesh, tp_axes) for k, v in aux.items()}
        if dp_axes:
            aux = {k: _group_mean(v, mesh, dp_axes) for k, v in aux.items()}
        return (y.reshape(x_l.shape), aux["load_balance_loss"],
                aux["dropped_fraction"])

    y, lb, dropped = local_map(
        local_fn, mesh=mesh, in_placements=(x_pl, *w_pl),
        out_placements=(x_pl, scalar_pl, scalar_pl))(x, *leaves)
    return y, {"load_balance_loss": lb, "dropped_fraction": dropped}
