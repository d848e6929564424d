"""Logical-axis sharding: 'dp'/'tp' names over whatever mesh is active.

Counterpart of ``repro/dist/sharding.py`` on torch's ``DeviceMesh`` and
``DTensor``.  The model code never names a physical mesh axis.  It says
``shard(x, "dp", None, "tp")`` and this module maps the logical names to
the active mesh's dimensions:

    dp (data/FSDP) -> ("pod", "data")   (whichever exist on the mesh)
    tp (tensor)    -> ("model",)

A layout is a *spec*: one entry a tensor dim, each ``None``, a mesh
dimension's name, or a tuple of names (major first), as a JAX
``PartitionSpec``'s entries are; :func:`placements` turns it into the
``Shard``/``Replicate`` placements of a ``DeviceMesh``.  Outside a
:func:`use_mesh` context :func:`shard` is a no-op, which is what the
single-device runs rely on.  Inside one a DTensor is redistributed to the
spec, and a plain tensor is left as it is (it lives whole on every rank);
:func:`use_mesh` also turns on DTensor's implicit replication, so the plain
tensors a forward makes (positions, masks) mix with DTensors as replicated
ones.

Param layouts (the reference's DESIGN.md §6):
  * training: FSDP on the dp axes over the weight's first big dim + TP on
    its last dim ('w2'-named leaves transpose this);
  * serving: TP-only when the bf16 params fit per chip (12e9 bytes).

Leaves are the reference's pytree leaves (``models/transformer.py::
reference_leaves``), so a port leaf and a reference leaf share a path and
a spec: a stacked leaf (the decoder's pattern groups, whisper's encoder and
decoder layers) is specced at its stacked shape (G, ...).  The port keeps
each block's tensor apart, so a block's placements drop the stack entry;
where the stack axis itself divides dp (a rank-1 leaf stacked to (G, d),
e.g. nemotron's 96 norm scales), each block's slice is replicated over dp
rather than held by 1/dp of the ranks.  Every rule checks divisibility; a
dim that does not divide its axes stays replicated.
"""

from __future__ import annotations

import contextlib
import math

import torch

# stack of (mesh, logical_map) — innermost context wins
_ACTIVE: list = []

_DP_AXES = ("pod", "data")
_TP_AXES = ("model",)


class AbstractMesh:
    """A mesh's shape and axis names with no devices behind it (the
    counterpart of ``jax.sharding.AbstractMesh``): enough for every spec
    function here, not for :func:`placements`."""

    def __init__(self, shape: tuple, names: tuple):
        if len(shape) != len(names):
            raise ValueError(f"shape {shape} and names {names} differ in "
                             "length")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(names)

    def size(self, dim: int | None = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or :class:`AbstractMesh`."""
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


def logical_map(mesh) -> dict:
    """{'dp': physical axes, 'tp': physical axes} present on ``mesh``."""
    names = set(mesh.mesh_dim_names)
    return {
        "dp": tuple(a for a in _DP_AXES if a in names),
        "tp": tuple(a for a in _TP_AXES if a in names),
    }


@contextlib.contextmanager
def use_mesh(mesh, lmap: dict | None = None):
    """Activate ``mesh`` for :func:`shard` / :func:`active_ctx`, with
    DTensor's implicit replication of plain tensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    _ACTIVE.append((mesh, lmap or logical_map(mesh)))
    try:
        with implicit_replication():
            yield mesh
    finally:
        _ACTIVE.pop()


def active_ctx():
    """(mesh, logical_map) of the innermost ``use_mesh``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _axis_size(mesh, axes: tuple) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes) if axes else 1


def _entry(axes: tuple):
    """A spec entry for a physical-axes tuple."""
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _spec_for(mesh, lmap: dict, shape: tuple, dims: tuple) -> tuple:
    """Map per-dim logical names ('dp'/'tp'/None) to a spec, dropping any
    assignment that does not divide the dim."""
    entries = []
    for size, name in zip(shape, dims):
        axes = tuple(lmap.get(name, ())) if name else ()
        if axes and size % _axis_size(mesh, axes) == 0:
            entries.append(_entry(axes))
        else:
            entries.append(None)
    return tuple(entries)


def placements(mesh, spec: tuple) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh
    dimension, ``Shard(d)`` where tensor dim d's entry names it, else
    ``Replicate()``.  A dim over several mesh dimensions is split over them
    major first (DTensor shards in mesh-dimension order), as a
    ``PartitionSpec`` with a tuple entry is."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dim = None
        for d, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            if name in names:
                dim = d
        out.append(Shard(dim) if dim is not None else Replicate())
    return tuple(out)


def is_dtensor(x) -> bool:
    """``x`` is a DTensor (laid out on a mesh), not a whole tensor."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x, *dims):
    """Redistribute ``x`` by logical dim names; a no-op outside a
    ``use_mesh`` context.  ``dims`` has one 'dp'/'tp'/None per tensor dim
    (a rank mismatch raises); a tensor that is not a DTensor is left as it
    is."""
    ctx = active_ctx()
    if ctx is None:
        return x
    mesh, lmap = ctx
    if len(dims) != x.ndim:
        raise ValueError(f"shard: {len(dims)} dims for rank-{x.ndim} tensor")
    if not is_dtensor(x):
        return x
    want = placements(mesh, _spec_for(mesh, lmap, tuple(x.shape), dims))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def split_heads(y, b: int, t: int, n: int, hd: int):
    """A projection (B, T, n hd) split into (B, T, n, hd).  Under a mesh a
    DTensor whose heads do not divide tp cannot be split with its last dim
    on tp (DTensor cannot unflatten an uneven shard), so that dim is
    replicated first, as the reference's ``shard`` of the split leaves it."""
    ctx = active_ctx()
    if ctx is not None and is_dtensor(y):
        mesh, lmap = ctx
        if n % _axis_size(mesh, lmap["tp"]):
            y = shard(y, "dp", None, None)
    return y.reshape(b, t, n, hd)


# ---------------------------------------------------------------------------
# parameter layouts
# ---------------------------------------------------------------------------


def _leaf_name(path: tuple) -> str:
    """Last string key on a leaf path ('w1', 'w', ...)."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _param_dims(name: str, ndim: int) -> tuple:
    """Logical dim assignment for one weight leaf: rank < 2 and 'router'
    replicate; 'w2' (tp, dp) over its last two dims; else (dp, tp)."""
    if ndim < 2 or name == "router":
        return (None,) * ndim
    lead = (None,) * (ndim - 2)
    if name == "w2":
        return lead + ("tp", "dp")
    return lead + ("dp", "tp")


def leaves(model) -> dict:
    """{reference leaf path: (its shape, the parameter names that form
    it)}: a stacked leaf's shape is (number of its blocks, *block shape)."""
    from repro_torch.models.transformer import STACKED, reference_leaves

    params = dict(model.named_parameters())
    out = {}
    for path, names in reference_leaves(model).items():
        shape = tuple(params[names[0]].shape)
        if path[0] in STACKED:
            shape = (len(names), *shape)
        out[path] = (shape, names)
    return out


def param_pspecs_of(mesh, lmap: dict, name: str, shape: tuple) -> tuple:
    """The spec of one tensor of ``shape`` whose leaf is named ``name``
    (its last path key) under ``lmap``."""
    return _spec_for(mesh, lmap, shape, _param_dims(name, len(shape)))


def param_pspecs(mesh, model, lmap: dict) -> dict:
    """{reference leaf path: spec} for ``model``'s parameters under an
    explicit logical map (the MoE branch passes a reduced one when it skips
    the FSDP gathers): the reference's ``param_pspecs`` leaf by leaf."""
    return {path: _spec_for(mesh, lmap, shape,
                            _param_dims(_leaf_name(path), len(shape)))
            for path, (shape, _) in leaves(model).items()}


def block_specs(mesh, model, lmap: dict) -> dict:
    """{parameter name: spec of that tensor}: each leaf's spec, less its
    stack entry for a stacked leaf."""
    from repro_torch.models.transformer import STACKED

    out = {}
    lv = leaves(model)
    for path, spec in param_pspecs(mesh, model, lmap).items():
        per = spec[1:] if path[0] in STACKED else spec
        for name in lv[path][1]:
            out[name] = per
    return out


def param_shardings(mesh, model) -> dict:
    """Training layout: {parameter name: spec}, FSDP(dp) x TP."""
    return block_specs(mesh, model, logical_map(mesh))


def serve_lmap(mesh, param_count: float, *,
               hbm_budget_bytes: float = 12e9) -> dict:
    """The logical map of the serving layout: TP only (dp dropped) when the
    bf16 params fit ``hbm_budget_bytes`` a chip over tp, else the training
    map."""
    lmap = logical_map(mesh)
    tp_bytes = 2.0 * param_count / max(_axis_size(mesh, lmap["tp"]), 1)
    if tp_bytes > hbm_budget_bytes:
        return lmap
    return {"dp": (), "tp": lmap["tp"]}


def serve_param_shardings(mesh, model, param_count: float, *,
                          hbm_budget_bytes: float = 12e9) -> dict:
    """Serving layout: {parameter name: spec}, TP-only when the bf16 params
    fit per chip, else the training layout."""
    return block_specs(mesh, model, serve_lmap(
        mesh, param_count, hbm_budget_bytes=hbm_budget_bytes))


def local_bytes(mesh, shape: tuple, itemsize: int, spec: tuple) -> int:
    """Bytes one device holds of a tensor of ``shape`` laid out by
    ``spec`` (every sharded dim divides its axes)."""
    sizes = axis_sizes(mesh)
    n = itemsize
    for size, entry in zip(shape, spec):
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= size // math.prod(sizes[a] for a in names)
    return n


@torch.no_grad()
def distribute_params(model, mesh, specs: dict) -> None:
    """Replace each parameter of ``model`` by a DTensor laid out by
    ``specs`` ({parameter name: spec}) on ``mesh``.  Every rank is taken to
    hold the whole tensor already (a seeded draw, a checkpoint, or a fake
    tensor), so no rank sends: each keeps its own shard."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    for name, p in list(model.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        d = distribute_tensor(p.detach(), mesh, placements(mesh,
                                                           specs[name]),
                              src_data_rank=None)
        setattr(mod, attr, nn.Parameter(d, requires_grad=p.requires_grad))
