"""Batch and serving-cache layouts (the reference's DESIGN.md §6).

Counterpart of ``repro/dist/cache_sharding.py``.  Activations and KV caches
are data-parallel over their batch dim; KV caches additionally TP-shard
axis 2 (the heads of the canonical (B, S, H, hd) layout).  The rules go by
axis index, as the reference's do, so on a stacked cache leaf (G, B, S, H,
hd) axis 2 is the sequence: the reference lays its stacked caches out that
way, and so does the port.  A recurrent layer's state is a NamedTuple with
a ``LAYOUT`` (``models/mamba.py``'s ``MambaState``, ``models/xlstm.py``'s
``MLSTMState`` and ``SLSTMState``): its fields take those logical dims,
the placements the cells' ``local_map`` regions read and write, where the
reference's axis rule would split the mLSTM's ``C`` on its key dim and
leave mamba's state whole on tp.  Every rule is divisibility-guarded: a
dim that does not divide its axis group stays replicated.

A cache tree is any nesting of tuples, lists and NamedTuples whose leaves
are tensors or shapes; the result has the same structure with a spec (see
``dist/sharding.py``) at each leaf.
"""

from __future__ import annotations

from repro_torch.dist.sharding import _axis_size, _entry, _spec_for, \
    logical_map


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") or (
        isinstance(x, tuple) and not hasattr(x, "_fields")
        and all(isinstance(d, int) for d in x))


def tree_map(fn, tree):
    """``fn`` over the leaves of a cache or batch tree, keeping its
    structure (dicts, lists, tuples, NamedTuples)."""
    if _is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"not a cache tree: {type(tree)}")


def _batch_spec(mesh, lmap: dict, shape: tuple) -> tuple:
    dp = lmap["dp"]
    if shape and dp and shape[0] % _axis_size(mesh, dp) == 0:
        return (_entry(dp), *([None] * (len(shape) - 1)))
    return (None,) * len(shape)


def batch_shardings(mesh, specs):
    """Input-batch layout: axis 0 over dp, everything else replicated."""
    lmap = logical_map(mesh)
    return tree_map(lambda s: _batch_spec(mesh, lmap, _shape(s)), specs)


def _cache_spec(mesh, lmap: dict, shape: tuple, global_batch: int) -> tuple:
    dp, tp = lmap["dp"], lmap["tp"]
    entries = [None] * len(shape)
    if (shape and shape[0] == global_batch and dp
            and shape[0] % _axis_size(mesh, dp) == 0):
        entries[0] = _entry(dp)
    # canonical KV layout (B, S, H, hd): heads on tp
    if len(shape) >= 4 and tp and shape[2] % _axis_size(mesh, tp) == 0:
        entries[2] = _entry(tp)
    return tuple(entries)


def cache_shardings(mesh, c_shapes, global_batch: int):
    """Serving-cache layout: batch over dp, axis 2 over tp; a state with a
    ``LAYOUT`` by its logical dims."""
    lmap = logical_map(mesh)

    def walk(tree):
        layout = getattr(type(tree), "LAYOUT", None)
        if layout is not None:
            return type(tree)(*(_spec_for(mesh, lmap, _shape(leaf), dims)
                                for leaf, dims in zip(tree, layout)))
        if _is_leaf(tree):
            return _cache_spec(mesh, lmap, _shape(tree), global_batch)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*(walk(v) for v in tree))
        return type(tree)(walk(v) for v in tree)

    return walk(c_shapes)
