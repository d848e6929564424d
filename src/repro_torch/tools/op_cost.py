"""FLOP/byte accounting of an eager step, op by op.

Counterpart of ``repro/tools/jaxpr_cost.py``.  The reference walks a
jaxpr, whose scans carry their trip counts; the port runs eagerly, so the
loops over layers, microbatches and KV chunks run in full and each op is
seen once per execution, while the recurrent cells' loops over T are
priced (below).  :class:`OpCost` is a ``TorchDispatchMode`` that sees each
aten op as it runs (on fake tensors in the dry run, on real ones anywhere
else) and adds, with the reference's conventions:

* ``2 * batch * m * n * k`` for each matrix product (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``mv``, ``dot``), in the ``"dot_general"``
  bucket of ``by_prim``; bytes its operands and result;
* for gather, index and scatter ops only the slices they touch: twice the
  result (or the update) plus the indices;
* for every other op 1 flop per output element (``"elementwise"``) and its
  operands' and results' bytes, except views and other metadata ops, which
  move nothing and are free here (the reference counts a jaxpr's reshape
  and transpose as elementwise);
* the flash-attention ops (``kernels/flash_attention.py``'s custom ops)
  4 hd flops for each (query row, key) pair the kernel visits, as it
  skips the masked tiles (causal, sliding window, past ``kv_valid_len``),
  in ``"flash_attention"``, and the backward 10 hd a visited pair (the
  five products it needs; it runs seven); beside it,
  ``"flash_attention_dense"`` counts what the reference's jnp formulation
  takes, every pair of the full key range (4 hd forward, 8 hd backward:
  the four einsums of the vjp), to set beside the reference's
  ``"dot_general"``;
* the recurrent cells' ops (``models/recurrence.py``: mamba's scan, the
  mLSTM and sLSTM cells) and their backward ops exactly what their plain
  loop counts here when it runs in full at the same shapes (forward; or
  autograd's backward of it, for the gradients the backward op is asked
  for), in the same buckets, without running it over T
  (:func:`recurrence_cost`): the reference's scan body times its length.

Under a mesh the count is one device's: the mode lets a DTensor op run
first (it answers ``NotImplemented``, as ``CommDebugMode`` does) and counts
the ops on local shards that DTensor runs for it, and a ``local_map``
region's ops are on local shards anyway.  So under the dry run's fake
process group the counts are rank 0's, per device; the reference's jaxpr
counts the global program and divides it by the chip count, which is the
same for work spread evenly.  Work a mesh replicates (a dim that does not
divide its axes, the sLSTM cell on tp) is counted on every device here,
and once in the reference's global program.
"""
from __future__ import annotations

import concurrent.futures
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot", "addmv", "addbmm"}
_GATHERS = {"index", "gather", "index_select", "embedding", "take",
            "_index_put_impl_"}
_SCATTERS = {"scatter", "scatter_add", "scatter_", "scatter_add_",
             "index_put", "index_put_", "index_add", "index_add_",
             "scatter_reduce", "index_copy", "index_copy_"}
_FREE = {"view", "_unsafe_view", "reshape", "transpose", "t", "permute",
         "expand", "slice", "select", "unsqueeze", "squeeze", "as_strided",
         "detach", "alias", "split", "split_with_sizes", "unbind", "chunk",
         "narrow", "view_as", "unflatten", "flatten", "_reshape_alias",
         "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_to_copy_noop", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size", "_local_scalar_dense",
         "diagonal", "movedim", "expand_as", "wait_tensor"}
_COLLECTIVE_NS = ("c10d_functional", "_c10d_functional",
                  "_c10d_functional_autograd")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(name: str, args) -> int:
    if name in ("mm", "addmm"):
        a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name in ("mv", "addmv"):
        a = args[0] if name == "mv" else args[1]
        return 2 * a.shape[0] * a.shape[1]
    if name == "addbmm":
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 2 * args[0].numel()                                  # dot


def visible_pairs(b: int, h: int, tq: int, tk: int, *, causal: bool,
                  q_offset: int, kv_valid_len: int | None,
                  sliding_window: int) -> int:
    """(batch, head, query row, key) quadruples the kernels visit: each
    row's keys from its window's start to its last visible key."""
    valid = tk if kv_valid_len is None else min(int(kv_valid_len), tk)
    total = 0
    for i in range(tq):
        pos = q_offset + i
        hi = min(valid, pos + 1) if causal else valid
        lo = max(0, pos - sliding_window + 1) if sliding_window else 0
        total += max(0, hi - lo)
    return b * h * total


class OpCost(TorchDispatchMode):
    """Counts flops and bytes of every op run under it (see the module
    docstring).  ``result()`` gives ``{"flops", "bytes", "by_prim"}``."""

    def __init__(self, collectives=None):
        super().__init__()
        # a tools.collectives.CollectiveCount to hand each collective to
        self.collectives = collectives
        # the recurrences' counts by shape (recurrence_cost)
        self.prices: dict = {}
        self._restore = None
        self.flops = 0.0
        self.bytes = 0.0
        self.by_prim: dict[str, float] = {}

    def _add(self, bucket: str, flops: float) -> None:
        self.by_prim[bucket] = self.by_prim.get(bucket, 0.0) + flops
        self.flops += flops

    def __enter__(self):
        self._restore = _hook_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        if self._restore is not None:
            self._restore()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if _has_dtensor(types):
            # let DTensor run it; its ops on local shards come back here
            return NotImplemented
        out = func(*args, **kwargs)
        self.count(func, args, kwargs, out)
        if self.collectives is not None:
            self.collectives.record(func, out)
        return out

    def count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        # prim:: ops (a fake tensor's ``device`` query) read metadata only
        if ns in _COLLECTIVE_NS or ns == "prim" or name in _FREE:
            return
        if _PROPAGATING[0]:
            return
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        mult = 1.0
        if ns == "repro_torch" and not name.startswith("flash"):
            priced = recurrence_cost(name, args, self.prices)
            for bucket, flops in priced["by_prim"].items():
                self._add(bucket, flops)
            self.bytes += priced["bytes"]
            return
        if ns == "repro_torch":
            self._flash(name, args, kwargs, mult)
            self.bytes += mult * sum(_nbytes(t) for t in ins + outs)
            return
        if name in _DOTS:
            self._add("dot_general", mult * _dot_flops(name, args))
            self.bytes += mult * sum(_nbytes(t) for t in ins + outs)
        elif name in _GATHERS:
            idx = sum(_nbytes(t) for t in ins[1:]
                      if not t.is_floating_point())
            self.bytes += mult * (2 * sum(_nbytes(t) for t in outs) + idx)
        elif name in _SCATTERS:
            upd = sum(_nbytes(t) for t in ins[1:])
            self.bytes += mult * 2 * upd
        else:
            self._add("elementwise",
                      mult * sum(t.numel() for t in outs))
            self.bytes += mult * sum(_nbytes(t) for t in ins + outs)

    def _flash(self, name: str, args, kwargs, mult: float) -> None:
        q, k = args[0], args[1]
        b, tq, h, hd = q.shape
        tk = k.shape[1]
        causal, q_offset, valid, window = args[3:7] if name.startswith(
            "flash_fwd") else args[5:9]
        pairs = visible_pairs(b, h, tq, tk, causal=bool(causal),
                              q_offset=int(q_offset),
                              kv_valid_len=int(valid),
                              sliding_window=int(window))
        dense = b * h * tq * tk
        if name.startswith("flash_fwd"):
            self._add("flash_attention", mult * 4 * hd * pairs)
            self.by_prim["flash_attention_dense"] = self.by_prim.get(
                "flash_attention_dense", 0.0) + mult * 4 * hd * dense
        else:
            self._add("flash_attention", mult * 10 * hd * pairs)
            self.by_prim["flash_attention_dense"] = self.by_prim.get(
                "flash_attention_dense", 0.0) + mult * 8 * hd * dense

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "by_prim": dict(self.by_prim)}


# set while DTensor plans an op (its sharding propagation runs the op once
# on fake global tensors to learn the output's shape, and sizes candidate
# layouts with small host tensors): that work is not the program's and is
# not counted
_PROPAGATING = [False]


@contextlib.contextmanager
def not_counted():
    """Ops run inside are not counted (DTensor's planning)."""
    was = _PROPAGATING[0]
    _PROPAGATING[0] = True
    try:
        yield
    finally:
        _PROPAGATING[0] = was


def _hook_propagation():
    """Wrap DTensor's sharding propagation in :func:`not_counted`; returns
    the undo."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:  # pragma: no cover - older torch
        return None
    name = "propagate_op_sharding_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:  # pragma: no cover - another torch
        return None

    def flagged(self, *args, **kwargs):
        with not_counted():
            return orig(self, *args, **kwargs)

    setattr(ShardingPropagator, name, flagged)
    return lambda: setattr(ShardingPropagator, name, orig)


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


def recurrence_cost(name: str, args, prices: dict) -> dict:
    """What :class:`OpCost` counts for the plain loop of the recurrence
    op ``name`` (``models/recurrence.py``; ``<cell>_bwd``: the backward of
    that loop for the output gradients given and the inputs flagged) at
    the shapes of ``args``: ``{"by_prim": {bucket: flops}, "bytes"}``.

    Each trip of a cell's loop runs the same ops, so every count c(n) is a
    polynomial in the trip count n, of degree 2 at most: autograd's
    backward of a step's slice of a (B, T, ...) input writes a whole
    (B, T, ...) gradient (``select_backward``, ``slice_backward``) and adds
    it to the others.  The first trip (from the zero state) and the last
    (whose state nothing reads) differ from the rest, so for n >= 2

        c(n) = c(2) + (n - 2) d1 + (n - 2)(n - 3) / 2 d2,
        d1 = c(3) - c(2),  d2 = c(4) - 2 c(3) + c(2):

    the plain loop is run on fake tensors at 2, 3 and 4 trips (everything
    else as in ``args``, a chunked loop's padding too) and once more at 5
    to check the degree, which raises if it fails; up to 5 trips it is run
    at n itself.  ``prices`` keeps the coefficients (or the count) for each
    shape, so a cell costs four short runs however long T is, once."""
    from repro_torch.models.recurrence import RECURRENCES

    backward = name.endswith("_bwd")
    rec = RECURRENCES[name[:-len("_bwd")] if backward else name]
    if backward:
        xs, ints, grads, needs = (list(a) for a in args)
    else:
        xs, ints = list(args[:-1]), list(args[-1])
        grads = needs = None
    t = rec.t_of(xs)
    n = rec.trips(t, ints)
    key = (name, tuple(ints), rec.length(t, ints, 0), backward and (
        tuple(g is not None for g in grads), tuple(needs)), tuple(
        None if x is None else (_less_t(rec, i, x.shape), x.dtype)
        for i, x in enumerate(xs)))
    if n <= 5:
        key += (t,)
        if key not in prices:
            prices[key] = _probe(rec, xs, ints, t, grads, needs)
        return prices[key]
    if key not in prices:
        c2, c3, c4, c5 = (_probe(rec, xs, ints, rec.length(t, ints, k),
                                 grads, needs) for k in (2, 3, 4, 5))
        prices[key] = _fit(c2, c3, c4, c5)
    c2, d1, d2 = prices[key]
    k = n - 2
    return _combine(lambda a, b, c: a + k * b + k * (k - 1) // 2 * c,
                    c2, d1, d2)


def _less_t(rec, i: int, shape) -> tuple:
    dim = rec.t_axes.get(i)
    return tuple(-1 if d == dim else s for d, s in enumerate(shape))


def _ints(c: dict) -> dict:
    return {"by_prim": {k: int(v) for k, v in c["by_prim"].items()},
            "bytes": int(c["bytes"])}


def _combine(fn, *cs) -> dict:
    keys = sorted(set().union(*(c["by_prim"] for c in cs)))
    return {"by_prim": {k: fn(*(c["by_prim"].get(k, 0) for c in cs))
                        for k in keys},
            "bytes": fn(*(c["bytes"] for c in cs))}


def _fit(c2, c3, c4, c5) -> tuple:
    c2, c3, c4, c5 = (_ints(c) for c in (c2, c3, c4, c5))
    d1 = _combine(lambda a, b: b - a, c2, c3)
    d2 = _combine(lambda a, b, c: c - 2 * b + a, c2, c3, c4)
    if _combine(lambda a, b, c: a + 3 * b + 3 * c, c2, d1, d2) != \
            _combine(lambda a: a, c5):
        raise RuntimeError("a recurrence's count is not quadratic in its "
                           "trips")
    return c2, d1, d2


def _probe(rec, xs, ints, t: int, grads, needs) -> dict:
    """:class:`OpCost`'s counts of ``rec``'s plain loop at T = ``t`` on
    fake tensors of ``xs``' shapes (T replaced) and dtypes: the forward,
    or with ``needs`` autograd's backward of it for the output gradients
    flagged in ``grads``.  Run in a thread of its own: the caller is
    inside a dispatch mode, below autograd, and the probe needs neither."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def shape(i, x):
        dim = rec.t_axes.get(i)
        return tuple(t if d == dim else s for d, s in enumerate(x.shape))

    def run():
        with FakeTensorMode():
            leaves = [None if x is None else torch.empty(
                shape(i, x), dtype=x.dtype).requires_grad_(
                    bool(needs and needs[i]))
                for i, x in enumerate(xs)]
            if needs is None:
                with OpCost() as cost:
                    rec.call(leaves, ints)
                return cost.result()
            outs = rec.call(leaves, ints)
            pairs = [(o, torch.empty_like(o)) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            wrt = [x for x, nd in zip(leaves, needs) if nd]
            with OpCost() as cost:
                if pairs and wrt:
                    torch.autograd.grad([o for o, _ in pairs], wrt,
                                        [g for _, g in pairs],
                                        allow_unused=True)
            return cost.result()

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return _ints(pool.submit(run).result())


def trace_cost(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under :class:`OpCost`; its counts."""
    with OpCost() as mode:
        fn(*args, **kwargs)
    return mode.result()
