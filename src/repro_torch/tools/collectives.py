"""Collective-byte accounting of an eager step.

Counterpart of ``repro/tools/hlo_collectives.py``.  The reference parses
the optimized HLO, where GSPMD has inserted the collectives, and corrects
for loop trip counts.  Here the collectives are ops that run: DTensor's
redistributions and the explicit ones (the MoE branch's all-gathers and
all-reduce) are ``c10d_functional`` ops on local shards, and every loop
runs in full, so :class:`CollectiveCount`, a ``TorchDispatchMode``, sums
each one's result bytes (the reference's per-device, one-shot convention)
and counts it, by kind:

    all-gather, all-reduce, reduce-scatter, all-to-all, permute

A DTensor op is let through first (``NotImplemented``, as
``CommDebugMode`` does), so the collectives it runs for a redistribution
come back to the mode.  Under the dry run's fake process group they move
nothing and take no time; their shapes are what one rank would move.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "permute")
_NS = ("c10d_functional", "_c10d_functional", "_c10d_functional_autograd")
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "permute",
    "broadcast_": "permute",
    "send": "permute",
    "recv": "permute",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


class CollectiveCount(TorchDispatchMode):
    """Result bytes and counts of the collectives run under it, by kind;
    ``result()`` has the reference's keys."""

    def __init__(self):
        super().__init__()
        self.bytes_by_kind = {k: 0.0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self.record(func, out)
        return out

    def record(self, func, out) -> None:
        """Add ``func``'s result if it is a collective (also called by
        ``tools.op_cost.OpCost``, which counts both in one mode: two
        dispatch modes that each defer to DTensor do not stack)."""
        if func.namespace in _NS:
            kind = _KIND.get(func._schema.name.split("::")[-1])
            if kind is not None:
                self.bytes_by_kind[kind] += sum(
                    t.numel() * t.element_size() for t in _tensors(out))
                self.counts[kind] += 1

    def result(self) -> dict[str, Any]:
        return {
            "bytes_by_kind": dict(self.bytes_by_kind),
            "counts_by_kind": dict(self.counts),
            "total_bytes": sum(self.bytes_by_kind.values()),
            "total_count": sum(self.counts.values()),
        }
