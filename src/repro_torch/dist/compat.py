"""torch version compatibility for the SPMD substrate.

Counterpart of ``repro/dist/compat.py`` (the ``shard_map`` shim).  torch's
``shard_map`` is ``local_map``: a function over local shards, called on
DTensors laid out by ``in_placements`` and returning DTensors of
``out_placements``.  It sits at
``torch.distributed.tensor.experimental.local_map`` in the torch releases
this repository runs (2.11 on the card, 2.13 on the CPU) and at
``torch.distributed._tensor.experimental`` before them; this wrapper finds
whichever the installed torch has, and always redistributes inputs to the
placements asked for.  :func:`all_gather_autograd` likewise takes the
functional all-gather by whichever name the installed torch gives it.
"""

from __future__ import annotations


def _local_map():
    try:
        from torch.distributed.tensor.experimental import local_map
    except ImportError:  # pragma: no cover - older torch
        from torch.distributed._tensor.experimental import local_map
    return local_map


def all_gather_autograd(x, dim: int, group):
    """The functional all-gather along ``dim`` whose gradient is the
    reduce-scatter: ``all_gather_single_autograd`` in torch 2.13, named
    ``all_gather_tensor_autograd`` before it."""
    from torch.distributed import _functional_collectives as funcol

    fn = getattr(funcol, "all_gather_single_autograd", None) or \
        funcol.all_gather_tensor_autograd
    return funcol.wait_tensor(fn(x, dim, group))


def local_map(fn, *, mesh, in_placements, out_placements,
              in_grad_placements=None):
    """``fn`` over local shards: each DTensor argument redistributed to its
    entry of ``in_placements`` (``None`` for a non-tensor argument), the
    results wrapped as DTensors of ``out_placements``."""
    return _local_map()(
        fn, out_placements=out_placements, in_placements=in_placements,
        in_grad_placements=in_grad_placements, device_mesh=mesh,
        redistribute_inputs=True)
