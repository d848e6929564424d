"""The recurrent cells as custom ops: mamba's selective scan and the xLSTM
cells (``repro_torch::ssm_scan``, ``mlstm_chunkwise``, ``mlstm_sequential``
and ``slstm_scan``).

Each cell is a Python loop over time, or over chunks of it, in plain torch
(the reference's are jnp ``lax.scan`` bodies outside any Pallas kernel).
Registered as custom ops, as the flash kernels are
(``kernels/flash_attention.py``), each is one op to the layers around it:

* its real implementation is the plain loop, unchanged, on the device of
  its inputs (the model modules keep it callable by name, ``*_plain``);
* ``register_fake`` gives its outputs' shapes, so a step traced on fake
  tensors (the dry run) runs no loop;
* ``register_autograd`` gives it a backward op, ``<name>_bwd``, itself a
  custom op with a fake implementation.  On real tensors the backward op
  recomputes the plain loop under autograd and differentiates it, so the
  gradients are the plain loop's, bit for bit.  The forward keeps only its
  inputs (none of the loop's intermediates): a training step runs each
  cell's loop once more than the plain loop would (twice more under a
  block's remat), and holds no per-step activation between the forward
  and the backward.

``tools/op_cost.py`` prices an op and its backward without running the
loop over T (:class:`Recurrence` says where T is and how many trips it
makes), as the reference's ``jaxpr_cost`` multiplies a scan's body by its
length.

Under a mesh (``dist.sharding.use_mesh``) with DTensor inputs,
:func:`apply` runs the op over local shards in a ``local_map`` region
(``dist/compat.py``), as the attention core runs: each input laid out by
its logical dims, each output by its own; an input that a mesh dimension
replicates while another input is sharded over it (the cell computes a
different part on each rank) takes its gradient as a ``Partial`` sum over
that dimension.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

RECURRENCES: dict[str, "Recurrence"] = {}


@dataclasses.dataclass
class Recurrence:
    """One cell: ``call(xs, ints)`` runs its plain loop over the tensor
    inputs ``xs`` (``None`` for an absent optional one) and the integer
    arguments ``ints``, returning its outputs; ``shapes(xs, ints)`` gives
    their (shape, dtype) without running it.  Each input i in ``t_axes``
    has T on its dim ``t_axes[i]``; ``trips(t, ints)`` is the loop's trip
    count at T = t, and ``length(t, ints, n)`` the T at which it makes
    ``n`` trips with everything else (the padding of a chunked loop)
    unchanged."""

    name: str
    call: Callable
    shapes: Callable
    t_axes: dict
    trips: Callable
    length: Callable
    op: object = None

    def t_of(self, xs) -> int:
        """T of the inputs ``xs``."""
        i, dim = next(iter(self.t_axes.items()))
        return int(xs[i].shape[dim])


@contextlib.contextmanager
def autograd_inside_op():
    """Grad mode inside a custom op's implementation: the dispatcher runs
    one below autograd (``_AutoDispatchBelowAutograd`` excludes its
    dispatch keys), so the keys are let through again for the block."""
    keys = torch._C.DispatchKey
    with contextlib.ExitStack() as stack:
        for key in (keys.AutogradFunctionality, keys.AutogradOther,
                    keys.AutogradNestedTensor):
            stack.enter_context(torch._C._SetExcludeDispatchKeyGuard(key,
                                                                     False))
        stack.enter_context(torch.enable_grad())
        yield


def vjp(rec: Recurrence, xs: list, ints: list, grads: list,
        needs: list) -> list:
    """The gradients of ``rec``'s plain loop at ``xs`` for the output
    gradients ``grads`` (``None``: that output takes none), with respect to
    the inputs flagged in ``needs``; an unflagged input's entry is an empty
    tensor."""
    with autograd_inside_op():
        leaves = [None if x is None else x.detach().requires_grad_(bool(nd))
                  for x, nd in zip(xs, needs)]
        outs = rec.call(leaves, ints)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [x for x, nd in zip(leaves, needs) if nd]
        got = torch.autograd.grad([o for o, _ in pairs], wrt,
                                  [g for _, g in pairs], allow_unused=True) \
            if pairs and wrt else [None] * len(wrt)
    got = iter(got)
    out = []
    for x, nd in zip(xs, needs):
        if nd:
            g = next(got)
            out.append(torch.zeros_like(x) if g is None else g)
        else:
            out.append(_absent(xs))
    return out


def _absent(xs) -> torch.Tensor:
    x = next(x for x in xs if x is not None)
    return x.new_empty((0,))


def define(rec: Recurrence, schema_args: str) -> Recurrence:
    """Register ``rec`` as ``repro_torch::<name>`` (its tensor arguments
    ``schema_args``, then ``int[] ints``) with its fake implementation and
    its backward op ``repro_torch::<name>_bwd``."""
    name = rec.name

    def fwd(*args):
        return list(rec.call(list(args[:-1]), list(args[-1])))

    def fwd_fake(*args):
        xs = list(args[:-1])
        dev = next(x for x in xs if x is not None).device
        return [torch.empty(s, dtype=dt, device=dev)
                for s, dt in rec.shapes(xs, list(args[-1]))]

    op = torch.library.custom_op(
        f"repro_torch::{name}", fwd, mutates_args=(),
        schema=f"({schema_args}, int[] ints) -> Tensor[]")
    op.register_fake(fwd_fake)

    def bwd(xs, ints, grads, needs):
        return vjp(rec, list(xs), list(ints), list(grads), list(needs))

    def bwd_fake(xs, ints, grads, needs):
        return [torch.empty_like(x) if nd else _absent(xs)
                for x, nd in zip(xs, needs)]

    bwd_op = torch.library.custom_op(
        f"repro_torch::{name}_bwd", bwd, mutates_args=(),
        schema="(Tensor?[] xs, int[] ints, Tensor?[] grads, bool[] needs) "
               "-> Tensor[]")
    bwd_op.register_fake(bwd_fake)

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:-1])
        ctx.ints = list(inputs[-1])
        ctx.set_materialize_grads(False)

    def backward(ctx, grads):
        xs = list(ctx.saved_tensors)
        needs = [bool(nd) and x is not None
                 for nd, x in zip(ctx.needs_input_grad, xs)]
        # torch's tree rule: the integer list takes None, or [] when empty
        no_grad = None if ctx.ints else []
        if not any(needs):
            return (*[None] * len(xs), no_grad)
        got = bwd_op(xs, ctx.ints, list(grads), needs)
        return (*[g if nd else None for g, nd in zip(got, needs)], no_grad)

    op.register_autograd(backward, setup_context=setup_context)
    rec.op = op
    RECURRENCES[name] = rec
    return rec


def apply(rec: Recurrence, xs: list, ints: list, dims: list,
          out_dims: list) -> list:
    """``rec``'s op over ``xs``.  Under a mesh with a DTensor among
    ``xs``, over local shards: input i laid out by the logical names
    ``dims[i]`` (one 'dp'/'tp'/None a dim, dropped where a dim does not
    divide its axes) and output j by ``out_dims[j]``; a plain tensor input
    is taken as replicated.  Returns the outputs (DTensors under a
    mesh)."""
    from repro_torch.dist.sharding import active_ctx, is_dtensor

    ctx = active_ctx()
    if ctx is None or not any(is_dtensor(x) for x in xs):
        return rec.op(*xs, ints)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.dist.compat import local_map
    from repro_torch.dist.sharding import _spec_for, placements

    mesh, lmap = ctx
    xs = [x if x is None or is_dtensor(x) else DTensor.from_local(
        x, mesh, [Replicate()] * mesh.ndim, run_check=False) for x in xs]
    # the region takes the tensors present; the absent ones and the
    # integers are closed over (local_map flattens its arguments)
    present = [i for i, x in enumerate(xs) if x is not None]
    in_pl = [placements(mesh, _spec_for(mesh, lmap, tuple(xs[i].shape),
                                        dims[i])) for i in present]
    sharded = {d for pl in in_pl for d, p in enumerate(pl)
               if isinstance(p, Shard)}
    grad_pl = [tuple(Partial() if d in sharded and isinstance(p, Replicate)
                     else p for d, p in enumerate(pl)) for pl in in_pl]
    out_pl = [placements(mesh, _spec_for(mesh, lmap, tuple(s), d))
              for (s, _), d in zip(rec.shapes(xs, ints), out_dims)]

    def region(*local):
        full = [None] * len(xs)
        for i, x in zip(present, local):
            full[i] = x
        return rec.op(*full, ints)

    return list(local_map(region, mesh=mesh, in_placements=tuple(in_pl),
                          out_placements=tuple(out_pl),
                          in_grad_placements=tuple(grad_pl))(
        *(xs[i] for i in present)))
