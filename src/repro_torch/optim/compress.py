"""2-bit Sign-Magnitude gradient compression with error feedback.

Counterpart of ``repro/optim/compress.py``: QuIVer's training-free 2-bit
encoder (§3.1) applied to gradients.  Per tensor, the threshold
tau = mean|g|, a sign plane and a magnitude plane packed into int32 words
(the port's ``core/bq.py::pack_bits``, int32 views of the reference's
uint32 words), and two reconstruction levels: the conditional means of
the weak and the strong bucket.  Error feedback carries the quantization
error to the next step.  16x fewer wire bytes than float32.

Plain torch, as the reference computes it outside any Pallas kernel (the
``binarize`` kernel's one-warp-a-row layout does not fit one flat tensor
of 2.8e8 elements).  On the CPU the sums that set tau and the two levels
are taken in XLA's order (``ivf/partition.py::xla_row_sum``), tau as the
sum times the float32 reciprocal of the size, as the reference's
``jnp.mean`` compiles: a tau one ulp off flips the strong bit of every
|g| that ties it (ROADMAP queue 3).  On the card they are torch's sums.

A "tensor" here is one leaf of the reference's pytree.  Its stacked layer
leaves (``layers/0/attn/wq/w``: every layer's ``wq``) are one tensor with
one tau, so the port's per-layer parameters are quantized in **groups**:
the names of one reference leaf, flattened layer after layer as the
stacked leaf flattens (``models/transformer.py::param_groups``).

The compressed all-reduce comes in two forms.  :func:`compressed_psum_local`
is the reference's collective over a mesh dimension: each rank quantizes
its own tensor, all-gathers the words and the two scalars with the
functional collectives (``dist/compat.py``), then decodes all of them and
sums, as ``repro/optim/compress.py::compressed_psum(x, axis_name)`` does
inside ``shard_map``; :func:`compressed_psum_mesh` runs it in a
``local_map`` region over a DTensor.  Every rank receives each member's
numel / 4 + 8 bytes (2 bits an element, two float32 scalars),
:func:`compression_ratio`'s count.  :func:`compressed_psum` is the same for
one controller, its plain version: the S members' tensors each lie on their own device; each
is quantized there, its words and two scalars are copied to every member's
device, and each member decodes all S and sums them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bq
from repro_torch.ivf.partition import xla_row_sum


def _sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a flat float32 tensor: XLA's order on the CPU."""
    if x.device.type == "cpu":
        return xla_row_sum(x[None, :])[0]
    return x.sum()


def sm2_quantize(x: torch.Tensor):
    """Flat float32 -> (packed words (2W,) int32, c_weak, c_strong)."""
    flat = x.reshape(-1).float()
    absx = flat.abs()
    tau = _sum(absx) * float(np.float32(1) / np.float32(flat.numel()))
    pos = flat > 0
    strong = absx > tau
    words = torch.cat([bq.pack_bits(pos), bq.pack_bits(strong)], dim=-1)
    # Lloyd-Max level update: the conditional mean |x| of each bucket
    n_strong = strong.sum().clamp_min(1).to(torch.float32)
    n_weak = (~strong).sum().clamp_min(1).to(torch.float32)
    c_strong = _sum(torch.where(strong, absx, 0.0)) / n_strong
    c_weak = _sum(torch.where(strong, 0.0, absx)) / n_weak
    return words, c_weak, c_strong


def sm2_dequantize(words, c_weak, c_strong, size: int, shape) -> torch.Tensor:
    w = words.shape[-1] // 2
    pos = bq.unpack_bits(words[..., :w], size)
    strong = bq.unpack_bits(words[..., w:], size)
    mag = torch.where(strong, c_strong, c_weak)
    return torch.where(pos, mag, -mag).reshape(shape)


def _groups(tree: dict, groups) -> list:
    return [[n] for n in tree] if groups is None else groups


@torch.no_grad()
def compress_decompress_tree(grads: dict, ef: dict, groups=None
                             ) -> tuple[dict, dict]:
    """Quantize and dequantize each tensor with error feedback: the
    numerical effect of the compressed all-reduce (the collective itself
    is :func:`compressed_psum`).  ``groups`` lists the names of each
    tensor (default: each name alone).  Works group by group and in
    place: each entry of ``grads`` is replaced by its decoded tensor (in
    its own dtype) and each of ``ef`` overwritten with the new error, so
    no second copy of the whole gradient is held.  Returns (grads, ef)."""
    for names in _groups(grads, groups):
        g32 = torch.cat([grads[n].float().reshape(-1) + ef[n].float()
                         .reshape(-1) for n in names])
        words, cw, cs = sm2_quantize(g32)
        dec = sm2_dequantize(words, cw, cs, g32.numel(), g32.shape)
        err = g32 - dec
        at = 0
        for n in names:
            size = grads[n].numel()
            shape, dtype = grads[n].shape, grads[n].dtype
            ef[n].copy_(err[at:at + size].reshape(shape))
            grads[n] = dec[at:at + size].reshape(shape).to(dtype)
            at += size
    return grads, ef


def init_error_feedback(params: dict, dtype=torch.float32) -> dict:
    return {n: torch.zeros(p.shape, dtype=dtype, device=p.device)
            for n, p in params.items()}


def compressed_psum(xs: list) -> list:
    """2-bit compressed all-reduce over S members, one controller: member
    s quantizes ``xs[s]`` on its device; the words and two scalars of
    every member are copied to each member's device, decoded and summed
    there.  Returns the S sums, each on its member's device."""
    shape, size = xs[0].shape, xs[0].numel()
    parts = [sm2_quantize(x) for x in xs]
    out = []
    for x in xs:
        decoded = [sm2_dequantize(w.to(x.device), a.to(x.device),
                                  b.to(x.device), size, shape)
                   for w, a, b in parts]
        out.append(torch.stack(decoded).sum(dim=0))
    return out


def compressed_psum_local(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The reference's ``compressed_psum(x, axis_name)``, over local
    tensors (in a ``local_map`` region): this rank quantizes ``x``,
    all-gathers every member's words and two scalars over the mesh
    dimension ``axis``, decodes each and sums them.  Returns the sum,
    the same on every member."""
    from repro_torch.dist.compat import all_gather_autograd

    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    words, cw, cs = sm2_quantize(x)
    aw = all_gather_autograd(words, 0, group).view(n, -1)
    acw = all_gather_autograd(cw[None], 0, group)
    acs = all_gather_autograd(cs[None], 0, group)
    decoded = [sm2_dequantize(aw[i], acw[i], acs[i], x.numel(), x.shape)
               for i in range(n)]
    return torch.stack(decoded).sum(dim=0)


def compressed_psum_mesh(x, mesh, axis: str = "data"):
    """:func:`compressed_psum_local` over a DTensor ``x`` whose value is the sum
    of its members' local tensors over ``axis`` (``Partial`` there, its
    other placements kept): the result is ``Replicate`` over ``axis``."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.dist.compat import local_map

    dim = mesh.mesh_dim_names.index(axis)
    in_pl = tuple(Partial() if i == dim else p
                  for i, p in enumerate(x.placements))
    out_pl = tuple(Replicate() if i == dim else p
                   for i, p in enumerate(x.placements))
    return local_map(lambda xl: compressed_psum_local(xl, mesh, axis),
                     mesh=mesh, in_placements=(in_pl,),
                     out_placements=(out_pl,))(x)


def compression_ratio(params: dict, groups=None) -> float:
    """Wire-byte ratio float32 : compressed for one gradient exchange; a
    group of names counts as one tensor (two scalars)."""
    total = sum(p.numel() for p in params.values())
    n_leaves = len(_groups(params, groups))
    fp32 = 4 * total
    comp = total / 4 + 8 * n_leaves      # 2 bits/elem + 2 fp32 scalars
    return fp32 / comp
