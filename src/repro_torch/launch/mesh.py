"""Mesh construction.

Counterpart of ``repro/launch/mesh.py``.  Functions, never module-level
constants, so importing this module starts no process group.

* :func:`make_production_mesh` builds the reference's single pod as (16,
  16) ``("data", "model")`` and its multi-pod (2, 16, 16) as (32, 16)
  ``("data", "model")``, the pod and data axes as one dp axis, pod-major,
  so dry-run cells shard every dim the same number of ways as the
  reference's.  No machine here has 256 cards: the dry run
  (``launch/dryrun.py``) builds it as rank 0 of a fake process group
  (:func:`init_fake_world`), whose collectives return at once without
  moving data.
* :func:`make_host_mesh` is the one card of this machine as a 1-D
  ``("data",)`` mesh of world size 1: NCCL on the card, gloo on the CPU when
  the caller asks for it (the tests, and the card's CPU-side parity runs:
  with a card visible the group holds both backends, so a CPU mesh and a
  card mesh can live side by side).  Its process group starts from a
  ``FileStore`` in a temporary directory, so it needs no network.
"""

from __future__ import annotations

import math
import os
import tempfile

import torch
import torch.distributed as dist


def _register_fake_backend() -> None:
    """The fake backend's creator, from torch's own ``FakeProcessGroup``
    (what ``torch.testing``'s fake_pg registers, without importing it)."""
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common_opts, backend_opts):
        return FakeProcessGroup._create_internal(
            common_opts.group_rank, common_opts.group_size, backend_opts)

    try:
        dist.Backend.register_backend(
            "fake", create, extended_api=True,
            devices=["cpu", "cuda"])
    except ValueError:  # already registered (by torch.testing, or before)
        pass


def init_fake_world(world_size: int, rank: int = 0) -> None:
    """Start a fake process group of ``world_size`` ranks with this process
    as ``rank``: collectives take no time and move no data, so one process
    can trace what one rank of a large mesh runs.  Destroys a group that is
    already up."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _register_fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The 16x16 single pod (256 ranks), or the 2x16x16 multi-pod (512
    ranks) laid out as (32, 16) ``("data", "model")``, on the process group
    already up (a fake one of that size for the dry run).

    The multi-pod mesh's dp axis is the reference's ``("pod", "data")``
    entry flattened pod-major (its device order), so every layout shards
    the same dims the same number of ways.  It is one axis because DTensor
    runs a collective over a tensor dim split over two mesh dims as two in
    sequence, and torch 2.11's DTensor has no sharding rule for a gather
    (the embedding's) from a dim split over two; on the one axis it runs
    one collective over the 32 ranks, as XLA runs one over the combined
    replica groups."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (32, 16) if multi_pod else (16, 16)
    if not dist.is_initialized() or dist.get_world_size() != math.prod(shape):
        raise RuntimeError(f"a {shape} mesh needs a process group of "
                           f"{math.prod(shape)} ranks (init_fake_world)")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=("data", "model"))


def make_host_mesh(device: str | torch.device | None = None):
    """This process's one device as a 1-D ``("data",)`` mesh of world size
    1: NCCL for a CUDA device (the default when a card is visible), gloo
    for ``device="cpu"``.  Starts the process group from a ``FileStore`` in
    a fresh temporary directory when none is up (gloo and NCCL in one group
    when a card is visible, gloo alone without)."""
    from torch.distributed.device_mesh import init_device_mesh

    if device is None:
        device = "cuda" if torch.cuda.is_available() else None
    if device is None:
        raise RuntimeError("no card is visible: ask for device='cpu'")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    if not dist.is_initialized():
        path = os.path.join(tempfile.mkdtemp(prefix="repro_mesh_"), "store")
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() \
            else "gloo"
        dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                rank=0, world_size=1)
    return init_device_mesh(dev.type, (1,), mesh_dim_names=("data",))


def close_mesh() -> None:
    """Destroy the process group a mesh was made on, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _sizes(mesh) -> dict:
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


def dp_size(mesh) -> int:
    s = _sizes(mesh)
    return int(s.get("data", 1) * s.get("pod", 1))


def tp_size(mesh) -> int:
    return int(_sizes(mesh).get("model", 1))
