"""Checkpoints in the reference's on-disk format, with async writes.

Counterpart of ``repro/ckpt/checkpoint.py``, and the same format, so a
checkpoint written by either package restores in the other: one
``shard0.npz`` holding every leaf under its tree path with ``/`` written
as ``__`` (``params__layers__0__attn__wq__w``), and a ``manifest.json``
(leaf paths, shapes, dtypes, step) replaced atomically last, so a
checkpoint is complete exactly when its manifest exists.  bfloat16 leaves
are stored as uint16 and tagged ``"bfloat16"`` in the manifest (numpy's
``savez`` has no bfloat16; the port reads and writes it without
``ml_dtypes``, through 16-bit views).

A tree is nested dicts and lists (a list index is a path component, as in
JAX's tree paths) whose leaves are numpy arrays or tensors on any device;
the trainer saves ``{"params": ..., "opt": ...}`` in the reference's
layout (``convert.lm_params_to_numpy(keep_bf16=True)`` and
``convert.opt_state_to_numpy``).  Async save: the device-to-host copy
happens at the step boundary, synchronously; the file writes run on a
background thread.  A DTensor leaf is gathered whole before it is
written, so the file holds every leaf whole and restores onto any mesh,
whatever mesh wrote it: the elastic restore of the reference's
``restore(..., shardings=)`` is the trainer's, which restores whole
tensors and distributes them onto its mesh
(``train.trainer.distribute_train_state``).
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
from typing import Any

import numpy as np
import torch

BF16 = "bfloat16"


def _walk(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs of nested dicts (sorted keys, as JAX flattens
    them) and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(storable array, manifest dtype) of a leaf; bfloat16 as uint16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
        if a.dtype.name == BF16:                       # ml_dtypes
            return a.view(np.uint16), BF16
    return a, str(a.dtype)


def save(path: str, tree: Any, *, step: int = 0,
         async_write: bool = False) -> threading.Thread | None:
    """Write a checkpoint.  Returns the writer thread if async."""
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    # the device-to-host copy happens here, synchronously
    flat = {k: _to_host(v) for k, v in _walk(tree)}
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                   for k, (a, dt) in flat.items()},
    }

    def write():
        np.savez(p / "shard0.npz",
                 **{k.replace("/", "__"): a for k, (a, _) in flat.items()})
        tmp = p / "manifest.json.tmp"
        tmp.write_text(json.dumps(manifest))
        os.replace(tmp, p / "manifest.json")   # atomic commit

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(root: str) -> int | None:
    """Scan a checkpoint root for the newest complete checkpoint."""
    r = pathlib.Path(root)
    if not r.exists():
        return None
    steps = []
    for d in r.iterdir():
        if (d / "manifest.json").exists():
            try:
                steps.append(json.loads((d / "manifest.json").read_text())
                             ["step"])
            except Exception:
                continue
    return max(steps) if steps else None


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _rebuild(like: Any, prefix: tuple, leaf) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, prefix + (str(k),), leaf)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, prefix + (str(i),), leaf)
                          for i, v in enumerate(like))
    return leaf("/".join(prefix), like)


def restore(path: str, like: Any) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (leaves of any kind with a
    ``shape``: arrays, tensors, meta tensors) as CPU tensors in the stored
    dtypes.  Returns (tree, step)."""
    p = pathlib.Path(path)
    manifest = json.loads((p / "manifest.json").read_text())
    data = np.load(p / "shard0.npz")

    def leaf(key, want):
        arr = _tensor(data[key.replace("/", "__")],
                      manifest["leaves"][key]["dtype"])
        expect = tuple(want.shape)
        assert tuple(arr.shape) == expect, (key, tuple(arr.shape), expect)
        return arr

    return _rebuild(like, (), leaf), manifest["step"]
