"""Carry an index between the two packages as numpy fields.

The dict keys are the npz field names of ``repro/core/index.py``'s
``save`` (``words`` as uint32, ``dim``, ``adjacency``, ``medoid``,
``vectors``, ``rotation``, ``metric_kind`` and one ``param_<name>`` per
:class:`BuildParams` field), so ``QuIVerIndex.save``/``load`` are thin
wrappers over :func:`index_to_numpy` / :func:`index_from_numpy`, and an
archive written by either package loads in the other.

An IVF partition travels as the reference's ``ivf_*`` fields, a nav
policy as its ``policy_*`` fields and a probe report as its ``probe_*``
fields; ``metric_kind`` is any registered kind.  Fields of parts not
ported yet (labels, graph-health reports, streaming archives) are refused
with an error rather than dropped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bq
from repro_torch.core.index import QuIVerIndex
from repro_torch.core.metric import registered_kinds
from repro_torch.core.vamana import BuildParams
from repro_torch.device import resolve_device
from repro_torch.ivf import IVFPartition
from repro_torch.probe import CompatibilityReport, NavPolicy

_PARAM_PREFIX = "param_"
# npz field prefixes of state this part of the port cannot honour
_UNPORTED_PREFIXES = ("label_", "graph_")


def params_to_npz(params: BuildParams) -> dict:
    """BuildParams -> named npz fields (``param_<name>``)."""
    return {
        _PARAM_PREFIX + f.name: np.asarray(getattr(params, f.name))
        for f in dataclasses.fields(BuildParams)
    }


def params_from_npz(fields: dict) -> BuildParams:
    """Named ``param_<name>`` fields -> BuildParams (absent names keep
    their defaults)."""
    if _PARAM_PREFIX + "m" not in fields:
        raise ValueError("archive has no param_* fields (a pre-named-field "
                         "archive, which the port does not read)")
    kw = {}
    for f in dataclasses.fields(BuildParams):
        key = _PARAM_PREFIX + f.name
        if key in fields:
            kw[f.name] = type(f.default)(fields[key][()])
    return BuildParams(**kw)


def index_to_numpy(index: QuIVerIndex) -> dict:
    """The index as the reference's npz fields."""
    def host(t):
        return t.detach().cpu().numpy() if t is not None else np.zeros((0,))

    extra = {}
    if index.policy is not None:
        extra.update(index.policy.to_npz_fields())
    if index.report is not None:
        extra.update(index.report.to_npz_fields())
    if index.ivf is not None:
        extra.update(index.ivf.to_npz_fields())
    return {
        "words": host(index.sigs.words).view(np.uint32),
        "dim": np.asarray(index.sigs.dim),
        "adjacency": host(index.adjacency),
        "medoid": np.asarray(index.medoid),
        "vectors": host(index.vectors),
        "rotation": host(index.rotation),
        "metric_kind": np.array(index.metric_kind),
        **params_to_npz(index.params),
        **extra,
    }


def index_from_numpy(fields: dict, device=None) -> QuIVerIndex:
    """An index from the reference's npz fields, on ``device`` (default:
    the CUDA card)."""
    if "stream_format" in fields:
        raise NotImplementedError("streaming archives are not ported yet")
    unported = sorted(k for k in fields if k.startswith(_UNPORTED_PREFIXES))
    if unported:
        raise NotImplementedError(
            f"archive carries state this port cannot honour yet: {unported}"
        )
    metric_kind = str(fields.get("metric_kind", "bq2"))
    if metric_kind not in registered_kinds():
        raise ValueError(f"unknown metric_kind {metric_kind!r}; "
                         f"registered: {registered_kinds()}")
    device = resolve_device(device)

    def dev(a, dtype):
        return torch.tensor(a, dtype=dtype, device=device) if a.size \
            else None

    words = np.ascontiguousarray(fields["words"]).view(np.int32)
    return QuIVerIndex(
        sigs=bq.Signature(words=dev(words, torch.int32),
                          dim=int(fields["dim"])),
        adjacency=dev(fields["adjacency"], torch.int32),
        medoid=int(fields["medoid"]),
        params=params_from_npz(fields),
        vectors=dev(fields["vectors"], torch.float32),
        rotation=dev(fields["rotation"], torch.float32),
        metric_kind=metric_kind,
        policy=NavPolicy.from_npz(fields),
        report=CompatibilityReport.from_npz(fields),
        ivf=IVFPartition.from_npz(fields, device),
    )
