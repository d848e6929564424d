"""Carry an index, or an LM's parameters, between the two packages as
numpy arrays.

The dict keys are the npz field names of ``repro/core/index.py``'s
``save`` (``words`` as uint32, ``dim``, ``adjacency``, ``medoid``,
``vectors``, ``rotation``, ``metric_kind`` and one ``param_<name>`` per
:class:`BuildParams` field), so ``QuIVerIndex.save``/``load`` are thin
wrappers over :func:`index_to_numpy` / :func:`index_from_numpy`, and an
archive written by either package loads in the other.

An IVF partition travels as the reference's ``ivf_*`` fields, a nav
policy as its ``policy_*`` fields, a probe report as its ``probe_*``
fields, a label store as its ``label_*`` fields (words as uint32) and a
graph X-ray as its ``graph_*`` fields; ``metric_kind`` is any registered
kind.  A streaming index travels as the reference's ``stream_format``
archive (:func:`mutable_to_numpy` / :func:`mutable_from_numpy`), which
:func:`index_from_numpy` refuses as the reference's ``QuIVerIndex.load``
does.
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
from repro_torch.filter import LabelStore
from repro_torch.ivf import IVFPartition
from repro_torch.models.transformer import DecoderLM
from repro_torch.obs.graph import GraphHealthReport
from repro_torch.probe import CompatibilityReport, NavPolicy, ProbeAccumulator
from repro_torch.stream.mutable import MutableQuIVerIndex

_PARAM_PREFIX = "param_"


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


def _host(t) -> np.ndarray:
    """A tensor on the host; None as the reference's empty field."""
    return t.detach().cpu().numpy() if t is not None else np.zeros((0,))


def _shared_fields(index) -> dict:
    """Label, policy, probe-report and graph-health fields of either kind
    of index."""
    extra = {}
    if index.labels is not None:
        extra.update(index.labels.to_npz_fields())
    if index.policy is not None:
        extra.update(index.policy.to_npz_fields())
    if index.report is not None:
        extra.update(index.report.to_npz_fields())
    if index.graph_health is not None:
        extra.update(index.graph_health.to_npz_fields())
    return extra


def _metric_kind(fields: dict) -> str:
    metric_kind = str(fields.get("metric_kind", "bq2"))
    if metric_kind not in registered_kinds():
        raise ValueError(f"unknown metric_kind {metric_kind!r}; "
                         f"registered: {registered_kinds()}")
    return metric_kind


def _tensor_or_none(a: np.ndarray, dtype, device) -> torch.Tensor | None:
    return torch.tensor(a, dtype=dtype, device=device) if a.size else None


def _words(fields: dict, device) -> torch.Tensor:
    """The uint32 signature words as int32 views on ``device``."""
    words = np.ascontiguousarray(fields["words"]).view(np.int32)
    return torch.tensor(words, dtype=torch.int32, device=device)


def index_to_numpy(index: QuIVerIndex) -> dict:
    """The index as the reference's npz fields."""
    extra = _shared_fields(index)
    if index.ivf is not None:
        extra.update(index.ivf.to_npz_fields())
    return {
        "words": _host(index.sigs.words).view(np.uint32),
        "dim": np.asarray(index.sigs.dim),
        "adjacency": _host(index.adjacency),
        "medoid": np.asarray(index.medoid),
        "vectors": _host(index.vectors),
        "rotation": _host(index.rotation),
        "metric_kind": np.array(index.metric_kind),
        **params_to_npz(index.params),
        **extra,
    }


def index_from_numpy(fields: dict, device=None) -> QuIVerIndex:
    """An index from the reference's npz fields, on ``device`` (default:
    the CUDA card)."""
    if "stream_format" in fields:
        raise ValueError(
            "this is a streaming archive; load it with "
            "repro_torch.stream.MutableQuIVerIndex.load (freeze() it for "
            "an immutable QuIVerIndex)"
        )
    metric_kind = _metric_kind(fields)
    device = resolve_device(device)
    return QuIVerIndex(
        sigs=bq.Signature(words=_words(fields, device),
                          dim=int(fields["dim"])),
        adjacency=torch.tensor(fields["adjacency"], dtype=torch.int32,
                               device=device),
        medoid=int(fields["medoid"]),
        params=params_from_npz(fields),
        vectors=_tensor_or_none(fields["vectors"], torch.float32, device),
        rotation=_tensor_or_none(fields["rotation"], torch.float32, device),
        metric_kind=metric_kind,
        labels=LabelStore.from_npz(fields, device),
        policy=NavPolicy.from_npz(fields),
        report=CompatibilityReport.from_npz(fields),
        ivf=IVFPartition.from_npz(fields, device),
        graph_health=GraphHealthReport.from_npz(fields),
    )


def mutable_to_numpy(index: MutableQuIVerIndex) -> dict:
    """A streaming index as the reference's ``stream_format`` npz fields
    (``repro/stream/mutable.py``'s ``save``)."""
    return {
        "stream_format": np.int64(1),
        **_shared_fields(index),
        "words": _host(index.words).view(np.uint32),
        "dim": np.int64(index.dim),
        "adjacency": _host(index.adjacency),
        "deg": _host(index.deg),
        "vectors": _host(index.vectors),
        "rotation": _host(index.rotation),
        "live": index.live.copy(),
        "allocated": index.allocated.copy(),
        "free": np.asarray(index._free, dtype=np.int64),
        "size": np.int64(index.size),
        "medoid": np.int64(index.medoid),
        "generation": np.int64(index.generation),
        "metric_kind": np.array(index.metric_kind),
        **params_to_npz(index.params),
    }


def mutable_from_numpy(fields: dict, device=None) -> MutableQuIVerIndex:
    """A streaming index from the reference's ``stream_format`` npz fields,
    on ``device`` (default: the CUDA card).  The probe accumulator is
    derived state: it is recomputed from the live rows."""
    if "stream_format" not in fields:
        raise ValueError("not a streaming archive (no stream_format field)")
    device = resolve_device(device)
    dim = int(fields["dim"])
    vectors = fields["vectors"]
    out = MutableQuIVerIndex(
        capacity=fields["words"].shape[0],
        dim=dim,
        params=params_from_npz(fields),
        metric_kind=_metric_kind(fields),
        keep_vectors=bool(vectors.size),
        rotation=_tensor_or_none(fields["rotation"], torch.float32, device),
        policy=NavPolicy.from_npz(fields),
        report=CompatibilityReport.from_npz(fields),
        device=device,
    )
    out.words = _words(fields, device)
    out.adjacency = torch.tensor(fields["adjacency"], dtype=torch.int32,
                                 device=device)
    out.deg = torch.tensor(fields["deg"], dtype=torch.int32, device=device)
    if vectors.size:
        out.vectors = torch.tensor(vectors, dtype=torch.float32,
                                   device=device)
    out.live = np.asarray(fields["live"]).astype(bool)
    out.allocated = np.asarray(fields["allocated"]).astype(bool)
    out.labels = LabelStore.from_npz(fields, device)
    out._free = [int(i) for i in fields["free"]]
    out.size = int(fields["size"])
    out.medoid = int(fields["medoid"])
    out.generation = int(fields["generation"])
    out.graph_health = GraphHealthReport.from_npz(fields)
    out.probe_acc = ProbeAccumulator.from_words(
        np.asarray(fields["words"])[out.live], dim)
    return out


# -- LM parameters ------------------------------------------------------------


def _block_leaves(blk) -> dict:
    """One block's tensors under the reference's pytree paths."""
    leaves = {("ln1", "scale"): blk.ln1.scale, ("ln2", "scale"): blk.ln2.scale}
    for name in ("wq", "wk", "wv", "wo"):
        leaves[("attn", name, "w")] = getattr(blk.attn, name).w
    for name in ("w1", "w3", "w2"):
        if hasattr(blk.mlp, name):
            leaves[("mlp", name, "w")] = getattr(blk.mlp, name).w
    return leaves


def _top_leaves(model) -> dict:
    return {("embed", "w"): model.embed.w,
            ("final_norm", "scale"): model.final_norm.scale,
            ("lm_head", "w"): model.lm_head.w}


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor; bfloat16 (``ml_dtypes``, as
    ``np.asarray`` of a JAX bf16 array gives it) through its 16 bits,
    recognised by name, since ``torch.from_numpy`` refuses it."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:           # a JAX array's host view
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def lm_params_from_numpy(params: dict, cfg, *, dtype=None,
                         device=None) -> DecoderLM:
    """The reference's parameter pytree (numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as a :class:`DecoderLM` on
    ``device`` (default: the CUDA card).  The matrices keep their dtype
    unless ``dtype`` is given; norm scales stay float32."""
    device = resolve_device(device)
    layers = params["layers"]
    if len(layers) != 1:
        raise NotImplementedError(
            f"a layer pattern of period {len(layers)} (hybrid, MoE, xLSTM "
            "stacks) is not ported yet")
    if dtype is None:
        dtype = _tensor(params["embed"]["w"]).dtype
    model = DecoderLM(cfg, device=device, dtype=dtype)
    pairs = [(p, _get(params, path)) for path, p in _top_leaves(model).items()]
    for g, blk in enumerate(model.blocks):
        pairs += [(p, np.asarray(_get(layers[0], path))[g])
                  for path, p in _block_leaves(blk).items()]
    for p, a in pairs:
        t = _tensor(a)
        if t.shape != p.shape:
            raise ValueError(f"parameter of shape {tuple(t.shape)} for a "
                             f"slot of {tuple(p.shape)}")
        p.copy_(t.to(p.dtype))
    return model


def lm_params_to_numpy(model: DecoderLM) -> dict:
    """The module's parameters as the reference's pytree of numpy arrays.
    bfloat16 tensors come out as float32 (exactly: every bf16 value is a
    float32), since numpy has no bfloat16 of its own."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def put(tree, path, value):
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = value

    out: dict = {}
    for path, p in _top_leaves(model).items():
        put(out, path, host(p))
    group: dict = {}
    per_block = [_block_leaves(blk) for blk in model.blocks]
    for path in per_block[0]:
        put(group, path, np.stack([host(leaves[path])
                                   for leaves in per_block]))
    out["layers"] = [group]
    return out
