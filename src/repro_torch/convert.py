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

A fleet travels as numpy arrays under the reference's field names:
:func:`sharded_to_numpy` / :func:`sharded_from_numpy` stack a
:class:`~repro_torch.core.distributed.ShardedIndex`'s per-shard tensors on
a leading shard axis (``sig_words`` and ``label_words`` as uint32) with
its policy and report as ``policy_*`` / ``probe_*`` fields, and
:func:`ivf_sharded_from_numpy` takes a list-partitioned fleet.  The
reference gives its fleets no archive, so neither has one here.

An LM's parameters travel as the reference's pytree (one stacked group
per position of the layer pattern, layers stacked on a leading axis; an
xLSTM layer's cell under ``layers[pos]["cell"]``; an encoder-decoder's
``enc_layers`` and ``dec_layers`` each stacked over its layers;
``models/transformer.py::reference_leaves``; an MoE's ``router.w`` stays
float32 whatever the matrices' dtype), its optimizer
state as ``{"mu", "nu", "count"[, "ef"]}`` in the same layout: the tree a
checkpoint of ``ckpt/checkpoint.py`` stores under ``params`` and ``opt``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bq
from repro_torch.core.distributed import (
    IVFShard,
    IVFShardedIndex,
    ShardedIndex,
    shard_devices,
)
from repro_torch.core.index import QuIVerIndex
from repro_torch.core.metric import registered_kinds
from repro_torch.core.vamana import BuildParams
from repro_torch.device import resolve_device
from repro_torch.filter import LabelStore
from repro_torch.ivf import IVFPartition
from repro_torch.models.model import lm_module
from repro_torch.models.transformer import STACKED, DecoderLM, \
    reference_leaves
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


# -- fleets ------------------------------------------------------------------


def sharded_to_numpy(index: ShardedIndex) -> dict:
    """A fleet as the reference's stacked ``ShardedIndex`` fields."""
    def stack(tensors):
        return np.stack([_host(t) for t in tensors])

    out = {
        "sig_words": stack(index.sig_words).view(np.uint32),
        "adjacency": stack(index.adjacency),
        "medoids": index.medoids.copy(),
        "vectors": stack(index.vectors),
        "dim": np.int64(index.dim),
        "metric": np.array(index.metric),
        "n_labels": np.int64(index.n_labels),
    }
    if index.live is not None:
        out["live"] = stack(index.live)
    if index.label_words is not None:
        out["label_words"] = stack(index.label_words).view(np.uint32)
    if index.label_entries is not None:
        out["label_entries"] = index.label_entries.copy()
    if index.label_counts is not None:
        out["label_counts"] = index.label_counts.copy()
    if index.policy is not None:
        out.update(index.policy.to_npz_fields())
    if index.report is not None:
        out.update(index.report.to_npz_fields())
    return out


def sharded_from_numpy(fields: dict, device=None) -> ShardedIndex:
    """A fleet from the reference's stacked fields (absent optional
    fields stay None), shard s on ``device`` as
    :func:`~repro_torch.core.distributed.shard_devices` places it."""
    words = np.ascontiguousarray(fields["sig_words"])
    devices = shard_devices(device, words.shape[0])

    def split(name, dtype, view=None):
        if fields.get(name) is None:
            return None
        a = np.ascontiguousarray(fields[name])
        if view is not None:
            a = a.view(view)
        return tuple(torch.tensor(a[s], dtype=dtype, device=dev)
                     for s, dev in enumerate(devices))

    def host(name, dtype):
        a = fields.get(name)
        return None if a is None else np.asarray(a, dtype=dtype)

    return ShardedIndex(
        sig_words=split("sig_words", torch.int32, np.int32),
        adjacency=split("adjacency", torch.int32),
        medoids=np.asarray(fields["medoids"], dtype=np.int32),
        vectors=split("vectors", torch.float32),
        dim=int(fields["dim"]),
        metric=str(fields.get("metric", "bq2")),
        live=split("live", torch.bool),
        label_words=split("label_words", torch.int32, np.int32),
        n_labels=int(fields.get("n_labels", 0)),
        label_entries=host("label_entries", np.int32),
        label_counts=host("label_counts", np.int64),
        policy=NavPolicy.from_npz(fields),
        report=CompatibilityReport.from_npz(fields),
    )


def ivf_sharded_from_numpy(fields: dict, device=None) -> IVFShardedIndex:
    """A list-partitioned fleet from the reference's fields:
    ``cent_words`` (uint32), ``list_shard``, ``list_local``, ``dim``,
    ``default_probes`` and ``shards``, one dict a shard with its
    ``IVFShard`` fields (``sig_words`` uint32).  The routing tier goes to
    the first shard's device."""
    devices = shard_devices(device, len(fields["shards"]))

    def words(a, dev):
        return torch.tensor(np.ascontiguousarray(a).view(np.int32),
                            device=dev)

    return IVFShardedIndex(
        cent_words=words(fields["cent_words"], devices[0]),
        list_shard=np.asarray(fields["list_shard"], dtype=np.int32),
        list_local=np.asarray(fields["list_local"], dtype=np.int32),
        shards=tuple(
            IVFShard(
                sig_words=words(sh["sig_words"], dev),
                vectors=torch.tensor(np.asarray(sh["vectors"]),
                                     dtype=torch.float32, device=dev),
                ids=np.asarray(sh["ids"], dtype=np.int32),
                list_ids=torch.tensor(np.asarray(sh["list_ids"]),
                                      dtype=torch.int32, device=dev),
                lists=np.asarray(sh["lists"], dtype=np.int32),
            )
            for sh, dev in zip(fields["shards"], devices)
        ),
        dim=int(fields["dim"]),
        default_probes=int(fields["default_probes"]),
    )


# -- LM parameters ------------------------------------------------------------


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _tensor(a) -> torch.Tensor:
    """A numpy array (or a tensor, as it is) as a tensor; bfloat16
    (``ml_dtypes``, as ``np.asarray`` of a JAX bf16 array gives it)
    through its 16 bits, recognised by name, since ``torch.from_numpy``
    refuses it."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:           # a JAX array's host view
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _put(tree: dict, path: tuple, value) -> None:
    """Set ``tree[path]``, making the dicts on the way and the ``layers``
    list of one dict per pattern position."""
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(tree, list):
            tree.extend({} for _ in range(key + 1 - len(tree)))
            tree = tree[key]
            continue
        if key not in tree:
            tree[key] = [] if isinstance(nxt, int) else {}
        tree = tree[key]
    tree[path[-1]] = value


def _host_copy(t: torch.Tensor, keep_bf16: bool):
    """A copy of a tensor on the host (a copy even of a CPU tensor, so that
    an async checkpoint write never sees the next step's in-place update):
    numpy, or (bfloat16 with ``keep_bf16``) a CPU tensor, since numpy has
    no bfloat16 of its own; otherwise bfloat16 comes out as float32
    (exactly).  A DTensor is gathered whole first."""
    t = t.detach()
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    t = t.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t if keep_bf16 else t.float().numpy()
    return t.numpy()


def _reference_tree(model: DecoderLM, named: dict, leaf) -> dict:
    """``named`` ({parameter name: tensor}, e.g. a moment of the
    optimizer) in the reference's pytree layout: ``leaf(tensors)`` of the
    tensors that form each of its leaves (one, or every block's, in layer
    order)."""
    out: dict = {}
    for path, names in reference_leaves(model).items():
        _put(out, path, leaf([named[n] for n in names], path[0] in STACKED))
    return out


def _stack_host(keep_bf16: bool):
    def leaf(ts, stacked):
        if not stacked:
            return _host_copy(ts[0], keep_bf16)
        hs = [_host_copy(t, keep_bf16) for t in ts]
        if isinstance(hs[0], torch.Tensor):
            return torch.stack(hs)
        return np.stack(hs)
    return leaf


def _cut(model: DecoderLM, tree: dict):
    """Inverse of :func:`_reference_tree`: (parameter name, tensor) pairs of
    a reference-layout ``tree``, a stacked leaf cut by layer (views, no
    copy)."""
    for path, names in reference_leaves(model).items():
        a = _get(tree, path)
        for i, n in enumerate(names):
            yield n, _tensor(a[i] if path[0] in STACKED else a)


@torch.no_grad()
def load_lm_params(model: DecoderLM, params: dict) -> DecoderLM:
    """Copy the reference's parameter pytree (numpy arrays or tensors, as
    :func:`lm_params_to_numpy` or ``ckpt.checkpoint.restore`` give it) into
    ``model``'s parameters, each cast to its slot's dtype (so an MoE's
    float32 router stays float32, and a mamba layer's ``dt_bias``,
    ``a_log`` and ``d_skip``, an xLSTM cell's ``norm_scale``).  A hybrid or
    xLSTM stack's pattern positions hold ``attn``, ``mamba`` or ``cell``
    leaves, each block's at index ``i // P`` as for any stack; an
    encoder-decoder's layer *i* at index *i* of ``enc_layers`` or
    ``dec_layers`` (``transformer.reference_leaves``)."""
    period, _ = model.cfg.pattern()
    if "layers" in params and len(params["layers"]) != period:
        raise ValueError(f"{len(params['layers'])} stacked layer groups for "
                         f"{model.cfg.name}, whose pattern has period "
                         f"{period}")
    slots = dict(model.named_parameters())
    for n, t in _cut(model, params):
        p = slots[n]
        if t.shape != p.shape:
            raise ValueError(f"parameter of shape {tuple(t.shape)} for "
                             f"{n} of {tuple(p.shape)}")
        p.copy_(t.to(p.dtype))
    return model


def lm_params_from_numpy(params: dict, cfg, *, dtype=None,
                         device=None) -> DecoderLM:
    """The reference's parameter pytree (numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the module of ``cfg``'s family
    (``models.model.lm_module``: a :class:`DecoderLM`, or an ``EncDecLM``)
    on ``device`` (default: the CUDA card).  The matrices keep their dtype
    unless ``dtype`` is given; norm scales stay float32."""
    device = resolve_device(device)
    if dtype is None:
        dtype = _tensor(params["embed"]["w"]).dtype
    return load_lm_params(lm_module(cfg, device=device, dtype=dtype), params)


def named_to_numpy(named: dict, model: DecoderLM, *,
                   keep_bf16: bool = False) -> dict:
    """``{parameter name: tensor}`` (the parameters, their gradients, a
    moment of the optimizer) as the reference's pytree of ``model``'s
    parameters (layers stacked on a leading axis) of numpy arrays.
    bfloat16 tensors come out as float32 (exactly: every bf16 value is a
    float32), since numpy has no bfloat16 of its own; with ``keep_bf16``
    they stay bfloat16, as CPU tensors, so a checkpoint stores them as the
    reference's bf16 leaves."""
    return _reference_tree(model, named, _stack_host(keep_bf16))


def lm_params_to_numpy(model: DecoderLM, *, keep_bf16: bool = False) -> dict:
    """The module's parameters as the reference's pytree: see
    :func:`named_to_numpy`."""
    return named_to_numpy(dict(model.named_parameters()), model,
                          keep_bf16=keep_bf16)


def opt_state_to_numpy(opt_state: dict, model: DecoderLM, *,
                       keep_bf16: bool = False) -> dict:
    """The optimizer state of ``optim/adamw.py`` (and the error feedback of
    ``optim/compress.py``) in the reference's layout: ``{"mu", "nu"[,
    "ef"]}`` as :func:`lm_params_to_numpy` lays out the parameters, and
    ``"count"`` a 0-d int32 array."""
    out = {k: named_to_numpy(opt_state[k], model, keep_bf16=keep_bf16)
           for k in ("mu", "nu", "ef") if k in opt_state}
    out["count"] = np.asarray(int(opt_state["count"]), dtype=np.int32)
    return out


def opt_state_from_numpy(tree: dict, model: DecoderLM, *,
                         device=None) -> dict:
    """Inverse of :func:`opt_state_to_numpy` on ``device`` (default: the
    model's), each moment in its stored dtype."""
    device = model.device if device is None else resolve_device(device)
    out = {k: {n: t.to(device, copy=True) for n, t in _cut(model, tree[k])}
           for k in ("mu", "nu", "ef") if k in tree}
    out["count"] = torch.tensor(int(np.asarray(tree["count"])),
                                dtype=torch.int32, device=device)
    return out


def train_state_like(model: DecoderLM, opt_state: dict) -> dict:
    """``{"params", "opt"}`` in the reference's layout with a stand-in of
    each leaf's shape and dtype (a meta tensor): the ``like`` of
    ``ckpt.checkpoint.restore``, made without copying."""
    def leaf(ts, stacked):
        shape = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
        return torch.empty(shape, dtype=ts[0].dtype, device="meta")

    named = dict(model.named_parameters())
    opt = {k: _reference_tree(model, opt_state[k], leaf)
           for k in ("mu", "nu", "ef") if k in opt_state}
    opt["count"] = torch.empty((), dtype=torch.int32, device="meta")
    return {"params": _reference_tree(model, named, leaf), "opt": opt}
