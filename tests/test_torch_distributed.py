"""The port's sharded fleet (``repro_torch.core.distributed``) against
``repro.core.distributed``, on the CPU.

The reference fans out through ``shard_map``, so an S-shard search needs S
devices.  S = 1 runs in this process; S = 3 and S = 4 run in one
module-scoped subprocess with four forced host devices (as
``tests/test_distributed.py`` runs its fleets), which builds both fleets,
searches them and writes fields and results to an npz.  Held:

* ``build_sharded``: the ceil partition, the pad rows and ``live``, the
  signature words, medoids, label words, per-label entries and fleet
  counts equal the reference's (the graphs differ: each package draws its
  own random starting graph); ``metric="auto"`` on a green and a red
  corpus chooses the reference's policy from an equal merged report;
* the reference's fleets carried across by ``convert.sharded_from_numpy``
  and searched by the port: ids equal to the reference's (scores within
  1e-6 where ids differ), unfiltered, filtered with per-label entries,
  ``nav="bq1"`` and ``expand=2``; the tail rows found as themselves and
  no pad row returned; a tie between shards goes to the lower shard;
* ``build_ivf_sharded`` placement and ``search_ivf_sharded`` ids,
  targeted and broadcast, with the same registry counts.
"""

import dataclasses
import functools
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core.vamana import BuildParams as JaxParams
from repro.filter import Any as JaxAny
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro_torch import convert
from repro_torch.core import distributed as dist
from repro_torch.core.vamana import BuildParams
from repro_torch.data.datasets import make_dataset
from repro_torch.filter import Any, Label
from repro_torch.obs.metrics import MetricsRegistry

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PARAMS = dict(m=4, ef_construction=24, prune_pool=24, chunk=128)
# one shard size for every fleet, so each package compiles its build once;
# 3 and 4 shards: two pad rows each
PER = 226
N_OF = {1: PER, 3: 3 * PER - 2, 4: 4 * PER - 2}
N_LABELS = 3
STACKED = ("sig_words", "adjacency", "medoids", "vectors", "live",
           "label_words", "label_entries", "label_counts")
# each case's search keywords, in the port's terms and in the reference's
CASES = {
    "plain": ({}, {}),
    "label": ({"filter": 1}, {"filter": 1}),
    "any": ({"filter": Any(0, 2)}, {"filter": JaxAny(0, 2)}),
    "bq1": ({"nav": "bq1"}, {"nav": "bq1"}),
    "expand2": ({"expand": 2}, {"expand": 2}),
}

REFERENCE = """
    import numpy as np
    from repro.core.distributed import build_sharded, search_sharded
    from repro.core.vamana import BuildParams
    from repro.filter import Any

    inp = np.load(INPUT)
    base, queries, labels = inp["base"], inp["queries"], inp["labels"]
    cases = {"plain": {}, "label": {"filter": 1},
             "any": {"filter": Any(0, 2)}, "bq1": {"nav": "bq1"},
             "expand2": {"expand": 2}}
    out = {}
    for s, n in N_OF.items():
        idx = build_sharded(base[:n], s, BuildParams(**PARAMS),
                            labels=list(labels[:n]), label_entry_min=16)
        for name in STACKED:
            out[f"s{s}_{name}"] = np.asarray(getattr(idx, name))
        for case, kw in cases.items():
            ids, scores = search_sharded(idx, queries, ef=48, k=10, **kw)
            out[f"s{s}_{case}_ids"] = ids
            out[f"s{s}_{case}_scores"] = scores
    np.savez(OUTPUT, **out)
"""


def assert_ids_match(a, b, scores_a, scores_b, tol=1e-6):
    """Ids may differ at a rank only where the two scores there tie."""
    np.testing.assert_allclose(scores_a, scores_b, rtol=1e-5, atol=1e-6)
    diff = a != b
    assert (np.abs(scores_a - scores_b)[diff] <= tol).all(), (
        np.nonzero(diff.any(axis=1))[0][:5])


@functools.lru_cache(maxsize=1)
def _data():
    base, queries = make_dataset("minilm-surrogate", 904, queries=20)
    labels = np.random.default_rng(5).integers(0, N_LABELS, len(base))
    return base, queries, labels


def _fields(idx) -> dict:
    """A reference fleet as the numpy fields ``sharded_from_numpy`` takes."""
    out = {name: np.asarray(getattr(idx, name)) for name in STACKED
           if getattr(idx, name) is not None}
    out.update(dim=idx.dim, metric=idx.metric, n_labels=idx.n_labels)
    if idx.policy is not None:
        out.update(idx.policy.to_npz_fields())
    if idx.report is not None:
        out.update(idx.report.to_npz_fields())
    return out


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The S = 3 and 4 reference fleets, started in a subprocess with four
    host devices; the first tests of the file run beside it."""
    base, queries, labels = _data()
    d = tmp_path_factory.mktemp("fleets")
    np.savez(d / "in.npz", base=base, queries=queries, labels=labels)
    prelude = (f"INPUT = {str(d / 'in.npz')!r}\n"
               f"OUTPUT = {str(d / 'out.npz')!r}\n"
               f"N_OF = { {s: n for s, n in N_OF.items() if s > 1}!r}\n"
               f"PARAMS = {PARAMS!r}\nSTACKED = {STACKED!r}\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.Popen(
        [sys.executable, "-c", prelude + textwrap.dedent(REFERENCE)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT,
    )
    try:
        yield proc, d / "out.npz"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def fleets(reference_run):
    """Fields and results of the reference's fleets: S = 1 in this
    process, S = 3 and 4 from the subprocess."""
    base, queries, labels = _data()
    n = N_OF[1]
    idx = jdist.build_sharded(base[:n], 1, JaxParams(**PARAMS),
                              labels=list(labels[:n]), label_entry_min=16)
    out = {1: {"fields": _fields(idx),
               "results": {c: jdist.search_sharded(idx, queries, ef=48,
                                                   k=10, **kw[1])
                           for c, kw in CASES.items()}}}
    proc, path = reference_run
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(path) as z:
        raw = dict(z)
    for s in (3, 4):
        pre = f"s{s}_"
        fields = {name: raw[pre + name] for name in STACKED}
        fields.update(dim=base.shape[1], metric="bq2", n_labels=N_LABELS)
        out[s] = {"fields": fields,
                  "results": {c: (raw[f"{pre}{c}_ids"],
                                  raw[f"{pre}{c}_scores"]) for c in CASES}}
    return out


@functools.lru_cache(maxsize=1)
def _ivf_pair():
    base, _, _ = _data()
    return (jdist.build_ivf_sharded(base, 4, seed=0),
            dist.build_ivf_sharded(base, 4, seed=0, device="cpu"))


def test_build_ivf_sharded_places_lists_as_the_reference(reference_run):
    # (requests the reference run so that it starts beside these tests)
    jidx, idx = _ivf_pair()
    assert (idx.n_shards, idx.n_lists, idx.default_probes) == (
        jidx.n_shards, jidx.n_lists, jidx.default_probes)
    np.testing.assert_array_equal(idx.cent_words.numpy(),
                                  np.asarray(jidx.cent_words).view(np.int32))
    np.testing.assert_array_equal(idx.list_shard, jidx.list_shard)
    np.testing.assert_array_equal(idx.list_local, jidx.list_local)
    for got, want in zip(idx.shards, jidx.shards):
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.lists, want.lists)
        np.testing.assert_array_equal(got.list_ids.numpy(),
                                      np.asarray(want.list_ids))
        np.testing.assert_array_equal(
            got.sig_words.numpy(), np.asarray(want.sig_words).view(np.int32))
        np.testing.assert_array_equal(got.vectors.numpy(),
                                      np.asarray(want.vectors))
    assert sum(s.ids.size for s in idx.shards) == len(_data()[0])


def _ivf_fields(jidx) -> dict:
    return {"cent_words": np.asarray(jidx.cent_words),
            "list_shard": jidx.list_shard, "list_local": jidx.list_local,
            "dim": jidx.dim, "default_probes": jidx.default_probes,
            "shards": [{name: np.asarray(getattr(sh, name)) for name in
                        ("sig_words", "vectors", "ids", "list_ids", "lists")}
                       for sh in jidx.shards]}


@pytest.mark.parametrize("probes", [2, None, "all"])
def test_ivf_scatter_matches_reference(probes):
    jidx, own = _ivf_pair()
    _, queries, _ = _data()
    carried = convert.ivf_sharded_from_numpy(_ivf_fields(jidx), "cpu")
    p = jidx.n_lists if probes == "all" else probes
    for broadcast in (False, True):
        jreg, reg = JaxRegistry(), MetricsRegistry()
        want_ids, want_scores = jdist.search_ivf_sharded(
            jidx, queries, k=10, ef=64, probes=p, broadcast=broadcast,
            registry=jreg)
        for idx in (own, carried):
            reg = MetricsRegistry()
            ids, scores = dist.search_ivf_sharded(
                idx, queries, k=10, ef=64, probes=p, broadcast=broadcast,
                registry=reg)
            assert_ids_match(ids, want_ids, scores, want_scores)
            assert reg.snapshot() == jreg.snapshot()
        if not broadcast:
            targeted = ids
        else:
            np.testing.assert_array_equal(targeted, ids)
    h = reg.histogram("quiver_ivf_scatter_shards")
    assert h.percentile(100) <= min(p or jidx.default_probes, own.n_shards)


def _report_fields_match(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, float):
            assert math.isnan(g) == math.isnan(w), f.name
            if not math.isnan(w):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                           err_msg=f.name)
        elif not dataclasses.is_dataclass(w):
            assert g == w, f.name
    assert got.verdict == want.verdict


@pytest.mark.parametrize("name,want_nav", [("minilm-surrogate", "bq2"),
                                           ("sift-like", "float32")])
def test_build_sharded_auto_matches_reference(name, want_nav):
    base, _ = make_dataset(name, 2 * PER, queries=4)
    jidx = jdist.build_sharded(base, 2, JaxParams(**PARAMS), metric="auto")
    idx = dist.build_sharded(base, 2, BuildParams(**PARAMS), metric="auto",
                             device="cpu")
    assert idx.metric == jidx.metric == want_nav
    assert dataclasses.asdict(idx.policy) == dataclasses.asdict(jidx.policy)
    _report_fields_match(idx.report, jidx.report)
    np.testing.assert_array_equal(
        convert.sharded_to_numpy(idx)["sig_words"],
        np.asarray(jidx.sig_words))


@functools.lru_cache(maxsize=None)
def _port_fleet(s: int):
    base, _, labels = _data()
    n = N_OF[s]
    return dist.build_sharded(base[:n], s, BuildParams(**PARAMS),
                              labels=list(labels[:n]), label_entry_min=16,
                              device="cpu")


@pytest.mark.parametrize("s", [1, 3, 4])
def test_build_sharded_matches_reference(fleets, s):
    want = fleets[s]["fields"]
    got = convert.sharded_to_numpy(_port_fleet(s))
    n = N_OF[s]
    per = -(-n // s)
    assert got["sig_words"].shape[:2] == (s, per)
    assert got["live"].sum() == n
    assert not got["live"].reshape(-1)[n:].any()
    for name in ("sig_words", "medoids", "live", "label_words",
                 "label_entries", "label_counts"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["adjacency"].shape == want["adjacency"].shape
    # the pad rows repeat the leading rows, labels and all
    flat = got["sig_words"].reshape(s * per, -1)
    np.testing.assert_array_equal(flat[n:], flat[:s * per - n])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("s", [1, 3, 4])
def test_reference_fleet_searches_identically(fleets, s, case):
    _, queries, _ = _data()
    idx = convert.sharded_from_numpy(fleets[s]["fields"], "cpu")
    ids, scores = dist.search_sharded(idx, queries, ef=48, k=10,
                                      **CASES[case][0])
    want_ids, want_scores = fleets[s]["results"][case]
    assert_ids_match(ids, np.asarray(want_ids), scores,
                     np.asarray(want_scores))
    # global ids, unique in each row, never a pad row
    assert (ids < N_OF[s]).all()
    for row in ids:
        v = row[row >= 0]
        assert len(set(v.tolist())) == len(v)
    if case in ("label", "any"):
        _, _, labels = _data()
        ok = ids[ids >= 0]
        allowed = (1,) if case == "label" else (0, 2)
        assert np.isin(labels[ok], allowed).all()


@pytest.mark.parametrize("s", [1, 3, 4])
def test_tail_rows_found_and_pad_rows_never_returned(fleets, s):
    """The reference's ``test_build_sharded_indexes_every_vector_with_
    indivisible_n``, on the port's own fleet and on the reference's."""
    base, _, _ = _data()
    n = N_OF[s]
    tail = list(range(n - 4, n))
    for idx in (_port_fleet(s),
                convert.sharded_from_numpy(fleets[s]["fields"], "cpu")):
        ids, _ = dist.search_sharded(idx, base[n - 4:n], ef=48, k=1)
        assert ids.ravel().tolist() == tail
        all_ids, _ = dist.search_sharded(idx, base[:100], ef=48, k=10)
        assert (all_ids < n).all()


def test_merge_gives_a_tie_to_the_lower_shard(fleets):
    """Two shards holding the same rows score every pair equal: the
    merge keeps the lower shard's id first, as ``lax.top_k`` does."""
    _, queries, _ = _data()
    one = fleets[1]["fields"]
    twin = {k: (np.concatenate([v, v]) if k in STACKED and k != "label_counts"
                else v) for k, v in one.items()}
    idx = convert.sharded_from_numpy(twin, "cpu")
    ids, scores = dist.search_sharded(idx, queries, ef=48, k=10)
    n = N_OF[1]
    np.testing.assert_array_equal(ids[:, 1::2], ids[:, 0::2] + n)
    np.testing.assert_array_equal(scores[:, 1::2], scores[:, 0::2])
    assert (ids[:, 0::2] < n).all()


def test_count_fn_without_counts_is_the_live_popcount(fleets):
    fields = dict(fleets[3]["fields"])
    want = fields.pop("label_counts")
    idx = convert.sharded_from_numpy(fields, "cpu")
    assert idx.label_counts is None
    count = dist.sharded_count_fn(idx)
    # the live popcount leaves out the two pad rows' labels
    _, _, labels = _data()
    for lb in range(N_LABELS):
        assert count(lb) == int((labels[:N_OF[3]] == lb).sum())
        assert want[lb] - 2 <= count(lb) <= want[lb]


def test_filter_needs_label_words_and_placement_checks(fleets):
    fields = {k: v for k, v in fleets[1]["fields"].items()
              if k not in ("label_words", "label_entries", "label_counts")}
    idx = convert.sharded_from_numpy(fields, "cpu")
    _, queries, _ = _data()
    with pytest.raises(ValueError, match="label_words"):
        dist.search_sharded(idx, queries, k=5, filter=Label(0))
    with pytest.raises(ValueError, match="devices for"):
        convert.sharded_from_numpy(fleets[3]["fields"], ["cpu", "cpu"])
    placed = convert.sharded_from_numpy(fleets[3]["fields"],
                                        ["cpu", "cpu", "cpu"])
    assert placed.devices == [torch.device("cpu")] * 3
    # the carried fleet goes back to the reference's fields unchanged
    back = convert.sharded_to_numpy(placed)
    for name in STACKED:
        np.testing.assert_array_equal(back[name],
                                      fleets[3]["fields"][name])
