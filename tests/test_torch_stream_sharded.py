"""The port's streaming fleet (``repro_torch.stream.StreamingShardedIndex``)
against ``repro.stream.sharded``, on the CPU.

Both packages run one mutation script from ``empty()`` over three shards
(:func:`fleet_script`: a labelled round-robin insert, deletes routed by
global id with one shard's medoid among them, consolidation, a re-insert
into the reclaimed slots, per-label entries), and an insert that would
overflow one shard must leave every shard as it was.  Held bit for bit after every step: every
shard's state (cold vectors within 2 ulp, as ``tests/test_torch_stream.py``
holds them), the insert cursor, the global ids, the snapshot's fields and
its cache on the generations.  The scatter (its lazy rebuild of the IVF
tier after a delete and its error before ``enable_ivf_routing``),
``replan`` and ``probe_report`` fan-out and the drift monitors' names run
in this process on both packages.  The reference's fan-out needs one
device a shard: one shard runs in this process (the reference's single
device cases, tombstones and filter push-down), and the three-shard fan-out
in one module-scoped subprocess with four host devices, which runs the
same script and writes its search results at each step to an npz.
"""

import dataclasses
import math
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import filter as jfilter
from repro.core.vamana import BuildParams as JaxParams
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.stream import StreamingShardedIndex as JaxFleet
from repro_torch import convert, filter as pfilter
from repro_torch.core.vamana import BuildParams
from repro_torch.data.datasets import make_dataset
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.stream import StreamingShardedIndex

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PARAMS = dict(m=6, ef_construction=32, prune_pool=32, chunk=128)
N_SHARDS, CAPACITY, N_LABELS = 3, 300, 3
STEPS = ("insert", "delete", "consolidate", "reinsert", "entries")
PORT = types.SimpleNamespace(Fleet=StreamingShardedIndex, Any=pfilter.Any,
                             Params=BuildParams, kw={"device": "cpu"})
REF = types.SimpleNamespace(Fleet=JaxFleet, Any=jfilter.Any,
                            Params=JaxParams, kw={})


def data():
    base, queries = make_dataset("minilm-surrogate", 700, queries=25)
    labels = np.random.default_rng(4).integers(0, N_LABELS, len(base))
    return base, queries, labels


def fleet_script(pkg, base, labels):
    """The mutation script; yields (step, fleet, global ids) after each
    step of ``STEPS``."""
    fleet = pkg.Fleet.empty(base.shape[1], n_shards=N_SHARDS,
                            capacity_per_shard=CAPACITY,
                            params=pkg.Params(**PARAMS), n_labels=N_LABELS,
                            **pkg.kw)
    gids = fleet.insert(base[:600], labels=list(labels[:600]))
    yield "insert", fleet, gids
    medoid = fleet.shards[0].medoid            # shard 0's slot = its gid
    fleet.delete(np.concatenate([gids[50:150], [medoid]]))
    yield "delete", fleet, gids
    fleet.consolidate()
    yield "consolidate", fleet, gids
    more = fleet.insert(base[600:700], labels=list(labels[600:700]))
    yield "reinsert", fleet, more
    fleet.build_label_entries(min_count=16)
    yield "entries", fleet, more


# the fan-out searches of every step, by name: (keywords, filter labels)
SEARCHES = {"plain": ({}, None), "label": ({"filter": 1}, None),
            "any": ({}, (0, 2))}


def searches(pkg, fleet, queries):
    out = {}
    for name, (kw, any_of) in SEARCHES.items():
        if any_of is not None:
            kw = {"filter": pkg.Any(*any_of)}
        out[name] = fleet.search(queries, ef=48, k=10, **kw)
    return out


REFERENCE = """
    import importlib.util
    import numpy as np

    spec = importlib.util.spec_from_file_location("fleet_test", TEST_FILE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    base, queries, labels = mod.data()
    out = {}
    for step, fleet, _ in mod.fleet_script(mod.REF, base, labels):
        for name, (ids, scores) in mod.searches(mod.REF, fleet,
                                                queries).items():
            out[f"{step}_{name}_ids"] = ids
            out[f"{step}_{name}_scores"] = scores
    np.savez(OUTPUT, **out)
"""


def _np(x):
    """A JAX array or a tensor as numpy (uint32 words as int32 views)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def assert_ids_match(a, b, scores_a, scores_b, tol=1e-6):
    """Ids may differ at a rank only where the two scores there tie."""
    np.testing.assert_allclose(scores_a, scores_b, rtol=1e-5, atol=1e-6)
    diff = a != b
    assert (np.abs(scores_a - scores_b)[diff] <= tol).all(), (
        np.nonzero(diff.any(axis=1))[0][:5])


def assert_same_shard(pm, jm):
    for name in ("words", "adjacency", "deg"):
        np.testing.assert_array_equal(_np(getattr(pm, name)),
                                      _np(getattr(jm, name)), err_msg=name)
    np.testing.assert_array_max_ulp(_np(pm.vectors), _np(jm.vectors),
                                    maxulp=2)
    np.testing.assert_array_equal(pm.live, jm.live)
    np.testing.assert_array_equal(pm.allocated, jm.allocated)
    assert pm._free == jm._free
    assert (pm.size, pm.medoid, pm.generation) == (jm.size, jm.medoid,
                                                   jm.generation)
    assert dataclasses.asdict(pm.stats) == dataclasses.asdict(jm.stats)
    np.testing.assert_array_equal(_np(pm.labels.words),
                                  _np(jm.labels.words))
    np.testing.assert_array_equal(pm.labels.entries, jm.labels.entries)
    np.testing.assert_array_equal(pm.labels.counts, jm.labels.counts)


def assert_same_snapshot(pf, jf):
    got = convert.sharded_to_numpy(pf.snapshot())
    want = jf.snapshot()
    for name in ("sig_words", "adjacency", "medoids", "live", "label_words",
                 "label_entries", "label_counts"):
        np.testing.assert_array_equal(_np(got[name]),
                                      _np(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_max_ulp(got["vectors"], _np(want.vectors),
                                    maxulp=2)
    assert got["n_labels"] == want.n_labels


@pytest.fixture(scope="module")
def fan_out_reference(tmp_path_factory):
    """The three-shard fan-out results of every step, from a subprocess
    with four host devices started now, beside this process's tests."""
    d = tmp_path_factory.mktemp("stream_fleet")
    prelude = (f"TEST_FILE = {str(Path(__file__).resolve())!r}\n"
               f"OUTPUT = {str(d / 'out.npz')!r}\n")
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
def scripts(fan_out_reference):
    """Both packages through the script, the states after each step."""
    base, _, labels = data()
    runs = zip(fleet_script(PORT, base, labels),
               fleet_script(REF, base, labels))
    steps = {}
    for (step, pf, pg), (_, jf, jg) in runs:
        for pm, jm in zip(pf.shards, jf.shards):
            assert_same_shard(pm, jm)
        assert pf._rr == jf._rr
        np.testing.assert_array_equal(pg, jg)
        assert_same_snapshot(pf, jf)
        steps[step] = pg
    return pf, jf, steps


def test_script_states_equal_the_reference(scripts):
    pf, jf, steps = scripts
    assert list(steps) == list(STEPS)
    assert [s.n_live for s in pf.shards] == [s.n_live for s in jf.shards]
    # round robin: 600 inserts give 200 a shard
    assert len(set(steps["insert"].tolist())) == 600
    assert (steps["insert"] // CAPACITY == np.arange(600) % 3).all()
    # the re-insert reused the reclaimed slots first
    assert pf.n_live == 600 - 101 + 100
    assert sum(len(s._free) for s in pf.shards) == 1


def test_insert_is_all_or_nothing():
    base, _, labels = data()
    pairs = []
    for pkg in (PORT, REF):
        fleet = pkg.Fleet.empty(base.shape[1], n_shards=N_SHARDS,
                                capacity_per_shard=40,
                                params=pkg.Params(**PARAMS), **pkg.kw)
        fleet.insert(base[:100])
        gens = [s.generation for s in fleet.shards]
        # 34, 33 and 33 rows: shard 0 has 6 free slots, and the next 21
        # inserts give it 7
        with pytest.raises(ValueError, match="shard 0 needs 7 slots"):
            fleet.insert(base[100:121])
        assert [s.generation for s in fleet.shards] == gens
        assert fleet.n_live == 100 and fleet._rr == 1
        with pytest.raises(ValueError, match="out of range"):
            fleet.delete([N_SHARDS * 40])
        pairs.append(fleet)
    for pm, jm in zip(pairs[0].shards, pairs[1].shards):
        np.testing.assert_array_equal(_np(pm.adjacency), _np(jm.adjacency))


def test_snapshot_is_cached_on_the_generations(scripts):
    pf, jf, _ = scripts
    snap = pf.snapshot()
    assert pf.snapshot() is snap
    for fleet in (pf, jf):
        fleet.delete([CAPACITY + 5])         # one shard's generation moves
    fresh = pf.snapshot()
    assert fresh is not snap
    # the held snapshot is a copy: it keeps the row live
    assert bool(snap.live[1][5]) and not bool(fresh.live[1][5])
    assert_same_snapshot(pf, jf)


def test_fan_out_matches_reference(scripts, fan_out_reference):
    proc, path = fan_out_reference
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(path) as z:
        want = dict(z)
    # the port's fan-out at every step of its own run of the script
    base, queries, labels = data()
    gids = None
    for step, fleet, g in fleet_script(PORT, base, labels):
        gids = g if step == "insert" else gids
        for name, (ids, scores) in searches(PORT, fleet, queries).items():
            assert_ids_match(ids, want[f"{step}_{name}_ids"], scores,
                             want[f"{step}_{name}_scores"])
            if step in ("delete", "consolidate"):
                assert not np.isin(ids, gids[50:150]).any()


def test_single_shard_fan_out_and_filter_push_down():
    """The reference's single-device streaming cases on both packages:
    tombstones excluded before the merge, through consolidation, and a
    filter pushed down beside them."""
    base, queries, labels = data()
    got = []
    for pkg in (PORT, REF):
        fleet = pkg.Fleet.empty(base.shape[1], n_shards=1,
                                capacity_per_shard=1000,
                                params=pkg.Params(**PARAMS), n_labels=3,
                                **pkg.kw)
        gids = fleet.insert(base[:600], labels=list(labels[:600]))
        kill = gids[50:150]
        fleet.delete(kill)
        fleet.build_label_entries(min_count=16)
        out = [fleet.search(queries, ef=48, k=10),
               fleet.search(queries, ef=48, k=10, filter=pkg.Any(0, 2))]
        fleet.consolidate()
        out.append(fleet.search(queries, ef=48, k=10))
        for ids, _ in out:
            assert not np.isin(ids, kill).any()
        ok = out[1][0][out[1][0] >= 0]
        assert ok.size and np.isin(labels[ok], (0, 2)).all()
        assert fleet.n_live == 500
        got.append(out)
    for (ids, scores), (jids, jscores) in zip(*got):
        assert_ids_match(ids, jids, scores, jscores)


def test_scatter_search_and_its_lazy_rebuild(scripts):
    pf, jf, _ = scripts
    _, queries, _ = data()
    for fleet in (pf, jf):
        with pytest.raises(ValueError, match="enable_ivf_routing"):
            fleet.search(queries[:2], k=5, scatter=True)
    n_lists = pf.enable_ivf_routing(seed=0)
    assert n_lists == jf.enable_ivf_routing(seed=0)
    np.testing.assert_array_equal(_np(pf._ivf_route[0]),
                                  _np(jf._ivf_route[0]))
    np.testing.assert_array_equal(pf._ivf_route[1], jf._ivf_route[1])
    assert pf._ivf_route[2:] == jf._ivf_route[2:]
    for probes in (None, n_lists):
        reg, jreg = MetricsRegistry(), JaxRegistry()
        ids, scores = pf.search(queries, k=10, ef=48, scatter=True,
                                probes=probes, registry=reg)
        jids, jscores = jf.search(queries, k=10, ef=48, scatter=True,
                                  probes=probes, registry=jreg)
        assert_ids_match(ids, jids, scores, jscores)
        assert reg.snapshot() == jreg.snapshot()
    # churn makes the tier stale: the next scatter rebuilds it
    dead = ids[0, :3][ids[0, :3] >= 0]
    for fleet in (pf, jf):
        fleet.delete(dead)
    gens = pf._ivf_route[3]
    ids2, _ = pf.search(queries[:4], k=5, ef=32, scatter=True,
                        registry=MetricsRegistry())
    jids2, _ = jf.search(queries[:4], k=5, ef=32, scatter=True,
                         registry=JaxRegistry())
    assert pf._ivf_route[3] != gens
    assert not np.isin(ids2, dead).any()
    np.testing.assert_array_equal(pf._ivf_route[1], jf._ivf_route[1])
    np.testing.assert_array_equal(ids2, jids2)


def test_replan_probe_report_and_drift_monitors_fan_out(scripts):
    pf, jf, _ = scripts
    reg, jreg = MetricsRegistry(), JaxRegistry()
    mons = pf.attach_drift_monitors(tenant="fleet", registry=reg)
    jmons = jf.attach_drift_monitors(tenant="fleet", registry=jreg)
    assert [m.tenant for m in mons] == [m.tenant for m in jmons] == [
        f"fleet/shard{i}" for i in range(N_SHARDS)]
    assert [m.band for m in mons] == [m.band for m in jmons]
    got, want = pf.probe_report(seed=1), jf.probe_report(seed=1)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, float) and not math.isnan(w):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=f.name)
        elif not isinstance(w, float) and not dataclasses.is_dataclass(w):
            assert g == w, f.name
    assert got.verdict == want.verdict
    policies = pf.replan(nav="adc", ef_scale=2)
    jpolicies = jf.replan(nav="adc", ef_scale=2)
    assert [dataclasses.asdict(p) for p in policies] == [
        dataclasses.asdict(p) for p in jpolicies]
    assert {s.metric_kind for s in pf.shards} == {"adc"}
    for fleet in (pf, jf):
        with pytest.raises(ValueError, match="ivf"):
            fleet.replan(nav="ivf")
    empty = StreamingShardedIndex.empty(8, n_shards=2, capacity_per_shard=4,
                                        device="cpu")
    with pytest.raises(ValueError, match="empty fleet"):
        empty.probe_report()
    with pytest.raises(ValueError, match="empty fleet"):
        empty.enable_ivf_routing()
