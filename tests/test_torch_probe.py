"""The port's applicability probe (``repro_torch.probe``) against ``repro.probe``.

On the reference's probe corpora (``tests/test_probe.py``: minilm-surrogate,
glove-like, sift-like and random-sphere, N = 1200) the port's report must
have equal int fields, float statistics within ``rtol=1e-5, atol=1e-6``
(torch and XLA sum in other orders), the same verdict and the same
:func:`select_policy` choice.  The agreement and the margin percentile,
which decide the verdict and an amber policy's escalation threshold, are
computed exactly as the reference computes them and are held equal.
``ProbeAccumulator`` must equal the reference's after the same words, and
``build(nav="auto")`` must choose the same rung, policy and report.  On a
green corpus the port's bq2 build, started from the JAX initial graph, is
the reference's graph, and its ids match by the ``ids_match`` rule of
``chip_smoke.py`` (ids may differ only where two cosine scores lie within
1e-6); on a red corpus the float-space graph may part from the
reference's at a near-tie, so the reference's graph is searched by the
port under the chosen policy (vector-free: negated adc distances, held
within 2.5e-4, the float tolerance of ``tests/test_torch_ladder.py``).
All on the CPU.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import probe as jprobe
from repro.core import bq as jbq
from repro.core import vamana as jvamana
from repro.core.index import QuIVerIndex as JaxIndex
from repro_torch import convert, probe
from repro_torch.core import bq, vamana
from repro_torch.core.index import QuIVerIndex
from repro_torch.data.datasets import make_dataset
from repro_torch.probe import diagnostics

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

N = 1200
PARAMS = dict(m=6, ef_construction=32, prune_pool=32, chunk=128)
CORPORA = ["minilm-surrogate", "glove-like", "sift-like", "random-sphere"]
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
INT_FIELDS = ("n_sampled", "n_queries", "k", "dim", "seed")
FLOAT_FIELDS = ("cos_mean", "cos_std", "sign_entropy", "strong_entropy",
                "inter_bit_corr", "bq_agreement", "margin_p30",
                "cluster_concentration")


@functools.lru_cache(maxsize=None)
def _corpus(name: str):
    return make_dataset(name, N, queries=20)


def assert_reports_match(got, want):
    for field in INT_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    for field in FLOAT_FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert math.isnan(g) == math.isnan(w), field
        if not math.isnan(w):
            np.testing.assert_allclose(g, w, **FLOAT_TOL, err_msg=field)
    if not math.isnan(want.bq_agreement):
        # the verdict's evidence and the escalation threshold: exact
        assert got.bq_agreement == want.bq_agreement
        assert got.margin_p30 == want.margin_p30
    assert got.verdict == want.verdict
    assert dataclasses.asdict(got.thresholds) \
        == dataclasses.asdict(want.thresholds)


def assert_policies_match(report, jreport):
    for have_vectors in (True, False):
        for have_ivf in (True, False):
            got = probe.select_policy(report, have_vectors=have_vectors,
                                      have_ivf=have_ivf)
            want = jprobe.select_policy(jreport, have_vectors=have_vectors,
                                        have_ivf=have_ivf)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", CORPORA)
def test_probe_corpus_matches_reference(name):
    base, _ = _corpus(name)
    for sample, seed in ((1024, 0), (512, 3)):
        want = jprobe.probe_corpus(base, sample=sample, seed=seed)
        got = probe.probe_corpus(base, sample=sample, seed=seed,
                                 device="cpu")
        assert_reports_match(got, want)
        assert_policies_match(got, want)
        assert got.summary() == want.summary()


@pytest.mark.parametrize("name", CORPORA)
def test_probe_signatures_matches_reference(name):
    base, _ = _corpus(name)
    words = np.asarray(jbq.encode(jnp.asarray(base)).words)
    dim = base.shape[1]
    want = jprobe.probe_signatures(words, dim, sample=512, seed=1)
    got = probe.probe_signatures(words, dim, sample=512, seed=1,
                                 device="cpu")
    assert_reports_match(got, want)
    assert_policies_match(got, want)
    # int32 bit views on a tensor give the same report
    again = probe.probe_signatures(torch.from_numpy(words.view(np.int32)),
                                   dim, sample=512, seed=1, device="cpu")
    assert_reports_match(again, got)


def test_verdicts_span_the_boundary():
    verdicts = {name: probe.probe_corpus(_corpus(name)[0],
                                         device="cpu").verdict
                for name in CORPORA}
    assert verdicts["minilm-surrogate"] == "green"
    assert verdicts["sift-like"] == "red"
    assert verdicts["random-sphere"] == "red"


def test_percentile_matches_jnp():
    """Against ``jnp.percentile`` compiled, as the reference's probe runs it
    (inside ``jax.jit``, where XLA fuses the interpolation)."""
    pct = jax.jit(jax.vmap(lambda v: jnp.percentile(v, 30.0)))
    rng = np.random.default_rng(0)
    for n in (2, 7, 37, 64, 99):
        m = rng.integers(-300, 3000, (40, n)).astype(np.float32)
        m = m * np.float32(1 / 3072)
        want = np.asarray(pct(jnp.asarray(m)))
        got = [diagnostics.percentile_linear(row, 30.0) for row in m]
        np.testing.assert_array_equal(np.float32(got), want)


def test_report_persistence_and_merge_match_reference():
    reports = [probe.probe_corpus(_corpus(name)[0], sample=256, seed=s,
                                  device="cpu")
               for s, name in enumerate(("minilm-surrogate", "glove-like"))]
    jreports = [jprobe.probe_corpus(_corpus(name)[0], sample=256, seed=s)
                for s, name in enumerate(("minilm-surrogate", "glove-like"))]
    with pytest.raises(ValueError, match="dim mismatch"):
        probe.merge_reports(reports)
    same_dim = [reports[0], dataclasses.replace(reports[0], n_sampled=64,
                                                bq_agreement=float("nan"))]
    jsame = [jreports[0], dataclasses.replace(jreports[0], n_sampled=64,
                                              bq_agreement=float("nan"))]
    assert_reports_match(probe.merge_reports(same_dim),
                         jprobe.merge_reports(jsame))
    fields = reports[0].to_npz_fields()
    jfields = jreports[0].to_npz_fields()
    assert set(fields) == set(jfields)
    for key in fields:
        assert fields[key].dtype == jfields[key].dtype, key
    assert probe.CompatibilityReport.from_npz(fields) == reports[0]
    assert probe.CompatibilityReport.from_npz({}) is None
    pol = probe.NavPolicy(nav="adc", ef_scale=4, adaptive=True,
                          escalate_margin=0.25, source="probe")
    jpol = jprobe.NavPolicy(**dataclasses.asdict(pol))
    assert {k: (v.dtype, v.tolist()) for k, v in pol.to_npz_fields().items()} \
        == {k: (v.dtype, v.tolist()) for k, v in jpol.to_npz_fields().items()}
    assert probe.NavPolicy.from_npz(jpol.to_npz_fields()) == pol
    assert pol.describe() == jpol.describe()


@pytest.mark.parametrize("kw", [
    dict(nav=None, ef=64, adaptive=None), dict(nav="bq2", ef=64,
                                                adaptive=None),
    dict(nav=None, ef=32, adaptive=False),
])
def test_resolve_schedule_matches_reference(kw):
    for pol in (None, probe.NavPolicy(nav="bq2", ef_scale=2, adaptive=True,
                                      escalate_margin=0.3)):
        jpol = None if pol is None \
            else jprobe.NavPolicy(**dataclasses.asdict(pol))
        ef, adaptive, sched = probe.resolve_schedule(pol, **kw)
        jef, jadaptive, jsched = jprobe.resolve_schedule(jpol, **kw)
        assert (ef, adaptive) == (jef, jadaptive)
        assert dataclasses.asdict(sched) == dataclasses.asdict(jsched)


def test_accumulator_matches_reference():
    base, _ = _corpus("minilm-surrogate")
    words = np.asarray(jbq.encode(jnp.asarray(base)).words)
    dim = base.shape[1]
    acc = probe.ProbeAccumulator(dim)
    jacc = jprobe.ProbeAccumulator(dim)
    acc.add(torch.from_numpy(words[:700].view(np.int32)))   # bit views
    jacc.add(words[:700])
    acc.remove(words[100:300])                              # uint32 words
    jacc.remove(words[100:300])
    acc.add(words[700:])
    jacc.add(words[700:])
    for field in ("dim", "n"):
        assert getattr(acc, field) == getattr(jacc, field)
    np.testing.assert_array_equal(acc.pos_counts, jacc.pos_counts)
    np.testing.assert_array_equal(acc.strong_counts, jacc.strong_counts)
    assert acc.sign_entropy == jacc.sign_entropy
    assert acc.strong_entropy == jacc.strong_entropy
    assert repr(acc) == repr(jacc)
    live = np.concatenate([words[:100], words[300:]])
    assert acc == probe.ProbeAccumulator.from_words(live, dim)
    sig = bq.Signature(torch.from_numpy(live.view(np.int32)), dim)
    assert acc == probe.ProbeAccumulator.from_signature(sig)
    assert_reports_match(acc.report(), jacc.report())
    with pytest.raises(ValueError, match="removed more"):
        probe.ProbeAccumulator(dim).remove(words[:1])


# -- build(nav="auto") -------------------------------------------------------


def _fields_of(jindex):
    """A JAX index's archive fields, written and read back."""
    import io
    buf = io.BytesIO()
    jindex.save(buf)
    buf.seek(0)
    with np.load(buf) as z:
        return dict(z)


@pytest.mark.parametrize("name,keep_vectors,nav", [
    ("minilm-surrogate", True, "bq2"),     # green
    ("sift-like", True, "float32"),        # red, cold vectors kept
    ("sift-like", False, "adc"),           # red, vector-free
])
def test_build_auto_matches_reference(name, keep_vectors, nav, monkeypatch):
    base, queries = _corpus(name)
    jindex = JaxIndex.build(jnp.asarray(base),
                            jvamana.BuildParams(**PARAMS), nav="auto",
                            probe_sample=512, keep_vectors=keep_vectors)
    # start the port from the reference's initial graph
    init_adj, _ = jvamana._init_graph(N, jvamana.BuildParams(**PARAMS), 0)
    init = torch.from_numpy(np.array(init_adj))
    monkeypatch.setattr(vamana, "_init_graph",
                        lambda n, params, seed, device: init.to(device))
    index = QuIVerIndex.build(base, vamana.BuildParams(**PARAMS),
                              nav="auto", probe_sample=512,
                              keep_vectors=keep_vectors, device="cpu")
    assert index.metric_kind == jindex.metric_kind == nav
    assert dataclasses.asdict(index.policy) \
        == dataclasses.asdict(jindex.policy)
    assert_reports_match(index.report, jindex.report)
    assert index.memory_breakdown() == jindex.memory_breakdown()
    jids, jscores = jindex.search(jnp.asarray(queries), k=10, ef=32)
    if nav == "bq2":
        # integer distances: the same graph, the same ids
        assert index.medoid == jindex.medoid
        np.testing.assert_array_equal(index.adjacency.numpy(),
                                      np.asarray(jindex.adjacency))
        ids, scores = index.search(queries, k=10, ef=32)
    else:
        # a float-space graph may part from the reference's at a near-tie:
        # the reference's graph, searched by the port under the policy
        ids, scores = convert.index_from_numpy(
            _fields_of(jindex), "cpu").search(queries, k=10, ef=32)
    if keep_vectors:
        np.testing.assert_allclose(scores, np.asarray(jscores), rtol=1e-5,
                                   atol=1e-6)
        tol = 1e-6
    else:
        # vector-free: scores are negated adc distances (up to 2*sqrt(D)),
        # equal to within the float tolerance of their sums
        np.testing.assert_allclose(scores, np.asarray(jscores), rtol=1e-6,
                                   atol=2.5e-4)
        tol = 2.5e-4
    diff = ids != np.asarray(jids)
    assert (np.abs(scores - np.asarray(jscores))[diff] <= tol).all()
    # the policy and the report ride the archive both ways
    fields = convert.index_to_numpy(index)
    loaded = convert.index_from_numpy(fields, "cpu")
    assert loaded.policy == index.policy and loaded.report == index.report
