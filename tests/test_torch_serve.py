"""The port's LM serving (``ServeEngine``, ``mean_pool_embedder``,
``Retriever``) against ``repro.serve.engine`` on the CPU, at smoke size.

With the reference's parameters cast to float32 (its KV caches stay bf16 in
both packages) greedy tokens are identical: logits agree within ~3e-6
(``tests/test_torch_lm.py``), far below these prompts' top-2 gaps.
Embeddings agree within 1e-5 in float32 and 2e-2 in bf16 (the mean is
rounded to bf16 in both).  Retrieval over one index (built by the reference
and carried across by ``repro_torch.convert``) with one embedding function
gives identical augmented prompts, blanked ids included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core.index import QuIVerIndex as JaxIndex
from repro.core.vamana import BuildParams as JaxParams
from repro.models.model import build_model as jax_build_model
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import build_model
from repro_torch.serve import engine

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

BUILD = dict(m=4, ef_construction=24, prune_pool=24, chunk=128)


@pytest.fixture(scope="module",
                params=["minicpm-2b", "yi-34b", "qwen2-moe-a2.7b"])
def lm(request):
    jcfg = jax_get_config(request.param).smoke()
    cfg = get_config(request.param).smoke()
    jbundle = jax_build_model(jcfg)
    params = jbundle.init(jax.random.PRNGKey(0))
    out = {"cfg": cfg, "jbundle": jbundle, "bundle": build_model(cfg),
           "params": {}, "models": {}}
    for key, p in (("bf16", params), ("f32", jax.tree.map(
            lambda a: a.astype(jnp.float32), params))):
        out["params"][key] = p
        out["models"][key] = convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, p), cfg, device="cpu")
    return out


@pytest.fixture(scope="module")
def rag(lm, tmp_path_factory):
    """A 300-document corpus embedded by the reference (float32
    parameters), indexed by the reference and loaded into the port."""
    cfg = lm["cfg"]
    rng = np.random.default_rng(11)
    corpus = rng.integers(0, cfg.vocab_size, (300, 8)).astype(np.int32)
    jembed = jengine.mean_pool_embedder(lm["jbundle"], lm["params"]["f32"])
    emb = np.asarray(jembed(jnp.asarray(corpus)))
    jindex = JaxIndex.build(jnp.asarray(emb), JaxParams(**BUILD))
    path = tmp_path_factory.mktemp("rag") / "index.npz"
    jindex.save(str(path))
    with np.load(path) as z:
        index = convert.index_from_numpy(dict(z), device="cpu")
    return {"corpus": corpus, "jembed": jembed, "jindex": jindex,
            "index": index}


def _prompts(cfg, b=3, s=10, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_generate_matches_reference(lm):
    prompts = _prompts(lm["cfg"])
    want = jengine.ServeEngine(lm["jbundle"], lm["params"]["f32"],
                               max_seq=32).generate(prompts, max_new=8)
    got = engine.ServeEngine(lm["bundle"], lm["models"]["f32"], max_seq=32,
                             device="cpu").generate(prompts, max_new=8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("key", ["f32", "bf16"])
def test_mean_pool_embedder(lm, key):
    tokens = _prompts(lm["cfg"], b=4, s=12, seed=6)
    want = jengine.mean_pool_embedder(lm["jbundle"], lm["params"][key])(
        jnp.asarray(tokens))
    got = engine.mean_pool_embedder(lm["bundle"], lm["models"][key])(tokens)
    assert got.dtype == torch.float32 and got.shape == (4, 64)
    tol = 1e-5 if key == "f32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_augment_matches_reference(lm, rag):
    """One embedding function and one index: identical augmented prompts.
    The token store lags the index by 60 documents, so every id past it
    is blanked with the pad token in both."""
    def embed_fn(tokens):
        return np.asarray(rag["jembed"](jnp.asarray(np.asarray(tokens))))

    store = rag["corpus"][:240]
    prompts = _prompts(lm["cfg"], b=16, s=10, seed=7)
    kw = dict(doc_tokens=store, embed_fn=embed_fn, k=4, ef=16, pad_token=7)
    want = jengine.Retriever(index=rag["jindex"], **kw).augment(prompts)
    got = engine.Retriever(index=rag["index"], **kw).augment(prompts)
    assert got.shape == (16, 4 * 8 + 10)
    np.testing.assert_array_equal(got, np.asarray(want))
    ids, _ = rag["index"].search(embed_fn(prompts), k=4, ef=16)
    blanked = ids >= len(store)
    assert blanked.any() and (~blanked).any()
    ctx = got[:, :32].reshape(16, 4, 8)
    assert (ctx[blanked] == 7).all()
    np.testing.assert_array_equal(ctx[~blanked], store[ids[~blanked]])


def test_rag_generate_matches_reference(lm, rag):
    """The whole smoke RAG path in float32: each package embeds with its
    own LM, searches the same index, prefills and decodes."""
    prompts = _prompts(lm["cfg"], b=3, s=10, seed=8)
    jret = jengine.Retriever(index=rag["jindex"], doc_tokens=rag["corpus"],
                             embed_fn=rag["jembed"], k=2, ef=32)
    want = jengine.ServeEngine(lm["jbundle"], lm["params"]["f32"],
                               max_seq=48).generate(prompts, max_new=6,
                                                    retriever=jret)
    model = lm["models"]["f32"]
    ret = engine.Retriever(index=rag["index"], doc_tokens=rag["corpus"],
                           embed_fn=engine.mean_pool_embedder(lm["bundle"],
                                                              model),
                           k=2, ef=32)
    np.testing.assert_array_equal(ret.augment(prompts),
                                  jret.augment(prompts))
    got = engine.ServeEngine(lm["bundle"], model, max_seq=48,
                             device="cpu").generate(prompts, max_new=6,
                                                    retriever=ret)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_sampling_is_seeded(lm):
    eng = engine.ServeEngine(lm["bundle"], lm["models"]["bf16"], max_seq=32,
                             device="cpu")
    prompts = _prompts(lm["cfg"])
    a = eng.generate(prompts, max_new=8, temperature=0.8, seed=3)
    b = eng.generate(prompts, max_new=8, temperature=0.8, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < lm["cfg"].vocab_size
    with pytest.raises(AssertionError):
        eng.generate(prompts, max_new=23)


def test_unported_options_raise(lm, rag):
    """``Retriever(engine=...)``, once refused, routes through the
    port's ``QueryEngine``: the prompts of the reference's engine-routed
    retriever, and of the direct one; growing the corpus still needs a
    mutable index, as in the reference."""
    def embed_fn(tokens):
        return np.asarray(rag["jembed"](jnp.asarray(np.asarray(tokens))))

    prompts = _prompts(lm["cfg"], b=6, s=10, seed=8)
    kw = dict(doc_tokens=rag["corpus"], embed_fn=embed_fn, k=3, ef=16)
    jeng = jengine.QueryEngine(rag["jindex"], obs=False)
    peng = engine.QueryEngine(rag["index"], obs=False)
    want = jengine.Retriever(index=rag["jindex"], engine=jeng,
                             **kw).augment(prompts)
    ret = engine.Retriever(index=rag["index"], engine=peng, **kw)
    got = ret.augment(prompts)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        got, engine.Retriever(index=rag["index"], **kw).augment(prompts))
    assert peng.stats.requests == 1 and peng.stats.done == 1
    with pytest.raises(TypeError, match="mutable index"):
        ret.add_documents(rag["corpus"][:2])


def test_launch_serve_smoke_on_cpu(capsys):
    assert launch_serve.main(["--arch", "minicpm-2b", "--smoke", "--device",
                              "cpu", "--rag", "--batch", "2",
                              "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "RAG enabled over 256 docs" in out and "seq 1:" in out
    assert launch_serve.main(["--arch", "minicpm-2b", "--device",
                              "cpu"]) == 1
