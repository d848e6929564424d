"""The port's MoE layer and MoE decoders (``repro_torch.models.moe``, the
qwen2-moe and qwen3-moe configs, a dense/MoE alternation) against
``repro.models`` on the CPU, at smoke size.

Inputs are drawn by numpy from a seed; parameters are the reference's,
carried across by ``repro_torch.convert``.  Tolerances, with the
difference measured at these inputs in parentheses:

* dispatch, fed the reference's own ``expert_idx`` (computed with jax):
  ranks, keep mask, slots, the expert buffers' source tokens and the
  dropped fraction bit for bit, against the reference's gather-only
  formulation (``repro/models/moe.py:94-117``, transcribed below and
  vmapped over rows as the reference vmaps ``_row_moe``);
* the MoE layer in float32: outputs within 1e-5 (3e-6), top-k indices
  identical wherever the reference's k-th and (k+1)-th probabilities are
  more than 1e-6 apart, aux within 1e-6; in bf16 within 0.1 (0.03: one
  bf16 ulp of the outputs);
* whole smoke decoders cast to float32: hidden states and logits within
  1e-4 of the reference's scanned forward, the same argmax and greedy
  tokens; against the bf16 KV caches of prefill and decode within 1e-3
  (2.3e-4 measured on the period-2 stack, whose caches hold 8 and 40 of
  4 096 K elements one bf16 ulp apart: float32 values either side of a
  bf16 rounding boundary).  In bf16 the port is held to the reference's
  blocks applied one at a time (``transformer._apply_layer``), logits
  within 0.1 (0.055 measured) and equal
  argmax where the top-2 gap exceeds 0.2: under ``lax.scan`` XLA fuses a
  group's bf16 elementwise chains in float32, which moves a router input
  by a bf16 ulp, and one near-tie flip of a top-k set then moves a token's
  hidden state by ~0.65 (measured between the reference's own scanned and
  block-by-block forwards), where the port and the block-by-block
  reference agree within 0.04;
* ``loss`` (cross entropy + 0.01 load-balance loss) and its gradients in
  float32 against ``jax.value_and_grad`` of the reference's loss: the loss
  and aux within 1e-5, each gradient leaf within a relative L2 of 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.model import build_model as jax_build_model
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.model import build_model
from repro_torch.serve import engine

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

# the two MoE configs, and qwen2-moe with the reference's period-2 pattern
# (dense blocks at even positions, MoE at odd ones)
ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "qwen2-moe-period2")


def _configs(name):
    if name == "qwen2-moe-period2":
        return tuple(
            dataclasses.replace(get("qwen2-moe-a2.7b"), moe_every=2,
                                moe_offset=1).smoke()
            for get in (jax_get_config, get_config))
    return jax_get_config(name).smoke(), get_config(name).smoke()


# -- the reference's dispatch, transcribed ------------------------------------


def _reference_dispatch(expert_idx, e: int, cap: int) -> dict:
    """``repro/models/moe.py``'s dispatch (lines 94-117, 126-130) for a
    (B, T, k) ``expert_idx``, vmapped over rows as the reference vmaps
    ``_row_moe``: ranks, keep mask and slots in pair order, the buffers'
    source tokens."""
    def row(idx):
        n_tok, top_k = idx.shape
        n_pairs = n_tok * top_k
        pairs_e = idx.reshape(-1)
        pairs_tok = jnp.repeat(jnp.arange(n_tok), top_k)
        order = jnp.argsort(pairs_e)
        inv_order = jnp.argsort(order)
        e_s = pairs_e[order]
        tok_s = pairs_tok[order]
        i = jnp.arange(n_pairs)
        boundary = jnp.concatenate([jnp.array([True]), e_s[1:] != e_s[:-1]])
        seg_start = jax.lax.cummax(jnp.where(boundary, i, 0))
        rank = i - seg_start
        keep = rank < cap
        starts = jnp.searchsorted(e_s, jnp.arange(e))
        pos = starts[:, None] + jnp.arange(cap)[None, :]
        pos_c = jnp.minimum(pos, n_pairs - 1)
        valid = (pos < n_pairs) & (e_s[pos_c] == jnp.arange(e)[:, None])
        src_tok = jnp.where(valid, tok_s[pos_c], n_tok)
        rank_orig = rank[inv_order]
        keep_orig = keep[inv_order]
        slot = jnp.where(keep_orig, pairs_e * cap + rank_orig, e * cap)
        return {"rank": rank_orig, "keep": keep_orig, "slot": slot,
                "src_tok": src_tok, "dropped": 1.0 - keep.mean()}

    return jax.tree.map(np.asarray,
                        jax.jit(jax.vmap(row))(jnp.asarray(expert_idx)))


def _reference_routes(x, router_w, top_k):
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32)
                           @ jnp.asarray(router_w), axis=-1)
    gate, idx = jax.lax.top_k(probs, top_k)
    return np.asarray(probs), np.asarray(gate), np.asarray(idx)


def _moe_inputs(b, t, d, *, skew: float, seed: int):
    """(B, T, d) float32 activations of unit RMS, as an RMS-normed block
    input; ``skew`` mixes one shared direction into every token, so the
    router sends most tokens to the same few experts and the capacity drops
    pairs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)) + skew * rng.standard_normal(d)
    return (x / np.sqrt(1.0 + skew ** 2)).astype(np.float32)


def test_capacity_is_the_references():
    for t in (1, 7, 24, 48, 64, 320, 4096):
        for e, k in ((60, 4), (128, 8), (8, 2), (4, 2)):
            for cf in (1.0, 1.25, 2.0):
                assert moe.capacity(t, e, k, cf) == jmoe._cap_for(t, e, k, cf)
    assert moe.capacity(320, 60, 4) == 32 and moe.capacity(1, 60, 4) == 8


def test_route_ties_go_to_the_lower_expert():
    """Exact ties (duplicated router columns): ``lax.top_k`` keeps the lower
    index first, and so does the port's stable descending sort."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    w[:, 5] = w[:, 2]
    w[:, 7] = w[:, 2]
    w[:, 6] = w[:, 0]
    x = rng.standard_normal((2, 30, 16)).astype(np.float32)
    p = moe.MoE(16, 8, 8, device="cpu", dtype=torch.float32)
    p.router.w.data = torch.from_numpy(w)
    for k in (2, 3, 4):
        got = moe.route(p, torch.from_numpy(x), top_k=k, norm_topk=False)
        probs, gate, idx = _reference_routes(x, w, k)
        np.testing.assert_array_equal(got.expert_idx.numpy(), idx)
        np.testing.assert_allclose(got.gate.detach().numpy(), gate,
                                   rtol=1e-6, atol=1e-7)


# (label, B, T, d, E, k, skew): rows long enough to drop, a decode row
# (T = 1, cap 8), the qwen2 (E = 60) and smoke (E = 8) expert counts
DISPATCH_CASES = [
    ("qwen2 prefill, drops", 2, 320, 32, 60, 4, 3.0),
    ("qwen2 decode", 8, 1, 32, 60, 4, 3.0),
    ("smoke E=8, drops", 3, 64, 32, 8, 2, 2.0),
    ("qwen3 E=128 k=8, drops", 2, 48, 32, 128, 8, 2.0),
]


@pytest.mark.parametrize("case", DISPATCH_CASES, ids=lambda c: c[0])
def test_dispatch_is_exact(case):
    label, b, t, d, e, k, skew = case
    x = _moe_inputs(b, t, d, skew=skew, seed=1)
    w = np.random.default_rng(2).standard_normal((d, e)).astype(np.float32)
    _, _, idx = _reference_routes(x, w, k)
    cap = jmoe._cap_for(t, e, k, 1.25)
    want = _reference_dispatch(idx, e, cap)
    got = moe.dispatch(torch.from_numpy(idx.copy()).long(), e, cap)
    np.testing.assert_array_equal(got.rank.numpy(), want["rank"])
    np.testing.assert_array_equal(got.keep.numpy(), want["keep"])
    np.testing.assert_array_equal(got.slot.numpy(), want["slot"])
    np.testing.assert_array_equal(got.src_tok.numpy(), want["src_tok"])
    np.testing.assert_array_equal(
        (1.0 - got.keep.float().mean(dim=1)).numpy(), want["dropped"])
    counts = np.stack([np.bincount(r.reshape(-1), minlength=e)
                       for r in idx])
    np.testing.assert_array_equal(got.counts.numpy(), counts)
    if "drops" in label:
        assert (~want["keep"]).any(axis=1).all(), "every row must drop"
    else:
        assert want["keep"].all()


def _layer_pair(d, f, e, k, shared, dtype, seed=0):
    """The reference's ``init_moe`` and the port's module holding it."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, f, e, k,
                       n_shared_experts=shared, dtype=jdt)
    p = moe.MoE(d, f, e, n_shared_experts=shared, device="cpu", dtype=dtype)
    with torch.no_grad():
        p.router.w.copy_(convert._tensor(np.asarray(jp["router"]["w"])))
        for n in ("w1", "w3", "w2"):
            getattr(p, n).copy_(convert._tensor(np.asarray(jp[n])))
            if shared:
                getattr(p.shared, n).copy_(
                    convert._tensor(np.asarray(jp["shared"][n])))
    return jp, p


# (label, B, T, d, f, E, k, shared, skew)
LAYER_CASES = [
    ("qwen2-like", 2, 48, 64, 128, 60, 4, 4, 0.0),
    ("qwen2-like drops", 2, 96, 64, 128, 60, 4, 4, 3.0),
    ("qwen3-like", 2, 40, 64, 32, 128, 8, 0, 0.5),
    ("smoke E=8 drops, decode", 4, 1, 64, 128, 8, 2, 2, 2.0),
]


@pytest.mark.parametrize("case", LAYER_CASES, ids=lambda c: c[0])
def test_moe_layer_float32(case):
    label, b, t, d, f, e, k, shared, skew = case
    jp, p = _layer_pair(d, f, e, k, shared, torch.float32)
    x = _moe_inputs(b, t, d, skew=skew, seed=3)
    want, jaux = jax.jit(functools.partial(jmoe.moe, top_k=k))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        got, aux = moe.moe(p, torch.from_numpy(x), top_k=k)
        routing = moe.route(p, torch.from_numpy(x), top_k=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    for key in ("load_balance_loss", "dropped_fraction"):
        assert abs(aux[key].item() - float(jaux[key])) <= 1e-6, key
    probs, _, idx = _reference_routes(x, jp["router"]["w"], k)
    ranked = -np.sort(-probs, axis=-1)
    clear = ranked[..., k - 1] - ranked[..., k] > 1e-6
    np.testing.assert_array_equal(routing.expert_idx.numpy()[clear],
                                  idx[clear])
    if "drops" in label and t > 1:
        assert float(jaux["dropped_fraction"]) > 0


@pytest.mark.parametrize("case", LAYER_CASES[:2], ids=lambda c: c[0])
def test_moe_layer_bf16(case):
    label, b, t, d, f, e, k, shared, skew = case
    jp, p = _layer_pair(d, f, e, k, shared, torch.bfloat16)
    x = _moe_inputs(b, t, d, skew=skew, seed=4)
    jx = jnp.asarray(x, jnp.bfloat16)
    want, _ = jax.jit(functools.partial(jmoe.moe, top_k=k))(jp, jx)
    with torch.no_grad():
        got, _ = moe.moe(p, convert._tensor(np.asarray(jx)), top_k=k)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - np.asarray(want, np.float32)).max() \
        <= 0.1


# -- whole smoke decoders ------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """A reference smoke MoE decoder, its parameters in bf16 (as drawn) and
    cast to float32, and the port's module of each."""
    jcfg, cfg = _configs(request.param)
    bundle = jax_build_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    ports = {key: convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, p), cfg, device="cpu")
        for key, p in (("bf16", params), ("f32", params32))}
    return {"name": request.param, "cfg": cfg, "jcfg": jcfg,
            "bundle": bundle, "params": {"bf16": params, "f32": params32},
            "ports": ports}


def _layer_params(params, group, pos):
    return jax.tree.map(lambda a: a[group], params["layers"][pos])


def _reference_blocks(params, jcfg, x, caches=None, cache_pos=None):
    """The reference's blocks applied one at a time (each op rounded to its
    dtype, as the port computes), caches updated group by group; returns
    (final-normed hidden, caches)."""
    from repro.models.layers import rmsnorm

    period, groups = jcfg.pattern()
    caches = None if caches is None else list(caches)
    for g in range(groups):
        for pos in range(period):
            cache = None if caches is None else jax.tree.map(
                lambda a: a[g], caches[pos])
            x, new, _ = jtf._apply_layer(
                _layer_params(params, g, pos), x, jcfg,
                jcfg.layer_kind(pos), jcfg.layer_has_moe(pos), cache=cache,
                cache_pos=cache_pos)
            if caches is not None:
                caches[pos] = jax.tree.map(lambda a, n: a.at[g].set(n),
                                           caches[pos], new)
    return rmsnorm(params["final_norm"], x, jcfg.norm_eps), caches


def _check_logits(got, want, key, f32_tol=1e-4):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    real = want > -1e29                # padded vocabulary slots are -1e30
    assert (got[~real] == want[~real]).all()
    if key == "f32":
        np.testing.assert_allclose(got, want, atol=f32_tol, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        return
    assert np.abs(got - want)[real].max() <= 0.1
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 0.2
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


@pytest.mark.parametrize("key", ["f32", "bf16"])
def test_forward_hidden_logits_and_aux(ref, key):
    jcfg, params, model = ref["jcfg"], ref["params"][key], ref["ports"][key]
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 24))
    jx = jtf.embed_tokens(params, jcfg, jnp.asarray(tokens))
    if key == "f32":
        jh, jaux = jtf.forward_hidden(params, jcfg, jx)
    else:
        jh, _ = _reference_blocks(params, jcfg, jx)
    with torch.no_grad():
        h, aux = tf.forward_hidden(model, tf.embed_tokens(
            model, torch.from_numpy(tokens)))
        got = tf.logits_from_hidden(model, h)
    want = jtf.logits_from_hidden(params, jcfg, jh)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _check_logits(got, want, key)
    if key == "f32":
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4,
                                   rtol=0)
        for name in ("load_balance_loss", "dropped_fraction"):
            assert abs(aux[name].item() - float(jaux[name])) <= 1e-5, name
    period, _ = jcfg.pattern()
    n_moe = sum(hasattr(blk, "moe") for blk in model.blocks)
    assert n_moe == sum(jcfg.layer_has_moe(i % period)
                        for i in range(jcfg.n_layers))
    assert 0.0 <= aux["dropped_fraction"].item() <= n_moe


@pytest.mark.parametrize("key", ["f32", "bf16"])
def test_prefill_and_decode(ref, key):
    """Prefill 24 tokens, then 4 decode steps fed the reference's greedy
    tokens, against bf16 caches."""
    cfg, bundle, jcfg = ref["cfg"], ref["bundle"], ref["jcfg"]
    params, model = ref["params"][key], ref["ports"][key]
    port = build_model(cfg)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 24))
    jcaches = bundle.init_caches(2, 32)
    caches = port.init_caches(2, 32, device="cpu")
    if key == "f32":
        want, jcaches = bundle.prefill(
            params, {"tokens": jnp.asarray(tokens)}, jcaches)
    else:
        jh, jcaches = _reference_blocks(
            params, jcfg, jtf.embed_tokens(params, jcfg, jnp.asarray(tokens)),
            jcaches, 0)
        want = jtf.logits_from_hidden(params, jcfg, jh[:, -1:])[:, 0]
    got, caches = port.prefill(model, {"tokens": tokens}, caches)
    _check_logits(got, want, key, f32_tol=1e-3)
    for pos in range(24, 28):
        tok = np.asarray(want).argmax(-1)[:, None]
        if key == "f32":
            want, jcaches = bundle.decode(params, jnp.asarray(tok), jcaches,
                                          jnp.int32(pos))
        else:
            jh, jcaches = _reference_blocks(
                params, jcfg, jtf.embed_tokens(params, jcfg, jnp.asarray(tok)),
                jcaches, pos)
            want = jtf.logits_from_hidden(params, jcfg, jh)[:, 0]
        got, caches = port.decode(model, tok, caches, pos)
        _check_logits(got, want, key, f32_tol=1e-3)
    assert caches.k.shape == (cfg.n_layers, 2, 32, cfg.n_kv_heads,
                              cfg.head_dim_)
    assert not caches.k[:, :, 28:].any()


def test_generate_greedy_tokens(ref):
    """``ServeEngine.generate`` in float32: the reference's greedy tokens."""
    prompts = np.random.default_rng(5).integers(
        0, ref["cfg"].vocab_size, (3, 10)).astype(np.int32)
    want = jengine.ServeEngine(ref["bundle"], ref["params"]["f32"],
                               max_seq=32).generate(prompts, max_new=8)
    got = engine.ServeEngine(build_model(ref["cfg"]), ref["ports"]["f32"],
                             max_seq=32, device="cpu").generate(prompts,
                                                                max_new=8)
    np.testing.assert_array_equal(got, np.asarray(want))


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / norm) if norm else \
        float(np.linalg.norm(got))


def _loss_batch(vocab):
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, vocab, (4, 24)),
             "labels": rng.integers(0, vocab, (4, 24))}
    batch["labels"][:, :3] = -1
    return batch


def test_loss_and_gradients(ref):
    """``loss`` = CE + 0.01 load-balance loss, its metrics and every
    gradient (the router's, through the gates and the aux loss, included)
    against ``jax.value_and_grad`` of the reference's loss, in float32."""
    jcfg, cfg = ref["jcfg"], ref["cfg"]
    params = ref["params"]["f32"]
    batch = _loss_batch(cfg.vocab_size)
    grad_fn = jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss,
                                         has_aux=True))
    (jl, jm), jg = grad_fn(params, {k: jnp.asarray(v.astype(np.int32))
                                    for k, v in batch.items()})
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, device="cpu")
    loss, metrics = build_model(cfg).loss(model, batch)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5
    for key in ("ce", "load_balance_loss", "dropped_fraction"):
        assert abs(metrics[key].item() - float(jm[key])) <= 1e-5, key
    assert metrics["load_balance_loss"].item() > 0
    grads = convert.named_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}, model)
    got_l = jax.tree_util.tree_leaves_with_path(grads)
    want_l = jax.tree_util.tree_leaves_with_path(jg)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        assert _rel_l2(g, w) <= 1e-4, (path, _rel_l2(g, w))
    for blk in model.blocks:
        if hasattr(blk, "moe"):
            assert blk.moe.router.w.grad.abs().sum() > 0


def test_remat_carries_aux_and_gradients(ref):
    """Remat (``torch.utils.checkpoint`` around each block, run again in
    its backward) carries the aux tuple and changes no loss, metric or
    gradient, bit for bit."""
    batch = _loss_batch(ref["cfg"].vocab_size)
    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(ref["cfg"], remat=remat)
        model = convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, ref["params"]["f32"]), cfg,
            device="cpu")
        loss, metrics = build_model(cfg).loss(model, batch)
        loss.backward()
        runs.append((metrics, {n: p.grad for n, p in
                               model.named_parameters()}))
    (m0, g0), (m1, g1) = runs
    for key in ("ce", "load_balance_loss", "dropped_fraction"):
        assert torch.equal(m0[key], m1[key]), key
    for n, g in g0.items():
        assert torch.equal(g, g1[n]), n


def test_params_round_trip(ref):
    """The reference's pytree out and in again, with the router float32
    whatever the matrices' dtype (``keep_bf16`` too), block *i* at index
    ``i // P`` of pattern position ``i % P``."""
    cfg = ref["cfg"]
    period, _ = cfg.pattern()
    model = ref["ports"]["bf16"]
    for keep in (False, True):
        tree = convert.lm_params_to_numpy(model, keep_bf16=keep)
        assert len(tree["layers"]) == period
        for pos in range(period):
            leaf = tree["layers"][pos]
            assert ("moe" in leaf) == cfg.layer_has_moe(pos)
            if "moe" in leaf:
                router = leaf["moe"]["router"]["w"]
                assert router.dtype == np.float32
                assert router.shape == (cfg.n_layers // period, cfg.d_model,
                                        cfg.n_experts)
                assert ("shared" in leaf["moe"]) == bool(cfg.n_shared_experts)
        again = convert.lm_params_from_numpy(tree, cfg, device="cpu",
                                             dtype=torch.bfloat16)
        for (n1, p1), (n2, p2) in zip(model.state_dict().items(),
                                      again.state_dict().items()):
            assert n1 == n2 and p1.dtype == p2.dtype
            assert torch.equal(p1, p2), n1
    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref["params"]["bf16"])
    got = convert.lm_params_to_numpy(model)
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(got)
    assert tree_g == tree_w
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_array_equal(a, b)
    for blk in model.blocks:
        if hasattr(blk, "moe"):
            assert blk.moe.router.w.dtype == torch.float32
            assert blk.moe.w1.dtype == torch.bfloat16


def test_period2_blocks_and_leaves():
    """Block *i* holds an MoE where ``layer_has_moe(i % P)``; its tensors
    sit at index ``i // P`` of the reference's leaf for position ``i % P``."""
    _, cfg = _configs("qwen2-moe-period2")
    model = tf.DecoderLM(cfg, device="meta")
    assert [hasattr(b, "moe") for b in model.blocks] == \
        [False, True, False, True]
    leaves = tf.reference_leaves(model)
    assert leaves[("layers", 0, "mlp", "w1", "w")] == \
        ["blocks.0.mlp.w1.w", "blocks.2.mlp.w1.w"]
    assert leaves[("layers", 1, "moe", "router", "w")] == \
        ["blocks.1.moe.router.w", "blocks.3.moe.router.w"]
    assert leaves[("layers", 1, "attn", "wq", "w")] == \
        ["blocks.1.attn.wq.w", "blocks.3.attn.wq.w"]
    assert tf.matrix_param_count(model) == cfg.param_count()


def test_init_decoder_moe_distributions():
    """The reference's distributions (not its draws): router normal /
    sqrt(d) in float32, experts normal / sqrt(d_in) each, the shared
    experts' down projection / sqrt(n_shared d_ff); seeded, repeatable."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").smoke(),
                              d_model=256, d_ff=256)
    bundle = build_model(cfg)
    a = bundle.init(7, device="cpu")
    b = bundle.init(7, device="cpu")
    for (name, p), (_, q) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(p, q), name
    m = a.blocks[0].moe
    assert m.router.w.dtype == torch.float32
    assert abs(m.router.w.std().item() * 256 ** 0.5 - 1.0) < 0.05
    for w, d_in in ((m.w1, 256), (m.w3, 256), (m.w2, 256),
                    (m.shared.w1, 256), (m.shared.w2, 2 * 256)):
        assert w.dtype == torch.bfloat16
        assert abs(w.float().std().item() * d_in ** 0.5 - 1.0) < 0.05
