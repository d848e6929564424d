"""The port's hybrid decoder (``jamba-v0.1-52b``: mamba layers with
attention at one pattern position in 8 and MoE on every second layer)
against ``repro.models`` on the CPU, at smoke size (16 layers: 14 mamba, 2
attention, 8 MoE; d 64).

The reference's parameters are carried across by
``convert.lm_params_from_numpy``; inputs are drawn by numpy from a seed.
Tolerances follow ``tests/test_torch_lm.py``'s ``_check_logits`` and
``tests/test_torch_moe.py``, with the difference measured at these inputs
in parentheses:

* cast to float32: hidden states and logits within 1e-4 of the reference's
  scanned forward, the same argmax; prefill and decode against the bf16
  KV caches within 1e-3 (the attention layers' caches hold float32 values
  either side of a bf16 rounding boundary, as in ``test_torch_moe.py``),
  the mamba states within 1e-3 (3.0e-4 measured);
* in bf16 two implementations of the 16-layer stack are not comparable
  logit for logit: the reference's own scanned forward and its blocks
  applied one at a time differ by 0.67 in a logit even with the MoE taken
  out, its bf16 forward differs from its float32 forward of the same
  weights by up to 2.6 (0.2 in the mean), and a router near-tie flipped at
  one token (0.78 in its hidden state, measured at the first MoE layer) is
  carried by every later mamba layer to every later token of the row.  So
  each of the port's blocks is held to the reference's
  ``transformer._apply_layer`` on the reference's input (and, serving, its
  state of that layer): every token of the outputs, of the mamba states
  and of the KV rows within 2^-5 of the largest value (four bf16 ulps;
  0.63 of that bound measured), but for at most 2% of the (token, MoE
  block) pairs, which take another expert set at a router near-tie; and
  the whole bf16 stack drifts from the float32 truth no more than 1.5 x
  the reference's own bf16 stack does;
* ``loss`` and its gradients in float32 against ``jax.value_and_grad``:
  the loss and aux within 1e-5, each gradient leaf within a relative L2 of
  1e-4;
* the port's own prefill of S - 1 tokens and one decode step against its
  teacher-forced forward, in float32: the reference's own rule
  (``tests/test_models_consistency.py``) for a stack with MoE, more than
  0.9 of the logits within 5e-2 and equal argmax; with the MoE taken out
  and float32 serving state, every logit within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import transformer as jtf
from repro.models.model import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf
from repro_torch.models.model import build_model
from repro_torch.serve import engine

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"


@pytest.fixture(scope="module")
def ref():
    """The reference's smoke jamba, its parameters in bf16 (as drawn) and
    cast to float32, the port's module of each, and the reference's
    jitted prefill and decode."""
    jcfg, cfg = jax_get_config(ARCH).smoke(), get_config(ARCH).smoke()
    bundle = jax_build_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    ports = {key: convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, p), cfg, device="cpu")
        for key, p in (("bf16", params), ("f32", params32))}
    def forward(p, tokens):
        h, aux = jtf.forward_hidden(p, jcfg, jtf.embed_tokens(p, jcfg,
                                                              tokens))
        return h, aux, jtf.logits_from_hidden(p, jcfg, h)

    return {"cfg": cfg, "jcfg": jcfg, "bundle": bundle,
            "params": {"bf16": params, "f32": params32}, "ports": ports,
            "forward": jax.jit(forward),
            "prefill": jax.jit(bundle.prefill),
            "decode": jax.jit(bundle.decode)}


def _check_logits(got, want, tol=1e-4):
    """``test_torch_lm.py``'s float32 rule: within ``tol``, equal argmax,
    the padded vocabulary slots equal."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    real = want > -1e29                # padded vocabulary slots are -1e30
    assert (got[~real] == want[~real]).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_blocks_follow_the_pattern(ref):
    """Block *i* holds the mixer of ``layer_kind(i % 8)`` (attention at 4
    and 12) and an MoE where ``layer_has_moe(i % 8)``; the serving state is
    a list of one entry a layer: KV caches for attention, bf16 conv and
    float32 ssm states for mamba."""
    cfg, model = ref["cfg"], ref["ports"]["bf16"]
    kinds = ["attn" if hasattr(blk, "attn") else "mamba"
             for blk in model.blocks]
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [4, 12]
    assert all(hasattr(blk, "moe") == (i % 2 == 1)
               for i, blk in enumerate(model.blocks))
    assert all(hasattr(blk, "mlp") != hasattr(blk, "moe")
               for blk in model.blocks)
    caches = build_model(cfg).init_caches(3, 20, device="cpu")
    assert isinstance(caches, list) and len(caches) == cfg.n_layers
    d_inner = cfg.ssm_expand * cfg.d_model
    for kind, c in zip(kinds, caches):
        if kind == "attn":
            assert isinstance(c, attn_mod.KVCache)
            assert c.k.shape == (3, 20, cfg.n_kv_heads, cfg.head_dim_)
            assert c.k.dtype == torch.bfloat16
        else:
            conv, ssm = c
            assert conv.shape == (3, cfg.d_conv - 1, d_inner)
            assert conv.dtype == torch.bfloat16
            assert ssm.shape == (3, d_inner, cfg.d_state)
            assert ssm.dtype == torch.float32
    blk = model.blocks[0].mamba
    assert blk.a_log.dtype == blk.dt_bias.dtype == torch.float32
    assert blk.in_proj.w.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "minicpm-2b",
                                  "qwen2-moe-a2.7b", "internvl2-2b"])
def test_layer_kinds_name_every_block(arch):
    """``transformer.layer_kinds`` gives each layer the reference's
    ``layer_kind`` of its pattern position, and each block holds that
    mixer."""
    cfg, jcfg = get_config(arch).smoke(), jax_get_config(arch).smoke()
    period, _ = jcfg.pattern()
    kinds = tf.layer_kinds(cfg)
    assert kinds == [jcfg.layer_kind(i % period)
                     for i in range(jcfg.n_layers)]
    model = tf.DecoderLM(cfg, device="meta")
    assert kinds == ["mamba" if hasattr(blk, "mamba") else "attn"
                     for blk in model.blocks]


def test_forward_hidden_and_logits(ref):
    """Cast to float32: the reference's scanned forward."""
    jcfg, params, model = ref["jcfg"], ref["params"]["f32"], \
        ref["ports"]["f32"]
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 24))
    jh, jaux, want = ref["forward"](params, jnp.asarray(tokens))
    with torch.no_grad():
        h, aux = tf.forward_hidden(model, tf.embed_tokens(
            model, torch.from_numpy(tokens)))
        got = tf.logits_from_hidden(model, h)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _check_logits(got, want)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
    for name in ("load_balance_loss", "dropped_fraction"):
        assert abs(aux[name].item() - float(jaux[name])) <= 1e-5, name


@pytest.mark.parametrize("key", ["f32", "bf16"])
def test_prefill_and_decode(ref, key):
    """Prefill 24 tokens, then 4 decode steps fed the reference's greedy
    tokens, the mamba states carried and the attention layers' bf16 KV
    caches written.  float32: whole stacks, the reference's jitted
    prefill and decode; bf16: each of the port's blocks fed the
    reference's input and serving state at every step (see
    :func:`_bf16_blocks`)."""
    cfg, bundle, jcfg = ref["cfg"], ref["bundle"], ref["jcfg"]
    params, model = ref["params"][key], ref["ports"][key]
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 24))
    if key == "bf16":
        _bf16_blocks(ref, tokens, serving=True)
        return
    port = build_model(cfg)
    jcaches = bundle.init_caches(2, 32)
    caches = port.init_caches(2, 32, device="cpu")
    want, jcaches = ref["prefill"](params, {"tokens": jnp.asarray(tokens)},
                                   jcaches)
    with torch.no_grad():
        got, caches = port.prefill(model, {"tokens": tokens}, caches)
    _check_logits(got, want, 1e-3)
    for pos in range(24, 28):
        tok = np.asarray(want).argmax(-1)[:, None]
        want, jcaches = ref["decode"](params, jnp.asarray(tok), jcaches,
                                      jnp.int32(pos))
        with torch.no_grad():
            got, caches = port.decode(model, tok, caches, pos)
        _check_logits(got, want, 1e-3)
    period, _ = cfg.pattern()
    for i, c in enumerate(caches):
        pos, g = i % period, i // period
        if isinstance(c, attn_mod.KVCache):
            assert not c.k[:, 28:].any()
            continue
        jconv, jssm = (np.asarray(a[g], np.float32) for a in jcaches[pos])
        # float32 like the reference's: the model's inputs, not rounded
        assert c[0].dtype == torch.float32 and c[1].dtype == torch.float32
        np.testing.assert_allclose(c[0].numpy(), jconv, atol=1e-3, rtol=0)
        np.testing.assert_allclose(c[1].numpy(), jssm, atol=1e-3, rtol=0)


_jit_layer = jax.jit(jtf._apply_layer, static_argnums=(2, 3, 4))


def _beyond_bf16(got, want) -> int:
    """The tokens (rows of the last axis) of ``got`` farther from ``want``
    than 2^-5 max |want|: four bf16 ulps of the largest value (bf16 products
    and activations round at other places in the two frameworks, e.g. a
    sigmoid, and an output near zero carries the rounding of the larger
    terms it sums; 0.28 of the bound measured, 0.63 in a decode step's
    2 tokens)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    bound = 2 ** -5 * np.abs(want).max()
    return int((np.abs(got - want) > bound).any(axis=-1).sum())


def _bf16_blocks(ref, tokens, *, serving: bool):
    """In bf16 the whole 16-layer stacks are not comparable (module
    docstring): hold each of the port's blocks, fed the reference's input
    (and, ``serving``, its serving state of that layer), to the
    reference's ``_apply_layer`` (jitted: eager, each new shape compiles
    every op again).  Every token of the output, of the new conv and
    float32 ssm states (whose inputs are the bf16 activations) and of the
    KV rows written within four bf16 ulps of the largest value
    (:func:`_beyond_bf16`), but in an MoE block, where a token whose router
    input sits at a near-tie may take another expert set: there at most 2
    tokens of a step, and at most 2% of the (token, MoE block) pairs in all
    (3 of 448 measured: one token each in blocks 3, 7 and 15 of the
    prefill; 2 of 384 in the forward, in block 15).  ``serving``: a prefill
    of ``tokens`` and 4 decode steps of the reference's greedy tokens; else
    the forward without state."""
    from repro.models.layers import rmsnorm

    jcfg, cfg = ref["jcfg"], ref["cfg"]
    params, model = ref["params"]["bf16"], ref["ports"]["bf16"]
    period, _ = jcfg.pattern()
    b, t = tokens.shape
    jcaches = ref["bundle"].init_caches(b, 32) if serving else None
    steps = [(tokens, 0)] + ([(None, t + i) for i in range(4)]
                             if serving else [])
    flipped = pairs = 0
    for tok, pos in steps:
        if tok is None:
            tok = np.asarray(logits).argmax(-1)[:, None]   # noqa: F821
        x = jtf.embed_tokens(params, jcfg, jnp.asarray(tok))
        for i, blk in enumerate(model.blocks):
            p, g = i % period, i // period
            cache = None if jcaches is None else jax.tree.map(
                lambda a: a[g], jcaches[p])
            xn, new, _ = _jit_layer(
                jax.tree.map(lambda a: a[g], params["layers"][p]), x, jcfg,
                jcfg.layer_kind(p), jcfg.layer_has_moe(p), cache=cache,
                cache_pos=None if cache is None else jnp.int32(pos))
            port_cache = None
            if cache is not None:
                host = [torch.from_numpy(np.array(a, np.float32)).to(
                    torch.float32 if a.dtype == jnp.float32
                    else torch.bfloat16) for a in cache]
                port_cache = attn_mod.KVCache(*host) \
                    if jcfg.layer_kind(p) == "attn" else tuple(host)
            with torch.no_grad():
                got, _, state = tf._apply_block(
                    blk, torch.from_numpy(np.asarray(x, np.float32))
                    .bfloat16(), cfg, cache=port_cache,
                    cache_pos=pos if serving else None)
            beyond = _beyond_bf16(got, xn)
            if hasattr(blk, "moe"):
                assert beyond <= 2, (i, pos, beyond)
                flipped += beyond
                pairs += tok.size
            else:
                assert beyond == 0, (i, pos, beyond)
            if cache is not None:
                if jcfg.layer_kind(p) == "attn":
                    rows = slice(pos, pos + tok.shape[1])
                    for got_kv, want_kv in ((state.k, new.k),
                                            (state.v, new.v)):
                        assert _beyond_bf16(got_kv[:, rows],
                                            want_kv[:, rows]) == 0, (i, pos)
                else:
                    for got_s, want_s in zip(state, new):
                        assert _beyond_bf16(got_s, want_s) == 0, (i, pos)
                jcaches[p] = jax.tree.map(
                    lambda a, n: a.at[g].set(n.astype(a.dtype)), jcaches[p],
                    new)
            x = xn
        h = rmsnorm(params["final_norm"], x, jcfg.norm_eps)
        logits = jtf.logits_from_hidden(params, jcfg, h[:, -1:])[:, 0]
    assert flipped <= 0.02 * pairs, (flipped, pairs)


def test_bf16_blocks_one_at_a_time(ref):
    """bf16, the forward without state: each block against the
    reference's on the reference's input."""
    tokens = np.random.default_rng(3).integers(0, ref["cfg"].vocab_size,
                                               (2, 24))
    _bf16_blocks(ref, tokens, serving=False)


def test_bf16_stack_drifts_no_more_than_the_reference(ref):
    """The whole bf16 stack against the float32 truth (the reference's
    float32 forward of the same bf16 weights): the port's mean |logit
    error| at most 1.5 x the reference's own bf16 forward's (measured
    0.95-1.16 x over three seeds; each about 0.2), and no larger than
    1.5 x its largest (2.6 measured)."""
    jcfg = ref["jcfg"]
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 24))
    truth, ref_bf16 = (np.asarray(ref["forward"](
        ref["params"][key], jnp.asarray(tokens))[2], np.float32)
        for key in ("f32", "bf16"))
    model = ref["ports"]["bf16"]
    with torch.no_grad():
        h, _ = tf.forward_hidden(model, tf.embed_tokens(
            model, torch.from_numpy(tokens)))
        got = tf.logits_from_hidden(model, h).numpy()
    real = truth > -1e29
    assert (got[~real] == truth[~real]).all()
    e_ref = np.abs(ref_bf16 - truth)[real]
    e_port = np.abs(got - truth)[real]
    assert np.isfinite(got).all()
    assert e_port.mean() <= 1.5 * e_ref.mean(), (e_port.mean(), e_ref.mean())
    assert e_port.max() <= 1.5 * e_ref.max(), (e_port.max(), e_ref.max())


def test_prefill_then_decode_matches_teacher_forced(ref):
    """The port's serving state against its own forward: logits of a
    prefill of 11 tokens and of the 12th decoded, against the forward over
    all 12 (as ``tests/test_models_consistency.py`` holds the reference)."""
    cfg, model = ref["cfg"], ref["ports"]["f32"]
    port = build_model(cfg)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 12))
    with torch.no_grad():
        h, _ = tf.forward_hidden(model, tf.embed_tokens(
            model, torch.from_numpy(tokens)))
        full = tf.logits_from_hidden(model, h)
        caches = port.init_caches(1, 16, device="cpu")
        logits_p, caches = port.prefill(model, {"tokens": tokens[:, :-1]},
                                        caches)
        logits_d, _ = port.decode(model, tokens[:, -1:], caches, 11)
    for got, want in ((logits_p, full[:, -2]), (logits_d, full[:, -1])):
        close = np.isclose(got.numpy(), want.numpy(), rtol=5e-2,
                           atol=5e-2).mean()
        assert close > 0.9, close
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      want.argmax(-1).numpy())


def test_prefill_then_decode_without_moe_is_the_forward():
    """With the MoE taken out (capacity drops depend on the length run)
    and float32 serving state, the state carries exactly what the forward
    sees: a prefill of 9 then 3 decode steps equal the teacher-forced
    logits within 1e-4."""
    cfg = dataclasses.replace(get_config(ARCH).smoke(), n_experts=0,
                              top_k=0)
    port = build_model(cfg)
    model = port.init(3, device="cpu", dtype=torch.float32)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12))
    with torch.no_grad():
        h, _ = tf.forward_hidden(model, tf.embed_tokens(
            model, torch.from_numpy(tokens)))
        full = tf.logits_from_hidden(model, h)
        # float32 state: the KV rows and the conv inputs are not rounded
        caches = tf.init_caches(cfg, 2, 16, device="cpu",
                                dtype=torch.float32)
        got, caches = port.prefill(model, {"tokens": tokens[:, :9]}, caches)
        steps = [got]
        for pos in range(9, 12):
            got, caches = port.decode(model, tokens[:, pos:pos + 1], caches,
                                      pos)
            steps.append(got)
    for got, want in zip(steps, full[:, 8:].unbind(1)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        assert torch.equal(got.argmax(-1), want.argmax(-1))


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / norm) if norm else \
        float(np.linalg.norm(got))


def test_loss_and_gradients(ref):
    """``loss`` and every gradient (mamba's float32 leaves included)
    against ``jax.value_and_grad`` of the reference's loss, in float32."""
    jcfg, cfg = ref["jcfg"], ref["cfg"]
    params = ref["params"]["f32"]
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 16))}
    batch["labels"][:, :3] = -1
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
    assert metrics["tokens"].item() == float(jm["tokens"]) == 2 * 13
    grads = convert.named_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}, model)
    got_l = jax.tree_util.tree_leaves_with_path(grads)
    want_l = jax.tree_util.tree_leaves_with_path(jg)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        assert _rel_l2(g, w) <= 1e-4, (path, _rel_l2(g, w))
    assert model.blocks[0].mamba.a_log.grad.abs().sum() > 0


def test_params_round_trip(ref):
    """The reference's pytree out and in again: pattern position 4 holds
    ``attn`` leaves, the rest ``mamba`` leaves (its float32 ones float32
    whatever the matrices' dtype, ``keep_bf16`` too)."""
    cfg = ref["cfg"]
    period, groups = cfg.pattern()
    model = ref["ports"]["bf16"]
    for keep in (False, True):
        tree = convert.lm_params_to_numpy(model, keep_bf16=keep)
        assert len(tree["layers"]) == period
        for pos in range(period):
            leaf = tree["layers"][pos]
            assert ("attn" in leaf) == (pos == 4) != ("mamba" in leaf)
            if "mamba" in leaf:
                assert leaf["mamba"]["a_log"].dtype == np.float32
                assert leaf["mamba"]["conv_w"].shape == (
                    groups, cfg.d_conv, 1, cfg.ssm_expand * cfg.d_model)
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


def test_generate_greedy_tokens(ref):
    """``ServeEngine.generate`` in float32: the reference's greedy tokens
    (its prefill and decode in the loop of ``repro.serve.engine``'s
    ``generate``, on the shapes the fixture's jitted functions hold)."""
    cfg, params = ref["cfg"], ref["params"]["f32"]
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jcaches = ref["bundle"].init_caches(2, 32)
    logits, jcaches = ref["prefill"](params, {"tokens": jnp.asarray(prompts)},
                                     jcaches)
    want = []
    for pos in range(24, 28):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
        logits, jcaches = ref["decode"](params, tok, jcaches, jnp.int32(pos))
    got = engine.ServeEngine(build_model(cfg), ref["ports"]["f32"],
                             max_seq=32, device="cpu").generate(prompts,
                                                                max_new=4)
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))


def test_full_config_bytes_counts_the_states():
    """jamba's serving state: K/V for its 4 attention layers only, and each
    of its 28 mamba layers' bf16 conv and float32 ssm states."""
    cfg = get_config(ARCH)
    b, s = 4, 128
    kv = 4 * 2 * 2 * b * s * cfg.n_kv_heads * cfg.head_dim_
    d_inner = 2 * cfg.d_model
    states = 28 * (2 * b * 3 * d_inner + 4 * b * d_inner * cfg.d_state)
    assert launch_serve.full_config_bytes(cfg, b, s) == \
        2 * cfg.param_count() + kv + states
    dense = get_config("minicpm-2b")
    assert launch_serve.full_config_bytes(dense, b, s) == 2 * (
        dense.param_count()
        + 2 * dense.n_layers * b * s * dense.n_kv_heads * dense.head_dim_)


def test_launch_serve_smoke_rag(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--rag", "--batch", "2", "--max-new", "4"]) \
        == 0
    out = capsys.readouterr().out
    assert "RAG enabled" in out and "[serve] seq 1:" in out
