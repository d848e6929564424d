"""The port's ssm family (``models/xlstm.py``: the mLSTM and sLSTM cells,
``xlstm-1.3b``'s 7:1 layer pattern) against ``repro.models`` on the CPU, at
smoke size (16 layers: 14 mLSTM, 2 sLSTM; d 64, d_inner 128, 4 heads).

Inputs are drawn by numpy from a seed; the reference's parameters are
carried across by ``convert.lm_params_from_numpy`` (a cell's by its leaves'
names).  Tolerances, with the gap measured at these inputs in parentheses:

* the mLSTM cells in float32 (``mlstm_chunkwise`` and ``mlstm_sequential``
  against the reference's, the chunkwise form against the port's own
  sequential one, a state carried across two chunkwise calls): every output
  and state within 1e-4 of its largest |value| (2.0e-6 measured against
  the reference; 1.1e-6 between the two forms, whose sums run in another
  order);
* the blocks (``mlstm_block``, ``slstm_block``) of the smoke
  ``xlstm-1.3b``, each fed the reference's input (and its state of that
  layer) for the forward (no state), a prefill from the zero state and 4
  one-token steps with every state: every output and state in float32
  within 1e-4 of its largest |value| (3.3e-6 measured), in bf16 within
  2^-5 (four bf16 ulps, ``tests/test_torch_hybrid.py``'s rule; 0.26 of
  it measured);
* the whole float32 smoke stack, forward and prefill then 4 decode steps
  with every state: logits within 0.1 and the same argmax where the
  reference's top-2 gap exceeds 0.2; the last states within 1e-2 of their
  largest |value| (2.4e-3 and 1.4e-2 in a logit at 24 and 70 tokens, the
  states 1.8e-4, measured on these weights).  The stack is not held to
  1e-4: it amplifies rounding.  An mLSTM block's output is a quotient
  whose denominator ``max(|q.n|, exp(-m))`` can sit near zero, and the
  port's blocks differ from the reference's by a few float32 ulps (their
  products sum in another order; 4e-6 at a magnitude of 5 measured, where
  the reference's jitted and eager blocks differ by 4e-7).  Through 14
  mLSTM layers that grows to 7e-4 to 5e-2 in a logit, and the
  reference's own jitted forward differs from its eager one by 2e-4 to
  5e-3 (measured on three draws of the reference's own init, at 24 and 70
  tokens);
* the whole bf16 stack is held as ``tests/test_torch_hybrid.py`` holds
  jamba's: against the float32 truth (the reference's float32 forward of
  the same bf16 weights), the port's mean |logit error| at most 1.5 x the
  reference's own bf16 forward's, its largest at most 1.5 x the
  reference's largest (0.51 against 0.44, 4.1 against 3.9 measured; the
  two bf16 stacks differ from each other by up to 4.2 in a logit);
* ``loss`` and its gradients in float32 against ``jax.value_and_grad``, on
  an mLSTM and an sLSTM layer: the loss within 1e-5 and each gradient leaf
  within a relative L2 of 1e-4 (the whole 16-layer stack amplifies as
  above: 2.5e-5 and 2.4e-3 measured there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import transformer as jtf
from repro.models import xlstm as jx
from repro.models.model import build_model as jax_build_model
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm
from repro_torch.models.model import build_model
from repro_torch.serve import engine

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

ARCH = "xlstm-1.3b"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rel=1e-4):
    """Within ``rel`` of the largest |value| of ``want``."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(),
                               rtol=0)


def _gates(seed, b=2, h=2, t=48, d=16, dv=None):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, h, t, dv or d)).astype(np.float32)
    ig = rng.standard_normal((b, h, t)).astype(np.float32)
    fg = (rng.standard_normal((b, h, t)) + 1.0).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("t,chunk", [(48, 8), (48, 16), (48, 48), (40, 16),
                                     (1, 1)])
def test_mlstm_cells_match_reference(t, chunk):
    """Both forms against the reference's, ragged T (40 over chunks of 16:
    the padded steps' input gate -1e30) included; the padded steps leave
    the state as the reference's does."""
    arrays = _gates(0, t=t, dv=24)
    jargs = [jnp.asarray(a) for a in arrays]
    args = [torch.from_numpy(a) for a in arrays]
    want, wstate = jx.mlstm_chunkwise(*jargs, chunk=chunk)
    got, state = xlstm.mlstm_chunkwise(*args, chunk=chunk)
    _close(got, want)
    for g, w in zip(state, wstate):
        _close(g, w)
    want, wstate = jx.mlstm_sequential(*jargs)
    got, state = xlstm.mlstm_sequential(*args)
    _close(got, want)
    for g, w in zip(state, wstate):
        _close(g, w)


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_chunkwise_is_the_sequential_recurrence(chunk):
    """The port's two forms of the cell agree: output and (C, n, m)."""
    args = [torch.from_numpy(a) for a in _gates(1)]
    want, wstate = xlstm.mlstm_sequential(*args)
    got, state = xlstm.mlstm_chunkwise(*args, chunk=chunk)
    _close(got, want.numpy())
    for g, w in zip(state, wstate):
        _close(g, w.numpy())


def test_chunkwise_state_carry():
    """A sequence split across two chunkwise calls, the state carried, is
    the whole sequence in one call; and a state carried into the
    reference's second call gives the reference's output."""
    q, k, v, ig, fg = (torch.from_numpy(a) for a in _gates(2, b=1, t=32,
                                                           d=8))
    full, _ = xlstm.mlstm_chunkwise(q, k, v, ig, fg, chunk=8)
    h1, st = xlstm.mlstm_chunkwise(q[:, :, :16], k[:, :, :16],
                                   v[:, :, :16], ig[:, :, :16],
                                   fg[:, :, :16], chunk=8)
    h2, _ = xlstm.mlstm_chunkwise(q[:, :, 16:], k[:, :, 16:], v[:, :, 16:],
                                  ig[:, :, 16:], fg[:, :, 16:], chunk=8,
                                  state=st)
    _close(torch.cat([h1, h2], dim=2), full.numpy())
    want, _ = jx.mlstm_chunkwise(
        *(jnp.asarray(a.numpy()[:, :, 16:]) for a in (q, k, v, ig, fg)),
        chunk=8, state=tuple(jnp.asarray(s.numpy()) for s in st))
    _close(h2, want)


def reference_params(model) -> dict:
    """The port's parameters as the reference's pytree of jnp arrays, bf16
    leaves kept bf16 (the reference's own init takes ~10 s to compile on
    this CPU; the two packages compute from the same numbers either way)."""
    def leaf(a):
        if isinstance(a, torch.Tensor):       # a bf16 leaf
            return jnp.asarray(a.float().numpy(), jnp.bfloat16)
        return jnp.asarray(a)

    return jax.tree.map(leaf, convert.lm_params_to_numpy(model,
                                                         keep_bf16=True))


@pytest.fixture(scope="module")
def ref():
    """The smoke xlstm drawn in bf16 by the port from seed 0, as the
    reference's parameters in bf16 and cast to float32, the port's module
    of each, and the reference's jitted forward, prefill and decode."""
    jcfg, cfg = jax_get_config(ARCH).smoke(), get_config(ARCH).smoke()
    bundle = jax_build_model(jcfg)
    params = reference_params(build_model(cfg).init(0, device="cpu"))
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    ports = {key: convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, p), cfg, device="cpu")
        for key, p in (("bf16", params), ("f32", params32))}

    def forward(p, tokens):
        h, _ = jtf.forward_hidden(p, jcfg, jtf.embed_tokens(p, jcfg, tokens))
        return jtf.logits_from_hidden(p, jcfg, h)

    return {"cfg": cfg, "jcfg": jcfg, "bundle": bundle,
            "params": {"bf16": params, "f32": params32}, "ports": ports,
            "forward": jax.jit(forward),
            "prefill": jax.jit(bundle.prefill),
            "decode": jax.jit(bundle.decode)}


def _check_logits(got, want):
    """The whole stack: within 0.1 and the same argmax where the
    reference's top-2 gap exceeds 0.2; the padded vocabulary slots
    equal."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    real = want > -1e29
    assert (got[~real] == want[~real]).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.1)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 0.2
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


_jit_layer = jax.jit(jtf._apply_layer, static_argnums=(2, 3, 4))


def _blocks(ref, key, tokens, *, serving: bool):
    """Each of the port's blocks fed the reference's input of that block
    (and, ``serving``, the reference's state of its layer): a prefill of
    ``tokens`` and 4 decode steps of the reference's greedy tokens, or the
    forward without state.  Every output and new state within 1e-4 (float32)
    or 2^-5 (bf16) of its largest |value|; the -1e30 sentinel equal."""
    from repro.models.layers import rmsnorm

    jcfg, cfg = ref["jcfg"], ref["cfg"]
    params, model = ref["params"][key], ref["ports"][key]
    rel = 1e-4 if key == "f32" else 2 ** -5
    period, _ = jcfg.pattern()
    b, t = tokens.shape
    jcaches = ref["bundle"].init_caches(b, 32) if serving else None
    steps = [(tokens, 0)] + ([(None, t + i) for i in range(4)]
                             if serving else [])
    logits = None
    for tok, pos in steps:
        if tok is None:
            tok = np.asarray(logits).argmax(-1)[:, None]
        x = jtf.embed_tokens(params, jcfg, jnp.asarray(tok))
        for i, blk in enumerate(model.blocks):
            p, g = i % period, i // period
            cache = None if jcaches is None else tuple(
                a[g] for a in jcaches[p])
            xn, new, _ = _jit_layer(
                jax.tree.map(lambda a: a[g], params["layers"][p]), x, jcfg,
                jcfg.layer_kind(p), False, cache=cache,
                cache_pos=None if cache is None else jnp.int32(pos))
            with torch.no_grad():
                got, _, state = tf._apply_block(
                    blk, torch.from_numpy(np.array(x, np.float32)).to(
                        model.embed.w.dtype), cfg,
                    cache=None if cache is None else tuple(
                        _t(a) for a in cache))
            _close(got, xn, rel)
            if cache is not None:
                for g_s, w_s in zip(state, new):
                    w_s = np.asarray(w_s, np.float32)
                    if np.abs(w_s).max() >= 1e29:
                        np.testing.assert_array_equal(g_s.numpy(), w_s)
                    else:
                        _close(g_s, w_s, rel)
                jcaches[p] = tuple(a.at[g].set(n) for a, n in
                                   zip(jcaches[p], new))
            x = xn
        h = rmsnorm(params["final_norm"], x, jcfg.norm_eps)
        logits = jtf.logits_from_hidden(params, jcfg, h[:, -1:])[:, 0]


def test_blocks_follow_the_pattern(ref):
    """Block *i* is an sLSTM at position 7 of each 8 and an mLSTM
    elsewhere, with ``ln1`` and a ``cell`` and no FFN; the serving state
    is a list of float32 tuples: (C, n, m) and (c, n, m, h)."""
    cfg, model = ref["cfg"], ref["ports"]["bf16"]
    kinds = tf.layer_kinds(cfg)
    assert [i for i, k in enumerate(kinds) if k == "slstm"] == [7, 15]
    assert kinds.count("mlstm") == 14
    for kind, blk in zip(kinds, model.blocks):
        assert isinstance(blk.cell, xlstm.MLSTM if kind == "mlstm"
                          else xlstm.SLSTM)
        assert not any(hasattr(blk, n) for n in ("ln2", "mlp", "moe"))
        assert blk.cell.norm_scale.dtype == torch.float32
    caches = build_model(cfg).init_caches(3, 20, device="cpu")
    hd = int(cfg.xlstm_expand * cfg.d_model) // cfg.n_heads
    for kind, c in zip(kinds, caches):
        assert all(s.dtype == torch.float32 for s in c)
        if kind == "mlstm":
            assert [s.shape for s in c] == [(3, 4, hd, hd), (3, 4, hd),
                                            (3, 4)]
        else:
            assert [s.shape for s in c] == [(3, 4, 16)] * 4
        assert (c[2] == -1e30).all()
    assert tf.param_count_gap(cfg) == 2 * 64 * 64
    assert tf.matrix_param_count(model) + tf.param_count_gap(cfg) \
        == cfg.param_count()


@pytest.mark.parametrize("key", ["f32", "bf16"])
def test_blocks_with_and_without_state(ref, key):
    """``mlstm_block`` and ``slstm_block``, each block on the reference's
    input: the forward of 70 tokens without state (chunks of 64, the
    second padded), then a prefill of 24 from the zero state and 4 decode
    steps with every state."""
    cfg = ref["cfg"]
    rng = np.random.default_rng(4)
    _blocks(ref, key, rng.integers(0, cfg.vocab_size, (2, 70)),
            serving=False)
    _blocks(ref, key, rng.integers(0, cfg.vocab_size, (2, 24)),
            serving=True)


def _forward(model, tokens) -> np.ndarray:
    with torch.no_grad():
        h, _ = tf.forward_hidden(model, tf.embed_tokens(
            model, torch.from_numpy(tokens)))
        return tf.logits_from_hidden(model, h).numpy()


@pytest.mark.parametrize("s", [24, 70])
def test_forward_logits(ref, s):
    """The whole float32 stack's training/scoring forward (24 tokens: one
    chunk; 70 tokens over chunks of 64, the second padded)."""
    tokens = np.random.default_rng(s).integers(0, ref["cfg"].vocab_size,
                                               (2, s))
    want = ref["forward"](ref["params"]["f32"], jnp.asarray(tokens))
    _check_logits(torch.from_numpy(_forward(ref["ports"]["f32"], tokens)),
                  want)


def test_bf16_stack_drifts_no_more_than_the_reference(ref):
    """The whole bf16 stack against the float32 truth: the port's mean
    |logit error| at most 1.5 x the reference's own bf16 forward's, and
    its largest no more than 1.5 x the reference's largest."""
    tokens = np.random.default_rng(3).integers(0, ref["cfg"].vocab_size,
                                               (2, 24))
    truth, ref_bf16 = (np.asarray(ref["forward"](
        ref["params"][key], jnp.asarray(tokens)), np.float32)
        for key in ("f32", "bf16"))
    got = _forward(ref["ports"]["bf16"], tokens)
    real = truth > -1e29
    assert (got[~real] == truth[~real]).all() and np.isfinite(got).all()
    e_ref, e_port = np.abs(ref_bf16 - truth)[real], np.abs(got - truth)[real]
    assert e_port.mean() <= 1.5 * e_ref.mean(), (e_port.mean(), e_ref.mean())
    assert e_port.max() <= 1.5 * e_ref.max(), (e_port.max(), e_ref.max())


def test_prefill_and_decode(ref):
    """The whole stack: prefill 24 tokens, then 4 decode steps fed the
    reference's greedy tokens, every layer's state carried; the last states
    of the float32 run within 1e-2 of their largest |value| (each block's
    own are held to 1e-4 by :func:`_blocks`)."""
    cfg, bundle = ref["cfg"], ref["bundle"]
    params, model = ref["params"]["f32"], ref["ports"]["f32"]
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))
    port = build_model(cfg)
    jcaches = bundle.init_caches(2, 32)
    caches = port.init_caches(2, 32, device="cpu")
    want, jcaches = ref["prefill"](params, {"tokens": jnp.asarray(tokens)},
                                   jcaches)
    got, caches = port.prefill(model, {"tokens": tokens}, caches)
    _check_logits(got, want)
    for pos in range(24, 28):
        tok = np.asarray(want).argmax(-1)[:, None]
        want, jcaches = ref["decode"](params, jnp.asarray(tok), jcaches,
                                      jnp.int32(pos))
        got, caches = port.decode(model, tok, caches, pos)
        _check_logits(got, want)
    period, _ = cfg.pattern()
    for i, c in enumerate(caches):
        for g, w in zip(c, jcaches[i % period]):
            _close(g, w[i // period], rel=1e-2)


def test_prefill_then_decode_is_the_forward(ref):
    """The port's own serving path in float32: a prefill of 11 tokens and
    one decode step give the forward's logits at positions 10 and 11."""
    cfg, model = ref["cfg"], ref["ports"]["f32"]
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 12))
    with torch.no_grad():
        h, _ = tf.forward_hidden(model, tf.embed_tokens(
            model, torch.from_numpy(tokens)))
        full = tf.logits_from_hidden(model, h)
    port = build_model(cfg)
    caches = port.init_caches(1, 16, device="cpu")
    got, caches = port.prefill(model, {"tokens": tokens[:, :11]}, caches)
    _close(got, full[:, 10].numpy())
    got, _ = port.decode(model, tokens[:, 11:], caches, 11)
    _close(got, full[:, 11].numpy())


def test_loss_and_gradients(ref):
    """``loss`` and every gradient (the cells' head blocks, gates and
    ``norm_scale`` included) against ``jax.value_and_grad`` of the
    reference's loss, in float32, on a period-2 pattern: the smoke
    model's first mLSTM and first sLSTM layer."""
    cut = dict(n_layers=2, slstm_every=2, slstm_offset=1)
    jcfg = dataclasses.replace(ref["jcfg"], **cut)
    cfg = dataclasses.replace(ref["cfg"], **cut)
    jbundle = jax_build_model(jcfg)
    full = ref["params"]["f32"]
    params = {**full, "layers": [jax.tree.map(lambda a: a[:1], full[
        "layers"][pos]) for pos in (0, 7)]}
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 20)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 20))}
    batch["labels"][:, :3] = -1
    (jl, jm), jg = jax.jit(jax.value_and_grad(jbundle.loss, has_aux=True))(
        params, {k: jnp.asarray(v.astype(np.int32))
                 for k, v in batch.items()})
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, device="cpu")
    loss, metrics = build_model(cfg).loss(model, batch)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5
    assert metrics["tokens"].item() == float(jm["tokens"]) == 34
    grads = convert.named_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}, model)
    got_l = jax.tree_util.tree_leaves_with_path(grads)
    want_l = jax.tree_util.tree_leaves_with_path(jg)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        w = np.asarray(w, np.float32)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-4, (path, rel)


def test_params_round_trip(ref):
    """The reference's tree (``layers[pos]["cell"]``, stacked over the 2
    groups) into the module and back, leaf for leaf; the module's draws
    have the reference's distributions."""
    params = jax.tree.map(np.asarray, ref["params"]["f32"])
    back = convert.lm_params_to_numpy(ref["ports"]["f32"])
    got_l = jax.tree_util.tree_leaves_with_path(back)
    want_l = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (_, g), (_, w) in zip(got_l, want_l):
        np.testing.assert_array_equal(g, w)
    assert back["layers"][7]["cell"]["r_kernel"].shape == (2, 4, 4, 16, 16)
    cfg = dataclasses.replace(get_config(ARCH).smoke(), n_layers=8)
    model = build_model(cfg).init(0, device="cpu", dtype=torch.float32)
    cell = model.blocks[0].cell
    assert abs(cell.wq.std().item() * 32 ** 0.5 - 1) < 0.05
    assert abs(cell.up.w.std().item() * 64 ** 0.5 - 1) < 0.05
    assert (cell.norm_scale == 1).all() and (model.blocks[7].ln1.scale
                                             == 1).all()


def test_generate_matches_reference(ref):
    """``ServeEngine.generate`` in float32: the reference engine's greedy
    tokens."""
    cfg = ref["cfg"]
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    want = jengine.ServeEngine(ref["bundle"], ref["params"]["f32"],
                               max_seq=24).generate(prompts, max_new=6)
    got = engine.ServeEngine(build_model(cfg), ref["ports"]["f32"],
                             max_seq=24, device="cpu").generate(
        prompts, max_new=6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_launch_serve_rag_on_cpu(capsys):
    """``launch.serve --arch xlstm-1.3b --smoke --rag`` serves on the
    CPU."""
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--rag", "--batch", "2", "--max-new",
                              "4"]) == 0
    out = capsys.readouterr().out
    assert "RAG enabled over 256 docs" in out and "seq 1:" in out


def test_mlstm_bf16_rounding_sensitivity():
    """Why the card holds an mLSTM block's bf16 outputs by an outlier share
    (``chip_smoke.py``'s ``MLSTM_OUTLIER_SHARE`` and ``MLSTM_OUTLIER_TOL``)
    and its states by 2^-5: one full-width ``xlstm-1.3b`` mLSTM block (d
    2 048, 4 heads of 1 024), bf16, a 2 x 64 prefill then 8 one-token steps
    with the state carried, run again on the same input moved by about one
    bf16 ulp (x (1 + 4e-3 n), n standard normal) from the same state.  The
    head-wise norm divides by the RMS of a quotient whose denominator
    ``max(|q.n|, exp(-m))`` can sit near zero, so output tokens move past
    2^-5 of the largest |value| (5 of 144 measured, the worst 0.105 of it:
    3.4 x 2^-5, under 2^-2) while every state stays within 2^-5 (0.41 of it
    at most).  Card against CPU (``chip_smoke.py``'s ``parity_xlstm``, on
    an NVIDIA H100 80GB HBM3) the block's differences were smaller than
    this perturbation: 1 of 1 008 (token, block) outputs past 2^-5, the
    worst 0.0433 of the largest |value| (PERF.md section 6)."""
    cfg = get_config(ARCH)
    cell = xlstm.init_mlstm(
        xlstm.MLSTM(cfg.d_model, n_heads=cfg.n_heads, device="cpu"),
        generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 72, cfg.d_model)).astype(np.float32))
    noise = torch.from_numpy(np.random.default_rng(1).standard_normal(
        x.shape).astype(np.float32))
    runs = []
    with torch.no_grad():
        for inp in (x, x * (1 + 4e-3 * noise)):
            inp, outs, state = inp.bfloat16(), [], None
            for lo, hi in [(0, 64)] + [(i, i + 1) for i in range(64, 72)]:
                out, state = xlstm.mlstm_block(cell, inp[:, lo:hi],
                                               n_heads=cfg.n_heads,
                                               state=state)
                outs.append(out.float())
            runs.append((torch.cat(outs, dim=1), state))
    (out, state), (moved, moved_state) = runs
    per_token = (moved - out).abs().amax(dim=-1) / out.abs().max()
    assert int((per_token > 2 ** -5).sum()) >= 1
    assert float(per_token.max()) <= 2 ** -2
    for got, want in zip(moved_state, state):
        assert float((got - want).abs().max()) <= 2 ** -5 * float(
            want.abs().max())
