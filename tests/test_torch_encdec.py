"""The port's encdec family (``models/encdec.py``, cross-attention in
``models/attention.py``, ``whisper-medium``) against ``repro.models`` on the
CPU, at smoke size (2 encoder and 2 decoder layers, d 64, 4 heads of 16).

The parameters are drawn by the port from a seed and carried to the
reference by ``convert.lm_params_to_numpy`` (``enc_layers`` and
``dec_layers`` stacked over their layers); frames and tokens are drawn by
numpy from a seed.  Every attention call of the port goes to the flash
kernel's plain version here: the encoder's and the cross-attention's
without a causal mask.  Tolerances, with the gap measured at these inputs
in parentheses:

* ``sinusoidal_positions`` equal to the reference's (both round float64
  angles once); the table read at a clamped start as
  ``jax.lax.dynamic_slice_in_dim`` reads it;
* cross-attention in float32 within 1e-5 (1.2e-6 measured);
* ``encode``, ``decode_train``, ``make_cross_kv`` and ``decode_with_cache``
  in float32 within 1e-4 of the largest |value| (3.8e-7 measured);
* the bundle's prefill and decode steps as ``tests/test_torch_lm.py``
  holds the dense decoder: in float32 within 1e-3 against the bf16 K/V
  caches and the same argmax (1.4e-6 measured), in bf16 within 0.1 and
  the same argmax where the reference's top-2 gap exceeds 0.2; ``loss``
  in float32 within 1e-5 and each gradient leaf within a relative L2 of
  1e-4 of ``jax.value_and_grad``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models.model import build_model as jax_build_model
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.model import build_model
from repro_torch.serve import engine

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

ARCH = "whisper-medium"


def _close(got, want, rel=1e-4):
    """Within ``rel`` of the largest |value| of ``want``."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(),
                               rtol=0)


@pytest.mark.parametrize("t,d", [(7, 64), (96, 1024), (1500, 1024)])
def test_sinusoidal_positions(t, d):
    got = layers.sinusoidal_positions(t, d)
    assert got.dtype == torch.float32 and got.shape == (t, d)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jlayers.sinusoidal_positions(
                                      t, d)))


@pytest.mark.parametrize("start", [0, 5, 28, 29, 31, 40])
def test_position_rows_clamp(start):
    """The table's rows at ``start``, clamped to [0, S - t] as the
    reference's ``dynamic_slice_in_dim`` clamps it (S 32, t 4: starts past
    28 read rows 28-31)."""
    table = layers.sinusoidal_positions(32, 16)
    want = jax.lax.dynamic_slice_in_dim(jnp.asarray(table.numpy()),
                                        jnp.int32(start), 4, axis=0)
    np.testing.assert_array_equal(encdec.position_rows(table, start, 4)
                                  .numpy(), np.asarray(want))


@pytest.mark.parametrize("tq,tk", [(5, 37), (1, 37), (20, 130)])
def test_cross_attention(tq, tk):
    """``cross_attention_kv`` and ``cross_attention_forward`` in float32
    (GQA 4 over 2, hd 16): every query row over every encoder key, a
    ragged encoder length, the one-row decode (the reference's one-pass
    path) and its chunked path (kv_chunk 16)."""
    d, h, kh, hd = 64, 4, 2, 16
    jp = jattn.init_cross_attention(jax.random.PRNGKey(tk), d, h, kh, hd,
                                    dtype=jnp.float32)
    port = attn.Attention(d, h, kh, hd, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(port, name).w.copy_(torch.from_numpy(np.array(
                jp[name]["w"])))
    rng = np.random.default_rng(tq)
    x = rng.standard_normal((2, tq, d)).astype(np.float32)
    enc = rng.standard_normal((2, tk, d)).astype(np.float32)
    jkv = jattn.cross_attention_kv(jp, jnp.asarray(enc), n_kv_heads=kh,
                                   head_dim=hd)
    with torch.no_grad():
        kv = attn.cross_attention_kv(port, torch.from_numpy(enc),
                                     n_kv_heads=kh, head_dim=hd)
        got = attn.cross_attention_forward(port, torch.from_numpy(x), kv,
                                           n_heads=h, head_dim=hd,
                                           kv_chunk=16)
    for g, w in zip(kv, jkv):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    want = jattn.cross_attention_forward(jp, jnp.asarray(x), jkv, n_heads=h,
                                         head_dim=hd, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _reference_params(model) -> dict:
    """The port's parameters as the reference's pytree of jnp arrays, bf16
    leaves kept bf16."""
    def leaf(a):
        if isinstance(a, torch.Tensor):       # a bf16 leaf
            return jnp.asarray(a.float().numpy(), jnp.bfloat16)
        return jnp.asarray(a)

    return jax.tree.map(leaf, convert.lm_params_to_numpy(model,
                                                         keep_bf16=True))


@pytest.fixture(scope="module")
def ref():
    """The smoke whisper drawn in bf16 by the port from seed 0, as the
    reference's parameters in bf16 and cast to float32, the port's module
    of each (carried back by ``convert.lm_params_from_numpy``), and the
    reference's jitted prefill and decode."""
    jcfg, cfg = jax_get_config(ARCH).smoke(), get_config(ARCH).smoke()
    bundle = jax_build_model(jcfg)
    params = _reference_params(build_model(cfg).init(0, device="cpu"))
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    ports = {key: convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, p), cfg, device="cpu")
        for key, p in (("bf16", params), ("f32", params32))}
    return {"cfg": cfg, "jcfg": jcfg, "bundle": bundle,
            "params": {"bf16": params, "f32": params32}, "ports": ports,
            "prefill": jax.jit(bundle.prefill),
            "decode": jax.jit(bundle.decode)}


def _frames(cfg, b, s, seed, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


def test_leaves_and_counts(ref):
    """The reference's leaves (``frontend_adapter``, ``enc_layers`` and
    ``dec_layers`` stacked over 2 layers, ``xattn`` and ``ln_x``, the two
    final norms) round-trip leaf for leaf; the matrices are
    ``param_count()`` less ``param_count_gap`` (the adapter, d^2)."""
    cfg, model = ref["cfg"], ref["ports"]["f32"]
    back = convert.lm_params_to_numpy(model)
    want = jax.tree.map(np.asarray, ref["params"]["f32"])
    got_l = jax.tree_util.tree_leaves_with_path(back)
    want_l = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (_, g), (_, w) in zip(got_l, want_l):
        np.testing.assert_array_equal(g, w)
    assert back["dec_layers"]["xattn"]["wq"]["w"].shape == (2, 64, 64)
    assert set(back) == {"frontend_adapter", "embed", "enc_layers",
                         "enc_norm", "dec_layers", "dec_norm", "lm_head"}
    assert tf.param_count_gap(cfg) == -64 * 64
    assert tf.matrix_param_count(model) + tf.param_count_gap(cfg) \
        == cfg.param_count()
    caches = build_model(cfg).init_caches(3, 20, device="cpu")
    for kv in caches:
        assert kv.k.shape == (2, 3, 20, 4, 16) and kv.k.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs(ref, name):
    want = ref["bundle"].input_specs(JSHAPES[name])
    got = build_model(ref["cfg"]).input_specs(SHAPES[name])
    assert set(got) == set(want)
    for key, (shape, dtype) in got.items():
        assert shape == want[key].shape
        assert str(dtype).split(".")[-1] == str(want[key].dtype)


def test_encoder_and_decoder_passes(ref):
    """``encode`` (24 frames), ``make_cross_kv``, ``decode_train`` (6
    tokens) and ``decode_with_cache`` (a prefill of 5 and one step at 5,
    then one at 31, the last row of a 32-row cache) in float32."""
    jcfg, params, model = ref["jcfg"], ref["params"]["f32"], \
        ref["ports"]["f32"]
    jx, x = _frames(jcfg, 2, 24, 1)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 6))
    jenc = jed.encode(params, jcfg, jx)
    jh = jed.decode_train(params, jcfg, jnp.asarray(tokens), jenc)
    jcross = jed.make_cross_kv(params, jcfg, jenc)
    with torch.no_grad():
        enc = encdec.encode(model, x)
        h = encdec.decode_train(model, torch.from_numpy(tokens), enc)
        cross = encdec.make_cross_kv(model, enc)
    _close(enc, jenc)
    _close(h, jh)
    for g, w in zip(cross, jcross):
        _close(g, w)

    jc = jed.init_encdec_caches(jcfg, 2, 32, 24)
    jc = jed.EncDecCaches(self_kv=jc.self_kv, cross_kv=jcross)
    c = encdec.init_encdec_caches(model.cfg, 2, 32, 24, device="cpu")
    c = encdec.EncDecCaches(self_kv=c.self_kv, cross_kv=cross)
    for toks, pos in ((tokens[:, :5], 0), (tokens[:, 5:], 5),
                      (tokens[:, :1], 31)):
        jh, jc = jed.decode_with_cache(params, jcfg, jnp.asarray(toks), jc,
                                       jnp.int32(pos))
        with torch.no_grad():
            h, c = encdec.decode_with_cache(model, torch.from_numpy(toks), c,
                                            pos)
        _close(h, jh)
        for g, w in zip(c.self_kv, jc.self_kv):
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))


def test_decode_past_the_cache_raises(ref):
    """A step at the cache's length: the reference clamps the table's read
    and the K/V write onto the last row; the port refuses it."""
    cfg, model = ref["cfg"], ref["ports"]["f32"]
    c = encdec.init_encdec_caches(cfg, 1, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="exceed"), torch.no_grad():
        encdec.decode_with_cache(model, torch.zeros((1, 1), dtype=torch.long),
                                 c, 8)


@pytest.mark.parametrize("key", ["f32", "bf16"])
def test_prefill_and_decode(ref, key):
    """The bundle: prefill (24 frames, 6 tokens; the cross K/V replaces
    the cache's ``max_seq`` rows), then 4 decode steps from position 6 fed
    the reference's greedy tokens."""
    cfg, bundle = ref["cfg"], ref["bundle"]
    params, model = ref["params"][key], ref["ports"][key]
    jx, x = _frames(cfg, 2, 24, 3, "bf16" if key == "bf16" else np.float32)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 6))
    port = build_model(cfg)
    jcaches = bundle.init_caches(2, 16)
    caches = port.init_caches(2, 16, device="cpu")
    want, jcaches = ref["prefill"](params, {"tokens": jnp.asarray(tokens),
                                            "frames": jx}, jcaches)
    got, caches = port.prefill(model, {"tokens": tokens, "frames": x},
                               caches)
    assert caches.cross_kv.k.shape == (2, 2, 24, 4, 16)
    _check_logits(got, want, key)
    for pos in range(6, 10):
        tok = np.asarray(want).argmax(-1)[:, None]
        want, jcaches = ref["decode"](params, jnp.asarray(tok), jcaches,
                                      jnp.int32(pos))
        got, caches = port.decode(model, tok, caches, pos)
        _check_logits(got, want, key)


def _check_logits(got, want, key):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    real = want > -1e29                # padded vocabulary slots are -1e30
    assert (got[~real] == want[~real]).all()
    if key == "f32":
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        return
    assert np.abs(got - want)[real].max() <= 0.1
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 0.2
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def test_loss_and_gradients(ref):
    """``loss`` over 32 frames and 8 tokens (``dec_ratio`` 4), some labels
    masked, and every gradient against ``jax.value_and_grad`` of the
    reference's loss, in float32."""
    jcfg, cfg = ref["jcfg"], ref["cfg"]
    params = ref["params"]["f32"]
    jx, x = _frames(cfg, 2, 32, 5)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8))
    labels = rng.integers(0, cfg.vocab_size, (2, 8))
    labels[:, :2] = -1
    (jl, jm), jg = jax.jit(jax.value_and_grad(ref["bundle"].loss,
                                              has_aux=True))(
        params, {"frames": jx, "tokens": jnp.asarray(tokens, jnp.int32),
                 "labels": jnp.asarray(labels, jnp.int32)})
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, device="cpu")
    loss, metrics = build_model(cfg).loss(
        model, {"frames": x, "tokens": tokens, "labels": labels})
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5
    assert metrics["tokens"].item() == float(jm["tokens"]) == 12
    grads = convert.named_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}, model)
    got_l = jax.tree_util.tree_leaves_with_path(grads)
    want_l = jax.tree_util.tree_leaves_with_path(jg)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        w = np.asarray(w, np.float32)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-4, (path, rel)


def test_generate_with_frames(ref):
    """``ServeEngine.generate(extra_batch={"frames": ...})`` in float32:
    the reference engine's greedy tokens, decode from the token prompt's
    length."""
    cfg = ref["cfg"]
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jx, x = _frames(cfg, 2, 30, 8)
    want = jengine.ServeEngine(ref["bundle"], ref["params"]["f32"],
                               max_seq=24).generate(
        prompts, max_new=6, extra_batch={"frames": jx})
    got = engine.ServeEngine(build_model(cfg), ref["ports"]["f32"],
                             max_seq=24, device="cpu").generate(
        prompts, max_new=6, extra_batch={"frames": x})
    np.testing.assert_array_equal(got, np.asarray(want))


def test_launch_serve_refuses_encdec(capsys):
    """``launch.serve`` serves decoder families only, as the reference's:
    an encoder-decoder needs frame inputs."""
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device",
                              "cpu"]) == 1
    assert "use examples/ for enc-dec serving" in capsys.readouterr().out
