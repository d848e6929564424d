"""The port's LM stack (configs, layers, FFN, the dense decoder, parameter
conversion) against ``repro.models`` on the CPU.

Tolerances.  Layers in float32 within 1e-6 (the same float32 arithmetic in
another order); bf16 outputs within one bf16 rounding.  Whole smoke models
with the reference's parameters carried across: cast to float32, hidden
states and logits within 1e-4 and the same argmax; in bf16 (the reference's
own parameter dtype) logits within 0.1 (0.055 was measured on a scratch
copy: bf16 products round at other places in the two frameworks) and the
same argmax wherever the reference's top-2 gap exceeds 0.2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import ffn as jffn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.model import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.models import ffn, layers
from repro_torch.models import transformer as tf
from repro_torch.models.model import build_model

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

ARCHS = ("minicpm-2b", "yi-34b")


@pytest.mark.parametrize("name", ARCHS)
def test_configs_are_copies(name):
    want, got = jax_get_config(name), get_config(name)
    for cfg_w, cfg_g in ((want, got), (want.smoke(), got.smoke())):
        w = dataclasses.asdict(cfg_w)
        g = dataclasses.asdict(cfg_g)
        w.pop("note"), g.pop("note")
        assert g == w
        assert cfg_g.param_count() == cfg_w.param_count()
        assert cfg_g.padded_vocab == cfg_w.padded_vocab
        assert cfg_g.pattern() == cfg_w.pattern()


@pytest.mark.parametrize("name", ARCHS)
def test_module_parameter_count_is_param_count(name):
    """Counted on the meta device: nothing is allocated."""
    cfg = get_config(name)
    model = tf.DecoderLM(cfg, device="meta")
    assert tf.matrix_param_count(model) == cfg.param_count()
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    assert sum(p.numel() for p in model.parameters()) \
        == cfg.param_count() + norms
    if name == "minicpm-2b":
        assert cfg.param_count() == 3_008_102_400
        assert cfg.padded_vocab == 122_880


def test_unported_families_raise():
    cfg = get_config("minicpm-2b").smoke()
    for bad in (dataclasses.replace(cfg, family="moe", n_experts=4, top_k=2),
                dataclasses.replace(cfg, family="hybrid"),
                dataclasses.replace(cfg, family="ssm")):
        with pytest.raises(NotImplementedError, match="item 14"):
            tf.DecoderLM(bad, device="meta")
    with pytest.raises(NotImplementedError, match="item 14"):
        build_model(dataclasses.replace(cfg, family="encdec"))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rmsnorm_rope_embed(dtype):
    rng = np.random.default_rng(0)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    tol = 1e-6 if dtype is np.float32 else 8e-3
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(tdt)

    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5)
    got = layers.rmsnorm(layers.Norm(torch.from_numpy(scale)), tx, 1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)

    pos = np.arange(12)[None, :] + 5
    want = jlayers.apply_rope(jx, jnp.asarray(pos), 1e4)
    got = layers.apply_rope(tx, torch.from_numpy(pos), 1e4)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)

    table = rng.standard_normal((50, 8)).astype(np.float32)
    tokens = rng.integers(0, 50, (3, 7))
    want = jlayers.embed({"w": jnp.asarray(table, jdt)}, jnp.asarray(tokens))
    got = layers.embed(layers.Embedding(torch.from_numpy(table).to(tdt)),
                       torch.from_numpy(tokens))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("activation", ["swiglu", "squared_relu", "gelu"])
def test_ffn(activation):
    jp = jffn.init_ffn(jax.random.PRNGKey(1), 64, 128, activation=activation,
                       dtype=jnp.float32)
    p = ffn.FFN(64, 128, activation=activation, device="cpu",
                dtype=torch.float32)
    for name, sub in jp.items():
        getattr(p, name).w.data = torch.from_numpy(np.array(sub["w"]))
    x = np.random.default_rng(2).standard_normal((2, 5, 64)) \
        .astype(np.float32)
    want = jffn.ffn(jp, jnp.asarray(x), activation=activation)
    got = ffn.ffn(p, torch.from_numpy(x), activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """A reference smoke model with its parameters in bf16 (as drawn) and
    cast to float32, and the port's module of each."""
    jcfg = jax_get_config(request.param).smoke()
    cfg = get_config(request.param).smoke()
    bundle = jax_build_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    ports = {}
    for key, p in (("bf16", params), ("f32", params32)):
        ports[key] = convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, p), cfg, device="cpu")
    return {"cfg": cfg, "jcfg": jcfg, "bundle": bundle,
            "params": {"bf16": params, "f32": params32}, "ports": ports}


def test_lm_params_round_trip(ref):
    cfg = ref["cfg"]
    for key in ("bf16", "f32"):
        model = ref["ports"][key]
        tree = convert.lm_params_to_numpy(model)
        want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            ref["params"][key])
        flat_w, tree_w = jax.tree.flatten(want)
        flat_g, tree_g = jax.tree.flatten(tree)
        assert tree_g == tree_w
        for a, b in zip(flat_g, flat_w):
            np.testing.assert_array_equal(a, b)
        again = convert.lm_params_from_numpy(tree, cfg, device="cpu",
                                             dtype=model.embed.w.dtype)
        for (n1, p1), (n2, p2) in zip(model.state_dict().items(),
                                      again.state_dict().items()):
            assert n1 == n2 and p1.dtype == p2.dtype
            assert torch.equal(p1, p2), n1
    assert ref["ports"]["bf16"].embed.w.dtype == torch.bfloat16
    assert ref["ports"]["bf16"].blocks[0].ln1.scale.dtype == torch.float32


def _check_logits(got, want, key):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if key == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        return
    real = want > -1e29                # padded vocabulary slots are -1e30
    assert (got[~real] == want[~real]).all()
    assert np.abs(got - want)[real].max() <= 0.1
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 0.2
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


@pytest.mark.parametrize("key", ["f32", "bf16"])
def test_forward_hidden_and_logits(ref, key):
    jcfg, params, model = ref["jcfg"], ref["params"][key], ref["ports"][key]
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 24))
    jh, _ = jtf.forward_hidden(params, jcfg,
                               jtf.embed_tokens(params, jcfg,
                                                jnp.asarray(tokens)))
    want = jtf.logits_from_hidden(params, jcfg, jh)
    h = tf.forward_hidden(model, tf.embed_tokens(model,
                                                 torch.from_numpy(tokens)))
    got = tf.logits_from_hidden(model, h)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if key == "f32":
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4,
                                   rtol=0)
    _check_logits(got, want, key)


@pytest.mark.parametrize("key", ["f32", "bf16"])
def test_prefill_and_decode(ref, key):
    """Prefill 24 tokens, then 4 decode steps fed the reference's greedy
    tokens, both against bf16 caches."""
    cfg, bundle = ref["cfg"], ref["bundle"]
    params, model = ref["params"][key], ref["ports"][key]
    port = build_model(cfg)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 24))
    jcaches = bundle.init_caches(2, 32)
    caches = port.init_caches(2, 32, device="cpu")
    want, jcaches = bundle.prefill(params, {"tokens": jnp.asarray(tokens)},
                                   jcaches)
    got, caches = port.prefill(model, {"tokens": tokens}, caches)
    _check_logits(got, want, key)
    for pos in range(24, 28):
        tok = np.asarray(want).argmax(-1)[:, None]
        want, jcaches = bundle.decode(params, jnp.asarray(tok), jcaches,
                                      jnp.int32(pos))
        got, caches = port.decode(model, tok, caches, pos)
        _check_logits(got, want, key)
    assert caches.k.shape == (cfg.n_layers, 2, 32, cfg.n_kv_heads,
                              cfg.head_dim_)
    assert caches.k.dtype == torch.bfloat16
    assert not caches.k[:, :, 28:].any()


def test_init_decoder_distributions():
    """The reference's distributions (not its draws): normal / sqrt(d_in)
    linears, normal * 0.02 embedding, unit norms; seeded, so repeatable."""
    cfg = dataclasses.replace(get_config("minicpm-2b").smoke(), d_model=256,
                              d_ff=512, vocab_size=4000)
    port = build_model(cfg)
    a = port.init(7, device="cpu")
    b = port.init(7, device="cpu")
    for (name, p), (_, q) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(p, q), name
    assert a.embed.w.dtype == torch.bfloat16
    assert abs(a.embed.w.float().std().item() - 0.02) < 0.002
    w1 = a.blocks[0].mlp.w1.w.float()
    assert abs(w1.std().item() * 256 ** 0.5 - 1.0) < 0.05
    w2 = a.blocks[0].mlp.w2.w.float()
    assert abs(w2.std().item() * 512 ** 0.5 - 1.0) < 0.05
    assert (a.blocks[1].ln2.scale == 1).all()
    assert a.blocks[1].ln2.scale.dtype == torch.float32
