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

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import all_configs as jax_all_configs
from repro.configs.base import cell_is_supported as jax_cell_is_supported
from repro.configs.base import get_config as jax_get_config
from repro.models import ffn as jffn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.model import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs.base import SHAPES, cell_is_supported, get_config
from repro_torch.models import ffn, layers
from repro_torch.models import transformer as tf
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.model import build_model, lm_module

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

# the dense configs: minicpm (MHA), yi and command-r-plus (GQA), nemotron
# (GQA, squared-ReLU FFN)
ARCHS = ("minicpm-2b", "yi-34b", "command-r-plus-104b", "nemotron-4-340b")
# the decoder configs of attention and mamba layers; the MoE, hybrid and vlm
# decoders' numerics are ``tests/test_torch_moe.py``'s,
# ``test_torch_hybrid.py``'s and ``test_torch_vlm.py``'s
DECODERS = ARCHS + ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
                    "internvl2-2b")
# every config the port carries: all ten of the reference's (the ssm and
# encdec families' numerics are ``tests/test_torch_xlstm.py``'s and
# ``test_torch_encdec.py``'s)
CONFIGS = DECODERS + ("xlstm-1.3b", "whisper-medium")


@pytest.fixture(autouse=True)
def _inference():
    """These tests hold inference numerics: the port's parameters are
    trainable, so each test runs under ``torch.no_grad``, as the serving
    entry points do (the gradients are ``tests/test_torch_train.py``'s)."""
    with torch.no_grad():
        yield


@pytest.mark.parametrize("name", CONFIGS)
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
        assert cfg_g.seq_sharded_residual == cfg_w.seq_sharded_residual
        assert cfg_g.active_param_count() == cfg_w.active_param_count()
        for pos in range(cfg_w.n_layers):
            assert cfg_g.layer_kind(pos) == cfg_w.layer_kind(pos)
            assert cfg_g.layer_has_moe(pos) == cfg_w.layer_has_moe(pos)
    for key, shape in JSHAPES.items():
        assert dataclasses.asdict(SHAPES[key]) == dataclasses.asdict(shape)
        assert cell_is_supported(got, SHAPES[key]) == \
            jax_cell_is_supported(want, shape)
    assert set(SHAPES) == set(JSHAPES)


@pytest.mark.parametrize("name", DECODERS)
def test_module_parameter_count_is_param_count(name):
    """Counted on the meta device: nothing is allocated."""
    cfg = get_config(name)
    model = tf.DecoderLM(cfg, device="meta")
    # the formula counts mamba's 1-D dt_bias and d_skip too (2 d_inner a
    # mamba layer): 28 of jamba's 32 layers
    gap = 28 * 2 * 8192 if name == "jamba-v0.1-52b" else 0
    assert tf.param_count_gap(cfg) == gap
    assert tf.matrix_param_count(model) + gap == cfg.param_count()
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    assert sum(p.numel() for p in model.parameters()) \
        == cfg.param_count() + norms
    if name == "minicpm-2b":
        assert cfg.param_count() == 3_008_102_400
        assert cfg.padded_vocab == 122_880
    if cfg.n_experts:
        assert cfg.active_param_count() < cfg.param_count()
        blk = next(b.moe for b in model.blocks if hasattr(b, "moe"))
        assert blk.router.w.dtype == torch.float32
        assert blk.w1.shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
        assert hasattr(blk, "shared") == bool(cfg.n_shared_experts)


def test_param_count_gap_at_smoke_width():
    """Below d = 256 the formula also reckons mamba's dt_rank as d // 16
    where the layer has max(16, d // 16): ``param_count_gap`` carries both
    differences exactly (jamba's smoke: 14 mamba layers, d 64, d_inner
    128, dt_rank 16 against 4)."""
    cfg = get_config("jamba-v0.1-52b").smoke()
    model = tf.DecoderLM(cfg, device="meta")
    vectors = sum(p.numel() for n, p in model.named_parameters()
                  if n.endswith((".dt_bias", ".d_skip")))
    assert vectors == 14 * 2 * 128
    short = 14 * 2 * 128 * (16 - 64 // 16)
    assert tf.param_count_gap(cfg) == vectors - short
    assert tf.matrix_param_count(model) + tf.param_count_gap(cfg) \
        == cfg.param_count()
    # the served cut: 16 layers at full width, 14 mamba
    cut = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=16)
    assert tf.param_count_gap(cut) == 229_376


@pytest.mark.parametrize("name", sorted(jax_all_configs()))
def test_every_reference_config_builds(name):
    """All ten of the reference's configs resolve through ``get_config`` and
    build on the meta device (nothing allocated), their module's matrices
    ``param_count()`` less ``param_count_gap``; an encoder-decoder is an
    ``EncDecLM``, every other family a ``DecoderLM``."""
    cfg = get_config(name)
    assert cfg.name == name
    model = lm_module(cfg, device="meta")
    assert isinstance(model, EncDecLM if cfg.family == "encdec"
                      else tf.DecoderLM)
    assert tf.matrix_param_count(model) + tf.param_count_gap(cfg) \
        == cfg.param_count()
    assert build_model(cfg).cfg is cfg
    with pytest.raises(KeyError, match="unknown arch"):
        get_config(name + "-x")


def test_moe_config_builds():
    """MoE is ported: a dense config given experts builds, with an MoE FFN
    in every block, and serves a decode step."""
    cfg = dataclasses.replace(get_config("minicpm-2b").smoke(), family="moe",
                              n_experts=4, top_k=2, moe_offset=0)
    bundle = build_model(cfg)
    model = bundle.init(0, device="cpu")
    assert all(hasattr(blk, "moe") and not hasattr(blk, "mlp")
               for blk in model.blocks)
    caches = bundle.init_caches(2, 8, device="cpu")
    logits, _ = bundle.decode(model, np.zeros((2, 1), np.int32), caches, 0)
    assert logits.shape == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())


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
    h, aux = tf.forward_hidden(model, tf.embed_tokens(
        model, torch.from_numpy(tokens)))
    assert set(aux) == {"load_balance_loss", "dropped_fraction"}
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
