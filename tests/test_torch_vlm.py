"""The port's vlm family (``internvl2-2b``: a dense GQA decoder behind the
reference's patch front-end stub) against ``repro.models`` on the CPU, at
smoke size (2 layers, d 64, 8 patch embeddings).

``patches`` (B, P, d) are put before the token embeddings, the loss counts
the token positions only, and serving decodes from position ``P + S``.
The reference's parameters are carried across by
``convert.lm_params_from_numpy``; patches and tokens are drawn by numpy
from a seed, the patches rounded to bf16 on both sides.  Tolerances follow
``tests/test_torch_lm.py``: cast to float32, logits within 1e-4 and the
same argmax (against bf16 KV caches within 1e-3, as ``test_torch_moe.py``
states), the loss within 1e-5; in bf16 (the two layers are shallow enough
to compare whole) logits within 0.1 and equal argmax where the reference's
top-2 gap exceeds 0.2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import build_model
from repro_torch.serve import engine

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

ARCH = "internvl2-2b"


@pytest.fixture(scope="module")
def ref():
    jcfg, cfg = jax_get_config(ARCH).smoke(), get_config(ARCH).smoke()
    bundle = jax_build_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    ports = {key: convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, p), cfg, device="cpu")
        for key, p in (("bf16", params), ("f32", params32))}
    return {"cfg": cfg, "jcfg": jcfg, "bundle": bundle,
            "params": {"bf16": params, "f32": params32}, "ports": ports,
            "prefill": jax.jit(bundle.prefill),
            "decode": jax.jit(bundle.decode)}


def _patches(cfg, b, seed):
    """(jax bf16, torch bf16) patch embeddings of the same values."""
    x = np.random.default_rng(seed).standard_normal(
        (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


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


def test_config_is_the_vlm_stub(ref):
    cfg = ref["cfg"]
    assert cfg.family == "vlm" and cfg.frontend == "patch_stub"
    assert cfg.n_frontend_tokens == 8
    assert get_config(ARCH).n_frontend_tokens == 256
    model = ref["ports"]["bf16"]
    assert all(hasattr(blk, "attn") and hasattr(blk, "mlp")
               for blk in model.blocks)


@pytest.mark.parametrize("name", sorted(JSHAPES))
def test_input_specs(ref, name):
    """``tokens`` (B, S - P), ``patches`` (B, P, d) bf16 and ``labels``
    (B, S - P) for train; decode ``tokens`` (B, 1) alone."""
    want = ref["bundle"].input_specs(JSHAPES[name])
    got = build_model(ref["cfg"]).input_specs(SHAPES[name])
    assert set(got) == set(want)
    for key, spec in want.items():
        shape, dtype = got[key]
        assert shape == spec.shape, key
        assert str(dtype).replace("torch.", "") == str(spec.dtype), key


def test_loss(ref):
    """The loss and its token count over the token positions only, in
    float32; the patches' positions add no label."""
    jcfg, cfg = ref["jcfg"], ref["cfg"]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16))
    labels = rng.integers(0, cfg.vocab_size, (2, 16))
    labels[:, :3] = -1
    jpatch, patch = _patches(cfg, 2, 2)
    jl, jm = ref["bundle"].loss(ref["params"]["f32"], {
        "tokens": jnp.asarray(tokens, jnp.int32), "patches": jpatch,
        "labels": jnp.asarray(labels, jnp.int32)})
    with torch.no_grad():
        loss, metrics = build_model(cfg).loss(ref["ports"]["f32"], {
            "tokens": tokens, "patches": patch, "labels": labels})
    assert metrics["tokens"].item() == float(jm["tokens"]) == 2 * 13
    assert abs(loss.item() - float(jl)) <= 1e-5
    assert abs(metrics["ce"].item() - float(jm["ce"])) <= 1e-5
    assert metrics["load_balance_loss"].item() == 0.0


@pytest.mark.parametrize("key", ["f32", "bf16"])
def test_prefill_with_patches_and_decode(ref, key):
    """Prefill 8 patches + 16 tokens, then 4 decode steps at positions 24
    onward, fed the reference's greedy tokens."""
    cfg, params, model = ref["cfg"], ref["params"][key], ref["ports"][key]
    port = build_model(cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16))
    jpatch, patch = _patches(cfg, 2, 4)
    jcaches = ref["bundle"].init_caches(2, 32)
    caches = port.init_caches(2, 32, device="cpu")
    want, jcaches = ref["prefill"](
        params, {"tokens": jnp.asarray(tokens, jnp.int32),
                 "patches": jpatch}, jcaches)
    with torch.no_grad():
        got, caches = port.prefill(model, {"tokens": tokens,
                                           "patches": patch}, caches)
    _check_logits(got, want, key, f32_tol=1e-3)
    start = 16 + cfg.n_frontend_tokens
    for pos in range(start, start + 4):
        tok = np.asarray(want).argmax(-1)[:, None]
        want, jcaches = ref["decode"](params, jnp.asarray(tok, jnp.int32),
                                      jcaches, jnp.int32(pos))
        with torch.no_grad():
            got, caches = port.decode(model, tok, caches, pos)
        _check_logits(got, want, key, f32_tol=1e-3)
    assert caches.k.shape == (cfg.n_layers, 2, 32, cfg.n_kv_heads,
                              cfg.head_dim_)
    assert caches.k[:, :, :start + 4].any(dim=-1).any(dim=-1).all()
    assert not caches.k[:, :, start + 4:].any()


def test_generate_with_patches(ref):
    """``ServeEngine.generate(extra_batch={"patches": ...})`` in float32:
    the reference's greedy tokens; a cache too short for the patches, the
    prompt and the new tokens is refused."""
    cfg = ref["cfg"]
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jpatch, patch = _patches(cfg, 2, 6)
    want = jengine.ServeEngine(ref["bundle"], ref["params"]["f32"],
                               max_seq=32).generate(
        prompts, max_new=6, extra_batch={"patches": jpatch})
    port = engine.ServeEngine(build_model(cfg), ref["ports"]["f32"],
                              max_seq=32, device="cpu")
    got = port.generate(prompts, max_new=6, extra_batch={"patches": patch})
    np.testing.assert_array_equal(got, np.asarray(want))
    # 8 patches + 16 tokens + 9 new rows > 32
    with pytest.raises(AssertionError):
        port.generate(prompts, max_new=9, extra_batch={"patches": patch})


def test_launch_serve_draws_patches(capsys, monkeypatch):
    """``launch.serve`` on a vlm smoke config passes seeded patches of (B,
    P, d) to ``generate``."""
    seen = {}
    generate = engine.ServeEngine.generate

    def tap(self, tokens, **kw):
        seen["patches"] = kw["extra_batch"]["patches"]
        return generate(self, tokens, **kw)

    monkeypatch.setattr(engine.ServeEngine, "generate", tap)
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--batch", "2", "--max-new", "4"]) == 0
    cfg = get_config(ARCH).smoke()
    assert seen["patches"].shape == (2, cfg.n_frontend_tokens, cfg.d_model)
    assert seen["patches"].dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, (2, 16))
    want = rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model))
    torch.testing.assert_close(seen["patches"],
                               torch.from_numpy(want).bfloat16())
    assert "[serve] seq 1:" in capsys.readouterr().out


def test_vlm_needs_its_patches(ref):
    """Without ``patches`` a vlm batch is malformed: the prefill raises
    rather than serving tokens alone."""
    cfg = ref["cfg"]
    port = build_model(cfg)
    caches = port.init_caches(1, 16, device="cpu")
    with pytest.raises(KeyError):
        port.prefill(ref["ports"]["f32"], {"tokens": np.zeros((1, 4))},
                     caches)
    dense = dataclasses.replace(cfg, family="dense", frontend=None)
    assert build_model(dense).input_specs(SHAPES["train_4k"])["tokens"][0] \
        == (256, 4096)
