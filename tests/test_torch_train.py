"""The port's training slice against the reference, on the CPU: the loss
and its gradients, the schedules, AdamW, gradient compression, the train
step, the token pipeline, checkpoints (both ways), the trainer's restart,
preemption and straggler logic, and ``launch.train``.

The smoke ``minicpm-2b`` (MHA) and ``yi-34b`` (GQA) carry the reference's
parameters across with ``convert.lm_params_from_numpy``.  Tolerances, with
the difference measured at these inputs in parentheses:

* loss and gradients cast to float32: the loss within 1e-5 (2e-6
  measured), each gradient leaf within a relative L2 of 1e-5 (1.1e-6);
  in bf16, the reference's own parameter dtype, the loss within 1e-2
  (3.1e-3) and each leaf within a relative L2 of 5e-2 (1.6e-2): bf16
  products round at other places in the two frameworks;
* schedules: ``wsd`` exact, ``warmup_cosine`` within 2 ulp (XLA's float32
  cosine is not correctly rounded; the port rounds a float64 cosine);
* AdamW against the reference's un-jitted update: exact, for float32 and
  for bf16 state, where the gradients' norm is under the clip (over it,
  the norm's sum order sets the scale, within 1 ulp);
* ``sm2_quantize``: words bit-exact, levels within 1e-6 (exact measured);
* the train step against the reference's jitted step over three steps
  (float32 parameters): loss within 1e-5 (1.4e-6), grad norm within a
  relative 1e-5 (3.4e-6), learning rate within 2 ulp (XLA fuses the
  schedule under jit), every parameter leaf within a relative L2 of 5e-5
  (1.5e-5 measured, on the embedding: AdamW's normalisation amplifies the
  float32 differences of its smallest gradients).
"""

import dataclasses
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import all_configs as jall_configs
from repro.configs.base import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models.model import build_model as jbuild_model
from repro.models.model import cross_entropy as jcross_entropy
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro.train import train_step as jtrain_step
from repro_torch import convert
from repro_torch.ckpt import checkpoint
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models.model import build_model, cross_entropy
from repro_torch.models.transformer import param_groups
from repro_torch.optim import adamw, compress, schedule
from repro_torch.train import train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCHS = ("minicpm-2b", "yi-34b")


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / norm) if norm else \
        float(np.linalg.norm(got))


def _assert_trees_close(got, want, rel: float):
    got_l, want_l = _leaves(got), _leaves(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        w = np.asarray(w, np.float32)
        assert np.shape(g) == w.shape, path
        assert _rel_l2(g, w) <= rel, (path, _rel_l2(g, w))


def _batch(rng, vocab, b=4, s=24, masked=True):
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    if masked:
        labels[:, :3] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.fixture(scope="module")
def ref():
    out = {}
    for name in ARCHS:
        jcfg = jget_config(name).smoke()
        build = jbuild_model(jcfg)
        params = build.init(jax.random.PRNGKey(0))
        out[name] = {"jcfg": jcfg, "cfg": get_config(name).smoke(),
                     "jbundle": build, "params": params}
    return out


def _port(r, dtype):
    params = r["params"]
    if dtype == "f32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         r["cfg"], device="cpu")
    return params, model


# -- loss and gradients -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_match_reference(ref, name, dtype):
    r = ref[name]
    params, model = _port(r, dtype)
    batch = _batch(np.random.default_rng(0), r["jcfg"].vocab_size)
    grad_fn = jax.jit(jax.value_and_grad(r["jbundle"].loss, has_aux=True))
    (jl, jm), jg = grad_fn(params,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = build_model(r["cfg"]).loss(model, batch)
    loss.backward()
    grads = convert.named_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}, model)
    assert abs(loss.item() - float(jl)) <= (1e-5 if dtype == "f32" else 1e-2)
    assert metrics["tokens"].item() == float(jm["tokens"]) == 4 * 21
    assert metrics["load_balance_loss"].item() == 0.0
    assert metrics["dropped_fraction"].item() == 0.0
    _assert_trees_close(grads, jg, 1e-5 if dtype == "f32" else 5e-2)
    # every attention weight has a gradient
    for blk in model.blocks:
        for lin in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo):
            assert lin.w.grad is not None and lin.w.grad.abs().sum() > 0


def test_remat_gives_the_same_gradients(ref):
    r = ref["yi-34b"]
    batch = _batch(np.random.default_rng(1), r["jcfg"].vocab_size)
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(r["cfg"], remat=remat)
        model = convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, r["params"]), cfg, device="cpu")
        loss, _ = build_model(cfg).loss(model, batch)
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


def test_cross_entropy_with_masked_labels():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (3, 7)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 6] = -100
    want, want_n = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                  40)
    got, got_n = cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels).long(), 40)
    assert got_n.item() == float(want_n) == 21 - 5
    assert abs(got.item() - float(want)) <= 1e-6
    none = torch.full((2, 3), -1)
    loss, n = cross_entropy(torch.zeros((2, 3, 5)), none, 5)
    assert loss.item() == 0.0 and n.item() == 0.0


def test_input_specs_match_reference(ref):
    r = ref["minicpm-2b"]
    port = build_model(r["cfg"])
    for name, shape in SHAPES.items():
        want = r["jbundle"].input_specs(JSHAPES[name])
        got = port.input_specs(shape)
        assert set(got) == set(want)
        for k, (shp, dt) in got.items():
            assert shp == want[k].shape and dt == torch.int32


# -- schedules, AdamW, compression --------------------------------------------


def _ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32))
               - int(np.float32(b).view(np.int32)))


COSINE = [dict(peak_lr=3e-4, warmup=5, total=40),
          dict(peak_lr=1e-2, warmup=0, total=17, final_frac=0.2),
          dict(peak_lr=3e-4, warmup=200, total=10_000),
          dict(peak_lr=3e-4, warmup=2, total=10)]
WSD = [dict(peak_lr=3e-4, warmup=5, stable=32, decay=4),
       dict(peak_lr=1e-3, warmup=2, stable=8, decay=1),
       dict(peak_lr=3e-4, warmup=2, stable=8, decay=1, final_frac=0.1)]


def test_schedules_match_reference():
    for step in range(41):
        for kw in COSINE:
            assert _ulps(schedule.warmup_cosine(step, **kw).item(),
                         jschedule.warmup_cosine(step, **kw)) <= 2, (step, kw)
        for kw in WSD:
            assert schedule.wsd(step, **kw).item() == np.float32(
                jschedule.wsd(step, **kw)), (step, kw)
    # a count tensor stays a tensor (no host sync)
    lr = schedule.wsd(torch.tensor(3, dtype=torch.int32), **WSD[0])
    assert lr.dtype == torch.float32 and lr.ndim == 0


@pytest.mark.parametrize("state", ["f32", "bf16"])
def test_adamw_matches_reference(state):
    rng = np.random.default_rng(3)
    shapes = {"a": (33, 17), "b": (64,), "c": (5, 7, 9)}
    jcfg = jadamw.AdamWConfig(
        state_dtype=jnp.float32 if state == "f32" else jnp.bfloat16)
    cfg = adamw.AdamWConfig(
        state_dtype=torch.float32 if state == "f32" else torch.bfloat16)
    start = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    jst, tst = jadamw.init_opt_state(jp, jcfg), adamw.init_opt_state(tp, cfg)
    for it in range(6):
        g = {k: (rng.standard_normal(s) * 0.01).astype(np.float32)
             for k, s in shapes.items()}
        lr = np.float32(1e-3 * (it + 1))
        jp, jst, jm = jadamw.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jst, jcfg,
            jnp.float32(lr))
        tp, tst, tm = adamw.adamw_update(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, tst, cfg,
            torch.tensor(lr))
        assert float(jm["grad_norm"]) < 1.0
        assert int(tst["count"]) == int(jst["count"]) == it + 1
        for k in shapes:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
            for m in ("mu", "nu"):
                assert tst[m][k].dtype == cfg.state_dtype
                np.testing.assert_array_equal(
                    tst[m][k].float().numpy(),
                    np.asarray(jst[m][k], np.float32))


def test_global_norm_and_clip():
    g = {"a": torch.full((10,), 3.0), "b": torch.full((6,), 4.0)}
    assert abs(adamw.global_norm(g).item()
               - float(jadamw.global_norm({k: jnp.asarray(v.numpy())
                                          for k, v in g.items()}))) <= 1e-5


@pytest.mark.parametrize("n", [1, 31, 100, 4097, 33_000, 100_003])
def test_sm2_quantize_matches_reference(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    if n > 100:
        x[:50], x[50:100] = 0.25, -0.25          # ties of |x|
    jw, jcw, jcs = jcompress.sm2_quantize(jnp.asarray(x))
    tw, tcw, tcs = compress.sm2_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int32))
    assert abs(tcw.item() - float(jcw)) <= 1e-6
    assert abs(tcs.item() - float(jcs)) <= 1e-6
    dec = compress.sm2_dequantize(tw, tcw, tcs, n, (n,))
    want = jcompress.sm2_dequantize(jw, jcw, jcs, n, (n,))
    np.testing.assert_allclose(dec.numpy(), np.asarray(want), atol=1e-6)


def test_error_feedback_and_groups(ref):
    r = ref["yi-34b"]
    params, model = _port(r, "f32")
    rng = np.random.default_rng(4)
    named = dict(model.named_parameters())
    grads = {n: torch.from_numpy(rng.standard_normal(p.shape)
                                 .astype(np.float32)) for n, p in named.items()}
    ef = compress.init_error_feedback(named)
    ef = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)
                              * 0.1) for n, p in ef.items()}
    jgrads = convert.named_to_numpy(grads, model)
    jef = convert.named_to_numpy(ef, model)
    want_g, want_ef = jax.jit(jcompress.compress_decompress_tree)(
        jax.tree.map(jnp.asarray, jgrads), jax.tree.map(jnp.asarray, jef))
    got_g, got_ef = compress.compress_decompress_tree(
        dict(grads), ef, param_groups(model))
    _assert_trees_close(convert.named_to_numpy(got_g, model), want_g, 1e-6)
    _assert_trees_close(convert.named_to_numpy(got_ef, model), want_ef, 1e-6)
    # a stacked reference leaf is one tensor: one tau over every layer
    assert compress.compression_ratio(named, param_groups(model)) == \
        jcompress.compression_ratio(params)
    assert compress.compression_ratio(named) != \
        jcompress.compression_ratio(params)


def test_compressed_psum_is_the_sum_of_round_trips():
    xs = np.random.default_rng(5).standard_normal((4, 256)).astype(np.float32)
    want = sum(np.asarray(jcompress.sm2_dequantize(
        *jcompress.sm2_quantize(jnp.asarray(x)), 256, (256,))) for x in xs)
    got = compress.compressed_psum([torch.from_numpy(x) for x in xs])
    assert len(got) == 4
    for g in got:
        np.testing.assert_allclose(g.numpy(), want, atol=1e-6)
    exact = xs.sum(0)
    cos = got[0].numpy() @ exact / (np.linalg.norm(got[0].numpy())
                                    * np.linalg.norm(exact))
    assert cos > 0.6


# -- the train step ------------------------------------------------------------


@pytest.mark.parametrize("name,n_micro,compressed", [
    ("minicpm-2b", 1, False), ("minicpm-2b", 2, False),
    ("minicpm-2b", 1, True), ("minicpm-2b", 2, True),
    ("yi-34b", 2, True)])
def test_train_step_matches_reference(ref, name, n_micro, compressed):
    r = ref[name]
    params, model = _port(r, "f32")
    kw = dict(n_micro=n_micro, peak_lr=1e-3, warmup=1, total_steps=10,
              compress_grads=compressed)
    jtc, tc = jtrain_step.TrainConfig(**kw), train_step.TrainConfig(**kw)
    jopt = jadamw.init_opt_state(params, jtc.adamw)
    opt = adamw.init_opt_state(dict(model.named_parameters()), tc.adamw)
    if compressed:
        jopt["ef"] = jcompress.init_error_feedback(params)
        opt["ef"] = compress.init_error_feedback(
            dict(model.named_parameters()))
    jstep = jax.jit(jtrain_step.make_train_step(r["jbundle"], jtc))
    step = train_step.make_train_step(build_model(r["cfg"]), tc)
    rng = np.random.default_rng(6)
    for _ in range(3):
        batch = _batch(rng, r["jcfg"].vocab_size, masked=False)
        params, jopt, jm = jstep(params, jopt,
                                 {k: jnp.asarray(v) for k, v in batch.items()})
        model, opt, m = step(model, opt, batch)
        assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5
        assert abs(m["grad_norm"].item() / float(jm["grad_norm"]) - 1) <= 1e-5
        assert _ulps(m["lr"].item(), jm["lr"]) <= 2
        assert int(opt["count"]) == int(jopt["count"])
        _assert_trees_close(convert.lm_params_to_numpy(model), params, 5e-5)
    _assert_trees_close(convert.opt_state_to_numpy(opt, model)["mu"],
                        jopt["mu"], 1e-4)


def test_suggest_n_micro_matches_reference():
    for jcfg in jall_configs().values():
        for shape in JSHAPES.values():
            for dp in (1, 8, 64, 256):
                assert train_step.suggest_n_micro(jcfg, shape, dp) == \
                    jtrain_step.suggest_n_micro(jcfg, shape, dp)
    for name in ARCHS:
        for key, shape in SHAPES.items():
            assert train_step.suggest_n_micro(get_config(name), shape, 8) \
                == jtrain_step.suggest_n_micro(jget_config(name),
                                               JSHAPES[key], 8)


# -- data, checkpoints, the trainer --------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_token_pipeline_matches_reference(seed):
    for n_hosts in (1, 4):
        kw = dict(vocab_size=503, seq_len=33, global_batch=8, seed=seed)
        for host in range(n_hosts):
            mine = TokenPipeline(DataConfig(**kw), host_id=host,
                                 n_hosts=n_hosts)
            theirs = JTokenPipeline(JDataConfig(**kw), host_id=host,
                                    n_hosts=n_hosts)
            for step in (0, 1, 5, 123):
                a, b = mine.batch_at(step), theirs.batch_at(step)
                for k in ("tokens", "labels"):
                    assert a[k].dtype == b[k].dtype == np.int32
                    np.testing.assert_array_equal(a[k], b[k])
    it = TokenPipeline(DataConfig(vocab_size=50, seq_len=8, global_batch=2,
                                  seed=seed)).iterate(start_step=3)
    first = next(it)
    np.testing.assert_array_equal(
        first["tokens"], JTokenPipeline(JDataConfig(
            vocab_size=50, seq_len=8, global_batch=2, seed=seed))
        .batch_at(3)["tokens"])


@pytest.mark.parametrize("state", ["f32", "bf16"])
def test_checkpoints_cross_load(ref, tmp_path, state):
    r = ref["minicpm-2b"]
    jtc = jtrain_step.TrainConfig(compress_grads=True, adamw=jadamw.AdamWConfig(
        state_dtype=jnp.float32 if state == "f32" else jnp.bfloat16))
    tc = train_step.TrainConfig(compress_grads=True, adamw=adamw.AdamWConfig(
        state_dtype=torch.float32 if state == "f32" else torch.bfloat16))
    bundle = build_model(r["cfg"])
    model, opt = train_step.init_train_state(bundle, tc, 3, device="cpu")
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for tree in (opt["mu"], opt["nu"], opt["ef"]):
            for t in tree.values():
                t.copy_(torch.from_numpy(rng.standard_normal(t.shape)
                                         .astype(np.float32)))
    opt["count"].fill_(5)
    # the port writes, the reference restores
    checkpoint.save(str(tmp_path / "port"), {
        "params": convert.lm_params_to_numpy(model, keep_bf16=True),
        "opt": convert.opt_state_to_numpy(opt, model, keep_bf16=True)},
        step=5)
    jparams, jopt = jtrain_step.init_train_state(r["jbundle"], jtc,
                                                 jax.random.PRNGKey(1))
    got, step = jckpt.restore(str(tmp_path / "port"),
                              {"params": jparams, "opt": jopt})
    assert step == 5 and int(got["opt"]["count"]) == 5
    assert got["params"]["embed"]["w"].dtype == jnp.bfloat16
    assert got["params"]["final_norm"]["scale"].dtype == jnp.float32
    assert got["opt"]["mu"]["embed"]["w"].dtype == jopt["mu"]["embed"][
        "w"].dtype
    want = {"params": convert.lm_params_to_numpy(model),
            "opt": convert.opt_state_to_numpy(opt, model)}
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert np.shape(g) == np.shape(w), path
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32), str(path))
    # the reference writes, the port restores
    jckpt.save(str(tmp_path / "ref"), {"params": jparams, "opt": jopt},
               step=9)
    assert checkpoint.latest_step(str(tmp_path)) == 9
    fresh, fopt = train_step.init_train_state(bundle, tc, 4, device="cpu")
    tree, step = checkpoint.restore(str(tmp_path / "ref"),
                                    convert.train_state_like(fresh, fopt))
    assert step == 9
    convert.load_lm_params(fresh, tree["params"])
    fopt = convert.opt_state_from_numpy(tree["opt"], fresh)
    assert fresh.embed.w.dtype == torch.bfloat16
    assert fopt["mu"]["embed.w"].dtype == tc.adamw.state_dtype
    mine = {"params": convert.lm_params_to_numpy(fresh),
            "opt": convert.opt_state_to_numpy(fopt, fresh)}
    assert fopt["count"].shape == () and int(fopt["count"]) == 0
    for (path, g), (_, w) in zip(_leaves(mine),
                                 _leaves({"params": jparams, "opt": jopt})):
        assert np.shape(g) == np.shape(w), path
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32), str(path))


def _trainer(ref, ckpt_dir, steps, ckpt_every=2, **kw):
    r = ref["minicpm-2b"]
    tc = train_step.TrainConfig(n_micro=2, peak_lr=5e-3, warmup=1,
                                total_steps=8, schedule="wsd",
                                compress_grads=True)
    pipeline = TokenPipeline(DataConfig(vocab_size=r["cfg"].vocab_size,
                                        seq_len=16, global_batch=4))
    return Trainer(build_model(r["cfg"]), tc,
                   TrainerConfig(steps=steps, ckpt_dir=ckpt_dir,
                                 ckpt_every=ckpt_every, log_every=1, **kw),
                   pipeline, seed=0, device="cpu")


def _state(result):
    model, opt = result["model"], result["opt_state"]
    return {"params": convert.lm_params_to_numpy(model),
            "opt": convert.opt_state_to_numpy(opt, model)}


def test_trainer_restart_is_bit_exact(ref, tmp_path, monkeypatch):
    whole = _trainer(ref, None, 5).run()
    # step 3 runs (updating the state in place) while step 2's checkpoint
    # is written on the writer thread, held back until step 3 is done
    savez = checkpoint.np.savez

    def slow_savez(*args, **kw):
        time.sleep(1.0)
        savez(*args, **kw)

    monkeypatch.setattr(checkpoint.np, "savez", slow_savez)
    first = _trainer(ref, str(tmp_path), 3).run()
    assert first["final_step"] == 3
    assert checkpoint.latest_step(str(tmp_path)) == 2
    resumed = _trainer(ref, str(tmp_path), 5, ckpt_every=100).run()
    assert resumed["final_step"] == 5
    assert [m["step"] for m in resumed["metrics"]] == [2, 3, 4]
    assert [m["loss"] for m in resumed["metrics"]] == \
        [m["loss"] for m in whole["metrics"][2:]]
    for (path, a), (_, b) in zip(_leaves(_state(resumed)),
                                 _leaves(_state(whole))):
        np.testing.assert_array_equal(a, b, str(path))


def test_trainer_sigterm_saves_and_stops(ref, tmp_path):
    trainer = _trainer(ref, str(tmp_path), 10, ckpt_every=100,
                       async_ckpt=True)
    step_fn = trainer.step_fn
    calls = []
    on_main = threading.current_thread() is threading.main_thread()

    def step_then_preempt(model, opt, batch):
        calls.append(1)
        if len(calls) == 3:
            if on_main:
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                trainer._preempted = True
        return step_fn(model, opt, batch)

    trainer.step_fn = step_then_preempt
    old = signal.getsignal(signal.SIGTERM)
    try:
        result = trainer.run()
    finally:
        if on_main:
            signal.signal(signal.SIGTERM, old)
    assert result["final_step"] == 3
    assert checkpoint.latest_step(str(tmp_path)) == 3
    # off the main thread the handler cannot be installed: swallowed
    t = threading.Thread(target=trainer._install_signal_handler)
    t.start()
    t.join()


def test_straggler_detector_flags_the_slow_step(ref):
    trainer = _trainer(ref, None, 16)
    times = [0.02] * 10 + [0.5] + [0.02] * 5
    calls = []

    def timed(model, opt, batch):
        time.sleep(times[len(calls)])
        calls.append(1)
        zero = torch.zeros(())
        return model, opt, {"loss": zero, "grad_norm": zero}

    trainer.step_fn = timed
    result = trainer.run()
    assert [e["step"] for e in result["stragglers"]] == [10]
    assert result["stragglers"][0]["dt"] >= 0.5


def test_launch_train_smoke_runs(capsys):
    result = launch_train.main(["--arch", "minicpm-2b", "--smoke",
                                "--device", "cpu", "--steps", "4",
                                "--seq-len", "16", "--global-batch", "4"])
    assert result["final_step"] == 4
    out = capsys.readouterr().out
    assert "[train] done at step 4" in out
    # a full config off a production mesh prints the plan and returns
    assert launch_train.main(["--arch", "minicpm-2b", "--device", "cpu"]) \
        is None
    assert "needs a production mesh" in capsys.readouterr().out
