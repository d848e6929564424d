"""The port's multi-chip substrate (``repro_torch.dist``, ``launch/mesh.py``,
the MoE mesh branch, elastic restore) against ``repro.dist``, on the CPU.

Layouts are held leaf by leaf, bit for bit: the port's model is built on
``meta`` at full size and its specs (``dist/sharding.py``) are compared
with the reference's ``param_pspecs`` / ``serve_param_shardings(...).spec``
on a ``jax.sharding.AbstractMesh`` of the production shapes, for all ten
configurations.  Per-device bytes: the port's blocks are separate tensors,
so a leaf the reference stacks and whose stack axis it shards over dp (a
rank-1 leaf stacked to (G, d) with G divisible by dp) is held by every dp
rank in the port; every other leaf holds exactly the reference's bytes.

The MoE branch and the meshed training step run on a gloo process group of
world size 1 (``make_host_mesh("cpu")``), started for this module and
destroyed after it; the reference's ``shard_map`` runs under its own
``use_mesh(make_host_mesh())`` on one CPU device.  Tolerances: the MoE
branch's y within 1e-5 (float32, the same products summed in another
order) and aux within 1e-6; dispatch (ranks, keep, slots) identical; the
meshed training step equal to the unmeshed one bit for bit (one rank's
DTensors run the same local kernels).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jax_get_config
from repro.dist import cache_sharding as jcache
from repro.dist import sharding as jshard
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import moe as jmoe
from repro.models.model import build_model as jax_build_model
from repro_torch.ckpt import checkpoint
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.dist import cache_sharding, sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.model import build_model, lm_module

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCHS = ("command-r-plus-104b", "internvl2-2b", "jamba-v0.1-52b",
         "minicpm-2b", "nemotron-4-340b", "qwen2-moe-a2.7b",
         "qwen3-moe-30b-a3b", "whisper-medium", "xlstm-1.3b", "yi-34b")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def host_mesh():
    """A gloo process group of world size 1 and its ("data",) mesh, for
    this module only."""
    mesh = mesh_mod.make_host_mesh("cpu")
    yield mesh
    mesh_mod.close_mesh()


def _path(jpath) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in jpath)


@pytest.fixture(scope="module")
def full_models():
    """{arch: (the port's module on meta, the reference's parameter
    shapes)} at full size."""
    out = {}
    for arch in ARCHS:
        model = lm_module(get_config(arch), device="meta")
        bundle = jax_build_model(jax_get_config(arch))
        shapes = jax.eval_shape(bundle.init, jax.random.PRNGKey(0))
        out[arch] = (model, shapes)
    return out


def _reference_specs(specs_tree) -> dict:
    return {_path(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                specs_tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _port_mesh(name):
    shape, names = MESHES[name]
    return sharding.AbstractMesh(shape, names)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_training_layout_matches_reference(full_models, arch, mesh_name):
    model, shapes = full_models[arch]
    jmesh = AbstractMesh(*MESHES[mesh_name])
    want = _reference_specs(jshard.param_pspecs(
        jmesh, shapes, jshard.logical_map(jmesh)))
    mesh = _port_mesh(mesh_name)
    got = sharding.param_pspecs(mesh, model, sharding.logical_map(mesh))
    assert set(got) == set(want)
    for path, spec in want.items():
        assert got[path] == spec, path


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_layout_matches_reference(full_models, arch, mesh_name):
    model, shapes = full_models[arch]
    jmesh = AbstractMesh(*MESHES[mesh_name])
    count = jax_get_config(arch).param_count()
    want = _reference_specs(jax.tree.map(
        lambda s: s.spec, jshard.serve_param_shardings(jmesh, shapes, count)))
    mesh = _port_mesh(mesh_name)
    assert count == get_config(arch).param_count()
    got = sharding.param_pspecs(mesh, model,
                                sharding.serve_lmap(mesh, count))
    for path, spec in want.items():
        assert got[path] == spec, path


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_bytes(full_models, arch, mesh_name):
    """Each leaf's bytes on one device: the port's blocks under their
    block specs against the reference's stacked leaf under its spec."""
    model, shapes = full_models[arch]
    mesh = _port_mesh(mesh_name)
    lmap = sharding.logical_map(mesh)
    specs = sharding.param_pspecs(mesh, model, lmap)
    blocks = sharding.block_specs(mesh, model, lmap)
    params = dict(model.named_parameters())
    sizes = sharding.axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in lmap["dp"])
    ref_leaves = {_path(p): s for p, s in
                  jax.tree_util.tree_flatten_with_path(shapes)[0]}
    for path, (shape, names) in sharding.leaves(model).items():
        ref = ref_leaves[path]
        assert tuple(ref.shape) == shape, path
        want = sharding.local_bytes(mesh, shape, ref.dtype.itemsize,
                                    specs[path])
        got = sum(sharding.local_bytes(mesh, tuple(params[n].shape),
                                       params[n].element_size(), blocks[n])
                  for n in names)
        stack_sharded = path[0] in tf.STACKED and specs[path][0] is not None
        assert got == (want * dp if stack_sharded else want), path


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_layouts(arch, shape_name, mesh_name):
    """``batch_shardings`` and ``cache_shardings`` on the reference's batch
    specs and cache shapes equal the reference's; on the port's own cache
    of a stack of attention layers (one stacked KVCache, the reference's
    layout at period 1) too."""
    jmesh = AbstractMesh(*MESHES[mesh_name])
    mesh = _port_mesh(mesh_name)
    jshape = JSHAPES[shape_name]
    bundle = jax_build_model(jax_get_config(arch))
    specs = bundle.input_specs(jshape)
    want = jax.tree.map(lambda s: tuple(s.spec),
                        jcache.batch_shardings(jmesh, specs))
    got = cache_sharding.batch_shardings(mesh, specs)
    assert got == want
    port_specs = build_model(get_config(arch)).input_specs(SHAPES[shape_name])
    assert cache_sharding.batch_shardings(
        mesh, {k: s for k, (s, _) in port_specs.items()}) == want
    if jshape.kind == "train":
        return
    b, s = jshape.global_batch, jshape.seq_len
    c_shapes = jax.eval_shape(lambda: bundle.init_caches(b, s))
    want = [tuple(tuple(x.spec) for x in leaf) for leaf in
            jcache.cache_shardings(jmesh, c_shapes, b)]
    got = cache_sharding.cache_shardings(mesh, c_shapes, b)
    assert [tuple(leaf) for leaf in got] == want
    cfg = get_config(arch)
    if cfg.family in ("dense", "moe"):
        caches = tf.init_caches(cfg, b, s, device="meta")
        mine = cache_sharding.cache_shardings(mesh, caches, b)
        assert (mine.k, mine.v) == want[0]


def test_shard_is_a_noop_outside_a_mesh_and_checks_rank(host_mesh):
    x = torch.ones((2, 3, 4))
    assert sharding.shard(x, "dp", None, "tp") is x
    assert sharding.shard(x, "dp") is x             # no mesh: no check
    with sharding.use_mesh(host_mesh):
        with pytest.raises(ValueError, match="3 dims for rank-2"):
            sharding.shard(torch.ones((2, 3)), "dp", None, "tp")
        assert sharding.shard(x, "dp", None, None) is x   # not a DTensor
        from torch.distributed.tensor import Shard, distribute_tensor

        d = distribute_tensor(x, host_mesh, (sharding.placements(
            host_mesh, (None, None, None))))
        got = sharding.shard(d, "dp", None, None)
        assert tuple(got.placements) == (Shard(0),)
        assert torch.equal(got.full_tensor(), x)
    assert sharding.active_ctx() is None


def test_spec_guards_and_placements():
    mesh = _port_mesh("2x16x16")
    lmap = sharding.logical_map(mesh)
    assert lmap == {"dp": ("pod", "data"), "tp": ("model",)}
    # 33 does not divide 32 dp ranks: replicated; 48 divides 16 tp ranks
    assert sharding._spec_for(mesh, lmap, (33, 48), ("dp", "tp")) == \
        (None, "model")
    assert sharding._spec_for(mesh, lmap, (64, 7), ("dp", "tp")) == \
        (("pod", "data"), None)
    assert sharding.param_pspecs_of(mesh, lmap, "w2", (64, 32)) == \
        ("model", ("pod", "data"))
    assert sharding.param_pspecs_of(mesh, lmap, "router", (64, 32)) == \
        (None, None)


def test_mesh_helpers(host_mesh):
    assert mesh_mod.dp_size(host_mesh) == 1
    assert mesh_mod.tp_size(host_mesh) == 1
    assert host_mesh.mesh_dim_names == ("data",)
    assert sharding.logical_map(host_mesh) == {"dp": ("data",), "tp": ()}


def _moe_pair(d, f, e, k, shared, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, f, e, k,
                       n_shared_experts=shared, dtype=jnp.float32)
    p = moe.MoE(d, f, e, n_shared_experts=shared, device="cpu",
                dtype=torch.float32)
    with torch.no_grad():
        p.router.w.copy_(torch.from_numpy(np.array(jp["router"]["w"])))
        for n in ("w1", "w3", "w2"):
            getattr(p, n).copy_(torch.from_numpy(np.array(jp[n])))
            if shared:
                getattr(p.shared, n).copy_(
                    torch.from_numpy(np.array(jp["shared"][n])))
    return jp, p


def _distributed(p, mesh, lmap):
    """``p``'s leaves as DTensors of the training layout under ``lmap``."""
    from torch.distributed.tensor import distribute_tensor

    names = ["router", "w1", "w3", "w2"] + (
        ["w1", "w3", "w2"] if hasattr(p, "shared") else [])
    return [distribute_tensor(w.detach(), mesh, sharding.placements(
        mesh, sharding.param_pspecs_of(mesh, lmap, n, tuple(w.shape))))
        for n, w in zip(names, p.leaves())]


# (label, B, T, d, f, E, k, shared, skew)
MOE_CASES = [
    ("qwen2-like", 2, 48, 64, 128, 60, 4, 4, 0.0),
    ("qwen2-like drops", 2, 96, 64, 128, 60, 4, 4, 3.0),
    ("qwen3-like", 2, 40, 64, 32, 128, 8, 0, 0.5),
]


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: c[0])
def test_moe_mesh_branch_matches_shard_map(host_mesh, case, serving):
    """The port's ``local_map`` branch against the reference's
    ``shard_map`` branch, each under its own one-device mesh: y within
    1e-5, aux within 1e-6, and the flat row's dispatch (one row of B T
    tokens at ``capacity(B T)``) identical to the reference's."""
    from torch.distributed.tensor import distribute_tensor

    label, b, t, d, f, e, k, shared, skew = case
    jp, p = _moe_pair(d, f, e, k, shared)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, t, d)) + skew * rng.standard_normal(d)
    x = (x / np.sqrt(1.0 + skew ** 2)).astype(np.float32)
    with jshard.use_mesh(jax_host_mesh()):
        want, jaux = jmoe.moe(jp, jnp.asarray(x), top_k=k, serving=serving)
    mesh = host_mesh
    with torch.no_grad(), sharding.use_mesh(mesh):
        dx = distribute_tensor(torch.from_numpy(x), mesh,
                               sharding.placements(mesh, ("data", None,
                                                          None)))
        leaves = _distributed(p, mesh, sharding.logical_map(mesh))
        for n, w in zip(("router.w", "w1", "w3", "w2"), leaves):
            mod, _, attr = n.rpartition(".")
            setattr(p.get_submodule(mod) if mod else p, attr,
                    torch.nn.Parameter(w, requires_grad=False))
        if shared:
            for n, w in zip(("w1", "w3", "w2"), leaves[4:]):
                setattr(p.shared, n, torch.nn.Parameter(
                    w, requires_grad=False))
        got, aux = moe.moe(p, dx, top_k=k, serving=serving)
        got = got.full_tensor()
        aux = {key: v.full_tensor() for key, v in aux.items()}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    for key in ("load_balance_loss", "dropped_fraction"):
        assert abs(float(aux[key]) - float(jaux[key])) <= 1e-6, key
    # the flat row's dispatch, fed the reference's expert ids
    _, idx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x, jnp.float32).reshape(1, b * t, d)
        @ jp["router"]["w"], axis=-1), k)
    cap = moe.capacity(b * t, e, k)
    assert cap == jmoe._cap_for(b * t, e, k, 1.25)
    ref = _reference_flat_dispatch(np.asarray(idx)[0], e, cap)
    disp = moe.dispatch(torch.from_numpy(np.asarray(idx)).long(), e, cap)
    np.testing.assert_array_equal(disp.rank[0].numpy(), ref["rank"])
    np.testing.assert_array_equal(disp.keep[0].numpy(), ref["keep"])
    np.testing.assert_array_equal(disp.slot[0].numpy(), ref["slot"])
    if "drops" in label:
        assert float(jaux["dropped_fraction"]) > 0


def _reference_flat_dispatch(idx, e, cap):
    """``repro/models/moe.py:94-130`` on one flat row (the mesh branch's)."""
    n_tok, top_k = idx.shape
    pairs_e = jnp.asarray(idx).reshape(-1)
    n_pairs = n_tok * top_k
    order = jnp.argsort(pairs_e)
    inv_order = jnp.argsort(order)
    e_s = pairs_e[order]
    i = jnp.arange(n_pairs)
    boundary = jnp.concatenate([jnp.array([True]), e_s[1:] != e_s[:-1]])
    seg_start = jax.lax.cummax(jnp.where(boundary, i, 0))
    rank = i - seg_start
    keep = rank < cap
    rank_orig, keep_orig = rank[inv_order], keep[inv_order]
    slot = jnp.where(keep_orig, pairs_e * cap + rank_orig, e * cap)
    return {"rank": np.asarray(rank_orig), "keep": np.asarray(keep_orig),
            "slot": np.asarray(slot)}


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2-moe-a2.7b"])
def test_meshed_training_step_equals_unmeshed(host_mesh, arch):
    """A smoke training step under ``use_mesh`` with the training layout
    (parameters, gradients and AdamW moments DTensors of one rank) equals
    the same step without a mesh, bit for bit for the dense stack; the MoE
    stack takes the mesh branch (one flat row, its own capacity), whose
    loss is held to the reference's mesh branch by the test above, so its
    step is held to run and stay finite."""
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step
    from repro_torch.train.trainer import distribute_train_state

    cfg = get_config(arch).smoke()
    bundle = build_model(cfg)
    tc = TrainConfig(n_micro=1, warmup=4)
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}

    def run(mesh):
        model = bundle.init(0, device="cpu", dtype=torch.float32)
        opt = init_opt_state(dict(model.named_parameters()), tc.adamw)
        opt["count"] += 8
        step = make_train_step(bundle, tc)
        if mesh is None:
            return step(model, opt, batch)
        model, opt = distribute_train_state(model, opt, mesh)
        with sharding.use_mesh(mesh):
            return step(model, opt, batch)

    def whole(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    m0, o0, met0 = run(None)
    m1, o1, met1 = run(host_mesh)
    if arch == "minicpm-2b":
        for key in met0:
            assert torch.equal(whole(met0[key]), whole(met1[key])), key
        for (n, a), (_, b) in zip(m0.named_parameters(),
                                  m1.named_parameters()):
            assert torch.equal(a.detach(), whole(b.detach())), n
        for n in o0["mu"]:
            assert torch.equal(o0["mu"][n], whole(o1["mu"][n])), n
    else:
        assert math.isfinite(float(whole(met1["loss"])))
        assert float(whole(met1["grad_norm"])) > 0


def test_elastic_restore_onto_a_mesh(host_mesh, tmp_path):
    """A checkpoint written from a meshed training state (parameters and
    moments DTensors) holds every leaf whole: it restores as plain tensors
    equal to the state gathered whole, and distributes onto the mesh again
    in the training layout, each moment as its parameter."""
    from torch.distributed.tensor import DTensor

    from repro_torch import convert
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.trainer import distribute_train_state

    cfg = get_config("minicpm-2b").smoke()
    bundle = build_model(cfg)

    def state():
        model = bundle.init(0, device="cpu", dtype=torch.float32)
        opt = init_opt_state(dict(model.named_parameters()), AdamWConfig())
        for n, t in opt["mu"].items():
            t.copy_(torch.randn(t.shape, generator=torch.Generator()
                                .manual_seed(len(n))))
        return model, opt

    model, opt = distribute_train_state(*state(), host_mesh)
    tree = {"params": convert.lm_params_to_numpy(model, keep_bf16=True),
            "opt": convert.opt_state_to_numpy(opt, model, keep_bf16=True)}
    checkpoint.save(str(tmp_path / "step_1"), tree, step=1)
    fresh, fresh_opt = state()
    like = convert.train_state_like(fresh, fresh_opt)
    got, step = checkpoint.restore(str(tmp_path / "step_1"), like)
    assert step == 1
    convert.load_lm_params(fresh, got["params"])
    fresh_opt = convert.opt_state_from_numpy(got["opt"], fresh)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              fresh.named_parameters()):
        assert not isinstance(b, DTensor)
        assert torch.equal(a.detach().full_tensor(), b.detach()), n
    for n, t in opt["mu"].items():
        assert torch.equal(t.full_tensor(), fresh_opt["mu"][n]), n
    again, again_opt = distribute_train_state(fresh, fresh_opt, host_mesh)
    specs = sharding.param_shardings(host_mesh, again)
    for n, p in again.named_parameters():
        assert isinstance(p, DTensor), n
        want = tuple(sharding.placements(host_mesh, specs[n]))
        assert tuple(p.placements) == want, n
        assert tuple(again_opt["mu"][n].placements) == want, n
        assert torch.equal(again_opt["mu"][n].full_tensor(),
                           opt["mu"][n].full_tensor()), n


def test_trainer_resumes_onto_a_mesh(host_mesh, tmp_path):
    """The trainer's elastic resume: a run checkpointed without a mesh
    resumes on one, its parameters and moments distributed in the training
    layout, and ends where an unmeshed resume ends, bit for bit."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("minicpm-2b").smoke()
    bundle = build_model(cfg)
    tc = TrainConfig(n_micro=1, warmup=2, total_steps=10)

    def trainer(d, steps, mesh=None):
        pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=16, global_batch=2))
        return Trainer(bundle, tc, TrainerConfig(
            steps=steps, ckpt_dir=str(d), ckpt_every=2, async_ckpt=False),
            pipe, device="cpu", mesh=mesh)

    for d in ("plain", "meshed"):
        trainer(tmp_path / d, 2).run()
    plain = trainer(tmp_path / "plain", 3).run()
    meshed = trainer(tmp_path / "meshed", 3, mesh=host_mesh).run()
    assert meshed["final_step"] == plain["final_step"] == 3
    for (n, a), (_, b) in zip(plain["model"].named_parameters(),
                              meshed["model"].named_parameters()):
        assert hasattr(b, "full_tensor"), n
        assert torch.equal(a.detach(), b.detach().full_tensor()), n
