"""The port's dry-run tools (``repro_torch.tools``, ``launch/dryrun.py``)
against ``repro.tools``, on the CPU.

* ``model_flops_for`` equals the reference's for every config x shape.
* ``tools/op_cost.py``'s ``"dot_general"`` against the reference's
  ``trace_cost(...)["by_prim"]["dot_general"]`` (a jaxpr walk) for a smoke
  config's training step, prefill and decode, run for real on the CPU:
  within a relative 1e-9, i.e. equal up to float summation.  Both count
  ``2 b m n k`` a product, and every product is the same one: the plain
  attention's einsums are the reference's (every (row, key) pair of the
  full key range), a remat block's forward runs again in its backward in
  both, and each product's backward is two products in both.  jamba's
  mamba scan, a custom op priced by ``op_cost``, counts as its loop.
  xlstm's count is below the reference's by a closed form (:func:`_gap`):
  the products that the port's cells write as elementwise work or skip.
* ``tools/collectives.py`` on a known ``full_tensor()``.
* ``tools/report.py``'s tables equal the reference's for the same JSON.
* Smoke dense, MoE, hybrid and ssm cells of ``launch/dryrun.py`` on fake
  16x16 and 2x16x16 meshes (a fake process group of 256 or 512 ranks,
  started for a cell and destroyed with this module): each finishes within
  its own time limit with every roofline key, the flash kernels counted
  through their custom ops (pairs they visit, and the dense pairs beside
  them), and collectives on the mesh.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro.tools import jaxpr_cost
from repro.tools import report as jreport
from repro.tools.roofline import model_flops_for as jax_model_flops_for
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import init_opt_state
from repro_torch.tools import collectives, op_cost, report, roofline
from repro_torch.train.train_step import TrainConfig, make_train_step

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCHS = ("command-r-plus-104b", "internvl2-2b", "jamba-v0.1-52b",
         "minicpm-2b", "nemotron-4-340b", "qwen2-moe-a2.7b",
         "qwen3-moe-30b-a3b", "whisper-medium", "xlstm-1.3b", "yi-34b")
DOT_RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _close_process_group():
    """The fake process groups the cells start end with this module."""
    yield
    mesh_mod.close_mesh()


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch, shape_name):
    assert roofline.model_flops_for(get_config(arch), SHAPES[shape_name]) \
        == jax_model_flops_for(jax_get_config(arch), JSHAPES[shape_name])


@pytest.fixture(scope="module", params=["minicpm-2b", "qwen2-moe-a2.7b",
                                        "jamba-v0.1-52b", "xlstm-1.3b"])
def smoke_pair(request):
    """(arch, the reference's bundle and smoke parameters, the port's
    bundle and model holding the same parameters), float32."""
    arch = request.param
    jb = jax_build_model(jax_get_config(arch).smoke())
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jb.init(jax.random.PRNGKey(0)))
    cfg = get_config(arch).smoke()
    bundle = build_model(cfg)
    model = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, dtype=torch.float32,
        device="cpu")
    return arch, jb, params, bundle, model


def _tokens(vocab, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)) \
        .astype(np.int32)


def _close(got, want):
    assert want > 0
    assert abs(got - want) <= DOT_RTOL * want, (got, want)


def _gap(cfg, kind: str, b: int, t: int) -> int:
    """The reference's ``dot_general`` less the port's for a step of
    ``kind`` over (b, t) tokens: 0 but for xlstm.  Per mLSTM layer (H
    heads of hd = dk = dv, T padded to whole chunks of L = min(64, T)):

    * forward (prefill), 6 B H T dk: the reference's chunk forms three
      products that the port writes as elementwise work, the denominator
      ``einsum('bhtd,bhtd->bht')``, the state's ``einsum('bhs,bhsd->bhd')``
      and the first product of the three-operand ``einsum('bhs,bhsd,bhsv->
      bhdv')`` (src_w by k; the port scales k elementwise, then one
      product with v);
    * decode, 2 B H dk: the sequential form's denominator einsum;
    * a training step, the forward's 6 B H T dk, their transposes 12 B H T
      dk, and 6 B H L dk dv: the reference's scan transposes every chunk's
      body whole, where autograd skips the gradient of the zero initial
      state (``q C`` of the first chunk, 2 B H L dk dv) and the last
      chunk's state update, which nothing reads (its product with v, two
      transposes, 4 B H L dk dv);
    * and per sLSTM layer of a training step, 8 B H hd^2: the gradient of
      the zero initial h through the first step's recurrent einsum, which
      autograd skips."""
    if cfg.family != "ssm":
        return 0
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    h = cfg.n_heads
    dk = int(cfg.xlstm_expand * cfg.d_model) // h
    chunk = min(64, t)
    tt = -(-t // chunk) * chunk
    if kind == "decode":
        return n_m * 2 * b * h * dk
    if kind == "prefill":
        return n_m * 6 * b * h * tt * dk
    hd = cfg.d_model // h
    return n_m * (18 * b * h * tt * dk + 6 * b * h * chunk * dk * dk) \
        + n_s * 8 * b * h * hd * hd


def test_dot_flops_match_reference_train(smoke_pair):
    """One training step (n_micro 1, remat as configured)."""
    arch, jb, params, bundle, model = smoke_pair
    b, t = 2, 24
    tok = _tokens(model.cfg.vocab_size, b, t)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    jtc = JTrainConfig(n_micro=1, adamw=JAdamWConfig())
    jstep = jax_make_train_step(jb, jtc)
    want = jaxpr_cost.trace_cost(
        jstep, params, jax_init_opt_state(params, jtc.adamw),
        jax.tree.map(jnp.asarray, batch))["by_prim"]["dot_general"]
    tc = TrainConfig(n_micro=1)
    step = make_train_step(bundle, tc)
    opt = init_opt_state(dict(model.named_parameters()), tc.adamw)
    got = op_cost.trace_cost(step, model, opt, batch)
    _close(got["by_prim"]["dot_general"] + _gap(model.cfg, "train", b, t),
           want)


def test_dot_flops_match_reference_prefill_and_decode(smoke_pair):
    arch, jb, params, bundle, model = smoke_pair
    b, t, s = 2, 24, 32
    tok = _tokens(model.cfg.vocab_size, b, t, seed=1)
    jcaches = jb.init_caches(b, s)
    want = jaxpr_cost.trace_cost(jb.prefill, params,
                                 {"tokens": jnp.asarray(tok)},
                                 jcaches)["by_prim"]["dot_general"]
    caches = bundle.init_caches(b, s, device="cpu")
    with torch.no_grad():
        got = op_cost.trace_cost(bundle.prefill, model, {"tokens": tok},
                                 caches)
    _close(got["by_prim"]["dot_general"] + _gap(model.cfg, "prefill", b, t),
           want)
    step = _tokens(model.cfg.vocab_size, b, 1, seed=2)
    want = jaxpr_cost.trace_cost(jb.decode, params, jnp.asarray(step),
                                 jcaches, t)["by_prim"]["dot_general"]
    with torch.no_grad():
        got = op_cost.trace_cost(bundle.decode, model, step, caches, t)
    _close(got["by_prim"]["dot_general"] + _gap(model.cfg, "decode", b, 1),
           want)


def test_op_cost_counts_the_flash_custom_ops():
    """On fake tensors the flash ops go through their custom ops: 4 hd a
    visited pair forward, 10 hd backward; the dense counts beside them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as kf

    b, t, h, kvh, hd, w = 2, 64, 8, 2, 32, 16
    with FakeTensorMode():
        q = torch.empty((b, t, h, hd), requires_grad=True)
        k = torch.empty((b, t, kvh, hd), requires_grad=True)
        with op_cost.OpCost() as oc:
            out = kf.flash_attention(q, k, k, sliding_window=w)
            out.backward(torch.empty_like(out))
    pairs = op_cost.visible_pairs(b, h, t, t, causal=True, q_offset=0,
                                  kv_valid_len=t, sliding_window=w)
    assert pairs == b * h * sum(min(i + 1, w) for i in range(t))
    by = oc.result()["by_prim"]
    assert by["flash_attention"] == 14 * hd * pairs
    assert by["flash_attention_dense"] == 12 * hd * b * h * t * t
    assert "dot_general" not in by


def test_collectives_count_a_full_tensor():
    """A (64, 32) float32 tensor sharded over both axes of a fake 16x16
    mesh, gathered whole: two all-gathers, the local (4, 2) shard gathered
    over one axis (512 bytes: (4, 32) or (64, 2)) and then the other (8 192
    bytes, the whole tensor), 8 704 result bytes in all."""
    from torch.distributed.tensor import Shard, distribute_tensor

    mesh_mod.init_fake_world(256)
    mesh = mesh_mod.make_production_mesh(device_type="cpu")
    x = distribute_tensor(torch.zeros((64, 32)), mesh, (Shard(0), Shard(1)),
                          src_data_rank=None)
    assert x.to_local().shape == (4, 2)
    with collectives.CollectiveCount() as cc:
        x.full_tensor()
    got = cc.result()
    assert got["counts_by_kind"] == {"all-gather": 2, "all-reduce": 0,
                                     "reduce-scatter": 0, "all-to-all": 0,
                                     "permute": 0}
    assert got["bytes_by_kind"]["all-gather"] == 512 + 8192
    assert got["total_bytes"] == 8704 and got["total_count"] == 2
    mesh_mod.close_mesh()


def _cells():
    """Three cells in the reference's JSON layout: two run, one skipped."""
    def ran(arch, shape, mesh, dom, terms, mfu):
        return {"cell": f"{arch}__{shape}__{mesh}", "arch": arch,
                "shape": shape, "mesh": mesh, "mode": "train_step(n_micro=1)",
                "compile_seconds": 12.3, "flops_per_device": 1.234e12,
                "bytes_per_device": 5.6e10,
                "collectives": {"total_bytes": 7.8e9},
                "terms_seconds": terms, "dominant": dom,
                "useful_flops_ratio": 0.42, "mfu_at_bound": mfu,
                "memory_analysis": {"argument_size_in_bytes": 3 * 2 ** 30,
                                    "temp_size_in_bytes": 2 ** 31}}
    return [
        ran("yi-34b", "train_4k", "16x16", "compute",
            {"compute": 2.5, "memory": 0.0004, "collective": 0.3}, 0.37),
        ran("minicpm-2b", "decode_32k", "2x16x16", "memory",
            {"compute": 2e-6, "memory": 0.12, "collective": 0.0}, 0.001),
        {"cell": "yi-34b__long_500k__16x16", "arch": "yi-34b",
         "shape": "long_500k", "mesh": "16x16",
         "skipped": "skip(full-attn): quadratic attention at 500k"},
    ]


def test_report_tables_match_reference(tmp_path):
    for c in _cells():
        (tmp_path / f"{c['cell']}.json").write_text(json.dumps(c))
    mine = report.load_cells(tmp_path)
    theirs = jreport.load_cells(pathlib.Path(tmp_path))
    assert mine == theirs
    assert report.dryrun_table(mine) == jreport.dryrun_table(theirs)
    for mesh in ("16x16", "2x16x16"):
        assert report.roofline_table(mine, mesh) == \
            jreport.roofline_table(theirs, mesh)
    assert report.summary(mine) == jreport.summary(theirs)
    for x in (0, 3e-7, 2.5e-4, 0.0123, 0.999, 1.0, 42.5):
        assert report.fmt_s(x) == jreport.fmt_s(x)


# (arch, shape, multi_pod): dense, MoE, hybrid and ssm smoke configs on
# both meshes
SMOKE_CELLS = [
    ("minicpm-2b", "train_4k", False),
    ("minicpm-2b", "decode_32k", True),
    ("qwen2-moe-a2.7b", "train_4k", True),
    ("qwen2-moe-a2.7b", "prefill_32k", False),
    ("jamba-v0.1-52b", "train_4k", False),
    ("jamba-v0.1-52b", "prefill_32k", True),
    ("xlstm-1.3b", "train_4k", True),
    ("xlstm-1.3b", "prefill_32k", False),
    ("xlstm-1.3b", "decode_32k", False),
]
# a cell's own limit: the recurrent cells' loops over T (4 096 and 32 768
# steps) are priced, not run, so each ends in seconds on one core
CELL_SECONDS = 120


@pytest.mark.parametrize("arch,shape_name,multi_pod", SMOKE_CELLS)
def test_smoke_cells_on_fake_meshes(arch, shape_name, multi_pod, tmp_path):
    cfg = get_config(arch).smoke()
    rep = dryrun.run_cell(arch, shape_name, multi_pod, tmp_path, cfg=cfg,
                          time_limit=CELL_SECONDS)
    assert "error" not in rep, rep.get("error")
    n = 512 if multi_pod else 256
    assert rep["n_chips"] == n
    assert rep["mesh"] == ("2x16x16" if multi_pod else "16x16")
    for key in ("terms_seconds", "dominant", "bound_seconds",
                "useful_flops_ratio", "mfu_at_bound", "collectives",
                "memory_analysis"):
        assert key in rep, key
    assert rep["flops_per_device"] > 0 and rep["bytes_per_device"] > 0
    assert rep["collectives"]["total_count"] > 0
    assert rep["memory_analysis"]["argument_size_in_bytes"] > 0
    by = rep["op_costs"]["by_prim"]
    assert by["dot_general"] > 0 and by["elementwise"] > 0
    if cfg.family == "ssm":          # no attention layer
        assert "flash_attention" not in by
    else:
        assert by["flash_attention"] > 0
        assert by["flash_attention"] <= by["flash_attention_dense"]
    assert rep["model_flops"] == roofline.model_flops_for(cfg,
                                                          SHAPES[shape_name])
    saved = json.loads((tmp_path / f"{rep['cell']}.json").read_text())
    assert saved["terms_seconds"] == rep["terms_seconds"]
    assert report.roofline_table([saved], saved["mesh"]).count("\n") == 2


def test_unsupported_cell_is_the_references_skip(tmp_path):
    rep = dryrun.run_cell("yi-34b", "long_500k", False, tmp_path)
    assert rep["skipped"] == "skip(full-attn): quadratic attention at 500k"
    saved = json.loads((tmp_path / f"{rep['cell']}.json").read_text())
    assert saved == rep


def test_report_has_a_row_for_a_stopped_cell(tmp_path):
    """A cell that stopped (the reference's tables have no row for it) is a
    FAIL row in both tables and listed in the summary; the other rows are
    the reference's."""
    cells = _cells() + [{"cell": "xlstm-1.3b__train_4k__16x16",
                         "arch": "xlstm-1.3b", "shape": "train_4k",
                         "mesh": "16x16", "error": "RuntimeError: x (at y)"}]
    table = report.dryrun_table(cells)
    assert "| xlstm-1.3b__train_4k__16x16 | 16x16 | FAIL: RuntimeError: " \
        "x (at y) |" in table
    assert table.startswith(jreport.dryrun_table(_cells()))
    assert "| xlstm-1.3b__train_4k__16x16 | — |" in report.roofline_table(
        cells)
    assert report.summary(cells)["failed"] == ["xlstm-1.3b__train_4k__16x16"]
