"""Multi-pod dry run: one step of every (arch x shape x mesh) cell, traced
as rank 0 of a fake process group on fake tensors.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's jitted step for 256 (16x16) or 512 (2x16x16) forced
host devices and reads XLA's cost and memory analyses.  torch has no
compiler in the loop, so this driver runs the step itself, eagerly, as one
rank of the mesh:

  1. starts a fake process group of 256 or 512 ranks (``launch/mesh.py``:
     collectives return at once and move nothing) and the production mesh
     on it (the multi-pod 2x16x16 one as (32, 16): its pod and data axes
     as one dp axis of 32, pod-major, ``make_production_mesh``);
  2. under a ``FakeTensorMode`` (tensors with shapes and no memory, on the
     ``cuda`` device of a CUDA build, else ``cpu``) builds the model and
     distributes its parameters with the layouts of ``dist/sharding.py``
     (training: FSDP x TP, with AdamW state in bf16 at >= 30e9 parameters,
     the reference's ``_opt_dtype``; serving: TP-only when the bf16
     parameters fit 12e9 bytes a chip), the batch and the caches with
     ``dist/cache_sharding.py``'s;
  3. runs one step under ``use_mesh``: a ``Trainer`` step
     (``train/train_step.py``), a prefill, or one decode step at the last
     position of the cache (every key visible), counting one device's flops
     and bytes (``tools/op_cost.py``) and its collectives
     (``tools/collectives.py``); the flash kernels and the recurrent
     cells (mamba's scan, the mLSTM and sLSTM cells) go through their
     custom ops' fake implementations, and ``tools/op_cost.py`` prices the
     cells' loops over T without running them;
  4. writes the roofline terms (``tools/roofline.py``), the argument bytes
     (one device's shards) and the peak (``MemTracker``, where it can follow
     the step) to ``experiments/dryrun_torch/<cell>.json``.

Cells the reference skips (``cell_is_supported``: ``long_500k`` of the
full-attention configs) are skipped here; every other cell ends.  A cell
that stops (an op with no DTensor sharding rule, or one past
``--cell-seconds``) is written with the error, naming the frame it was in.

``--arch quiver-1m`` runs the paper's own workload instead: 1 048 576 x 768
sharded over every rank of the mesh (4 096 rows a shard at 256), 256
queries, ef 64, k 10.  The beam syncs with the host at every hop, so it
cannot run on fake tensors: one shard is built and searched for real at
its size on the default device, under ``tools/op_cost.py``, and the
fan-out's all-gather of each shard's (Q, k) ids and scores is added as its
collective.

Usage:
    python -m repro_torch.launch.dryrun --arch minicpm-2b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
    python -m repro_torch.launch.dryrun --arch quiver-1m --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import signal
import threading
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, cell_is_supported, get_config

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"
ARCHS = ("command-r-plus-104b", "internvl2-2b", "jamba-v0.1-52b",
         "minicpm-2b", "nemotron-4-340b", "qwen2-moe-a2.7b",
         "qwen3-moe-30b-a3b", "whisper-medium", "xlstm-1.3b", "yi-34b")


def _opt_dtype(cfg) -> torch.dtype:
    # bf16 optimizer state for >= 30B models (the reference's DESIGN.md §7)
    return torch.bfloat16 if cfg.param_count() >= 30e9 else torch.float32


def fake_device() -> str:
    """The fake tensors' device: ``cuda`` on a CUDA build; ``cpu`` on a
    CPU-only one, whose autograd cannot hold a gradient on a ``cuda``
    device."""
    return "cuda" if torch.backends.cuda.is_built() and \
        torch.cuda.is_available() else "cpu"


def _distribute(tree, specs, mesh):
    """Each tensor of a batch or cache tree distributed by the spec at the
    same place of ``specs``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import placements

    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, placements(mesh, specs),
                                 src_data_rank=None)
    if isinstance(tree, dict):
        return {k: _distribute(v, specs[k], mesh) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_distribute(v, s, mesh)
                            for v, s in zip(tree, specs)))
    return type(tree)(_distribute(v, s, mesh) for v, s in zip(tree, specs))


def _local_bytes(tree) -> int:
    from repro_torch.dist.cache_sharding import tree_map

    total = [0]

    def add(t):
        local = t.to_local() if hasattr(t, "to_local") else t
        total[0] += local.numel() * local.element_size()
    tree_map(add, tree)
    return total[0]


def run_step(cfg, shape, mesh, *, device: str, n_micro: int | None = None):
    """One step of ``cfg`` x ``shape`` on ``mesh`` under a fake mode:
    (op costs, collectives, memory analysis, mode string)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.cache_sharding import batch_shardings, \
        cache_shardings
    from repro_torch.dist.sharding import distribute_params, \
        param_shardings, serve_param_shardings, use_mesh
    from repro_torch.launch.mesh import dp_size
    from repro_torch.models.model import build_model, lm_module
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.tools.collectives import CollectiveCount
    from repro_torch.tools.op_cost import OpCost
    from repro_torch.train.train_step import TrainConfig, make_train_step, \
        suggest_n_micro

    bundle = build_model(cfg)
    specs = bundle.input_specs(shape)
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = lm_module(cfg, device=device, dtype=torch.bfloat16)
        if shape.kind == "train":
            distribute_params(model, mesh, param_shardings(mesh, model))
        else:
            distribute_params(model, mesh, serve_param_shardings(
                mesh, model, cfg.param_count()))
        batch = {k: torch.zeros(s, dtype=dt, device=device)
                 for k, (s, dt) in specs.items()}
        batch = _distribute(batch, batch_shardings(
            mesh, {k: s for k, (s, _) in specs.items()}), mesh)
        args = _local_bytes(list(model.parameters())) + _local_bytes(
            list(batch.values()))
        cc = CollectiveCount()
        if shape.kind == "train":
            nm = n_micro or suggest_n_micro(cfg, shape, dp_size(mesh))
            tc = TrainConfig(n_micro=nm,
                             adamw=AdamWConfig(state_dtype=_opt_dtype(cfg)))
            opt = init_opt_state(dict(model.named_parameters()), tc.adamw)
            args += _local_bytes(list(opt["mu"].values())) * 2
            step = make_train_step(bundle, tc)
            mode = f"train_step(n_micro={nm})"
            with use_mesh(mesh), OpCost(cc) as oc:
                step(model, opt, batch)
        else:
            caches = bundle.init_caches(shape.global_batch, shape.seq_len,
                                        device=device)
            c_specs = cache_shardings(mesh, caches, shape.global_batch)
            caches = _distribute(caches, c_specs, mesh)
            args += _local_bytes(caches)
            if shape.kind == "prefill":
                mode = "prefill_step"
                with use_mesh(mesh), OpCost(cc) as oc:
                    bundle.prefill(model, batch, caches)
            else:
                mode = "serve_step(decode)"
                with use_mesh(mesh), OpCost(cc) as oc:
                    bundle.decode(model, batch["tokens"], caches,
                                  shape.seq_len - 1)
    memory = {"argument_size_in_bytes": args}
    return oc.result(), cc.result(), memory, mode


class CellTimeout(Exception):
    """A cell ran past its time limit."""


@contextlib.contextmanager
def _time_limit(seconds: float | None):
    """Raise :class:`CellTimeout` in the main thread after ``seconds``; no
    limit off the main thread or without ``seconds``."""
    if not seconds or threading.current_thread() is not threading.main_thread():
        yield
        return

    def fire(signum, frame):
        raise CellTimeout(f"over {seconds:.0f} s")

    old = signal.signal(signal.SIGALRM, fire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _where(exc: BaseException) -> str:
    """The innermost frame of this package in ``exc``'s traceback, past
    this driver and the counting modes of ``tools/``, as ``path:line in
    function``."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "repro_torch" in f.filename and "/tools/" not in f.filename
              and not f.filename.endswith("dryrun.py")]
    if not frames:
        return ""
    f = frames[-1]
    path = f.filename[f.filename.rindex("repro_torch"):]
    return f"{path}:{f.lineno} in {f.name}"


def _cell_name(arch: str, shape_name: str, multi_pod: bool) -> str:
    return f"{arch}__{shape_name}__{'2x16x16' if multi_pod else '16x16'}"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path | None = None, *, cfg=None,
             device: str | None = None,
             time_limit: float | None = None) -> dict:
    """One cell's report (``cfg`` overrides the named config, as the tests'
    smoke configs do); a cell past ``time_limit`` seconds stops with the
    frame it was in."""
    from repro_torch.launch.mesh import init_fake_world, make_production_mesh
    from repro_torch.tools.roofline import analyze, model_flops_for

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    cell = _cell_name(arch, shape_name, multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    ok, why = cell_is_supported(cfg, shape)
    if not ok:
        report = {"cell": cell, "arch": arch, "shape": shape_name,
                  "mesh": mesh_name, "skipped": why}
    else:
        n_chips = 512 if multi_pod else 256
        device = device or fake_device()
        try:
            init_fake_world(n_chips)
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=device)
            t0 = time.perf_counter()
            with _time_limit(time_limit):
                costs, coll, memory, mode = run_step(cfg, shape, mesh,
                                                     device=device)
            seconds = time.perf_counter() - t0
        except Exception as e:  # a failure here names the op that stopped it
            traceback.print_exc()
            first = str(e).splitlines()[0] if str(e) else ""
            report = {"cell": cell, "arch": arch, "shape": shape_name,
                      "mesh": mesh_name, "error": f"{type(e).__name__}: "
                      f"{first} (at {_where(e)})"}
        else:
            report = analyze(costs, coll, n_chips=n_chips,
                             model_flops=model_flops_for(cfg, shape),
                             memory_analysis=memory)
            report["op_costs"] = costs
            report["jaxpr_global"] = {"flops": costs["flops"] * n_chips,
                                      "bytes": costs["bytes"] * n_chips}
            report.update({"cell": cell, "arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "mode": mode,
                           "compile_seconds": round(seconds, 1)})
            print(f"[dryrun] {cell}: flops/dev="
                  f"{report['flops_per_device']:.3e} bytes/dev="
                  f"{report['bytes_per_device']:.3e} coll_bytes/dev="
                  f"{coll['total_bytes']:.3e}")
            print(f"[dryrun] {cell}: terms={report['terms_seconds']}"
                  f" dominant={report['dominant']}")
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{cell}.json").write_text(json.dumps(report, indent=2))
    return report


def run_quiver_cell(multi_pod: bool, out_dir: pathlib.Path | None = None,
                    *, n_total: int = 1_048_576, seed: int = 0,
                    device=None) -> dict:
    """The paper's workload on the production mesh: 1M x 768 sharded over
    every rank, 256 queries, ef 64, k 10.  One shard is built and searched
    for real at its size; its counts are one device's."""
    import numpy as np

    from repro_torch.core.index import QuIVerIndex
    from repro_torch.core.vamana import BuildParams
    from repro_torch.tools.collectives import COLLECTIVES
    from repro_torch.tools.op_cost import OpCost
    from repro_torch.tools.roofline import analyze

    n_chips = 512 if multi_pod else 256
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell = f"quiver-1m__search_ef64__{mesh_name}"
    dim, ef, k, q = 768, 64, 10, 256
    n_per_shard = n_total // n_chips
    try:
        rng = np.random.default_rng(seed)
        base = rng.standard_normal((n_per_shard, dim)).astype(np.float32)
        queries = rng.standard_normal((q, dim)).astype(np.float32)
        t0 = time.perf_counter()
        index = QuIVerIndex.build(base, BuildParams(m=32, ef_construction=64,
                                                    prune_pool=64),
                                  device=device)
        t_build = time.perf_counter() - t0
        with OpCost() as oc:
            index.search(queries, k=k, ef=ef)
        costs = oc.result()
    except Exception as e:
        traceback.print_exc()
        return {"cell": cell, "error": f"{type(e).__name__}: {e}"}
    # the fan-out: every shard's (Q, k) int32 ids and float32 scores
    # all-gathered to every rank
    gathered = float(n_chips * q * k * (4 + 4))
    coll = {"bytes_by_kind": {kind: 0.0 for kind in COLLECTIVES},
            "counts_by_kind": {kind: 0 for kind in COLLECTIVES},
            "total_bytes": gathered, "total_count": 2}
    coll["bytes_by_kind"]["all-gather"] = gathered
    coll["counts_by_kind"]["all-gather"] = 2
    report = analyze(
        costs, coll, n_chips=n_chips,
        # the reference's "useful work": Q queries x hops x R neighbour
        # distances x 2D bit-ops-equivalent + rerank GEMV flops
        model_flops=float(q * (4 * ef + 128) * 72 * 2 * dim
                          + q * ef * 2 * dim),
        memory_analysis=None)
    report["op_costs"] = costs
    report.update({
        "cell": cell, "arch": "quiver-1m", "shape": "search_ef64",
        "mesh": mesh_name, "mode": f"sharded_search(shard={n_per_shard})",
        "build_seconds": round(t_build, 1),
        "compile_seconds": 0.0,
    })
    print(f"[dryrun] {cell}: terms={report['terms_seconds']} "
          f"dominant={report['dominant']}")
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{cell}.json").write_text(json.dumps(report, indent=2))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--cell-seconds", type=float, default=300.0,
                    help="a cell's time limit (0: none)")
    args = ap.parse_args(argv)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    out_dir = pathlib.Path(args.out)

    from repro_torch.launch.mesh import close_mesh

    failures = 0
    try:
        if args.arch == "quiver-1m":
            for mp in meshes:
                if "error" in run_quiver_cell(mp, out_dir):
                    failures += 1
            raise SystemExit(failures)
        archs = ARCHS if args.arch == "all" else (args.arch,)
        shapes = list(SHAPES) if args.shape == "all" else [args.shape]
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    rep = run_cell(arch, shape, mp, out_dir,
                                   time_limit=args.cell_seconds)
                    if "error" in rep:
                        failures += 1
                        print(f"[dryrun] FAIL {rep['cell']}: {rep['error']}")
                    elif "skipped" in rep:
                        print(f"[dryrun] SKIP {rep['cell']}: "
                              f"{rep['skipped']}")
                    else:
                        print(f"[dryrun] OK   {rep['cell']} "
                              f"({rep['compile_seconds']}s)")
    finally:
        close_mesh()
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
