"""The port stands alone: importing it pulls in neither jax nor ``repro``,
and builds no kernel."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

SRC = Path(repro_torch.__file__).resolve().parent


def _modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages([str(SRC)], "repro_torch.")
    )


def _run_fresh(code: str) -> None:
    """Run ``code`` after importing every port module, in a new process
    that sees only the port's source root."""
    prelude = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", prelude + code], capture_output=True,
        text=True, env={**os.environ, "PYTHONPATH": str(SRC.parent)},
        timeout=300,
    )
    assert out.returncode == 0, out.stderr + out.stdout


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.core.index" in mods
    assert "repro_torch.kernels.bq_distance" in mods
    assert "repro_torch.kernels.list_scan" in mods
    assert {"repro_torch.ivf.partition", "repro_torch.ivf.search"} <= set(mods)
    assert {"repro_torch.kernels.hamming", "repro_torch.probe.diagnostics",
            "repro_torch.probe.incremental", "repro_torch.probe.policy",
            "repro_torch.probe.report"} <= set(mods)
    assert {"repro_torch.configs.base", "repro_torch.configs.minicpm_2b",
            "repro_torch.configs.yi_34b", "repro_torch.models.layers",
            "repro_torch.models.ffn", "repro_torch.models.attention",
            "repro_torch.models.transformer", "repro_torch.models.model",
            "repro_torch.kernels.flash_attention",
            "repro_torch.serve.engine", "repro_torch.launch.serve"} <= set(mods)
    assert {"repro_torch.dist", "repro_torch.dist.sharding",
            "repro_torch.dist.cache_sharding", "repro_torch.dist.compat",
            "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
            "repro_torch.tools.roofline", "repro_torch.tools.report",
            "repro_torch.tools.op_cost",
            "repro_torch.tools.collectives"} <= set(mods)
    assert {"repro_torch.plan.plan", "repro_torch.plan.planner",
            "repro_torch.plan.cache", "repro_torch.plan.trace",
            "repro_torch.filter.labels", "repro_torch.filter.predicate",
            "repro_torch.filter.search"} <= set(mods)
    assert {"repro_torch.stream", "repro_torch.stream.mutable",
            "repro_torch.stream.consolidate", "repro_torch.obs.drift",
            "repro_torch.data.dedup"} <= set(mods)
    assert {"repro_torch.obs", "repro_torch.obs.tracing",
            "repro_torch.obs.tenant", "repro_torch.obs.sinks",
            "repro_torch.obs.hub", "repro_torch.obs.quality",
            "repro_torch.obs.graph", "repro_torch.obs.remediate"} <= set(mods)
    assert {"repro_torch.core.distributed",
            "repro_torch.stream.sharded"} <= set(mods)
    assert {"repro_torch.optim.adamw", "repro_torch.optim.schedule",
            "repro_torch.optim.compress", "repro_torch.train.train_step",
            "repro_torch.train.trainer", "repro_torch.ckpt.checkpoint",
            "repro_torch.data.pipeline", "repro_torch.launch.train"} <= set(mods)
    assert {"repro_torch.models.moe", "repro_torch.configs.qwen2_moe_a2_7b",
            "repro_torch.configs.qwen3_moe_30b_a3b"} <= set(mods)
    assert {"repro_torch.models.mamba", "repro_torch.models.xlstm",
            "repro_torch.models.encdec", "repro_torch.configs.xlstm_1_3b",
            "repro_torch.configs.whisper_medium"} <= set(mods)
    assert {"repro_torch.models.recurrence", "repro_torch.tools.op_cost",
            "repro_torch.dist.cache_sharding", "repro_torch.dist.sharding",
            "repro_torch.models.attention", "repro_torch.launch.dryrun",
            "repro_torch.optim.compress"} <= set(mods)
    _run_fresh(
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )


def test_importing_builds_no_kernel():
    _run_fresh(
        "from repro_torch.kernels import build\n"
        "assert not build._libs, build._libs\n"
    )


def test_no_source_imports_jax_or_repro():
    smoke = SRC.parents[1] / "chip_smoke.py"
    assert smoke.is_file()
    for path in [*SRC.rglob("*.py"), smoke]:
        text = path.read_text()
        for needle in ("import jax", "from jax", "from repro.",
                       "import repro."):
            assert needle not in text, (path, needle)
