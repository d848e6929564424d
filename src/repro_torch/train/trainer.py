"""Training loop with fault tolerance: checkpoint/restart, preemption
safety, straggler detection.

Counterpart of ``repro/train/trainer.py``:

  * **checkpoint/restart** — periodic async saves (never two writers in
    flight); on startup the loop scans the checkpoint root and resumes
    from the newest complete manifest (the data pipeline is a pure
    function of the step, so batches line up, and the step's kernels are
    deterministic, so a resumed run equals an uninterrupted one bit for
    bit).  Checkpoints are the reference's format and tree
    (``ckpt/checkpoint.py``), so either package resumes the other's.
  * **preemption safety** — SIGTERM sets a flag; the loop then makes a
    final synchronous save and stops (off the main thread the handler
    cannot be installed, and the ``ValueError`` is swallowed).
  * **straggler detection** — per-step wall times feed an EWMA; steps
    slower than ``straggler_factor`` x EWMA are logged with the step.

The step runs eagerly (``train/train_step.py``): nothing is compiled and
nothing is donated; a step's time is taken on the host clock after the
device finishes it.

  * **elastic resume** — given a ``mesh`` (``launch/mesh.py``), the
    parameters and the AdamW moments are distributed onto it in the
    training layout (``dist.sharding.param_shardings``) after the
    restore, and every step runs under ``use_mesh``; the checkpoint holds
    each leaf whole, so it restores onto any mesh, whatever mesh wrote it.
"""

from __future__ import annotations

import dataclasses
import signal
import time

import torch

from repro_torch import convert
from repro_torch.ckpt import checkpoint
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import distribute_params, param_shardings, \
    placements, use_mesh
from repro_torch.train.train_step import TrainConfig, init_train_state, \
    make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    async_ckpt: bool = True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def distribute_train_state(model, opt_state: dict, mesh) -> tuple:
    """``model``'s parameters and ``opt_state``'s moments distributed onto
    ``mesh`` in the training layout (each moment as its parameter), from
    whole tensors on every rank; the count stays a plain tensor."""
    from torch.distributed.tensor import distribute_tensor

    specs = param_shardings(mesh, model)
    distribute_params(model, mesh, specs)
    for key in ("mu", "nu", "ef"):
        if key in opt_state:
            opt_state[key] = {
                n: distribute_tensor(t, mesh, placements(mesh, specs[n]),
                                     src_data_rank=None)
                for n, t in opt_state[key].items()}
    return model, opt_state


class Trainer:
    def __init__(self, bundle, train_cfg: TrainConfig,
                 trainer_cfg: TrainerConfig, pipeline, *, seed=0,
                 device=None, mesh=None):
        self.bundle = bundle
        self.tc = train_cfg
        self.cfg = trainer_cfg
        self.pipeline = pipeline
        self.step_fn = make_train_step(bundle, train_cfg)
        self.seed = seed
        self.device = resolve_device(device)
        self.mesh = mesh
        self.metrics_log: list[dict] = []
        self.straggler_events: list[dict] = []
        self._preempted = False
        self._writer = None

    # -- lifecycle -----------------------------------------------------------

    def _install_signal_handler(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass   # non-main thread (tests)

    def init_or_restore(self):
        model, opt_state = init_train_state(self.bundle, self.tc, self.seed,
                                            device=self.device)
        start = 0
        if self.cfg.ckpt_dir:
            latest = checkpoint.latest_step(self.cfg.ckpt_dir)
            if latest is not None:
                restored, start = checkpoint.restore(
                    f"{self.cfg.ckpt_dir}/step_{latest}",
                    convert.train_state_like(model, opt_state))
                convert.load_lm_params(model, restored["params"])
                opt_state = convert.opt_state_from_numpy(restored["opt"],
                                                         model)
        if self.mesh is not None:
            model, opt_state = distribute_train_state(model, opt_state,
                                                      self.mesh)
        return model, opt_state, start

    def _save(self, model, opt_state, step, *, sync=False):
        if not self.cfg.ckpt_dir:
            return
        if self._writer is not None:
            self._writer.join()   # never two writers in flight
        self._writer = checkpoint.save(
            f"{self.cfg.ckpt_dir}/step_{step}",
            {"params": convert.lm_params_to_numpy(model, keep_bf16=True),
             "opt": convert.opt_state_to_numpy(opt_state, model,
                                               keep_bf16=True)},
            step=step,
            async_write=self.cfg.async_ckpt and not sync,
        )

    # -- main loop --------------------------------------------------------

    def run(self) -> dict:
        if self.mesh is None:
            return self._run()
        with use_mesh(self.mesh):
            return self._run()

    def _run(self) -> dict:
        self._install_signal_handler()
        model, opt_state, start = self.init_or_restore()
        ewma = None
        it = self.pipeline.iterate(start_step=start)

        step = start
        for step in range(start, self.cfg.steps):
            batch = next(it)
            t0 = time.perf_counter()
            model, opt_state, metrics = self.step_fn(model, opt_state,
                                                     batch)
            _sync(self.device)
            dt = time.perf_counter() - t0

            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > self.cfg.straggler_factor * ewma and step > start + 3:
                self.straggler_events.append({"step": step, "dt": dt,
                                              "ewma": ewma})
            if step % self.cfg.log_every == 0 or step == self.cfg.steps - 1:
                self.metrics_log.append(
                    {"step": step,
                     "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "seconds": dt}
                )
            if self.cfg.ckpt_dir and (step + 1) % self.cfg.ckpt_every == 0:
                self._save(model, opt_state, step + 1)
            if self._preempted:
                self._save(model, opt_state, step + 1, sync=True)
                break

        if self._writer is not None:
            self._writer.join()
        return {
            "model": model,
            "opt_state": opt_state,
            "final_step": step + 1,
            "metrics": self.metrics_log,
            "stragglers": self.straggler_events,
        }
