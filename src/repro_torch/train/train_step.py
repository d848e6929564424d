"""Training step: microbatch gradient accumulation + AdamW + schedules.

Counterpart of ``repro/train/train_step.py``.  The global batch is split
into ``n_micro`` microbatches, each one ``loss.backward()``; the
gradients are accumulated into float32 buffers (one a parameter, each
parameter's ``.grad`` added and dropped as soon as its microbatch's
backward is done), then averaged, with the loss summed and averaged; the
metrics are the last microbatch's.  Then the optional 2-bit compression
with error feedback (``optim/compress.py``, grouped as the reference's
pytree leaves), then AdamW (``optim/adamw.py``, in place).

The reference's ``params`` is the :class:`~repro_torch.models.transformer.
DecoderLM` here; the step updates it and the optimizer state in place and
returns them.  It runs eagerly: nothing is compiled and nothing is
donated.  The learning rate is the schedule at ``opt_state["count"]``
before its increment, a device scalar (no host sync).

Each part of the step runs inside a ``torch.profiler.record_function``
range (:data:`SCOPES`: a microbatch's forward and backward, the float32
accumulation, the optimizer), so that a profile of a step can say which
part launched each kernel; outside a profile a range costs a few
microseconds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import param_groups
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.compress import compress_decompress_tree, \
    init_error_feedback
from repro_torch.optim.schedule import SCHEDULES

# the step's profiler ranges: a microbatch's forward and backward, the
# accumulation of its gradients, the optimizer (clip, compression, AdamW)
SCOPES = ("train_step::microbatch", "train_step::accumulate",
          "train_step::optimizer")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_micro: int = 1
    peak_lr: float = 3e-4
    warmup: int = 200
    total_steps: int = 10_000
    schedule: str = "cosine"
    adamw: AdamWConfig = AdamWConfig()
    compress_grads: bool = False


def suggest_n_micro(cfg: ArchConfig, shape: ShapeConfig, dp: int) -> int:
    """Fewest microbatches whose activations fit (the reference's napkin
    model: saved group-boundary residuals per device
      = n_layers * (B/dp/n_micro) * S/tp_or_1 * d_model * 2 B
    against a budget of ~4 GB next to parameters and optimizer state)."""
    per_dev = max(1, shape.global_batch // dp)
    seq_shard = 16 if cfg.seq_sharded_residual else 1
    budget = 4e9
    for n_micro in (1, 2, 4, 8, 16, 32):
        if n_micro > per_dev:
            break
        act = (cfg.n_layers * (per_dev / n_micro)
               * shape.seq_len / seq_shard * cfg.d_model * 2)
        if act <= budget:
            return n_micro
    return per_dev


def _lr(tc: TrainConfig, step):
    sched = SCHEDULES[tc.schedule]
    if tc.schedule == "wsd":
        return sched(step, peak_lr=tc.peak_lr, warmup=tc.warmup,
                     stable=int(0.8 * tc.total_steps),
                     decay=int(0.1 * tc.total_steps))
    return sched(step, peak_lr=tc.peak_lr, warmup=tc.warmup,
                 total=tc.total_steps)


def _micro(batch: dict, n: int, i: int, device) -> dict:
    """The i-th of n equal slices of each leaf's leading axis, on
    ``device``."""
    out = {}
    for k, x in batch.items():
        x = torch.as_tensor(x)
        per = x.shape[0] // n
        # one microbatch is the whole batch (a DTensor batch stays laid out)
        out[k] = (x if n == 1 else x[i * per:(i + 1) * per]).to(device)
    return out


def make_train_step(bundle, tc: TrainConfig) -> Callable:
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics).  ``batch`` leaves have leading dim = global_batch (numpy
    arrays or tensors); ``metrics`` are 0-d tensors on the model's
    device."""

    def train_step(model, opt_state, batch):
        device = model.device
        params = dict(model.named_parameters())
        step = opt_state["count"]
        for p in params.values():
            p.grad = None
        grads = None
        loss_sum = None
        for i in range(tc.n_micro):
            with record_function(SCOPES[0]):
                mb = _micro(batch, tc.n_micro, i, device)
                loss, metrics = bundle.loss(model, mb)
                loss.backward()
            with record_function(SCOPES[1]):
                if grads is None:
                    # laid out as its parameter (a DTensor's shards)
                    grads = {n: torch.zeros_like(p, dtype=torch.float32)
                             for n, p in params.items()}
                for n, p in params.items():
                    grads[n].add_(p.grad.float())
                    p.grad = None
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        with record_function(SCOPES[1]):
            if tc.n_micro > 1:
                for g in grads.values():
                    g.div_(tc.n_micro)
                loss = loss_sum / tc.n_micro
        metrics = {k: v.detach() for k, v in metrics.items()}

        with record_function(SCOPES[2]):
            if tc.compress_grads:
                grads, _ = compress_decompress_tree(
                    grads, opt_state["ef"], param_groups(model))
            lr = _lr(tc, step)
            _, opt_state, opt_metrics = adamw_update(params, grads,
                                                     opt_state, tc.adamw, lr)
        del grads
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def init_train_state(bundle, tc: TrainConfig, seed=0, *, device=None,
                     dtype=torch.bfloat16):
    """(model, opt_state): ``bundle.init(seed)`` on ``device`` (default:
    the card), zero AdamW state and, with compression, zero error
    feedback."""
    model = bundle.init(seed, device=resolve_device(device), dtype=dtype)
    params = dict(model.named_parameters())
    opt_state = init_opt_state(params, tc.adamw)
    if tc.compress_grads:
        opt_state["ef"] = init_error_feedback(params)
    return model, opt_state
