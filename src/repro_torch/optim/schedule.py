"""LR schedules: linear-warmup cosine and MiniCPM's WSD (warmup-stable-decay).

Counterpart of ``repro/optim/schedule.py``, computed in float32 as the
reference's ``jnp`` computes them: each Python constant enters a float32
operation as a float32 scalar, the step becomes a float32 tensor on its
own device (a count tensor on the card stays there: no host sync).

WSD [arXiv:2404.06395 §4]: warmup to peak, hold constant for the stable
phase, then a short exponential decay tail.
"""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def _cos(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine rounded once from float64: XLA's float32 cosine is
    within 1 ulp of that, torch's own float32 cosine within 2 (steps 0-40
    of the schedules)."""
    return torch.cos(x.double()).float()


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = peak_lr * step / max(warmup, 1)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (
        1 + _cos(math.pi * progress))
    return torch.where(step < warmup, warm, peak_lr * cos)


def wsd(step, *, peak_lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.01) -> torch.Tensor:
    """Warmup-Stable-Decay (MiniCPM)."""
    step = _step(step)
    warm = peak_lr * step / max(warmup, 1)
    decay_progress = torch.clamp((step - warmup - stable) / max(decay, 1),
                                 0.0, 1.0)
    # exponential-style decay tail
    base = torch.tensor(final_frac, dtype=torch.float32, device=step.device)
    decayed = peak_lr * torch.pow(base, decay_progress)
    peak = torch.tensor(peak_lr, dtype=torch.float32, device=step.device)
    out = torch.where(step < warmup, warm, peak)
    return torch.where(step > warmup + stable, decayed, out)


SCHEDULES = {"cosine": warmup_cosine, "wsd": wsd}
