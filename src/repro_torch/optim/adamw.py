"""AdamW on named parameter tensors, with dtype-configurable state.

Counterpart of ``repro/optim/adamw.py``: the reference's own formula, not
``torch.optim.AdamW`` (which decays by ``p * (1 - lr * wd)`` and rounds
elsewhere).  The gradients are clipped by their global norm, then each
leaf's update ``(mu / c1) / (sqrt(nu / c2) + eps) + wd * p`` is computed in
float32 and cast back to the leaf's dtype (and the state to its own).

The reference's pytrees become dicts ``{name: tensor}`` keyed by
``model.named_parameters()`` (:mod:`repro_torch.convert` maps them onto the
reference's layout); the count is a 0-d int32 tensor on the parameters'
device.  Unlike the reference, :func:`adamw_update` works leaf by leaf and
**in place**: each parameter and its two moments are overwritten as soon
as its update is computed, so no float32 copy of the whole model (of the
parameters, the gradients or the update) is ever held at once.  The
scalars (the norm, the clip scale, the bias corrections, the learning
rate) stay 0-d tensors on the device: no step synchronises the host.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32


def init_opt_state(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.state_dtype`` beside each parameter, and a
    zero int32 count on the parameters' device."""
    device = next(iter(params.values())).device
    # each moment laid out as its parameter (a DTensor's shards)
    return {
        "mu": {n: torch.zeros_like(p, dtype=cfg.state_dtype)
               for n, p in params.items()},
        "nu": {n: torch.zeros_like(p, dtype=cfg.state_dtype)
               for n, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA's and CUDA's: torch's
    vectorised CPU ``sqrt`` is not (0.6% of random inputs a ulp off), so
    on the CPU it is taken in float64 and rounded once (exact for sqrt)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (one leaf's float32 copy at a time)."""
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return _sqrt(total)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                 lr: torch.Tensor) -> tuple[dict, dict, dict]:
    """One AdamW step, in place: ``params`` and ``state``'s moments are
    overwritten leaf by leaf.  Returns (params, state, metrics) with the
    same dicts, ``state["count"]`` a new tensor one higher."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    cnt = count.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                      device=cnt.device), cnt)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                      device=cnt.device), cnt)
    for name, p in params.items():
        g32 = grads[name].float() * scale
        mu, nu = state["mu"][name], state["nu"][name]
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
        nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g32 * g32
        del g32
        update = (mu32 / c1) / (_sqrt(nu32 / c2) + cfg.eps)
        mu.copy_(mu32)
        nu.copy_(nu32)
        del mu32, nu32
        update = update + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * update)
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
