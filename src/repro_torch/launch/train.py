"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --smoke --device cpu --steps 50 --ckpt-dir build/ckpt

Counterpart of ``repro/launch/train.py``, with ``--device`` (default: the
CUDA card) as ``launch/serve.py`` has it.  ``--smoke`` trains the reduced
config; the full config path expects a production mesh (>= 256 devices)
and otherwise prints the plan and returns, as the reference does: the
port has one controller, and its full-width training on one card is
driven through :class:`~repro_torch.train.trainer.Trainer` directly
(``chip_smoke.py``'s ``train`` phase).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

PRODUCTION_MESH = 256


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd"])
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    else:
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        if n_dev < PRODUCTION_MESH:
            print(f"[train] full config {cfg.name} needs a production mesh; "
                  f"found {n_dev} devices. Use --smoke locally, or drive "
                  "repro_torch.train.trainer.Trainer directly on one card.")
            return None

    # minicpm's paper schedule is WSD; honor it by default
    schedule = "wsd" if "minicpm" in cfg.name else args.schedule

    bundle = build_model(cfg)
    tc = TrainConfig(
        n_micro=args.n_micro,
        peak_lr=args.lr,
        total_steps=args.steps,
        schedule=schedule,
        adamw=AdamWConfig(),
        compress_grads=args.compress_grads,
    )
    pipeline = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
    ))
    trainer = Trainer(
        bundle, tc,
        TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every),
        pipeline, device=device,
    )
    result = trainer.run()
    for m in result["metrics"]:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}  {m['seconds']*1e3:.0f} ms")
    print(f"[train] done at step {result['final_step']}; "
          f"stragglers flagged: {len(result['stragglers'])}")
    return result


if __name__ == "__main__":
    main()
