"""Serving entry point: batched generation, optionally QuIVer-RAG.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b --rag
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
        --rag
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b --rag
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-34b --smoke \
        --device cpu --batch 4 --max-new 16 [--rag]

Counterpart of ``repro/launch/serve.py``, with the same flags plus
``--device`` (default: the CUDA card), for the decoder families (dense,
MoE, hybrid, ssm, vlm); an encoder-decoder (whisper) needs frame inputs
and is refused, as in the reference (``ServeEngine.generate(extra_batch=
{"frames": ...})`` serves it).  ``--smoke`` serves the reduced config
anywhere.  A full config runs on one card when its bf16 weights
(``param_count() * 2`` bytes, every expert counted) and serving state fit
in the card's memory, and is refused otherwise, and on the CPU.  Weights are drawn from ``--seed``; a
vlm's patch embeddings (``frontend="patch_stub"``) are drawn from the same
numpy generator after the prompts, as the reference draws them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.models.transformer import layer_kinds
from repro_torch.serve.engine import Retriever, ServeEngine, \
    mean_pool_embedder


def full_config_bytes(cfg, batch: int, max_seq: int) -> int:
    """bf16 weights plus the serving state of ``batch`` sequences: the bf16
    K and V caches of the attention layers, each mamba layer's bf16 conv
    state (d_conv - 1 inputs) and float32 ssm state, and each xLSTM cell's
    float32 state (an mLSTM's C, n and m; an sLSTM's c, n, m and h)."""
    kinds = layer_kinds(cfg)
    n_attn, n_mamba = kinds.count("attn"), kinds.count("mamba")
    d_inner = cfg.ssm_expand * cfg.d_model
    kv = 2 * 2 * batch * max_seq * cfg.n_kv_heads * cfg.head_dim_
    mamba = batch * d_inner * (2 * (cfg.d_conv - 1) + 4 * cfg.d_state)
    hd = int(cfg.xlstm_expand * cfg.d_model) // cfg.n_heads
    mlstm = 4 * batch * cfg.n_heads * (hd * hd + hd + 1)
    slstm = 4 * batch * 4 * cfg.d_model
    return 2 * cfg.param_count() + n_attn * kv + n_mamba * mamba \
        + kinds.count("mlstm") * mlstm + kinds.count("slstm") * slstm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--rag", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    elif device.type != "cuda":
        print(f"[serve] full config {cfg.name} runs on a CUDA card; use "
              "--smoke on the CPU")
        return 1
    else:
        need = full_config_bytes(cfg, args.batch, args.max_seq)
        have = torch.cuda.get_device_properties(device).total_memory
        if need > have:
            print(f"[serve] full config {cfg.name} needs {need} bytes of "
                  f"bf16 weights and caches; the card has {have}. Use "
                  "--smoke.")
            return 1
    if cfg.family == "encdec":
        print("[serve] use examples/ for enc-dec serving "
              "(needs frame inputs); decoder-family archs only here.")
        return 1

    bundle = build_model(cfg)
    model = bundle.init(args.seed, device=device)
    engine = ServeEngine(bundle, model, max_seq=args.max_seq, device=device)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)
    ).astype(np.int32)
    extra = None
    if cfg.frontend == "patch_stub":
        extra = {"patches": torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.n_frontend_tokens, cfg.d_model)))
            .to(device, torch.bfloat16)}

    retriever = None
    if args.rag:
        from repro_torch.core.index import QuIVerIndex
        from repro_torch.core.vamana import BuildParams
        embed_fn = mean_pool_embedder(bundle, model)
        corpus = rng.integers(0, cfg.vocab_size, (256, 8)).astype(np.int32)
        emb = embed_fn(corpus)
        index = QuIVerIndex.build(
            emb, BuildParams(m=4, ef_construction=24, prune_pool=24,
                             chunk=128),
            device=device,
        )
        retriever = Retriever(index=index, doc_tokens=corpus,
                              embed_fn=embed_fn, k=2, ef=32)
        print(f"[serve] RAG enabled over {len(corpus)} docs")

    t0 = time.perf_counter()
    out = engine.generate(
        prompts, max_new=args.max_new, retriever=retriever,
        temperature=args.temperature, seed=args.seed, extra_batch=extra,
    )
    dt = time.perf_counter() - t0
    for i, row in enumerate(out):
        print(f"[serve] seq {i}: {row.tolist()}")
    print(f"[serve] {out.size} tokens in {dt:.2f}s on {device} "
          f"({out.size / dt:.1f} tok/s incl. kernel builds)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
