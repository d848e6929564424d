"""Model dispatcher: one uniform serving bundle per architecture.

Counterpart of ``repro/models/model.py``.  ``build_model(cfg)`` returns a
:class:`ModelBundle` exposing

    init(seed, device=None, dtype=bf16) -> DecoderLM
    prefill(model, batch, caches)       -> (last_logits, caches)
    decode(model, tokens, caches, pos)  -> (logits, caches)
    init_caches(b, max_seq, device=None) -> KVCache (written in place)

for the dense decoder family; ``device=None`` means the CUDA card.  Batch
layout: ``{"tokens": (B, S) integers}``.  The reference's ``loss`` and
``input_specs`` come with the training slice; the encoder-decoder bundle
(whisper) is not ported and raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf


class ModelBundle(NamedTuple):
    cfg: ArchConfig
    init: Callable
    prefill: Callable
    decode: Callable
    init_caches: Callable


def _as_tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).long()


def _decoder_bundle(cfg: ArchConfig) -> ModelBundle:
    tf.check_supported(cfg)

    def init(seed: int | torch.Generator = 0, *, device=None,
             dtype=torch.bfloat16) -> tf.DecoderLM:
        device = resolve_device(device)
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(seed))
        return tf.init_decoder(cfg, generator=gen, device=device,
                               dtype=dtype)

    def init_caches(b: int, max_seq: int, *, device=None):
        return tf.init_caches(cfg, b, max_seq, device=resolve_device(device))

    def prefill(model, batch, caches):
        x = tf.embed_tokens(model, _as_tokens(batch["tokens"], model.device))
        h, caches = tf.forward_with_cache(model, x, caches, 0)
        logits = tf.logits_from_hidden(model, h[:, -1:])
        return logits[:, 0], caches

    def decode(model, tokens, caches, pos: int):
        x = tf.embed_tokens(model, _as_tokens(tokens, model.device))
        h, caches = tf.forward_with_cache(model, x, caches, int(pos))
        logits = tf.logits_from_hidden(model, h[:, -1:])
        return logits[:, 0], caches

    return ModelBundle(cfg, init, prefill, decode, init_caches)


def build_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder bundle is not ported yet "
            "(ROADMAP modules item 14)")
    return _decoder_bundle(cfg)
