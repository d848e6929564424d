"""Model dispatcher: one uniform bundle per architecture.

Counterpart of ``repro/models/model.py``.  ``build_model(cfg)`` returns a
:class:`ModelBundle` exposing

    init(seed, device=None, dtype=bf16) -> DecoderLM
    loss(model, batch)                  -> (loss, metrics)
    prefill(model, batch, caches)       -> (last_logits, caches)
    decode(model, tokens, caches, pos)  -> (logits, caches)
    init_caches(b, max_seq, device=None) -> serving state (written in place)
    input_specs(shape)                  -> {name: (shape, dtype)} (global)

for the decoder families (dense, MoE, hybrid, vlm); ``device=None`` means
the CUDA card.  The module takes the place of the reference's parameter
pytree.  Batch layouts (numpy arrays or tensors; labels for ``loss``
only):

    decoder LM : tokens (B, S) labels (B, S)
    vlm        : patches (B, P, d) tokens (B, S - P) labels (B, S - P)

The vlm front end is the reference's stub (``frontend="patch_stub"``):
``P = cfg.n_frontend_tokens`` precomputed patch embeddings are put before
the token embeddings, cast to their dtype; the loss counts token positions
only, and decode continues at position ``P + S`` (``serve.engine``).
``loss`` runs with gradients (a caller calls ``backward()`` on it); prefill
and decode run under ``torch.no_grad``.  The encoder-decoder bundle
(whisper) is not ported and raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf


class ModelBundle(NamedTuple):
    cfg: ArchConfig
    init: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    init_caches: Callable
    input_specs: Callable


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-mean CE with label mask (labels < 0 ignored), float32; returns
    (loss, number of counted tokens).  ``vocab`` is unused, as in the
    reference (the padded slots' -1e30 logits add nothing)."""
    del vocab
    logits = logits.float()
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    n = mask.sum()
    return ((logz - ll) * mask).sum() / n.clamp_min(1.0), n


def _as_tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).long()


def _decoder_bundle(cfg: ArchConfig) -> ModelBundle:
    tf.check_supported(cfg)
    is_vlm = cfg.frontend == "patch_stub"
    n_front = cfg.n_frontend_tokens if is_vlm else 0

    def init(seed: int | torch.Generator = 0, *, device=None,
             dtype=torch.bfloat16) -> tf.DecoderLM:
        device = resolve_device(device)
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(seed))
        return tf.init_decoder(cfg, generator=gen, device=device,
                               dtype=dtype)

    def _embed_batch(model, batch):
        x = tf.embed_tokens(model, _as_tokens(batch["tokens"], model.device))
        if is_vlm:
            patches = torch.as_tensor(batch["patches"], device=model.device)
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        return x

    def loss(model, batch):
        h, aux = tf.forward_hidden(model, _embed_batch(model, batch))
        if n_front:
            h = h[:, n_front:]
        logits = tf.logits_from_hidden(model, h)
        ce, n_tok = cross_entropy(
            logits, _as_tokens(batch["labels"], model.device),
            cfg.vocab_size)
        # the MoE layers' auxiliary metrics, summed over layers (zeros for a
        # dense stack)
        total = ce + 0.01 * aux["load_balance_loss"]
        return total, {"ce": ce, "tokens": n_tok,
                       "load_balance_loss": aux["load_balance_loss"],
                       "dropped_fraction": aux["dropped_fraction"]}

    def input_specs(shape: ShapeConfig) -> dict:
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": ((b, 1), torch.int32)}
        specs = {"tokens": ((b, s - n_front), torch.int32)}
        if is_vlm:
            specs["patches"] = ((b, n_front, cfg.d_model), torch.bfloat16)
        if shape.kind == "train":
            specs["labels"] = ((b, s - n_front), torch.int32)
        return specs

    def init_caches(b: int, max_seq: int, *, device=None):
        return tf.init_caches(cfg, b, max_seq, device=resolve_device(device))

    @torch.no_grad()
    def prefill(model, batch, caches):
        h, caches = tf.forward_with_cache(model, _embed_batch(model, batch),
                                          caches, 0)
        logits = tf.logits_from_hidden(model, h[:, -1:])
        return logits[:, 0], caches

    @torch.no_grad()
    def decode(model, tokens, caches, pos: int):
        x = tf.embed_tokens(model, _as_tokens(tokens, model.device))
        h, caches = tf.forward_with_cache(model, x, caches, int(pos))
        logits = tf.logits_from_hidden(model, h[:, -1:])
        return logits[:, 0], caches

    return ModelBundle(cfg, init, loss, prefill, decode, init_caches,
                       input_specs)


def build_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder bundle is not ported yet "
            "(ROADMAP modules item 14d)")
    return _decoder_bundle(cfg)
