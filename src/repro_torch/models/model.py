"""Model dispatcher: one uniform bundle per architecture.

Counterpart of ``repro/models/model.py``.  ``build_model(cfg)`` returns a
:class:`ModelBundle` exposing

    init(seed, device=None, dtype=bf16) -> DecoderLM or EncDecLM
    loss(model, batch)                  -> (loss, metrics)
    prefill(model, batch, caches)       -> (last_logits, caches)
    decode(model, tokens, caches, pos)  -> (logits, caches)
    init_caches(b, max_seq, device=None) -> serving state (written in place)
    input_specs(shape)                  -> {name: (shape, dtype)} (global)

for every family; ``device=None`` means the CUDA card.  The module takes
the place of the reference's parameter pytree.  Batch layouts (numpy
arrays or tensors; labels for ``loss`` only):

    decoder LM : tokens (B, S) labels (B, S)
    vlm        : patches (B, P, d) tokens (B, S - P) labels (B, S - P)
    encdec     : frames (B, S, d) tokens (B, S // 4) labels (B, S // 4)

The vlm front end is the reference's stub (``frontend="patch_stub"``):
``P = cfg.n_frontend_tokens`` precomputed patch embeddings are put before
the token embeddings, cast to their dtype; the loss counts token positions
only, and decode continues at position ``P + S`` (``serve.engine``).
The encoder-decoder (whisper, ``frontend="audio_stub"``) encodes the
frames (cast to the model's dtype: the reference's ``input_specs`` gives
them in bf16), and its decoder starts at position 0 of its own cache, so
decode continues at the token prompt's length S.  Its ``init_caches(b,
max_seq)`` sizes the cross K/V to ``max_seq`` too, as the reference's;
prefill replaces it with the encoder's S_enc rows.
``loss`` runs with gradients (a caller calls ``backward()`` on it); prefill
and decode run under ``torch.no_grad``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import shard
from repro_torch.models import encdec as encdec_mod
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
    # under a mesh the vocabulary is on tp: the gathered logit is partial
    # over it, and is reduced here, before the trailing axis goes
    ll = shard(torch.gather(logits, -1, safe[..., None]), "dp", None,
               None)[..., 0]
    n = mask.sum()
    return ((logz - ll) * mask).sum() / n.clamp_min(1.0), n


def _as_tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).long()


def _init_fn(cfg: ArchConfig, init_model: Callable) -> Callable:
    """The bundle's ``init``: ``init_model(cfg, generator=, device=,
    dtype=)`` from a seed or a generator on the device."""
    def init(seed: int | torch.Generator = 0, *, device=None,
             dtype=torch.bfloat16):
        device = resolve_device(device)
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(seed))
        return init_model(cfg, generator=gen, device=device, dtype=dtype)
    return init


def _decoder_bundle(cfg: ArchConfig) -> ModelBundle:
    is_vlm = cfg.frontend == "patch_stub"
    n_front = cfg.n_frontend_tokens if is_vlm else 0
    init = _init_fn(cfg, tf.init_decoder)

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


def _encdec_bundle(cfg: ArchConfig) -> ModelBundle:
    dec_ratio = 4   # audio frames per text token (training shapes)
    init = _init_fn(cfg, encdec_mod.init_encdec)

    def _frames(model, batch) -> torch.Tensor:
        return torch.as_tensor(batch["frames"], device=model.device).to(
            model.frontend_adapter.w.dtype)

    def loss(model, batch):
        enc_out = encdec_mod.encode(model, _frames(model, batch))
        h = encdec_mod.decode_train(
            model, _as_tokens(batch["tokens"], model.device), enc_out)
        logits = tf.logits_from_hidden(model, h)
        ce, n_tok = cross_entropy(
            logits, _as_tokens(batch["labels"], model.device),
            cfg.vocab_size)
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        return ce, {"ce": ce, "tokens": n_tok, "load_balance_loss": zero,
                    "dropped_fraction": zero}

    def init_caches(b: int, max_seq: int, *, device=None):
        # self K/V sized for the decoder; cross K/V sized for the encoder
        return encdec_mod.init_encdec_caches(cfg, b, max_seq, max_seq,
                                             device=resolve_device(device))

    @torch.no_grad()
    def prefill(model, batch, caches):
        enc_out = encdec_mod.encode(model, _frames(model, batch))
        caches = encdec_mod.EncDecCaches(
            self_kv=caches.self_kv,
            cross_kv=encdec_mod.make_cross_kv(model, enc_out))
        h, caches = encdec_mod.decode_with_cache(
            model, _as_tokens(batch["tokens"], model.device), caches, 0)
        return tf.logits_from_hidden(model, h[:, -1:])[:, 0], caches

    @torch.no_grad()
    def decode(model, tokens, caches, pos: int):
        h, caches = encdec_mod.decode_with_cache(
            model, _as_tokens(tokens, model.device), caches, int(pos))
        return tf.logits_from_hidden(model, h[:, -1:])[:, 0], caches

    def input_specs(shape: ShapeConfig) -> dict:
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": ((b, 1), torch.int32)}
        specs = {"frames": ((b, s, cfg.d_model), torch.bfloat16),
                 "tokens": ((b, s // dec_ratio), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = ((b, s // dec_ratio), torch.int32)
        return specs

    return ModelBundle(cfg, init, loss, prefill, decode, init_caches,
                       input_specs)


def build_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.family == "encdec":
        return _encdec_bundle(cfg)
    return _decoder_bundle(cfg)


def lm_module(cfg: ArchConfig, *, device=None, dtype=torch.bfloat16):
    """The uninitialised module of ``cfg``'s family (``device="meta"``
    allocates nothing): an :class:`~repro_torch.models.encdec.EncDecLM`
    for an encoder-decoder, else a
    :class:`~repro_torch.models.transformer.DecoderLM`."""
    cls = encdec_mod.EncDecLM if cfg.family == "encdec" else tf.DecoderLM
    return cls(cfg, device=device, dtype=dtype)
