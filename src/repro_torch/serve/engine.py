"""LM generation with QuIVer retrieval-augmented prompts.

Counterpart of the LM half of ``repro/serve/engine.py``:

* :class:`ServeEngine` — batched generation: one prefill into a KV cache,
  then one decode step a token (greedy, or sampled from an explicit
  ``torch.Generator``).
* :class:`Retriever` — a QuIVer index plus a token store: the prompt's
  embedding queries the index and the top-k neighbours' tokens are
  prepended to the prompt before prefill.
* :func:`mean_pool_embedder` — the LM as its own embedding model (the mean
  of the final hidden state over positions).

Every attention call goes through the hand-written flash kernel on the card.
Not ported: ``QueryEngine`` (the retrieval serving queue, ROADMAP modules
item 11), so ``Retriever(engine=...)`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class Retriever:
    """QuIVer index + token store for RAG.

    ``index`` may be an immutable :class:`QuIVerIndex` or a streaming
    :class:`repro_torch.stream.MutableQuIVerIndex`; with the latter the
    corpus can grow *while serving* through :meth:`add_documents`.

    ``embed_fn`` maps (B, S) tokens (a numpy array) to (B, D) embeddings
    (a tensor or array); ``nav=None`` navigates in the metric the index was
    built in; ``expand`` is the beam expansion width; ``pad_token`` fills
    the context slots of missing hits (search returns -1 ids when the beam
    finds fewer than k live documents, and ids past a lagging token store
    are blanked the same way); ``adaptive=None`` follows the index's own
    nav policy.

    ``filter`` (optional) is a label predicate (``repro_torch.filter``):
    retrieval only surfaces documents matching it (metadata-filtered RAG:
    language, tenant, source tags).  The index needs labels attached
    (``attach_labels``); ``augment(filter=...)`` overrides it per call.
    """
    index: Any                      # QuIVerIndex | MutableQuIVerIndex
    doc_tokens: np.ndarray          # (n_docs, doc_len) int32
    embed_fn: Callable              # (B, S) tokens -> (B, D) embeddings
    k: int = 2
    ef: int = 64
    nav: str | None = None
    expand: int = 1
    pad_token: int = 0
    filter: Any = None              # label predicate (repro_torch.filter)
    adaptive: bool | None = None    # None: the index policy decides
    engine: Any = None              # QueryEngine routing: not ported

    def __post_init__(self):
        if self.engine is not None:
            raise NotImplementedError(
                "QueryEngine routing is not ported yet (ROADMAP modules "
                "item 11)")

    def augment(self, tokens: np.ndarray, *, filter=None) -> np.ndarray:
        """(B, S) prompts -> (B, k * doc_len + S): the retrieved documents'
        tokens, then the prompt; ``filter`` (default: the retriever's own)
        restricts the documents retrieved."""
        tokens = np.asarray(tokens)
        emb = self.embed_fn(tokens)
        ids, _ = self.index.search(
            emb, k=self.k, ef=self.ef, nav=self.nav, expand=self.expand,
            adaptive=self.adaptive,
            filter=filter if filter is not None else self.filter,
        )
        ids = np.asarray(ids).reshape(len(tokens), -1)
        # ids outside the token store (-1 padding, or slots beyond a lagging
        # doc_tokens) must not gather a real document: clamp for the gather,
        # then blank out
        in_store = (ids >= 0) & (ids < len(self.doc_tokens))
        safe = np.clip(ids, 0, len(self.doc_tokens) - 1)
        ctx = np.asarray(self.doc_tokens)[safe]
        ctx = np.where(in_store[..., None], ctx, self.pad_token)
        ctx = ctx.reshape(len(tokens), -1)
        return np.concatenate([ctx, tokens], axis=1)

    def add_documents(self, doc_tokens, embeddings=None, *,
                      labels=None) -> np.ndarray:
        """Insert documents into a *mutable* index while serving.

        Returns the slot ids the index assigned.  The token store is
        slot-addressed: it is grown to the index capacity on first use, so
        reclaimed slots (delete + consolidate) are overwritten in place.
        ``labels`` tags the new documents for filtered retrieval (one int
        or iterable of ints per document).  ``embeddings`` default to
        ``embed_fn`` of the tokens.
        """
        if not hasattr(self.index, "insert"):
            raise TypeError(
                "add_documents needs a mutable index (repro_torch.stream); "
                f"got {type(self.index).__name__}"
            )
        doc_tokens = np.atleast_2d(np.asarray(doc_tokens, dtype=np.int32))
        if embeddings is None:
            embeddings = self.embed_fn(doc_tokens)
        ids = np.asarray(self.index.insert(embeddings, labels=labels))
        cap = self.index.capacity
        if len(self.doc_tokens) < cap:
            pad = np.full(
                (cap - len(self.doc_tokens), self.doc_tokens.shape[1]),
                self.pad_token, dtype=self.doc_tokens.dtype,
            )
            self.doc_tokens = np.concatenate([self.doc_tokens, pad])
        self.doc_tokens[ids] = doc_tokens
        return ids


class ServeEngine:
    """Batched generation over ``model`` (a :class:`DecoderLM` from
    ``bundle.init``), which must live on ``device`` (default: the card)."""

    def __init__(self, bundle, model, *, max_seq: int = 512, device=None):
        device = resolve_device(device)
        if model.device.type != device.type:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"on {device}")
        self.device = model.device
        self.bundle = bundle
        self.model = model
        self.max_seq = max_seq

    def generate(
        self,
        tokens: np.ndarray,              # (B, S) int32 prompts
        *,
        max_new: int = 32,
        retriever: Retriever | None = None,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> np.ndarray:
        """(B, max_new) int32 new tokens.  Greedy (``argmax``, ties to the
        lower index, as ``jnp.argmax``) at ``temperature == 0``; otherwise
        sampled from a ``torch.Generator`` seeded with ``seed`` (not the
        reference's ``jax.random`` draws).  Tokens stay on the device until
        the end."""
        if retriever is not None:
            tokens = retriever.augment(tokens)
        tokens = np.asarray(tokens, dtype=np.int32)
        b, s = tokens.shape
        assert s + max_new <= self.max_seq, (s, max_new, self.max_seq)

        caches = self.bundle.init_caches(b, self.max_seq, device=self.device)
        logits, caches = self.bundle.prefill(
            self.model, {"tokens": torch.from_numpy(tokens)}, caches)
        gen = None
        if temperature > 0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        out = torch.empty((b, max_new), dtype=torch.int64, device=self.device)
        pos = s
        for i in range(max_new):
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            out[:, i] = tok
            logits, caches = self.bundle.decode(self.model, tok[:, None],
                                                caches, pos)
            pos += 1
        return out.cpu().numpy().astype(np.int32)


def mean_pool_embedder(bundle, model) -> Callable:
    """(B, S) tokens -> (B, d_model) float32 embeddings on the model's
    device: the mean over positions of the final hidden state.  As the
    reference's ``jnp.mean`` of a bf16 state, the mean is summed in float32
    and rounded to the state's dtype before the cast to float32."""
    del bundle

    def embed(tokens) -> torch.Tensor:
        x = tf.embed_tokens(
            model, torch.as_tensor(tokens, device=model.device).long())
        h = tf.forward_hidden(model, x)
        return h.float().mean(dim=1).to(h.dtype).float()

    return embed
