"""Deterministic, resumable, shard-indexed token pipeline.

Counterpart of ``repro/data/pipeline.py``, copied: it is numpy only, and
its batches equal the reference's for the same seed, step and host.

Design constraints at fleet scale:
  * **Deterministic**: batch t is a pure function of (seed, step, host),
    so a restarted job resumes mid-epoch with no pipeline state beyond
    the step counter (pairs with the checkpoint design).
  * **Host-sharded**: each host materializes only its slice of the
    global batch (``host_slice``).
  * **Prefetch**: a background thread keeps ``prefetch`` batches ready.

Sources: a synthetic LM stream (n-gram-ish mixture, good enough for
loss-goes-down validation) or a memory-mapped token file.  The QuIVer
integration — semantic dedup of documents before batching — lives in
``repro_torch/data/dedup.py``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    token_file: str | None = None
    prefetch: int = 2


class TokenPipeline:
    def __init__(self, cfg: DataConfig, *, host_id: int = 0,
                 n_hosts: int = 1):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        self._tokens = None
        if cfg.token_file:
            self._tokens = np.memmap(cfg.token_file, dtype=np.int32,
                                     mode="r")

    # -- deterministic batch construction ---------------------------------

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The batch for a given step — pure function, resumable."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4099 + self.host_id
        )
        if self._tokens is not None:
            n = len(self._tokens) - cfg.seq_len - 1
            starts = rng.integers(0, n, size=self.local_batch)
            toks = np.stack(
                [self._tokens[s:s + cfg.seq_len + 1] for s in starts]
            )
        else:
            toks = self._synthetic(rng)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def _synthetic(self, rng) -> np.ndarray:
        """Markov-ish synthetic stream with learnable structure."""
        cfg = self.cfg
        b, s, v = self.local_batch, cfg.seq_len + 1, cfg.vocab_size
        # mixture: repeated motifs + skew-Zipf unigrams
        motif_len = 16
        n_motifs = 64
        motif_rng = np.random.default_rng(cfg.seed)   # fixed across steps
        motifs = motif_rng.integers(0, v, size=(n_motifs, motif_len))
        out = np.empty((b, s), dtype=np.int64)
        for i in range(b):
            pos = 0
            while pos < s:
                if rng.random() < 0.7:
                    m = motifs[rng.integers(0, n_motifs)]
                    take = min(motif_len, s - pos)
                    out[i, pos:pos + take] = m[:take]
                    pos += take
                else:
                    take = min(int(rng.integers(4, 16)), s - pos)
                    out[i, pos:pos + take] = (
                        rng.zipf(1.4, size=take).clip(1, v) - 1
                    )
                    pos += take
        return out

    # -- prefetching iterator ------------------------------------------------

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                q.put(self.batch_at(step))
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
