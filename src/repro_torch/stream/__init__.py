"""Streaming index: live insert, tombstone delete, consolidate, freeze.

Counterpart of ``repro.stream``:

* :class:`~repro_torch.stream.mutable.MutableQuIVerIndex` — live insert
  (chunk-linked with the shared Vamana primitives), tombstone delete,
  FreshDiskANN-style consolidation, ``freeze()`` snapshots and
  persistence, over capacity-preallocated tensors on the index's device;
* :class:`~repro_torch.stream.mutable.StreamStats` — its cumulative
  mutation accounting;
* :class:`~repro_torch.stream.sharded.StreamingShardedIndex` — mutable
  shards behind one fan-out API: round-robin inserts, deletes routed by
  global id, per-shard consolidation, and an optional IVF routing tier
  for a targeted scatter.
"""

from repro_torch.stream.mutable import MutableQuIVerIndex, StreamStats
from repro_torch.stream.sharded import StreamingShardedIndex

__all__ = ["MutableQuIVerIndex", "StreamStats", "StreamingShardedIndex"]
