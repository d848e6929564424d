"""Streaming index: live insert, tombstone delete, consolidate, freeze.

Counterpart of ``repro.stream`` (without its sharded index, which comes
with the port's distributed layer, ROADMAP modules item 13):

* :class:`~repro_torch.stream.mutable.MutableQuIVerIndex` — live insert
  (chunk-linked with the shared Vamana primitives), tombstone delete,
  FreshDiskANN-style consolidation, ``freeze()`` snapshots and
  persistence, over capacity-preallocated tensors on the index's device;
* :class:`~repro_torch.stream.mutable.StreamStats` — its cumulative
  mutation accounting.
"""

from repro_torch.stream.mutable import MutableQuIVerIndex, StreamStats

__all__ = ["MutableQuIVerIndex", "StreamStats"]
