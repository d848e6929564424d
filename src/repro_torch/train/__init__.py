"""Training: the step (microbatches, compression, AdamW) and the
fault-tolerant loop; the port's counterpart of ``repro/train``."""
