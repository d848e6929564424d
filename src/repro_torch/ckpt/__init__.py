"""Checkpoints in the reference's on-disk format; the port's counterpart of
``repro/ckpt``."""
