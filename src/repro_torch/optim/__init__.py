"""Optimizer: AdamW, learning-rate schedules and 2-bit gradient compression;
the port's counterpart of ``repro/optim``."""
