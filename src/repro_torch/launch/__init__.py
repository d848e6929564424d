"""Entry points: the port's counterpart of ``repro/launch``."""
