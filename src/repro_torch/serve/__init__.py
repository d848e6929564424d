"""LM serving with QuIVer retrieval: the port's counterpart of the LM half
of ``repro/serve``."""
