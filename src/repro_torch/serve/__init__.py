"""Retrieval serving (``QueryEngine``) and LM serving with QuIVer
retrieval: the port's counterpart of ``repro/serve``."""
