"""QuIVer in PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The layout mirrors the JAX package (``core/``, ``kernels/``, ``plan/``,
``filter/``, ``ivf/``, ``probe/``, ``obs/``, ``data/``, ...) so each module
has a named counterpart there.  This package
imports torch and numpy, never jax and nothing of ``repro``.  Its entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
``kernels/`` holds the hand-written Hopper kernels (``csrc/*.cu``, built
with nvcc on first use) and their plain torch versions.
"""
