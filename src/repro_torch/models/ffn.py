"""Dense feed-forward variants: SwiGLU (llama family), squared-ReLU
(nemotron), GELU (whisper).  Counterpart of ``repro/models/ffn.py``; the
products are plain ``torch.matmul``, as the reference leaves them to XLA."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import ACTIVATIONS, Linear, linear, silu


class FFN(nn.Module):
    """SwiGLU holds ``w1`` (gate), ``w3`` (up) and ``w2`` (down); the other
    activations ``w1`` and ``w2``."""

    def __init__(self, d_model: int, d_ff: int, *, activation: str = "swiglu",
                 device=None, dtype=torch.bfloat16):
        super().__init__()
        self.activation = activation

        def mat(d_in, d_out):
            return Linear(torch.empty((d_in, d_out), device=device,
                                      dtype=dtype))

        self.w1 = mat(d_model, d_ff)
        if activation == "swiglu":
            self.w3 = mat(d_model, d_ff)
        self.w2 = mat(d_ff, d_model)


def ffn(p: FFN, x: torch.Tensor, *, activation: str = "swiglu") -> torch.Tensor:
    if activation == "swiglu":
        h = silu(linear(p.w1, x)) * linear(p.w3, x)
    else:
        h = ACTIVATIONS[activation](linear(p.w1, x))
    return linear(p.w2, h)
