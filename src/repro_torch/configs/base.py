"""Architecture configuration schema and registry.

Counterpart of ``repro/configs/base.py``, copied so the port imports
nothing of ``repro``: every architecture is an :class:`ArchConfig` in its
own module under ``repro_torch/configs``, and ``get_config(name)`` resolves
it.  ``smoke()`` derives a reduced config of the same family for CPU tests;
:class:`ShapeConfig` and :data:`SHAPES` are the reference's workload
shapes (``input_specs``, ``suggest_n_micro``).
The port carries the configs whose family it runs: ``minicpm-2b`` (dense
MHA), ``yi-34b``, ``command-r-plus-104b`` (dense GQA) and
``nemotron-4-340b`` (dense GQA, squared-ReLU FFN), ``qwen2-moe-a2.7b``
(MoE, 60 routed experts top-4 plus 4 shared) and ``qwen3-moe-30b-a3b``
(MoE, 128 experts top-8, head_dim 128 over GQA 32/4), ``jamba-v0.1-52b``
(hybrid: mamba with attention at one position in 8, MoE 16 experts top-2
on every second layer), ``internvl2-2b`` (vlm: 256 patch embeddings
prepended to the tokens), ``xlstm-1.3b`` (ssm: 7 mLSTM and 1 sLSTM block
in every 8) and ``whisper-medium`` (encdec: 24 encoder and 24 decoder
layers over stub frame embeddings): all ten of the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_every: int = 1
    moe_offset: int = 1
    # hybrid (attention-every-k, rest mamba)
    attn_every: int = 1
    attn_offset: int = 0
    # SSM / mamba
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2
    # xLSTM
    slstm_every: int = 0
    slstm_offset: int = 0
    xlstm_expand: float = 2.0
    # misc
    activation: str = "swiglu"
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    sliding_window: int = 0
    n_dec_layers: int = 0           # encdec only
    frontend: str | None = None     # "patch_stub" | "audio_stub"
    n_frontend_tokens: int = 256
    supports_long_context: bool = False
    vocab_pad_to: int = 512
    kv_chunk: int = 1024
    remat: bool = True
    note: str = ""

    # -- derived -------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def seq_sharded_residual(self) -> bool:
        """The reference's sequence-parallel residual stream (attention-
        dominant stacks); read by ``train.train_step.suggest_n_micro``."""
        return self.family in ("dense", "moe", "vlm", "encdec")

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    def pattern(self) -> tuple[int, int]:
        """(period, n_groups) of the layer stack's grouping."""
        period = 1
        if self.family == "hybrid":
            period = math.lcm(period, self.attn_every)
        if self.n_experts:
            period = math.lcm(period, self.moe_every)
        if self.slstm_every:
            period = math.lcm(period, self.slstm_every)
        assert self.n_layers % period == 0, (self.n_layers, period)
        return period, self.n_layers // period

    def layer_kind(self, pos: int) -> str:
        if self.family == "ssm":
            if self.slstm_every and pos % self.slstm_every == self.slstm_offset:
                return "slstm"
            return "mlstm"
        if self.family == "hybrid":
            if pos % self.attn_every == self.attn_offset:
                return "attn"
            return "mamba"
        return "attn"

    def layer_has_moe(self, pos: int) -> bool:
        return bool(self.n_experts) and pos % self.moe_every == self.moe_offset

    def param_count(self) -> int:
        """Analytic parameter count of the matrices (norm scales are not
        counted), as the reference's."""
        d, hd = self.d_model, self.head_dim_
        total = self.padded_vocab * d * 2          # embed + lm_head
        period, groups = self.pattern()
        for pos in range(period):
            kind = self.layer_kind(pos)
            n = groups
            if kind == "attn":
                total += n * d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
            elif kind == "mamba":
                di = self.ssm_expand * d
                total += n * (
                    d * 2 * di + di * d            # in/out proj
                    + di * (self.d_conv + 2 * self.d_state + d // 16 + 2)
                    + (d // 16) * di + di * self.d_state
                )
            elif kind == "mlstm":
                di = int(self.xlstm_expand * d)
                hd_x = di // self.n_heads
                total += n * (2 * d * di + 3 * self.n_heads * hd_x * hd_x
                              + di * 2 * self.n_heads + di * d)
                continue
            elif kind == "slstm":
                total += n * (4 * d * d + 4 * d * (d // self.n_heads)
                              + 4 * d * d)
                continue
            if self.layer_has_moe(pos):
                total += n * self.n_experts * 3 * d * self.d_ff
                total += n * self.n_shared_experts * 3 * d * self.d_ff
                total += n * d * self.n_experts
            else:
                mats = 3 if self.activation == "swiglu" else 2
                total += n * mats * d * self.d_ff
        if self.family == "encdec":
            # decoder self+cross attention and FFN
            total += self.n_dec_layers * (
                d * hd * (self.n_heads * 2 + self.n_kv_heads * 2) * 2
                + 2 * d * self.d_ff
            )
        return total

    def active_param_count(self) -> int:
        """Matrix parameters a token passes through: an MoE layer counts
        ``top_k`` of its routed experts, as the reference's."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        period, groups = self.pattern()
        moe_layers = sum(groups for pos in range(period)
                         if self.layer_has_moe(pos))
        routed = self.n_experts * 3 * d * self.d_ff
        active = self.top_k * 3 * d * self.d_ff
        return self.param_count() - moe_layers * (routed - active)

    # -- reduced config for CPU smoke tests ----------------------------------

    def smoke(self) -> "ArchConfig":
        period, _ = self.pattern()
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=period * 2 if period > 1 else 2,
            d_model=64,
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2)
            if self.n_kv_heads < self.n_heads else min(self.n_heads, 4),
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=503,                      # odd on purpose: pad path
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 2),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_state=8,
            n_dec_layers=2 if self.n_dec_layers else 0,
            n_frontend_tokens=8 if self.frontend else 0,
            kv_chunk=64,
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_is_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether this (arch x shape) cell runs or is a documented skip."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "skip(full-attn): quadratic attention at 500k"
    return True, ""


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port carries "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _load_all():
    # importing a config module registers it
    from repro_torch.configs import (  # noqa: F401
        command_r_plus_104b,
        internvl2_2b,
        jamba_v0_1_52b,
        minicpm_2b,
        nemotron_4_340b,
        qwen2_moe_a2_7b,
        qwen3_moe_30b_a3b,
        whisper_medium,
        xlstm_1_3b,
        yi_34b,
    )
