"""Model configuration (the port's copy of the JAX package's schema).

A model is a sequence of blocks: ``prefix + pattern * pattern_repeats +
suffix``. This package runs the ``dense`` block (causal self-attention +
dense MLP), the ``moe`` block (causal self-attention + mixture of
experts), the ``local`` block (sliding-window self-attention over the
last ``window`` positions + dense MLP), the ``rec`` block (RG-LRU
recurrence + dense MLP) and the ``mlstm`` / ``slstm`` blocks (xLSTM's
cells, no separate MLP); the encoder and cross-attention kinds are
named so that configs validate the same way, and
:func:`repro_torch.models.model.forward` raises for them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

BLOCK_KINDS = ("dense", "local", "moe", "xattn", "enc", "dec", "rec",
               "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01   # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[str, ...]
    pattern_repeats: int
    prefix: Tuple[str, ...] = ()
    suffix: Tuple[str, ...] = ()
    head_dim: Optional[int] = None
    act: str = "swiglu"          # swiglu | geglu | gelu
    norm: str = "rms"            # rms | ln
    use_bias: bool = False
    qk_norm: bool = False
    rope_theta: Optional[float] = 10000.0   # None -> learned/no positions
    learned_pos: bool = True     # when rope is None: learned table vs none
    max_pos: int = 524288        # learned-pos table size when rope is None
    window: Optional[int] = None             # sliding window (local blocks)
    logit_softcap: Optional[float] = None
    moe: Optional[MoEConfig] = None
    lru_width: Optional[int] = None          # rec blocks (default d_model)
    conv_width: int = 4                      # temporal conv in rec blocks
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""

    def __post_init__(self):
        for k in self.prefix + self.pattern + self.suffix:
            assert k in BLOCK_KINDS, f"unknown block kind {k}"
        assert self.n_heads % self.n_kv_heads == 0

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return (self.prefix + self.pattern * self.pattern_repeats
                + self.suffix)

    @property
    def n_layers(self) -> int:
        return len(self.layer_kinds)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads
