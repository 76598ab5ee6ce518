"""Model configuration (the port's copy of the JAX package's schema).

A model is a sequence of blocks: ``prefix + pattern * pattern_repeats +
suffix``. Every kind of :data:`BLOCK_KINDS` is served:

  kind     mixer                      ffn
  -------  -------------------------  -----------
  dense    causal self-attention      dense MLP
  local    sliding-window self-attn   dense MLP
  moe      causal self-attention      MoE
  xattn    cross-attention (no self)  dense MLP     (VLM image layers)
  enc      bidirectional self-attn    dense MLP     (whisper encoder)
  dec      causal self + cross-attn   dense MLP     (whisper decoder)
  rec      RG-LRU recurrence          dense MLP     (recurrentgemma)
  mlstm    matrix-LSTM (internal up-proj, no separate MLP)
  slstm    scalar-LSTM (internal proj, no separate MLP)

An encoder-decoder model (``encoder.n_layers > 0``) runs ``n_layers``
``enc`` blocks over the frontend's embeddings before the decoder; a
model with ``xattn`` or ``dec`` blocks attends to the encoder's output,
or, with no encoder layers, to the embeddings themselves. The frontends
(audio convolutions, a ViT and its projector) are stubs, as in the JAX
package: the caller gives precomputed ``(batch, n_ctx, d_model)``
embeddings.
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
class EncoderConfig:
    """Audio/vision frontend stub: the caller feeds precomputed
    frame/patch embeddings of shape (batch, n_ctx, d_model)."""
    n_layers: int = 0            # encoder transformer layers (whisper)
    n_ctx: int = 1500            # frames (whisper) / patches (vlm)


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
    encoder: Optional[EncoderConfig] = None  # enc-dec (whisper) / vlm stub
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

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder is not None and self.encoder.n_layers > 0

    @property
    def has_cross(self) -> bool:
        return any(k in ("xattn", "dec") for k in self.layer_kinds)

    def param_count(self) -> int:
        """Parameter count of the *unpadded* logical model: the JAX
        package's closed form (weight matrices, embeddings, norms; biases
        and gate vectors left out). The launcher logs it and the
        analyzer's gradient-site payloads and lowering plans use it."""
        d, hd = self.d_model, self.hd
        n = self.vocab * d                      # embedding
        if not self.tie_embeddings:
            n += self.vocab * d                 # lm head
        if self.rope_theta is None and self.learned_pos:
            n += self.max_pos * d

        def attn(kv=True, q=True):
            c = 0
            if q:
                c += d * self.n_heads * hd + self.n_heads * hd * d
            if kv:
                c += 2 * d * self.n_kv_heads * hd
            return c

        def mlp(d_ff):
            mats = 3 if self.act in ("swiglu", "geglu") else 2
            return mats * d * d_ff

        for k in self.layer_kinds:
            n += 2 * d                          # block norms
            if k in ("dense", "local", "moe", "enc"):
                n += attn()
            elif k == "xattn":
                n += attn()                     # q from text, kv from image
            elif k == "dec":
                n += 2 * attn() + d             # self + cross (+extra norm)
            elif k == "rec":
                w = self.lru_width or d
                n += 2 * d * w + w * d + 3 * w + self.conv_width * w
            elif k == "mlstm":
                up = 2 * d
                n += d * up * 2 + up * d + 3 * up
            elif k == "slstm":
                n += 4 * d * d + 4 * d
            if k == "moe":
                assert self.moe is not None
                m = self.moe
                mats = 3 if self.act in ("swiglu", "geglu") else 2
                n += d * m.n_experts + m.n_experts * mats * d * m.d_ff
            elif k in ("dense", "local", "enc", "dec", "xattn", "rec"):
                n += mlp(self.d_ff)
        if self.is_enc_dec:
            e = self.encoder
            n += e.n_layers * (2 * d + self.d_ff * d *
                               (3 if self.act in ("swiglu", "geglu") else 2)
                               + 4 * d * d)
        return n


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch, mode) input shape."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
