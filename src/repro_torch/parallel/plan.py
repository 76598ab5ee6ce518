"""ShardingPlan: how a dense model maps onto tensor-parallel ranks.

The port's copy of the JAX package's plan, for the dense block:

* q heads are sharded over ``tp`` ranks, padded up to a multiple of
  ``tp`` (padded heads are masked, exact no-ops);
* kv heads are sharded when ``n_kv % tp == 0`` ("shard"), otherwise
  replicated per rank ("replicate");
* the FFN hidden and the vocabulary are padded to ``tp`` multiples and
  sharded.

The flat parameter store pads each rank's values to an
``fsdp * FLAT_QUANT_GROUP`` multiple, so that a store built by the JAX
package unflattens here with the same offsets.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

# flat shards are padded so quantized FSDP-gather groups always divide.
FLAT_QUANT_GROUP = 128


def pad_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    tp: int
    fsdp: int
    hq_pad: int
    hq_loc: int
    kv_mode: str                  # "shard" | "replicate"
    kv_loc: int                   # kv heads held per rank
    f_loc: int                    # dense FFN hidden per rank
    vocab_pad: int
    v_loc: int


def make_plan(cfg: ModelConfig, tp: int, fsdp: int = 1) -> ShardingPlan:
    assert cfg.d_model % fsdp == 0, (cfg.name, cfg.d_model, fsdp)
    hq_pad = pad_to(cfg.n_heads, tp)
    if cfg.n_kv_heads % tp == 0 or tp <= cfg.n_kv_heads:
        assert cfg.n_kv_heads % tp == 0, \
            f"{cfg.name}: kv={cfg.n_kv_heads} not divisible by tp={tp}"
        kv_mode, kv_loc = "shard", cfg.n_kv_heads // tp
    else:
        kv_mode, kv_loc = "replicate", cfg.n_kv_heads
    f_pad = pad_to(cfg.d_ff, tp)
    vocab_pad = pad_to(cfg.vocab, tp)
    return ShardingPlan(tp=tp, fsdp=fsdp, hq_pad=hq_pad,
                        hq_loc=hq_pad // tp, kv_mode=kv_mode, kv_loc=kv_loc,
                        f_loc=f_pad // tp, vocab_pad=vocab_pad,
                        v_loc=vocab_pad // tp)


def flat_store_len(numel_loc: int, fsdp: int) -> int:
    """Stored flat length per rank (whole quant groups per fsdp shard)."""
    return pad_to(numel_loc, fsdp * FLAT_QUANT_GROUP)
