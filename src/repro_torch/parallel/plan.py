"""ShardingPlan: how a model maps onto tensor-parallel ranks.

The port's copy of the JAX package's plan:

* q heads are sharded over ``tp`` ranks, padded up to a multiple of
  ``tp`` (padded heads are masked, exact no-ops);
* kv heads are sharded when ``n_kv % tp == 0`` ("shard"), otherwise
  replicated per rank ("replicate");
* the FFN hidden, the vocabulary and the RG-LRU width (``lru_width``,
  else ``d_model``) are padded to ``tp`` multiples and sharded;
* the xLSTM cells' heads are padded to a multiple of ``tp``
  (``nh_lstm_pad``, ``nh_lstm_loc`` a rank; padded heads are masked,
  exact no-ops);
* experts (EP): the axis factorises ``tp = ep * etp`` (ep-major), with
  ``ep = gcd(n_experts, tp)``: rank ``m = ep_idx * etp + tp_idx`` owns
  experts ``[ep_idx * e_loc, (ep_idx + 1) * e_loc)``, each with its hidden
  sharded ``etp`` ways. The dispatch All2All runs within an ``ep_groups``
  group, the within-expert AllReduce within an ``etp_groups`` group.

The flat parameter store pads each rank's values to an
``fsdp * FLAT_QUANT_GROUP`` multiple, so that a store built by the JAX
package unflattens here with the same offsets.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.models.config import ModelConfig

# flat shards are padded so quantized FSDP-gather groups always divide.
FLAT_QUANT_GROUP = 128


def pad_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class MoEPlan:
    ep: int                       # expert-parallel ways (groups of ranks)
    etp: int                      # tensor-parallel ways within an expert
    e_loc: int                    # experts owned per rank
    ef_loc: int                   # expert d_ff per rank
    ep_groups: Tuple[Tuple[int, ...], ...]   # A2A groups (size ep each)
    etp_groups: Tuple[Tuple[int, ...], ...]  # psum groups (size etp each)


def make_moe_plan(n_experts: int, d_ff: int, tp: int) -> MoEPlan:
    ep = math.gcd(n_experts, tp)  # largest expert-parallel ways dividing tp
    etp = tp // ep
    ep_groups = tuple(tuple(ei * etp + ti for ei in range(ep))
                      for ti in range(etp))
    etp_groups = tuple(tuple(ei * etp + ti for ti in range(etp))
                       for ei in range(ep))
    return MoEPlan(ep, etp, n_experts // ep, pad_to(d_ff, etp) // etp,
                   ep_groups, etp_groups)


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
    lru_loc: int                  # RG-LRU channels per rank
    nh_lstm_pad: int              # xLSTM heads padded to tp
    nh_lstm_loc: int
    moe: Optional[MoEPlan] = None


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
    lru_pad = pad_to(cfg.lru_width or cfg.d_model, tp)
    nh_lstm_pad = pad_to(max(cfg.n_heads, 1), tp)
    moe = (make_moe_plan(cfg.moe.n_experts, cfg.moe.d_ff, tp)
           if cfg.moe is not None else None)
    return ShardingPlan(tp=tp, fsdp=fsdp, hq_pad=hq_pad,
                        hq_loc=hq_pad // tp, kv_mode=kv_mode, kv_loc=kv_loc,
                        f_loc=f_pad // tp, vocab_pad=vocab_pad,
                        v_loc=vocab_pad // tp, lru_loc=lru_pad // tp,
                        nh_lstm_pad=nh_lstm_pad,
                        nh_lstm_loc=nh_lstm_pad // tp, moe=moe)


def flat_store_len(numel_loc: int, fsdp: int) -> int:
    """Stored flat length per rank (whole quant groups per fsdp shard)."""
    return pad_to(numel_loc, fsdp * FLAT_QUANT_GROUP)
