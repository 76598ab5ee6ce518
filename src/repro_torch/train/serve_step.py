"""Serving: prefill (full-sequence forward) and single-token decode.

The TP AllReduces inside the forward run through the paper's quantized
two-step (the TTFT site of the paper's Fig. 2), an MoE block's dispatch
through the quantized All2All. ``group`` is the model axis: ``None`` (one
rank: each site still runs the full codec schedule), a process group, or
a :class:`~repro_torch.parallel.axis.ModelAxis` whose peer world carries
the ``fused`` sites (see :mod:`repro_torch.launch.mesh`); the rank is
read from it.
``stats``, if given, gathers the MoE routing counts of every call
(:func:`repro_torch.models.moe.moe_apply`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.policy import CommPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (forward, init_caches,
                                      next_token_logits)
from repro_torch.parallel.axis import axis_rank
from repro_torch.parallel.plan import ShardingPlan


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def make_prefill(cfg: ModelConfig, plan: ShardingPlan, policy: CommPolicy,
                 group=None, stats: Optional[Dict] = None):
    """prefill(params, tokens (B, S), enc_embeds=None) -> (B, v_loc) f32
    logits of the next token; :func:`repro_torch.models.model.
    greedy_next_token` picks it. ``enc_embeds`` (B, n_ctx, d_model): the
    stub frontend's embeddings, for a model with an encoder or
    cross-attention."""
    dtype = _dtype(cfg)
    rank = axis_rank(group)

    @torch.no_grad()
    def prefill(params, tokens, enc_embeds=None):
        hidden, unemb, _, _ = forward(params, tokens, cfg, plan, policy,
                                      dtype=dtype, group=group, stats=stats,
                                      enc_embeds=enc_embeds)
        return next_token_logits(hidden, unemb, cfg, plan, rank)

    return prefill


def make_decode_step(cfg: ModelConfig, plan: ShardingPlan,
                     policy: CommPolicy, group=None,
                     stats: Optional[Dict] = None):
    """step(params, caches, tokens (B, 1), enc_embeds=None) -> ((B, v_loc)
    f32 logits of the next token, caches); the caches are updated in
    place. A model with an encoder or cross-attention takes its
    ``enc_embeds`` at every step, as the JAX package's step does (the
    encoder runs again each step)."""
    dtype = _dtype(cfg)
    rank = axis_rank(group)

    @torch.no_grad()
    def step(params, caches, tokens, enc_embeds=None):
        hidden, unemb, _, caches = forward(params, tokens, cfg, plan,
                                           policy, caches=caches,
                                           dtype=dtype, group=group,
                                           stats=stats,
                                           enc_embeds=enc_embeds)
        return next_token_logits(hidden, unemb, cfg, plan, rank), caches

    return step


def make_cache_init(cfg: ModelConfig, plan: ShardingPlan, batch: int,
                    cache_len: int, device):
    """init() -> fresh decode caches on ``device``: a kv ring a
    self-attention block (a local block's of at most its window's
    slots), a recurrent state a rec, mlstm or slstm block, none an xattn
    block (:func:`repro_torch.models.model.init_block_cache`)."""
    dtype = _dtype(cfg)

    def init():
        return init_caches(cfg, plan, batch, cache_len, dtype, device)

    return init
