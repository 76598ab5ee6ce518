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

Data-parallel serving (``plan.fsdp > 1``) runs on this rank's shard of
the flat float32 store, every block group gathered over the data axis
``data_group`` at every prefill and decode step (the ``qag`` site), as
the JAX package's does; ``flat`` takes that road at ``fsdp == 1`` too.
Each data replica serves the rows :func:`local_rows` gives it: the
global batch split over the replicas when their number divides it, else
every row on every replica (the JAX package's ``batch_spec``).
``window_override`` gives every self-attention block but a local one a
window (:func:`repro_torch.models.model.forward`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.policy import CommPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (forward, init_caches,
                                      next_token_logits)
from repro_torch.parallel.axis import MeshAxes, axis_rank
from repro_torch.parallel.plan import ShardingPlan
from repro_torch.train.train_step import batch_slice


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def local_rows(global_batch: int, data_group=None) -> slice:
    """The rows of the global batch this data replica serves: its share
    when the data axis divides the batch, else all of them (the JAX
    package's ``batch_spec`` and ``_local_batch`` of a serving mesh,
    which has no pod axis)."""
    return batch_slice(global_batch, MeshAxes(data=data_group))


def _forward_kw(plan: ShardingPlan, group, stats, data_group,
                window_override, flat) -> Dict:
    return dict(group=group, stats=stats, data_group=data_group,
                window_override=window_override,
                flat=plan.fsdp > 1 if flat is None else flat)


def make_prefill(cfg: ModelConfig, plan: ShardingPlan, policy: CommPolicy,
                 group=None, stats: Optional[Dict] = None, *,
                 data_group=None, window_override: Optional[int] = None,
                 flat: Optional[bool] = None):
    """prefill(params, tokens (B, S), enc_embeds=None) -> (B, v_loc) f32
    logits of the next token; :func:`repro_torch.models.model.
    greedy_next_token` picks it. ``tokens`` are this replica's rows
    (:func:`local_rows`). ``enc_embeds`` (B, n_ctx, d_model): the stub
    frontend's embeddings, for a model with an encoder or
    cross-attention. ``params`` is this rank's flat store when ``flat``
    (default: ``plan.fsdp > 1``), gathered over ``data_group``."""
    dtype = _dtype(cfg)
    rank = axis_rank(group)
    kw = _forward_kw(plan, group, stats, data_group, window_override, flat)

    @torch.no_grad()
    def prefill(params, tokens, enc_embeds=None):
        hidden, unemb, _, _ = forward(params, tokens, cfg, plan, policy,
                                      dtype=dtype, enc_embeds=enc_embeds,
                                      **kw)
        return next_token_logits(hidden, unemb, cfg, plan, rank)

    return prefill


def make_decode_step(cfg: ModelConfig, plan: ShardingPlan,
                     policy: CommPolicy, group=None,
                     stats: Optional[Dict] = None, *, data_group=None,
                     window_override: Optional[int] = None,
                     flat: Optional[bool] = None):
    """step(params, caches, tokens (B, 1), enc_embeds=None) -> ((B, v_loc)
    f32 logits of the next token, caches); the caches are updated in
    place. A model with an encoder or cross-attention takes its
    ``enc_embeds`` at every step, as the JAX package's step does (the
    encoder runs again each step). ``data_group``, ``window_override``
    and ``flat`` as :func:`make_prefill`'s: on the flat store every step
    gathers every block group again, as the JAX package's does."""
    dtype = _dtype(cfg)
    rank = axis_rank(group)
    kw = _forward_kw(plan, group, stats, data_group, window_override, flat)

    @torch.no_grad()
    def step(params, caches, tokens, enc_embeds=None):
        hidden, unemb, _, caches = forward(params, tokens, cfg, plan,
                                           policy, caches=caches,
                                           dtype=dtype,
                                           enc_embeds=enc_embeds, **kw)
        return next_token_logits(hidden, unemb, cfg, plan, rank), caches

    return step


def make_cache_init(cfg: ModelConfig, plan: ShardingPlan, batch: int,
                    cache_len: int, device, data_group=None):
    """init() -> fresh decode caches on ``device`` for this replica's
    rows of a global batch of ``batch`` (:func:`local_rows`): a kv ring a
    self-attention block (a local block's of at most its window's
    slots; with a ``window_override``, pass ``cache_len`` = the window),
    a recurrent state a rec, mlstm or slstm block, none an xattn block
    (:func:`repro_torch.models.model.init_block_cache`)."""
    dtype = _dtype(cfg)
    rows = local_rows(batch, data_group)
    b_loc = rows.stop - rows.start

    def init():
        return init_caches(cfg, plan, b_loc, cache_len, dtype, device)

    return init
