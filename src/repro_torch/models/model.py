"""Decoder of dense and MoE blocks: parameter layout, forward, decode
caches, greedy next.

Parameters are ``params[group][name]`` tensors of shape
``(n_stack, *local_shape)`` (see :mod:`repro_torch.parallel.shardings`),
grouped as in the JAX package: ``embed`` (``tok``), ``out`` (``nf_gain``,
``unemb``) and ``pattern`` (the repeated blocks, names prefixed ``L{j}_``),
plus ``pre{i}_{kind}`` / ``suf{i}_{kind}`` for unrepeated blocks. Every
activation crossing the TP ranks goes through the quantized AllReduce
site, and an MoE block's dispatch through the quantized All2All site,
each resolved per ``(site, global block index)``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.policy import CommPolicy
from repro_torch.core.collectives import all_gather_rows
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed_lookup, mlp_apply, rms_norm,
                                       vocab_parallel_logits)
from repro_torch.parallel.axis import axis_rank
from repro_torch.parallel.plan import ShardingPlan
from repro_torch.parallel.shardings import ParamSpec, Params

SUPPORTED_KINDS = ("dense", "moe")


def _norm_specs(cfg: ModelConfig, name: str) -> Dict[str, ParamSpec]:
    if cfg.norm != "rms":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported")
    return {name + "gain": ParamSpec((cfg.d_model,), init="ones")}


def _mlp_specs(cfg: ModelConfig, plan: ShardingPlan) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, plan.f_loc * plan.tp
    s = {"w1": ParamSpec((d, f), tp_dim=1),
         "w2": ParamSpec((f, d), tp_dim=0, init="zeros")}
    if cfg.act in ("swiglu", "geglu"):
        s["w3"] = ParamSpec((d, f), tp_dim=1)
    if cfg.use_bias:
        s["b1"] = ParamSpec((f,), tp_dim=0, init="zeros")
        s["b2"] = ParamSpec((d,), init="zeros")
        if cfg.act in ("swiglu", "geglu"):
            s["b3"] = ParamSpec((f,), tp_dim=0, init="zeros")
    return s


def block_specs(kind: str, cfg: ModelConfig,
                plan: ShardingPlan) -> Dict[str, ParamSpec]:
    if kind not in SUPPORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    s = dict(_norm_specs(cfg, "n1_"))
    s.update(attn.attn_specs(cfg, plan))
    s.update(_norm_specs(cfg, "n2_"))
    s.update(moe_mod.moe_specs(cfg, plan) if kind == "moe"
             else _mlp_specs(cfg, plan))
    return s


def param_groups(cfg: ModelConfig, plan: ShardingPlan
                 ) -> Dict[str, Tuple[int, Dict[str, ParamSpec]]]:
    """{group_name: (n_stack, {param: spec})}, as in the JAX package."""
    if cfg.rope_theta is None:
        raise NotImplementedError("learned positions are not ported")
    d = cfg.d_model
    groups: Dict[str, Tuple[int, Dict[str, ParamSpec]]] = {
        "embed": (1, {"tok": ParamSpec((plan.vocab_pad, d), tp_dim=0)})}
    out = dict(_norm_specs(cfg, "nf_"))
    if not cfg.tie_embeddings:
        out["unemb"] = ParamSpec((plan.vocab_pad, d), tp_dim=0)
    groups["out"] = (1, out)
    for i, kind in enumerate(cfg.prefix):
        groups[f"pre{i}_{kind}"] = (1, block_specs(kind, cfg, plan))
    if cfg.pattern_repeats:
        merged: Dict[str, ParamSpec] = {}
        for j, kind in enumerate(cfg.pattern):
            for n, sp in block_specs(kind, cfg, plan).items():
                merged[f"L{j}_{n}"] = sp
        groups["pattern"] = (cfg.pattern_repeats, merged)
    for i, kind in enumerate(cfg.suffix):
        groups[f"suf{i}_{kind}"] = (1, block_specs(kind, cfg, plan))
    return groups


def layer_params(params: Params, cfg: ModelConfig
                 ) -> List[Tuple[str, Dict[str, torch.Tensor]]]:
    """[(kind, {name: tensor}), ...] for every block in layer order."""
    out = []
    for i, kind in enumerate(cfg.prefix):
        out.append((kind, {k: v[0] for k, v in
                           params[f"pre{i}_{kind}"].items()}))
    for r in range(cfg.pattern_repeats):
        for j, kind in enumerate(cfg.pattern):
            pre = f"L{j}_"
            out.append((kind, {k[len(pre):]: v[r] for k, v in
                               params["pattern"].items()
                               if k.startswith(pre)}))
    for i, kind in enumerate(cfg.suffix):
        out.append((kind, {k: v[0] for k, v in
                           params[f"suf{i}_{kind}"].items()}))
    return out


def apply_block(kind: str, p: Dict, x: torch.Tensor, *, positions,
                cfg: ModelConfig, plan: ShardingPlan, policy: CommPolicy,
                cache: Optional[Dict], pos: int = 0,
                layer: Optional[int] = None, group=None,
                rank: int = 0, stats: Optional[Dict] = None):
    """x + attn(norm(x)), then x + mlp(norm(x)) (dense) or
    x + moe(norm(x)) (moe) -> (x, aux_loss); aux is 0.0 for a dense
    block. ``stats`` gathers the MoE routing counts
    (:func:`repro_torch.models.moe.moe_apply`)."""
    if kind not in SUPPORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    h = rms_norm(x, p["n1_gain"])
    a, _ = attn.self_attention(p, h, positions, cfg, plan, policy,
                               cache=cache, pos=pos, layer=layer,
                               group=group, rank=rank)
    x = x + a
    h = rms_norm(x, p["n2_gain"])
    if kind == "moe":
        f, aux = moe_mod.moe_apply(p, h, cfg, plan, policy, layer=layer,
                                   group=group, rank=rank, stats=stats)
        return x + f, aux
    return x + mlp_apply(p, h, cfg.act, policy, cfg.use_bias, layer=layer,
                         group=group), 0.0


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            plan: ShardingPlan, policy: CommPolicy, *,
            caches: Optional[Dict] = None, dtype=torch.bfloat16,
            group=None, stats: Optional[Dict] = None):
    """tokens (B, S) -> (hidden (B, S, d), unemb, aux_loss, caches), this
    rank's shard of the model axis ``group`` (its rank read from it).

    ``aux_loss`` is the MoE blocks' load-balance loss, summed (serving
    ignores it).

    caches=None: full sequence (prefill). caches given: S must be 1, the
    token sits at ``caches["pos"]``, and the caches are updated in place
    (``pos`` advances by one).
    """
    policy = policy.bind(cfg.n_layers)
    rank = axis_rank(group)
    decode = caches is not None
    x = embed_lookup(tokens, params["embed"]["tok"][0], policy, dtype,
                     group, rank)
    pos = caches["pos"] if decode else 0
    positions = None if decode else torch.arange(tokens.shape[1],
                                                 device=tokens.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, (kind, p) in enumerate(layer_params(params, cfg)):
        x, aux = apply_block(
            kind, p, x, positions=positions, cfg=cfg, plan=plan,
            policy=policy, cache=caches["layers"][layer] if decode else None,
            pos=pos, layer=layer, group=group, rank=rank, stats=stats)
        aux_total = aux_total + aux
    if decode:
        caches["pos"] = pos + 1
    po = params["out"]
    x = rms_norm(x, po["nf_gain"][0])
    unemb = (po["unemb"] if not cfg.tie_embeddings
             else params["embed"]["tok"])[0]
    return x, unemb, aux_total, caches


def init_caches(cfg: ModelConfig, plan: ShardingPlan, batch: int,
                cache_len: int, dtype, device) -> Dict:
    """{"pos": 0, "layers": [per-block kv cache]} for decoding."""
    return {"pos": 0,
            "layers": [attn.init_kv_cache(cfg, plan, batch, cache_len,
                                          dtype, device)
                       for _ in cfg.layer_kinds]}


def next_token_logits(hidden: torch.Tensor, unemb: torch.Tensor,
                      cfg: ModelConfig, plan: ShardingPlan,
                      rank: int = 0) -> torch.Tensor:
    """(B, S, d) -> (B, v_loc) f32 logits at the last position, padded
    vocabulary masked to -inf."""
    logits = vocab_parallel_logits(hidden[:, -1], unemb, cfg.logit_softcap)
    col = torch.arange(plan.v_loc, device=logits.device) + rank * plan.v_loc
    return torch.where(col[None, :] < cfg.vocab, logits,
                       torch.full_like(logits, float("-inf")))


def greedy_next_token(logits: torch.Tensor, plan: ShardingPlan,
                      group=None) -> torch.Tensor:
    """(B, v_loc) logits of this rank's vocabulary shard -> (B,) argmax
    over the whole vocabulary, the same on every rank: each rank's
    maximum and its index, gathered over ``group`` in one hop (as f64
    pairs, which hold an f32 logit and a vocabulary index exactly); the
    first maximum wins (the lowest index on ties, as the JAX package's)."""
    if plan.tp == 1:
        return torch.argmax(logits, dim=-1)
    rank = axis_rank(group)
    idx = torch.argmax(logits, dim=-1)                    # (B,), first max
    val = torch.gather(logits, -1, idx[:, None])[:, 0]
    pair = torch.stack([val.to(torch.float64),
                        (idx + rank * plan.v_loc).to(torch.float64)])
    pairs = all_gather_rows(pair, group)                  # (tp, 2, B)
    best = torch.argmax(pairs[:, 0], dim=0)               # first rank's max
    return torch.gather(pairs[:, 1], 0, best[None])[0].to(torch.int64)
