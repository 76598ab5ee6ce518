"""Encoder and decoder of every block kind: parameter layout, forward,
decode caches, greedy next.

Block kinds (:data:`SUPPORTED_KINDS`): ``dense`` (causal self-attention
+ MLP), ``moe`` (causal self-attention + mixture of experts), ``local``
(self-attention over the last ``cfg.window`` positions + MLP), ``rec``
(RG-LRU + MLP), ``mlstm`` / ``slstm`` (xLSTM's cells, no MLP;
:mod:`repro_torch.models.recurrent`), ``enc`` (non-causal
self-attention + MLP: the encoder's), ``dec`` (causal self-attention,
cross-attention onto the encoder's output, MLP) and ``xattn``
(cross-attention onto the image embeddings + MLP). Positions are rotary
(``rope_theta``), a learned table ``pos`` added to the token embeddings
(``rope_theta`` None and ``learned_pos``), or none.

Parameters are ``params[group][name]`` tensors of shape
``(n_stack, *local_shape)`` (see :mod:`repro_torch.parallel.shardings`),
grouped as in the JAX package: ``embed`` (``tok``, and ``pos`` when
learned), ``out`` (``nf_gain``, ``unemb``) and ``pattern`` (the repeated
blocks, names prefixed ``L{j}_``), plus ``pre{i}_{kind}`` /
``suf{i}_{kind}`` for unrepeated blocks, and for an encoder-decoder
model ``encoder`` (its ``enc`` blocks stacked) and ``encoder_extra``
(the final norm ``ef_`` and the learned table ``enc_pos``). Every
activation crossing the TP ranks goes through the quantized AllReduce
site, and an MoE block's dispatch through the quantized All2All site,
each resolved per ``(site, global block index)``; the encoder's sites
resolve at ``layer=None``, as the JAX package's do.

The encoder runs in every :func:`forward`, the decode steps' too, as in
the JAX package, whose decode step is given the embeddings at every step.

Serving runs :func:`forward` on resident weights (``fsdp == 1``), or
with ``flat`` on the flat ZeRO store of
:mod:`repro_torch.parallel.shardings` (data-parallel serving, ``fsdp >
1``): there, as in the JAX package's ``forward``, each block group is
gathered over the data axis at every prefill and decode step, the
embedding's first, then the encoder's, the blocks' in layer order and
the output's, quantized at the ``qag`` site, with no autograd graph
kept. ``window_override`` gives every self-attention block but a
``local`` one (whose window is ``cfg.window``) a window; the encoder's
blocks get none, as in the JAX package.
Training (every kind) runs :func:`forward_train` on the flat store,
gathered the same way, and each block, its gather included, is
recomputed in the backward (``torch.utils.checkpoint``, as
``jax.checkpoint``), an encoder's ``enc`` blocks each on its own, as the
JAX package's scan of a checkpointed body; so the backward replays the
block's forward sites before it runs their backward sites.
:func:`lm_loss` is the vocabulary-parallel cross-entropy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.core.policy import CommPolicy
from repro_torch.core.collectives import all_gather_rows
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.config import BLOCK_KINDS, ModelConfig
from repro_torch.models.layers import (apply_norm, embed_lookup, mlp_apply,
                                       vocab_parallel_ce,
                                       vocab_parallel_logits)
from repro_torch.parallel.axis import axis_rank
from repro_torch.parallel.plan import ShardingPlan
from repro_torch.parallel.shardings import (ParamSpec, Params, Store,
                                            gather_group)

SUPPORTED_KINDS = BLOCK_KINDS
#: the recurrent kinds' mixers
_RECURRENT = {"rec": rec_mod.rglru_apply, "mlstm": rec_mod.mlstm_apply,
              "slstm": rec_mod.slstm_apply}


def _norm_specs(cfg: ModelConfig, name: str) -> Dict[str, ParamSpec]:
    s = {name + "gain": ParamSpec((cfg.d_model,), init="ones")}
    if cfg.norm == "ln":
        s[name + "bias"] = ParamSpec((cfg.d_model,), init="zeros")
    return s


def _norm(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
          name: str) -> torch.Tensor:
    """The model's norm (``cfg.norm``) with the parameters ``name*``."""
    prm = {"gain": p[name + "gain"]}
    if cfg.norm == "ln":
        prm["bias"] = p[name + "bias"]
    return apply_norm(x, prm, cfg.norm)


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
    s = dict(_norm_specs(cfg, "n1_"))
    if kind in ("dense", "local", "moe", "enc", "dec"):
        s.update(attn.attn_specs(cfg, plan))
    if kind in ("dec", "xattn"):
        s.update(attn.attn_specs(cfg, plan, prefix="x"))
    if kind == "dec":
        s.update(_norm_specs(cfg, "n3_"))
    if kind not in ("mlstm", "slstm"):
        s.update(_norm_specs(cfg, "n2_"))
        s.update(moe_mod.moe_specs(cfg, plan) if kind == "moe"
                 else _mlp_specs(cfg, plan))
    if kind == "rec":
        s.update(rec_mod.rglru_specs(cfg, plan))
    if kind == "mlstm":
        s.update(rec_mod.mlstm_specs(cfg, plan))
    if kind == "slstm":
        s.update(rec_mod.slstm_specs(cfg, plan))
    return s


def param_groups(cfg: ModelConfig, plan: ShardingPlan
                 ) -> Dict[str, Tuple[int, Dict[str, ParamSpec]]]:
    """{group_name: (n_stack, {param: spec})}, as in the JAX package."""
    d = cfg.d_model
    emb = {"tok": ParamSpec((plan.vocab_pad, d), tp_dim=0)}
    if cfg.rope_theta is None and cfg.learned_pos:
        emb["pos"] = ParamSpec((cfg.max_pos, d))
    groups: Dict[str, Tuple[int, Dict[str, ParamSpec]]] = {"embed": (1, emb)}
    out = dict(_norm_specs(cfg, "nf_"))
    if not cfg.tie_embeddings:
        out["unemb"] = ParamSpec((plan.vocab_pad, d), tp_dim=0)
    groups["out"] = (1, out)
    if cfg.is_enc_dec:
        groups["encoder"] = (cfg.encoder.n_layers,
                             block_specs("enc", cfg, plan))
        extra = dict(_norm_specs(cfg, "ef_"))
        extra["enc_pos"] = ParamSpec((cfg.encoder.n_ctx, d))
        groups["encoder_extra"] = (1, extra)
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


def _block_order(cfg: ModelConfig) -> List[Tuple[str, int, List[str]]]:
    """[(group, stack index, block kinds), ...] in layer order: one entry
    for each unrepeated block and for each repeat of the pattern."""
    out = [(f"pre{i}_{k}", 0, [k]) for i, k in enumerate(cfg.prefix)]
    out += [("pattern", r, list(cfg.pattern))
            for r in range(cfg.pattern_repeats)]
    return out + [(f"suf{i}_{k}", 0, [k]) for i, k in enumerate(cfg.suffix)]


def _block_of(p: Dict[str, torch.Tensor], gname: str,
              j: int) -> Dict[str, torch.Tensor]:
    """Block ``j`` of a group's parameters ``p``, its names unprefixed
    (the pattern's names carry ``L{j}_``)."""
    if gname != "pattern":
        return p
    pre = f"L{j}_"
    return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}


def layer_params(params: Params, cfg: ModelConfig
                 ) -> List[Tuple[str, Dict[str, torch.Tensor]]]:
    """[(kind, {name: tensor}), ...] for every block in layer order."""
    out = []
    for gname, stack, kinds in _block_order(cfg):
        p = {k: v[stack] for k, v in params[gname].items()}
        out += [(kind, _block_of(p, gname, j)) for j, kind in
                enumerate(kinds)]
    return out


def apply_block(kind: str, p: Dict, x: torch.Tensor, *, positions,
                cfg: ModelConfig, plan: ShardingPlan, policy: CommPolicy,
                cache: Optional[Dict], pos: int = 0,
                layer: Optional[int] = None, group=None,
                rank: int = 0, stats: Optional[Dict] = None,
                enc_out: Optional[torch.Tensor] = None,
                window_override: Optional[int] = None):
    """x + mixer(norm(x)), then (but for mlstm and slstm) x +
    mlp(norm(x)), or x + moe(norm(x)) in a moe block -> (x, aux_loss);
    aux is 0.0 but for a moe block. The mixer is the causal
    self-attention (dense, moe, dec; local over the last ``cfg.window``
    positions, the others over the last ``window_override`` when it is
    given; enc's not causal), the cross-attention onto ``enc_out``
    (xattn; a dec block's follows its self-attention, through its own
    norm ``n3_``), RG-LRU (rec) or the xLSTM cell (mlstm, slstm).
    ``cache`` is the block's decode cache (:func:`init_block_cache`),
    advanced in place. ``stats`` gathers the MoE routing counts
    (:func:`repro_torch.models.moe.moe_apply`)."""
    h = _norm(p, x, cfg, "n1_")
    if kind in _RECURRENT:
        x = x + _RECURRENT[kind](p, h, cfg, plan, policy, state=cache,
                                 layer=layer, group=group)
        if kind != "rec":
            return x, 0.0
    elif kind == "xattn":
        x = x + attn.cross_attention(p, h, enc_out, cfg, plan, policy,
                                     layer=layer, group=group, rank=rank)
    else:
        a, _ = attn.self_attention(
            p, h, positions, cfg, plan, policy, causal=kind != "enc",
            window=cfg.window if kind == "local" else window_override,
            cache=cache, pos=pos, layer=layer, group=group, rank=rank)
        x = x + a
        if kind == "dec":
            h = _norm(p, x, cfg, "n3_")
            x = x + attn.cross_attention(p, h, enc_out, cfg, plan, policy,
                                         layer=layer, group=group,
                                         rank=rank)
    h = _norm(p, x, cfg, "n2_")
    if kind == "moe":
        f, aux = moe_mod.moe_apply(p, h, cfg, plan, policy, layer=layer,
                                   group=group, rank=rank, stats=stats)
        return x + f, aux
    return x + mlp_apply(p, h, cfg.act, policy, cfg.use_bias, layer=layer,
                         group=group), 0.0


def _recomputed(fn, recompute: bool, *args):
    """``fn(*args)``; with ``recompute``, its activations are recomputed in
    the backward (``torch.utils.checkpoint``: the whole of ``fn``
    replayed, as ``jax.checkpoint``)."""
    if not recompute:
        return fn(*args)
    with ckpt.set_checkpoint_early_stop(False):
        return ckpt.checkpoint(fn, *args, use_reentrant=False)


def _encode(get, enc_embeds: torch.Tensor, cfg: ModelConfig,
            plan: ShardingPlan, policy: CommPolicy, *, group,
            rank: int, recompute: bool = False) -> torch.Tensor:
    """The encoder over the stub frontend's embeddings (B, n, d): the
    learned ``enc_pos[:n]`` added, the ``enc`` blocks in order (their
    sites at ``layer=None``, as the JAX package's), then the ``ef_``
    norm. ``encoder_extra`` is gathered once, outside the blocks; with
    ``recompute`` each block, its ``get("encoder", i)`` included, is
    recomputed in the backward."""
    px = get("encoder_extra", 0)
    n = enc_embeds.shape[1]
    x = enc_embeds + px["enc_pos"][None, :n].to(enc_embeds.dtype)
    positions = torch.arange(n, device=x.device)

    def body(cx, i):
        return apply_block("enc", get("encoder", i), cx,
                           positions=positions, cfg=cfg, plan=plan,
                           policy=policy, cache=None, group=group,
                           rank=rank)[0]

    for i in range(cfg.encoder.n_layers):
        x = _recomputed(body, recompute, x, i)
    return _norm(px, x, cfg, "ef_")


def _decoder(get, tokens: torch.Tensor, cfg: ModelConfig,
             plan: ShardingPlan, policy: CommPolicy, *, dtype, group,
             caches: Optional[Dict] = None, stats: Optional[Dict] = None,
             recompute: bool = False,
             enc_embeds: Optional[torch.Tensor] = None,
             window_override: Optional[int] = None):
    """The one decoder loop of :func:`forward` and :func:`forward_train`:
    ``get(group, stack)`` gives a parameter group's tensors at one stack
    index; with ``recompute`` each block group, its ``get`` included, is
    recomputed in the backward (``torch.utils.checkpoint``), and ``stats``
    counts the routes of the forward only, not of the replay.
    ``enc_embeds`` (B, n_ctx, d) feed the encoder of an encoder-decoder
    model, or the cross-attention of a model with ``xattn`` blocks
    directly; such a model raises ValueError without them.
    ``window_override`` goes to every decoder block
    (:func:`apply_block`)."""
    policy = policy.bind(cfg.n_layers)
    rank = axis_rank(group)
    decode = caches is not None
    pe = get("embed", 0)
    x = embed_lookup(tokens, pe["tok"], policy, dtype, group, rank)
    pos = caches["pos"] if decode else 0
    positions = None if decode else torch.arange(tokens.shape[1],
                                                 device=tokens.device)
    if cfg.rope_theta is None and cfg.learned_pos:
        # replicated: no TP site; a decode step reads row ``pos``, clipped
        # to the table as the JAX package clips it
        x = x + (pe["pos"][min(max(pos, 0), cfg.max_pos - 1)] if decode
                 else pe["pos"][None, :tokens.shape[1]]).to(dtype)
    enc_out = None
    if cfg.is_enc_dec or cfg.has_cross:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} attends to encoder embeddings "
                             f"(B, n_ctx, d_model): enc_embeds is required")
        enc_out = (_encode(get, enc_embeds.to(dtype), cfg, plan, policy,
                           group=group, rank=rank, recompute=recompute)
                   if cfg.is_enc_dec else enc_embeds.to(dtype))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = 0
    for gname, stack, kinds in _block_order(cfg):
        def body(cx, aux, gname=gname, stack=stack, kinds=kinds,
                 layer0=layer, first=[True]):
            p = get(gname, stack)
            st, first[0] = (stats if first[0] else None), False
            for j, kind in enumerate(kinds):
                cx, a = apply_block(
                    kind, _block_of(p, gname, j), cx, positions=positions,
                    cfg=cfg, plan=plan, policy=policy,
                    cache=caches["layers"][layer0 + j] if decode else None,
                    pos=pos, layer=layer0 + j, group=group, rank=rank,
                    stats=st, enc_out=enc_out,
                    window_override=window_override)
                aux = aux + a
            return cx, aux
        x, aux_total = _recomputed(body, recompute, x, aux_total)
        layer += len(kinds)
    if decode:
        caches["pos"] = pos + 1
    po = get("out", 0)
    x = _norm(po, x, cfg, "nf_")
    unemb = po["unemb"] if not cfg.tie_embeddings else pe["tok"]
    return x, unemb, aux_total


def _store_get(store: Store, cfg: ModelConfig, plan: ShardingPlan,
               policy: CommPolicy, dtype, data_group,
               grad_deltas: Optional[Store] = None):
    """``get(group, stack)`` over the flat store: the group's shards at
    one stack index gathered over the data axis ``data_group``
    (:func:`~repro_torch.parallel.shardings.gather_group`; quantized at
    the ``qag`` site), each ``grad_deltas`` leaf added when given."""
    groups = param_groups(cfg, plan)
    qag = policy.bind(cfg.n_layers).resolve("qag")

    def get(gname: str, stack: int) -> Dict[str, torch.Tensor]:
        views = {k: v[stack] for k, v in store[gname].items()}
        deltas = None if grad_deltas is None else {
            k: v[stack] for k, v in grad_deltas[gname].items()}
        return gather_group(views, groups[gname][1], plan, dtype, qag,
                            data_group, deltas)

    return get


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            plan: ShardingPlan, policy: CommPolicy, *,
            caches: Optional[Dict] = None, dtype=torch.bfloat16,
            group=None, stats: Optional[Dict] = None,
            enc_embeds: Optional[torch.Tensor] = None,
            window_override: Optional[int] = None, flat: bool = False,
            data_group=None):
    """tokens (B, S) -> (hidden (B, S, d), unemb, aux_loss, caches), this
    rank's shard of the model axis ``group`` (its rank read from it).
    ``enc_embeds`` (B, n_ctx, d): the stub frontend's embeddings, which a
    model with an encoder or ``xattn`` blocks needs at prefill and at
    every decode step (the encoder runs each time). ``window_override``:
    the window of every self-attention block but a local one
    (:func:`apply_block`).

    ``params``: resident weights (``params[g][name]`` of shape ``(n_stack,
    *local_shape)``), or with ``flat`` this rank's flat store (``(n_stack,
    flat / fsdp)`` float32 shards, :func:`~repro_torch.parallel.
    shardings.init_store`), every block group gathered over the data axis
    ``data_group`` in this call (the ``qag`` site; at ``fsdp == 1`` the
    flat values reshaped and cast to ``dtype``), no autograd graph kept.

    ``aux_loss`` is the MoE blocks' load-balance loss, summed (serving
    ignores it).

    caches=None: full sequence (prefill). caches given: S must be 1, the
    token sits at ``caches["pos"]``, and the caches are updated in place
    (``pos`` advances by one).
    """
    if flat:
        gather = _store_get(params, cfg, plan, policy, dtype, data_group)

        def get(gname: str, stack: int) -> Dict[str, torch.Tensor]:
            with torch.no_grad():
                return gather(gname, stack)
    else:
        def get(gname: str, stack: int) -> Dict[str, torch.Tensor]:
            return {k: v[stack] for k, v in params[gname].items()}

    x, unemb, aux = _decoder(get, tokens, cfg, plan, policy, dtype=dtype,
                             group=group, caches=caches, stats=stats,
                             enc_embeds=enc_embeds,
                             window_override=window_override)
    return x, unemb, aux, caches


def forward_train(store: Store, tokens: torch.Tensor, cfg: ModelConfig,
                  plan: ShardingPlan, policy: CommPolicy, *,
                  dtype=torch.bfloat16, group=None, data_group=None,
                  grad_deltas: Optional[Store] = None,
                  stats: Optional[Dict] = None,
                  enc_embeds: Optional[torch.Tensor] = None):
    """The training forward: tokens (B_loc, S) -> (hidden (B_loc, S, d),
    unemb, aux_loss); ``enc_embeds`` (B_loc, n_ctx, d), the stub
    frontend's embeddings of these rows, feed a model with an encoder or
    ``xattn`` blocks (:func:`_decoder`).

    ``store`` is this rank's flat ZeRO store (``store[g][name]`` of shape
    ``(n_stack, flat / fsdp)``); every block group is gathered over the
    data axis ``data_group`` through ``gather_group`` (quantized at the
    ``qag`` site), ``group`` is the model axis. ``grad_deltas`` mirrors
    the store with zero full-flat-length leaves ``(n_stack, flat)``: when
    given, every gathered parameter is detached and its delta added (the
    ``qgrad_rs`` tap). Each block, its gather included, is recomputed in
    the backward (``torch.utils.checkpoint``, the whole block replayed).
    An MoE block's aux loss enters ``aux_loss``; ``stats``, if given,
    gathers its routing counts (:func:`repro_torch.models.moe.moe_apply`)
    in the forward.
    """
    get = _store_get(store, cfg, plan, policy, dtype, data_group,
                     grad_deltas)
    return _decoder(get, tokens, cfg, plan, policy, dtype=dtype,
                    group=group, stats=stats, recompute=True,
                    enc_embeds=enc_embeds)


def lm_loss(hidden: torch.Tensor, unemb: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, plan: ShardingPlan, aux: torch.Tensor,
            aux_weight: float = 0.01, group=None) -> torch.Tensor:
    """Vocabulary-parallel cross-entropy, the mean over this rank's tokens
    (the caller averages over the data ranks), plus ``aux_weight`` x the
    auxiliary loss."""
    t = hidden.shape[0] * hidden.shape[1]
    logits = vocab_parallel_logits(hidden.reshape(t, -1), unemb,
                                   cfg.logit_softcap)
    nll = vocab_parallel_ce(logits, labels.reshape(t), cfg.vocab, plan.v_loc,
                            group, axis_rank(group))
    return torch.mean(nll) + aux_weight * aux


def policy_segments(cfg: ModelConfig, policy: CommPolicy):
    """Maximal runs of pattern repeats whose resolved layer-site configs
    are identical -> ``[(start, end), ...)`` repeat ranges (end
    exclusive).

    The JAX package scans the pattern and splits the scan at these
    segments (a config that varies across repeats cannot bind inside one
    traced scan body). The port's forward runs its blocks in a Python
    loop and has no scan: this pure function of the config and the
    policy exists so that the analyzer's ``SITE-SEGMENT`` rule gives the
    JAX package's verdicts. A uniform policy resolves to one segment,
    first/last-K schedules to at most three.
    """
    from repro_torch.core.policy import LAYER_SITES
    r_total = cfg.pattern_repeats
    base, period = len(cfg.prefix), len(cfg.pattern)

    def sig(r):
        return tuple(policy.resolve(site, base + r * period + j)
                     for j in range(period) for site in LAYER_SITES)

    segs, start, cur = [], 0, sig(0)
    for r in range(1, r_total):
        s = sig(r)
        if s != cur:
            segs.append((start, r))
            start, cur = r, s
    segs.append((start, r_total))
    return segs


def init_block_cache(kind: str, cfg: ModelConfig, plan: ShardingPlan,
                     batch: int, cache_len: int, dtype, device) -> Dict:
    """A block's decode cache: a self-attention block's kv ring of
    ``cache_len`` slots (a local block's of ``min(cache_len, window)``;
    as in the JAX package, a ``window_override`` cuts no ring: its caller
    passes ``cache_len`` = the window),
    a rec block's RG-LRU state ``{h, conv}``, an mlstm block's ``{c, n,
    m}``, an slstm block's ``{c, n, h, m}``; an xattn block has none
    (``{}``: its keys are the encoder's, recomputed each step)."""
    if kind == "xattn":
        return {}
    if kind == "rec":
        return rec_mod.rglru_init_state(cfg, plan, batch, device)
    if kind == "mlstm":
        return rec_mod.mlstm_init_state(cfg, plan, batch, device)
    if kind == "slstm":
        return rec_mod.slstm_init_state(cfg, plan, batch, device)
    if kind == "local" and cfg.window:
        cache_len = min(cache_len, cfg.window)
    return attn.init_kv_cache(cfg, plan, batch, cache_len, dtype, device)


def init_caches(cfg: ModelConfig, plan: ShardingPlan, batch: int,
                cache_len: int, dtype, device) -> Dict:
    """{"pos": 0, "layers": [each block's cache]} for decoding
    (:func:`init_block_cache`)."""
    return {"pos": 0,
            "layers": [init_block_cache(k, cfg, plan, batch, cache_len,
                                        dtype, device)
                       for k in cfg.layer_kinds]}


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
