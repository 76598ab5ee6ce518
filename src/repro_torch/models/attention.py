"""GQA attention: blockwise (online-softmax) prefill + cached decode.

Written with plain tensor ops and float32 scores, as the JAX package
writes it. q heads are sharded over the TP ranks (padded to a multiple
of tp; padded heads are masked, exact no-ops). kv heads are sharded when
``n_kv % tp == 0`` ("shard" mode), else every rank holds all of them
("replicate" mode, Megatron's GQA fallback). The out-projection's
partial sums cross the ranks through :func:`repro_torch.models.layers.
tp_psum`.

A ``local`` block attends over the last ``window`` positions only (its
key at ``p`` is seen from the query at ``q`` when ``q - window < p <=
q``), at prefill and at decode; so does any other self-attention block
given a window (the model's ``window_override``). An ``enc`` block's
self-attention is not causal; with a window it sees the keys after the
query and those fewer than ``window`` positions before it, as the JAX
package's does. :func:`cross_attention` (``dec`` and ``xattn`` blocks)
attends from the decoder's positions to every position of the encoder's
output, with its own parameters (``xwq`` ... ``xwo``) and its own TP
site.

The decode cache is a ring: ``slot_pos[c]`` is the position held in slot
``c`` (-1 when empty); a local block's ring has ``min(cache_len,
window)`` slots, so it wraps once the sequence passes the window. In
shard mode each rank holds every position of its kv heads, position
``pos`` in slot ``pos % cache_len``; a ring of ``window`` slots (a
window given with ``cache_len`` = window) wraps likewise, each slot then
within the window. In replicate
mode the ring is sharded by sequence: each rank holds ``cache_len / tp``
positions of all kv heads, position ``pos`` goes to slot ``pos %
cache_len`` of the whole ring, which rank ``slot // c_loc`` owns, and
the ranks' online-softmax partials are merged (:func:`_ring_attention`,
counted in :data:`RING_MERGES`). Unlike the JAX package, which returns a
new cache, the port writes the cache in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.collectives import (all_gather_rows, all_to_all_rows,
                                          sum_rows)
from repro_torch.core.policy import CommPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import inv_sqrt, rms_norm, rope, tp_psum
from repro_torch.parallel.plan import ShardingPlan
from repro_torch.parallel.shardings import ParamSpec

KV_CHUNK = 1024
_NEG = -1e30
#: replicate mode's decode merges over the ring (:func:`_ring_attention`),
#: one a layer and step, each an all-gather of q and an all-to-all of the
#: partials (:func:`reset_ring_merges` zeroes it)
RING_MERGES = 0


def reset_ring_merges() -> None:
    global RING_MERGES
    RING_MERGES = 0


def attn_specs(cfg: ModelConfig, plan: ShardingPlan,
               prefix: str = "") -> Dict[str, ParamSpec]:
    """The attention's parameters, named ``prefix + name``: ``""`` for
    the self-attention, ``"x"`` for the cross-attention (``xwq`` ...
    ``xbo``)."""
    d, hd = cfg.d_model, cfg.hd
    kv_dim = cfg.n_kv_heads * hd
    kv_tp = 1 if plan.kv_mode == "shard" else None
    s = {
        "wq": ParamSpec((d, plan.hq_pad * hd), tp_dim=1),
        "wk": ParamSpec((d, kv_dim), tp_dim=kv_tp),
        "wv": ParamSpec((d, kv_dim), tp_dim=kv_tp),
        "wo": ParamSpec((plan.hq_pad * hd, d), tp_dim=0, init="zeros"),
    }
    if cfg.use_bias:
        kv_btp = 0 if kv_tp is not None else None
        s["bq"] = ParamSpec((plan.hq_pad * hd,), tp_dim=0, init="zeros")
        s["bk"] = ParamSpec((kv_dim,), tp_dim=kv_btp, init="zeros")
        s["bv"] = ParamSpec((kv_dim,), tp_dim=kv_btp, init="zeros")
        s["bo"] = ParamSpec((d,), init="zeros")
    if cfg.qk_norm:
        s["qnorm"] = ParamSpec((hd,), init="ones")
        s["knorm"] = ParamSpec((hd,), init="ones")
    return {prefix + k: v for k, v in s.items()}


def _kv_map(cfg: ModelConfig, plan: ShardingPlan, rank: int) -> List[int]:
    """The local kv index of each of rank ``rank``'s q heads: in replicate
    mode the global one (every rank holds every kv head). A host list: it
    depends on the plan and the rank only."""
    q_per_kv = cfg.n_heads // cfg.n_kv_heads
    gkv = [min((rank * plan.hq_loc + i) // q_per_kv, cfg.n_kv_heads - 1)
           for i in range(plan.hq_loc)]
    if plan.kv_mode == "shard":
        return [min(max(k - rank * plan.kv_loc, 0), plan.kv_loc - 1)
                for k in gkv]
    return gkv


def _head_maps(cfg: ModelConfig, plan: ShardingPlan, rank: int, device
               ) -> Tuple[torch.Tensor, List[int]]:
    """This rank's (q-head validity mask, :func:`_kv_map`)."""
    valid = (rank * plan.hq_loc + torch.arange(plan.hq_loc, device=device)
             ) < cfg.n_heads
    return valid, _kv_map(cfg, plan, rank)


def _per_q_head(t: torch.Tensor, kvmap: List[int]) -> torch.Tensor:
    """(B, S, kv_loc, hd) -> (B, S, hq_loc, hd), the kv head of each q
    head. The map never decreases, so it is runs of kv heads: one
    broadcast of a slice when every run has one length, else a
    concatenation of one broadcast a run (the padded q heads' clamped
    heads make a shorter last run; a rank of replicate mode may start or
    end inside a kv head's q heads). Either backward sums in a fixed
    order, where index_select's adds atomically on the card, so a
    training step gives the same bits every run."""
    runs: List[List[int]] = []                    # [kv head, count]
    for k in kvmap:
        if runs and runs[-1][0] == k:
            runs[-1][1] += 1
        else:
            runs.append([k, 1])
    b, s, _, hd = t.shape
    k0, n, rep = runs[0][0], len(runs), runs[0][1]
    if all(r == [k0 + i, rep] for i, r in enumerate(runs)):
        return t[:, :, k0:k0 + n, None, :].expand(b, s, n, rep, hd).reshape(
            b, s, n * rep, hd)
    return torch.cat([t[:, :, k:k + 1].expand(b, s, c, hd)
                      for k, c in runs], dim=2)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        qpos: torch.Tensor, kpos: torch.Tensor,
                        window: Optional[int] = None,
                        chunk: int = KV_CHUNK,
                        causal: bool = True) -> torch.Tensor:
    """Online-softmax attention over KV chunks. q (B,S,H,hd); k/v
    (B,Skv,H,hd). kpos entries < 0 are masked (padding); with ``causal``
    so are keys after the query, and with ``window`` keys at ``window``
    or more positions before it. The last chunk is not padded: padded
    keys would add exact zeros."""
    b, s, h, hd = q.shape
    skv = k.shape[1]
    scale = inv_sqrt(hd)
    qf = q.to(torch.float32)
    m = torch.full((b, s, h), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, s, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, chunk):
        kb = k[:, c0:c0 + chunk].to(torch.float32)
        vb = v[:, c0:c0 + chunk].to(torch.float32)
        pb = kpos[c0:c0 + chunk]
        sc = torch.einsum("bshd,bchd->bshc", qf, kb) * scale
        mask = (pb >= 0)[None, :].expand(s, -1)
        if causal:
            mask = mask & (pb[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (pb[None, :] > qpos[:, None] - window)
        mask = mask[None, :, None, :]
        sc = torch.where(mask, sc, torch.full_like(sc, _NEG))
        m_new = torch.maximum(m, torch.amax(sc, dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bshc,bchd->bshd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.to(q.dtype)


def init_kv_cache(cfg: ModelConfig, plan: ShardingPlan, batch: int,
                  cache_len: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Decode cache. Shard mode: head-sharded, every rank holds all
    positions of its ``kv_loc`` heads. Replicate mode: the sequence-
    sharded ring, each rank ``cache_len / tp`` positions of all kv heads
    (a replicated cache would hold every position tp times)."""
    if plan.kv_mode == "shard":
        c_loc = cache_len
    else:
        assert cache_len % plan.tp == 0, (cache_len, plan.tp)
        c_loc = cache_len // plan.tp
    shape = (batch, c_loc, plan.kv_loc, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((c_loc,), -1, dtype=torch.int64,
                                   device=device)}


def _project_qkv(p, x, kv_src, cfg, plan, prefix=""):
    """q from ``x``, k and v from ``kv_src`` (``x`` itself in a
    self-attention, the encoder's output in a cross-attention), with the
    parameters ``prefix + name``."""
    b = x.shape[0]
    hd = cfg.hd
    q = x @ p[prefix + "wq"]
    k, v = kv_src @ p[prefix + "wk"], kv_src @ p[prefix + "wv"]
    if cfg.use_bias:
        q, k, v = (q + p[prefix + "bq"], k + p[prefix + "bk"],
                   v + p[prefix + "bv"])
    q = q.reshape(b, -1, plan.hq_loc, hd)
    k = k.reshape(b, -1, plan.kv_loc, hd)
    v = v.reshape(b, -1, plan.kv_loc, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p[prefix + "qnorm"])
        k = rms_norm(k, p[prefix + "knorm"])
    return q, k, v


def _finish(p, ctx, valid, policy: CommPolicy, cfg, layer, group,
            prefix=""):
    """Mask padded heads, out-project, quantized TP AllReduce."""
    b, s = ctx.shape[0], ctx.shape[1]
    ctx = ctx * valid.to(ctx.dtype)[None, None, :, None]
    y = tp_psum(ctx.reshape(b, s, -1) @ p[prefix + "wo"], policy, group,
                layer)
    if cfg.use_bias:
        y = y + p[prefix + "bo"]
    return y


def self_attention(p: Dict, x: torch.Tensor, positions, cfg: ModelConfig,
                   plan: ShardingPlan, policy: CommPolicy, *,
                   causal: bool = True, window: Optional[int] = None,
                   cache: Optional[Dict] = None, pos: int = 0,
                   layer: Optional[int] = None, group=None, rank: int = 0
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention, causal unless ``causal`` is False (the encoder's),
    over the last ``window`` positions when given: full-sequence
    (cache=None; positions (S,)) or single-token cached decode (x
    (B,1,d) at position ``pos``; the cache is written in place)."""
    valid, kvmap = _head_maps(cfg, plan, rank, x.device)
    q, k, v = _project_qkv(p, x, x, cfg, plan)

    if cache is None:
        if cfg.rope_theta is not None:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        ke, ve = (_per_q_head(t, kvmap) for t in (k, v))
        ctx = blockwise_attention(q, ke, ve, positions, positions, window,
                                  causal=causal)
        return _finish(p, ctx, valid, policy, cfg, layer, group), None

    if cfg.rope_theta is not None:
        pvec = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        q = rope(q, pvec, cfg.rope_theta)
        k = rope(k, pvec, cfg.rope_theta)
    c_loc = cache["k"].shape[1]
    # the slot of ``pos`` in the whole ring, and the rank that holds it
    # (every rank in shard mode); ``pos`` is a host int, so is the owner
    slot = pos % (c_loc * (1 if plan.kv_mode == "shard" else plan.tp))
    if slot // c_loc == (0 if plan.kv_mode == "shard" else rank):
        cache["k"][:, slot % c_loc] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot % c_loc] = v[:, 0].to(cache["v"].dtype)
        cache["slot_pos"][slot % c_loc] = pos
    spos = cache["slot_pos"]
    mask = (spos >= 0) & (spos <= pos)
    if causal and window is not None:
        mask = mask & (spos > pos - window)
    mask = mask[None, None, None, :]
    if plan.kv_mode == "shard":
        ke = _per_q_head(cache["k"], kvmap)          # (B, C, hq_loc, hd)
        ve = _per_q_head(cache["v"], kvmap)
        sc = torch.einsum("bshd,bchd->bshc", q.to(torch.float32),
                          ke.to(torch.float32)) * inv_sqrt(cfg.hd)
        sc = torch.where(mask, sc, torch.full_like(sc, _NEG))
        w = torch.softmax(sc, dim=-1)
        ctx = torch.einsum("bshc,bchd->bshd", w, ve.to(torch.float32))
    else:
        ctx = _ring_attention(q, cache, mask, cfg, plan, group)
    return _finish(p, ctx.to(x.dtype), valid, policy, cfg, layer,
                   group), cache


def _ring_attention(q: torch.Tensor, cache: Dict, mask: torch.Tensor,
                    cfg: ModelConfig, plan: ShardingPlan,
                    group) -> torch.Tensor:
    """Replicate mode's decode over the sequence-sharded ring: q (B, 1,
    hq_loc, hd) -> this rank's heads' context (B, 1, hq_loc, hd) f32.

    The ring's slots on this rank serve every q head, so the ranks' q
    heads are gathered first (exact); this rank's online-softmax partials
    (m, l, acc) of every q head go to the rank that owns the head in one
    all-to-all, and each rank merges its heads' partials with the JAX
    package's arithmetic, the sums over the ranks in rank order. (JAX
    gathers the partials of each rank's own heads and merges them as if
    they were one head's: a difference from the reference, ROADMAP Queue
    C.) A rank whose slots are all masked has m = -1e30, weights exp(0) =
    1 and l = c_loc, as in JAX: its correction exp(m - max m) is 0, which
    takes its share out."""
    global RING_MERGES
    tp, hq, hd = plan.tp, plan.hq_loc, cfg.hd
    b = q.shape[0]
    qa = all_gather_rows(q, group)                   # (tp, B, 1, hq, hd)
    qa = qa.permute(1, 2, 0, 3, 4).reshape(b, 1, tp * hq, hd)
    every = [k for r in range(tp) for k in _kv_map(cfg, plan, r)]
    ke = _per_q_head(cache["k"], every)              # (B, C_loc, hq_pad, hd)
    ve = _per_q_head(cache["v"], every)
    sc = torch.einsum("bshd,bchd->bshc", qa.to(torch.float32),
                      ke.to(torch.float32)) * inv_sqrt(hd)
    sc = torch.where(mask, sc, torch.full_like(sc, _NEG))
    m_loc = torch.amax(sc, dim=-1)                   # (B, 1, hq_pad)
    pw = torch.exp(sc - m_loc[..., None])
    l_loc = torch.sum(pw, dim=-1)
    acc = torch.einsum("bshc,bchd->bshd", pw, ve.to(torch.float32))
    part = torch.cat([acc, m_loc[..., None], l_loc[..., None]], dim=-1)
    part = part.reshape(b, 1, tp, hq, hd + 2).permute(2, 0, 1, 3, 4)
    parts = all_to_all_rows(part.contiguous(), group)  # row p: rank p's
    RING_MERGES += 1
    a_all, m_all, l_all = parts[..., :-2], parts[..., -2], parts[..., -1]
    m_g = torch.amax(m_all, dim=0)
    corr = torch.exp(m_all - m_g[None])
    l_g = sum_rows(l_all * corr, 0)
    return (sum_rows(a_all * corr[..., None], 0)
            / torch.clamp(l_g, min=1e-20)[..., None])


def cross_attention(p: Dict, x: torch.Tensor, enc: torch.Tensor,
                    cfg: ModelConfig, plan: ShardingPlan,
                    policy: CommPolicy, prefix: str = "x",
                    layer: Optional[int] = None, group=None,
                    rank: int = 0) -> torch.Tensor:
    """Cross-attention of x (B, S, d) onto the encoder's output or the
    image embeddings ``enc`` (B, Senc, d): q from ``x``, k and v from
    ``enc`` (parameters ``prefix + name``), no rotation (the absolute
    positions are in the embeddings), never causal, no cache (``enc`` is
    the same at every step), then the quantized TP site."""
    valid, kvmap = _head_maps(cfg, plan, rank, x.device)
    q, k, v = _project_qkv(p, x, enc, cfg, plan, prefix)
    kpos = torch.arange(enc.shape[1], device=x.device)
    qpos = torch.zeros((x.shape[1],), dtype=torch.int64, device=x.device)
    ke, ve = (_per_q_head(t, kvmap) for t in (k, v))
    ctx = blockwise_attention(q, ke, ve, qpos, kpos, causal=False)
    return _finish(p, ctx, valid, policy, cfg, layer, group, prefix)
