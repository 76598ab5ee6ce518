"""GQA attention: blockwise (online-softmax) prefill + cached decode.

Written with plain tensor ops and float32 scores, as the JAX package
writes it. q heads are sharded over the TP ranks; kv heads are sharded
("shard" mode, the only mode this package runs). The out-projection's
partial sums cross the ranks through :func:`repro_torch.models.layers.
tp_psum`.

The decode cache is a ring: ``slot_pos[c]`` is the position held in slot
``c`` (-1 when empty); position ``pos`` goes to slot ``pos % cache_len``.
Unlike the JAX package, which returns a new cache, the port writes the
cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.policy import CommPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm, rope, tp_psum
from repro_torch.parallel.plan import ShardingPlan
from repro_torch.parallel.shardings import ParamSpec

KV_CHUNK = 1024
_NEG = -1e30


def attn_specs(cfg: ModelConfig, plan: ShardingPlan) -> Dict[str, ParamSpec]:
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
    return s


def _head_maps(cfg: ModelConfig, plan: ShardingPlan, rank: int, device):
    """This rank's (q-head validity mask, local kv index per q head)."""
    gq = rank * plan.hq_loc + torch.arange(plan.hq_loc, device=device)
    valid = gq < cfg.n_heads
    q_per_kv = cfg.n_heads // cfg.n_kv_heads
    gkv = torch.clamp(gq // q_per_kv, 0, cfg.n_kv_heads - 1)
    if plan.kv_mode != "shard":
        raise NotImplementedError(
            "replicated-kv attention (tp > n_kv_heads) is not ported")
    kv_local = torch.clamp(gkv - rank * plan.kv_loc, 0, plan.kv_loc - 1)
    return valid, kv_local


def _per_q_head(t: torch.Tensor, kvmap: torch.Tensor, cfg: ModelConfig,
                plan: ShardingPlan, rank: int) -> torch.Tensor:
    """(B, S, kv_loc, hd) -> (B, S, hq_loc, hd), the kv head of each q
    head. Where the map is kv head ``i // (hq_loc / kv_loc)`` for q head
    ``i`` (every q head of the rank real), a broadcast: its backward sums
    in a fixed order, where index_select's adds atomically on the card,
    so a training step gives the same bits every run. Else index_select."""
    rep, rem = divmod(plan.hq_loc, plan.kv_loc)
    if rem == 0 and (rank + 1) * plan.hq_loc <= cfg.n_heads and \
            cfg.n_heads // cfg.n_kv_heads == rep:
        b, s, kv, hd = t.shape
        return t[:, :, :, None, :].expand(b, s, kv, rep, hd).reshape(
            b, s, kv * rep, hd)
    return torch.index_select(t, 2, kvmap)


def _scale(hd: int) -> float:
    """1/sqrt(hd) as float32 arithmetic gives it (as in the JAX code), as
    a Python float (exact in float32) so that no host-to-device copy
    synchronises the stream."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        qpos: torch.Tensor, kpos: torch.Tensor,
                        chunk: int = KV_CHUNK) -> torch.Tensor:
    """Causal online-softmax attention over KV chunks. q (B,S,H,hd); k/v
    (B,Skv,H,hd). kpos entries < 0 are masked (padding). The last chunk
    is not padded: padded keys would add exact zeros."""
    b, s, h, hd = q.shape
    skv = k.shape[1]
    scale = _scale(hd)
    qf = q.to(torch.float32)
    m = torch.full((b, s, h), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, s, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, chunk):
        kb = k[:, c0:c0 + chunk].to(torch.float32)
        vb = v[:, c0:c0 + chunk].to(torch.float32)
        pb = kpos[c0:c0 + chunk]
        sc = torch.einsum("bshd,bchd->bshc", qf, kb) * scale
        mask = ((pb >= 0)[None, :] & (pb[None, :] <= qpos[:, None])
                )[None, :, None, :]
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
    """Head-sharded decode cache: every rank holds all positions of its
    ``kv_loc`` heads."""
    shape = (batch, cache_len, plan.kv_loc, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((cache_len,), -1, dtype=torch.int64,
                                   device=device)}


def _project_qkv(p, x, cfg, plan):
    b = x.shape[0]
    hd = cfg.hd
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.use_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, -1, plan.hq_loc, hd)
    k = k.reshape(b, -1, plan.kv_loc, hd)
    v = v.reshape(b, -1, plan.kv_loc, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"])
        k = rms_norm(k, p["knorm"])
    return q, k, v


def _finish(p, ctx, valid, policy: CommPolicy, cfg, layer, group):
    """Mask padded heads, out-project, quantized TP AllReduce."""
    b, s = ctx.shape[0], ctx.shape[1]
    ctx = ctx * valid.to(ctx.dtype)[None, None, :, None]
    y = tp_psum(ctx.reshape(b, s, -1) @ p["wo"], policy, group, layer)
    if cfg.use_bias:
        y = y + p["bo"]
    return y


def self_attention(p: Dict, x: torch.Tensor, positions, cfg: ModelConfig,
                   plan: ShardingPlan, policy: CommPolicy, *,
                   cache: Optional[Dict] = None, pos: int = 0,
                   layer: Optional[int] = None, group=None, rank: int = 0
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Causal self-attention: full-sequence (cache=None; positions (S,))
    or single-token cached decode (x (B,1,d) at position ``pos``; the
    cache is written in place)."""
    valid, kvmap = _head_maps(cfg, plan, rank, x.device)
    q, k, v = _project_qkv(p, x, cfg, plan)

    if cache is None:
        if cfg.rope_theta is not None:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        ke, ve = (_per_q_head(t, kvmap, cfg, plan, rank) for t in (k, v))
        ctx = blockwise_attention(q, ke, ve, positions, positions)
        return _finish(p, ctx, valid, policy, cfg, layer, group), None

    if cfg.rope_theta is not None:
        pvec = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        q = rope(q, pvec, cfg.rope_theta)
        k = rope(k, pvec, cfg.rope_theta)
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["slot_pos"][slot] = pos
    spos = cache["slot_pos"]

    ke = torch.index_select(cache["k"], 2, kvmap)   # (B, C, hq_loc, hd)
    ve = torch.index_select(cache["v"], 2, kvmap)
    sc = torch.einsum("bshd,bchd->bshc", q.to(torch.float32),
                      ke.to(torch.float32)) * _scale(cfg.hd)
    mask = (spos >= 0) & (spos <= pos)
    sc = torch.where(mask[None, None, None, :], sc, torch.full_like(sc, _NEG))
    w = torch.softmax(sc, dim=-1)
    ctx = torch.einsum("bshc,bchd->bshd", w, ve.to(torch.float32))
    return _finish(p, ctx.to(x.dtype), valid, policy, cfg, layer,
                   group), cache
