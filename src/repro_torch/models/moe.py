"""Mixture of experts with the quantized expert-parallel dispatch.

The port of the JAX package's ``repro.models.moe``. The TP axis factorises
``tp = ep * etp`` (see :class:`repro_torch.parallel.plan.MoEPlan`): rank
``m = ep_idx * etp + tp_idx`` owns ``e_loc = E / ep`` experts, each with
its hidden sharded ``etp`` ways. Routing is capacity based and sort-free
(one-hot cumsum positions); the dispatch All2All's payload goes through
the paper's wire codec (the ``a2a`` site), the combine stays exact, and
the within-expert partial sums take the quantized TP AllReduce when
``etp > 1``.

Process groups: ``group`` is the TP group. With ``etp == 1`` the dispatch
runs over it; with ``ep == 1`` the within-expert AllReduce does. With
both above 1, the dispatch, the combine and ``ep_slice``'s gather run
over the axis's ``ep`` subaxis and the within-expert AllReduce over its
``etp`` subaxis (the JAX package's ``axis_index_groups``), while the aux
loss's mean stays over the whole axis, as JAX's ``lax.pmean``.

Under autograd every collective has the JAX package's transpose: the
dispatch's is the exact all-to-all (straight-through quantization), the
combine's an all-to-all, the ``ep_slice`` gather's the exact
reduce-scatter, the aux loss's mean over the ranks the exact sum over
``tp``. The backward adds in a fixed order: the routes' token copies are
a broadcast, the dispatch buffer an out-of-place ``index_add`` whose
backward is a gather, and the combine's gather scatters exact zeros only
into slots that several routes read (a dropped route weighs 0).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import (all_gather_rows, all_to_all_rows,
                                          compressed_psum,
                                          dispatch_all_to_all, psum_exact)
from repro_torch.core.comm_config import NO_COMPRESSION
from repro_torch.core.policy import CommPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gelu
from repro_torch.parallel.axis import ModelAxis
from repro_torch.parallel.plan import ShardingPlan
from repro_torch.parallel.shardings import ParamSpec


def moe_specs(cfg: ModelConfig, plan: ShardingPlan,
              prefix: str = "moe_") -> Dict[str, ParamSpec]:
    m = cfg.moe
    d = cfg.d_model
    s = {
        prefix + "router": ParamSpec((d, m.n_experts)),
        prefix + "w1": ParamSpec((m.n_experts, d, m.d_ff), moe_fold="in"),
        prefix + "w2": ParamSpec((m.n_experts, m.d_ff, d), moe_fold="out",
                                 init="zeros"),
    }
    if cfg.act in ("swiglu", "geglu"):
        s[prefix + "w3"] = ParamSpec((m.n_experts, d, m.d_ff),
                                     moe_fold="in")
    return s


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``tokens`` tokens: a multiple of 8 from 8 up,
    else at least 1 (at decode a floor of 8 would inflate the All2All)."""
    m = cfg.moe
    c = -(-int(tokens * m.top_k * m.capacity_factor) // m.n_experts)
    if c >= 8:
        return -(-c // 8) * 8
    return max(1, c)


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """(T, d) tokens -> (topi, topv, pos, keep, aux), in float32: the top-k
    experts of each token and their renormalised weights, each route's
    position in its expert's queue (token order, one-hot cumsum), whether
    it fits the capacity, and the load-balance loss
    ``E * sum_e f_e * p_e``. Routes are token-major: route ``i`` is token
    ``i // top_k``."""
    m = cfg.moe
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: NaN above every number, ties to the lower
    # expert (a token holding an infinity has all-NaN probabilities)
    topv, topi = (t[:, :m.top_k] for t in torch.sort(
        probs, dim=-1, descending=True, stable=True))
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    route_frac = F.one_hot(topi, m.n_experts).to(torch.float32).mean((0, 1))
    aux = m.n_experts * torch.sum(route_frac * probs.mean(0))
    re = topi.reshape(-1)
    onehot = F.one_hot(re, m.n_experts).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, re[:, None])[:, 0]
    keep = pos < capacity(xt.shape[0], cfg)
    return topi, topv, pos, keep, aux


def _groups(plan: ShardingPlan, group):
    """(dispatch group, within-expert group) for the TP group: the whole
    axis where the other factor is 1, else the model axis's ``ep`` and
    ``etp`` subaxes (:class:`~repro_torch.parallel.axis.ModelAxis`)."""
    mp = plan.moe
    if mp.etp == 1:
        return group, None
    if mp.ep == 1:
        return None, group
    if not isinstance(group, ModelAxis) or group.ep is None:
        raise ValueError(f"ep={mp.ep} x etp={mp.etp}: the model axis needs "
                         f"its ep and etp subaxes (launch/mesh.py "
                         f"init_mesh)")
    return group.ep, group.etp


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig,
              plan: ShardingPlan, policy: CommPolicy,
              prefix: str = "moe_", layer: Optional[int] = None,
              group=None, rank: int = 0,
              stats: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d), the same on every TP rank -> (out, aux_loss).

    ``layer`` is the global block index: the dispatch and the
    within-expert AllReduce resolve their configs at ``(site, layer)``.
    ``stats``, if given, gathers ``routes`` and ``dropped`` (routes over
    capacity, a device tensor) across calls.
    """
    a2a_cfg = policy.resolve("a2a", layer) or NO_COMPRESSION
    tp_cfg = policy.resolve("tp", layer) or NO_COMPRESSION
    m = cfg.moe
    mp = plan.moe
    ep_group, etp_group = _groups(plan, group)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)

    # EP token slicing: each ep rank dispatches 1/ep of the tokens, and
    # the outputs are gathered after the combine
    ep_slice = policy.ep_slice and mp.ep > 1
    t_orig = t
    if ep_slice:
        ts = -(-t // mp.ep)
        xt = F.pad(xt, (0, 0, 0, ts * mp.ep - t))
        ep_idx = rank // mp.etp
        xt = xt[ep_idx * ts:(ep_idx + 1) * ts]
        t = ts

    topi, topv, pos, keep, aux = route(xt, p[prefix + "router"], cfg)
    if stats is not None:
        stats["routes"] = stats.get("routes", 0) + keep.numel()
        stats["dropped"] = stats.get("dropped", 0) + (~keep).sum()

    # dispatch buffer (E, cap, d), built as the JAX package builds it:
    # every route added into +0.0, a dropped one as x * 0 into slot
    # cap - 1 of its expert (so a kept -0.0 becomes +0.0, and a dropped
    # inf or NaN makes that slot NaN). A slot holds at most one kept
    # route and otherwise zeros, so the sum does not depend on the order
    # of the adds, but for the payload of a NaN.
    cap = capacity(t, cfg)
    re = topi.reshape(-1)
    rw = topv.reshape(-1)
    slot = re * cap + torch.where(keep, pos, torch.full_like(pos, cap - 1))
    src = xt[:, None].expand(t, m.top_k, d).reshape(-1, d)   # route i's token
    buf = torch.zeros((m.n_experts * cap, d), dtype=x.dtype,
                      device=x.device).index_add(
                          0, slot, src * keep[:, None].to(x.dtype))
    buf = buf.reshape(mp.ep, mp.e_loc * cap, d)
    recv = dispatch_all_to_all(buf, a2a_cfg, ep_group)

    # expert FFN: my e_loc experts, etp-sharded hidden
    tok = recv.reshape(mp.ep, mp.e_loc, cap, d).transpose(0, 1)
    tok = tok.reshape(mp.e_loc, mp.ep * cap, d)
    h = torch.bmm(tok, p[prefix + "w1"])
    if cfg.act in ("swiglu", "geglu"):
        act = F.silu(h) if cfg.act == "swiglu" else gelu(h)
        h = act * torch.bmm(tok, p[prefix + "w3"])
    else:
        h = gelu(h)
    y = torch.bmm(h, p[prefix + "w2"])
    if mp.etp > 1:
        y = compressed_psum(y, tp_cfg, etp_group)

    # combine: exact, back to the tokens' ranks, weighted sum over top-k
    y = y.reshape(mp.e_loc, mp.ep, cap, d).transpose(0, 1)
    back = all_to_all_rows(y.reshape(mp.ep, mp.e_loc * cap, d), ep_group)
    back = back.reshape(m.n_experts * cap, d)
    out_r = back[torch.clamp(re * cap + pos, 0, m.n_experts * cap - 1)]
    # JAX's rw * keep with a boolean keep is a select: a dropped route
    # weighs 0 even where its weight is NaN
    out_r = out_r * torch.where(keep, rw, 0.0)[:, None].to(x.dtype)
    out = torch.sum(out_r.reshape(t, m.top_k, d), dim=1)
    if ep_slice:
        out = all_gather_rows(out, ep_group).reshape(-1, d)[:t_orig]
        # the slice's aux estimates the whole; average over the TP group
        aux = psum_exact(aux, group) / plan.tp
    return out.reshape(b, s, d), aux
