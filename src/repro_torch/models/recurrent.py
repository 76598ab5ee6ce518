"""Recurrent mixers: RG-LRU (recurrentgemma's recurrent block), mLSTM and
sLSTM (xLSTM's cells), the port's copy of the JAX package's.

Each is sharded over the TP ranks by channel (RG-LRU: ``plan.lru_loc``
channels a rank) or by head (the cells: ``plan.nh_lstm_loc`` heads a
rank, padded to a multiple of tp; the padded heads are masked, exact
no-ops), and ends in the TP AllReduce site
(:func:`repro_torch.models.layers.tp_psum`). RG-LRU mixes the sequence
by a diagonal linear recurrence, which the prefill runs as JAX's
``lax.associative_scan`` does (:func:`associative_scan`: about 2 log2(S)
steps); the cells by a gated nonlinear one, a loop over the sequence as
JAX's ``lax.scan``. Decode carries a small state instead of a KV cache
(``rglru_init_state``, ``mlstm_init_state``, ``slstm_init_state``) and
advances it one step, written in place as the attention's cache is.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.policy import CommPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (gelu, inv_sqrt, log_sigmoid, sigmoid,
                                       softplus, tp_psum)
from repro_torch.parallel.axis import axis_rank
from repro_torch.parallel.plan import ShardingPlan
from repro_torch.parallel.shardings import ParamSpec

_C_RGLRU = 8.0
_M0 = -1e30                     # the cells' stabiliser before the first step


# ===========================================================================
# RG-LRU
# ===========================================================================

def rglru_specs(cfg: ModelConfig, plan: ShardingPlan
                ) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    w = plan.lru_loc * plan.tp            # padded global lru width
    cw = cfg.conv_width
    return {
        "rg_wx": ParamSpec((d, w), tp_dim=1),
        "rg_wg": ParamSpec((d, w), tp_dim=1),
        "rg_conv_w": ParamSpec((cw, w), tp_dim=1),
        "rg_conv_b": ParamSpec((w,), tp_dim=0, init="zeros"),
        "rg_wi": ParamSpec((w,), tp_dim=0, init="zeros"),
        "rg_bi": ParamSpec((w,), tp_dim=0, init="zeros"),
        "rg_wr": ParamSpec((w,), tp_dim=0, init="zeros"),
        "rg_br": ParamSpec((w,), tp_dim=0, init="zeros"),
        "rg_lam": ParamSpec((w,), tp_dim=0, init="lru_lambda"),
        "rg_wo": ParamSpec((w, d), tp_dim=0, init="zeros"),
    }


def associative_scan(combine: Callable, elems: List[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """The inclusive scan of ``elems`` (tensors of one shape) along dim 1
    under the associative ``combine(left, right)`` (lists in, list out),
    in the order of JAX's ``lax.associative_scan``: combine adjacent
    pairs, scan the half recursively, then combine the even elements with
    the odd results before them."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = combine([e[:, 0:-1:2] for e in elems],
                      [e[:, 1::2] for e in elems])
    odd = associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([e[:, :-1] for e in odd],
                       [e[:, 2::2] for e in elems])
    else:
        even = combine(odd, [e[:, 2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        t = torch.empty_like(e)
        t[:, 0] = e[:, 0]
        t[:, 2::2] = ev
        t[:, 1::2] = od
        out.append(t)
    return out


def _lru_combine(c1, c2):
    (a1, b1), (a2, b2) = c1, c2
    return [a1 * a2, a2 * b1 + b2]


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv over S, in ``u``'s dtype: u (B, S, W), w
    (cw, W), b (W,). ``state`` (B, cw - 1, W) holds the trailing inputs
    for decode; the new one comes back in ``u``'s dtype. The taps are
    summed in JAX's order (Python's ``sum``, from 0)."""
    cw = w.shape[0]
    if state is None:
        hist = F.pad(u, (0, 0, cw - 1, 0))
    else:
        hist = torch.cat([state.to(u.dtype), u], dim=1)
    s = u.shape[1]
    out = sum(hist[:, i:i + s, :] * w[i] for i in range(cw)) + b
    new_state = hist[:, -(cw - 1):, :] if cw > 1 else None
    return out.to(u.dtype), new_state


def rglru_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                plan: ShardingPlan, policy: CommPolicy,
                state: Optional[Dict] = None, layer: Optional[int] = None,
                group=None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d). With ``state`` ({"h", "conv"}, S = 1)
    one decode step, the state advanced in place."""
    u = x @ p["rg_wx"]
    u, new_conv = _causal_conv(u, p["rg_conv_w"], p["rg_conv_b"],
                               None if state is None else state["conv"])
    uf = u.to(torch.float32)
    i = sigmoid(uf * p["rg_wi"].to(torch.float32)
                + p["rg_bi"].to(torch.float32))
    rgate = sigmoid(uf * p["rg_wr"].to(torch.float32)
                    + p["rg_br"].to(torch.float32))
    log_a = -_C_RGLRU * rgate * softplus(p["rg_lam"].to(torch.float32))
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * uf)
    if state is None:
        h = associative_scan(_lru_combine, [a, gated])[1]
    else:
        h = a[:, 0] * state["h"] + gated[:, 0]
        state["h"].copy_(h)
        state["conv"].copy_(new_conv)
        h = h[:, None]
    g = gelu(x @ p["rg_wg"])
    y = (h.to(x.dtype) * g) @ p["rg_wo"]
    return tp_psum(y, policy, group, layer).to(x.dtype)


def rglru_init_state(cfg: ModelConfig, plan: ShardingPlan, batch: int,
                     device) -> Dict[str, torch.Tensor]:
    """Float32, as JAX's (the conv history's values are the activation
    dtype's, which float32 holds exactly)."""
    w, cw = plan.lru_loc, cfg.conv_width
    return {"h": torch.zeros((batch, w), device=device),
            "conv": torch.zeros((batch, cw - 1, w), device=device)}


# ===========================================================================
# mLSTM
# ===========================================================================

def _head_valid(cfg: ModelConfig, plan: ShardingPlan, group,
                device) -> torch.Tensor:
    """This rank's (nh_lstm_loc,) mask of real (unpadded) heads."""
    nh = plan.nh_lstm_loc
    return (axis_rank(group) * nh + torch.arange(nh, device=device)
            ) < cfg.n_heads


def mlstm_specs(cfg: ModelConfig, plan: ShardingPlan
                ) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    nhp = plan.nh_lstm_pad
    inner = nhp * (d // cfg.n_heads)
    return {
        "ml_wq": ParamSpec((d, inner), tp_dim=1),
        "ml_wk": ParamSpec((d, inner), tp_dim=1),
        "ml_wv": ParamSpec((d, inner), tp_dim=1),
        "ml_wi": ParamSpec((d, nhp), tp_dim=1),
        "ml_wf": ParamSpec((d, nhp), tp_dim=1),
        "ml_wog": ParamSpec((d, inner), tp_dim=1),
        "ml_wo": ParamSpec((inner, d), tp_dim=0, init="zeros"),
    }


def _mlstm_step(c, n, m, q, k, v, it, ft):
    """One step: c (B,H,dh,dh), n (B,H,dh), m (B,H); q, k, v (B,H,dh),
    it, ft (B,H) -> (c, n, m, h (B,H,dh)). ``m`` at -1e30 makes the first
    step's forget weight exactly 0."""
    m_new = torch.maximum(ft + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + m - m_new)
    c = fp[..., None, None] * c + ip[..., None, None] * (
        v[..., :, None] * k[..., None, :])            # outer(v, k)
    n = fp[..., None] * n + ip[..., None] * k
    num = torch.einsum("bhij,bhj->bhi", c, q)
    den = torch.maximum(torch.abs(torch.einsum("bhj,bhj->bh", n, q)),
                        torch.exp(-m_new))
    return c, n, m_new, num / den[..., None]


def mlstm_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                plan: ShardingPlan, policy: CommPolicy,
                state: Optional[Dict] = None, layer: Optional[int] = None,
                group=None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d). With ``state`` ({"c", "n", "m"}, S = 1)
    one decode step, the state advanced in place."""
    b, s, d = x.shape
    nh = plan.nh_lstm_loc
    dh = d // cfg.n_heads
    scale = inv_sqrt(dh)
    q = (x @ p["ml_wq"]).reshape(b, s, nh, dh).to(torch.float32) \
        * scale
    k = (x @ p["ml_wk"]).reshape(b, s, nh, dh).to(torch.float32) \
        * scale
    v = (x @ p["ml_wv"]).reshape(b, s, nh, dh).to(torch.float32)
    it = (x @ p["ml_wi"]).to(torch.float32)
    ft = log_sigmoid((x @ p["ml_wf"]).to(torch.float32))
    if state is None:
        c = x.new_zeros((b, nh, dh, dh), dtype=torch.float32)
        n = x.new_zeros((b, nh, dh), dtype=torch.float32)
        m = torch.full((b, nh), _M0, dtype=torch.float32, device=x.device)
        hs = []
        for t in range(s):
            c, n, m, ht = _mlstm_step(c, n, m, q[:, t], k[:, t], v[:, t],
                                      it[:, t], ft[:, t])
            hs.append(ht)
        h = torch.stack(hs, dim=1)                     # (B, S, H, dh)
    else:
        c, n, m, ht = _mlstm_step(state["c"], state["n"], state["m"],
                                  q[:, 0], k[:, 0], v[:, 0], it[:, 0],
                                  ft[:, 0])
        for key, val in (("c", c), ("n", n), ("m", m)):
            state[key].copy_(val)
        h = ht[:, None]
    og = sigmoid(x @ p["ml_wog"])
    valid = _head_valid(cfg, plan, group, x.device)
    h = h * valid[None, None, :, None]
    y = h.reshape(b, s, nh * dh).to(x.dtype) * og
    return tp_psum(y @ p["ml_wo"], policy, group, layer).to(x.dtype)


def mlstm_init_state(cfg: ModelConfig, plan: ShardingPlan, batch: int,
                     device) -> Dict[str, torch.Tensor]:
    nh, dh = plan.nh_lstm_loc, cfg.d_model // cfg.n_heads
    return {"c": torch.zeros((batch, nh, dh, dh), device=device),
            "n": torch.zeros((batch, nh, dh), device=device),
            "m": torch.full((batch, nh), _M0, device=device)}


# ===========================================================================
# sLSTM
# ===========================================================================

_GATES = "zifo"


def slstm_specs(cfg: ModelConfig, plan: ShardingPlan
                ) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    nhp = plan.nh_lstm_pad
    dh = d // cfg.n_heads
    inner = nhp * dh
    s = {}
    for g in _GATES:
        s["sl_w" + g] = ParamSpec((d, inner), tp_dim=1)
        s["sl_r" + g] = ParamSpec((nhp, dh, dh), tp_dim=0)
        s["sl_b" + g] = ParamSpec((inner,), tp_dim=0, init="zeros")
    # "wout", not "wo": "wo" is the output *gate* above
    s["sl_wout"] = ParamSpec((inner, d), tp_dim=0, init="zeros")
    return s


def _slstm_step(r, c, n, h, m, xz, xi, xf, xo):
    """One step: r (H, dh, 4 dh) the four gates' recurrent weights side by
    side (z, i, f, o); c, n, h, m (B,H,dh); the gates' inputs (B,H,dh)
    -> (c, n, h, m). ``m`` is per (B, H, dh)."""
    rz, ri, rf, ro = torch.einsum("bhj,hjk->bhk", h, r).chunk(4, dim=-1)
    zt = torch.tanh(xz + rz)
    it = xi + ri
    ft = log_sigmoid(xf + rf)
    ot = sigmoid(xo + ro)
    m_new = torch.maximum(ft + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + m - m_new)
    c = fp * c + ip * zt
    n = fp * n + ip
    return c, n, ot * (c / torch.clamp(n, min=1e-6)), m_new


def slstm_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                plan: ShardingPlan, policy: CommPolicy,
                state: Optional[Dict] = None, layer: Optional[int] = None,
                group=None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d). With ``state`` ({"c", "n", "h", "m"},
    S = 1) one decode step, the state advanced in place."""
    b, s, d = x.shape
    nh = plan.nh_lstm_loc
    dh = d // cfg.n_heads
    xs = [(x @ p["sl_w" + g] + p["sl_b" + g]).reshape(
        b, s, nh, dh).to(torch.float32) for g in _GATES]
    r = torch.cat([p["sl_r" + g].to(torch.float32) for g in _GATES],
                  dim=-1)
    if state is None:
        c = x.new_zeros((b, nh, dh), dtype=torch.float32)
        n, h = torch.zeros_like(c), torch.zeros_like(c)
        m = torch.full_like(c, _M0)
        hs = []
        for t in range(s):
            c, n, h, m = _slstm_step(r, c, n, h, m,
                                     *(a[:, t] for a in xs))
            hs.append(h)
        h = torch.stack(hs, dim=1)                     # (B, S, H, dh)
    else:
        new = _slstm_step(r, state["c"], state["n"], state["h"], state["m"],
                          *(a[:, 0] for a in xs))
        for key, val in zip("cnhm", new):
            state[key].copy_(val)
        h = new[2][:, None]
    valid = _head_valid(cfg, plan, group, x.device)
    h = h * valid[None, None, :, None]
    y = h.reshape(b, s, nh * dh).to(x.dtype) @ p["sl_wout"]
    return tp_psum(y, policy, group, layer).to(x.dtype)


def slstm_init_state(cfg: ModelConfig, plan: ShardingPlan, batch: int,
                     device) -> Dict[str, torch.Tensor]:
    shape = (batch, plan.nh_lstm_loc, cfg.d_model // cfg.n_heads)
    return {"c": torch.zeros(shape, device=device),
            "n": torch.zeros(shape, device=device),
            "h": torch.zeros(shape, device=device),
            "m": torch.full(shape, _M0, device=device)}
