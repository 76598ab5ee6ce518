"""Normalization (RMS and LayerNorm), activations, RoPE, embeddings,
vocab-parallel logits, dense MLP.

Every activation that crosses the TP ranks goes through
:func:`tp_psum`, the paper's quantized AllReduce site (its backward the
``tp_bwd`` site). ``group`` is the TP process group (``None``: one rank)
and ``rank`` this rank's index in it.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.collectives import (all_gather_rows, compressed_psum,
                                          psum_exact)
from repro_torch.core.comm_config import NO_COMPRESSION
from repro_torch.core.policy import CommPolicy


def tp_psum(x: torch.Tensor, policy: CommPolicy, group=None,
            layer: Optional[int] = None) -> torch.Tensor:
    """The TP AllReduce site. ``layer`` is the global block index (None
    for the embedding psum); the policy resolves ``("tp", layer)``, and
    ``("tp_bwd", layer)`` for the backward (None: the exact sum of the
    cotangent)."""
    cfg = policy.resolve("tp", layer) or NO_COMPRESSION
    bwd = policy.resolve("tp_bwd", layer)
    return compressed_psum(x, cfg, group, bwd)


@functools.lru_cache(maxsize=None)
def _gelu_consts(dtype: torch.dtype) -> Tuple[float, ...]:
    """sqrt(2 / pi), 0.044715, 0.5 and 1 rounded to ``dtype``, as JAX's
    weak-typed scalars are in an op with an array of that dtype."""
    return tuple(torch.tensor(v, dtype=dtype).item()
                 for v in (math.sqrt(2 / math.pi), 0.044715, 0.5, 1.0))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU of the JAX package (``jax.nn.gelu(approximate=True)``)
    op for op in ``x``'s dtype, each op rounded to it: in bf16 JAX's bits
    on the CPU. ``F.gelu(approximate="tanh")`` rounds once from float32
    and differs from it in 39% of bf16 values, by up to 253 ulps near
    its cancellation at large negative ``x``. In float32 the two tanh
    implementations differ by at most 2^-22 max(|x|, 1)
    (``tests/test_torch_moe_archs.py``)."""
    c, a, half, one = _gelu_consts(x.dtype)
    return x * (half * (one + torch.tanh(c * (x + a * x ** 3))))


def inv_sqrt(n: int) -> float:
    """1/sqrt(n) as float32 arithmetic gives it (as in the JAX code), as
    a Python float (exact in float32) so that no host-to-device copy
    synchronises the stream."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``jnp.logaddexp(x, 0)``, that is ``max(x, 0) +
    log1p(exp(-|x|))`` (NaN where ``x`` is NaN). ``F.softplus`` differs:
    it is ``log1p(exp(x))`` below its threshold of 20 and ``x`` above."""
    sp = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, sp)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)`` (not ``F.logsigmoid``)."""
    return -softplus(-x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: ``lax.logistic``, which lowers to ``1 / (1 +
    exp(-x))``, each op in ``x``'s dtype."""
    return 1.0 / (1.0 + torch.exp(-x))


def rms_norm(x: torch.Tensor, gain: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gain.to(torch.float32)
            ).to(x.dtype)


def layer_norm(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (the population variance,
    as ``jnp.var``), cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    c = xf - mu
    var = torch.mean(c * c, dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + eps)
    return (y * gain.to(torch.float32) + bias.to(torch.float32)
            ).to(x.dtype)


def apply_norm(x: torch.Tensor, p: Dict, kind: str) -> torch.Tensor:
    """The norm ``kind``: "rms" (``p["gain"]``) or "ln" (``p["gain"]``,
    ``p["bias"]``)."""
    if kind == "rms":
        return rms_norm(x, p["gain"])
    return layer_norm(x, p["gain"], p["bias"])


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    # a Python-scalar base (rounded to float32, as JAX's weak-typed
    # ``theta ** arr`` is): a device tensor made from a host scalar would
    # synchronise the stream on every call
    freqs = torch.pow(float(theta), exponent)
    ang = positions.to(torch.float32)[..., None] * freqs     # (.., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (.., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    while cos.dim() < x.dim():
        cos, sin = cos[None], sin[None]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def embed_lookup(tokens: torch.Tensor, emb_loc: torch.Tensor,
                 policy: CommPolicy, dtype, group=None,
                 rank: int = 0) -> torch.Tensor:
    """tokens (B,S) int; emb_loc (v_loc, d) = this rank's vocab rows.
    Masked local lookup + TP psum (the paper's quantized AR site)."""
    v_loc = emb_loc.shape[0]
    ids = tokens.to(torch.int64) - rank * v_loc
    ok = (ids >= 0) & (ids < v_loc)
    vec = emb_loc[torch.clamp(ids, 0, v_loc - 1)]
    vec = torch.where(ok[..., None], vec, torch.zeros_like(vec)).to(dtype)
    return tp_psum(vec, policy, group).to(dtype)


def vocab_parallel_logits(x: torch.Tensor, unemb_loc: torch.Tensor,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """x (..., d) @ unemb_loc (v_loc, d)^T -> this rank's logits, f32."""
    logits = torch.einsum("...d,vd->...v", x.to(torch.float32),
                          unemb_loc.to(torch.float32))
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def vocab_parallel_ce(logits_loc: torch.Tensor, labels: torch.Tensor,
                      vocab: int, v_loc: int, group=None,
                      rank: int = 0) -> torch.Tensor:
    """Cross-entropy over logits sharded by vocabulary over ``group``:
    logits_loc (T, v_loc) f32, labels (T,) global ids -> (T,) nll.

    The stabiliser max carries no gradient (a detached local max, its
    maxima gathered without one); the sums over the ranks are exact, with
    the exact sum as their backward.
    """
    base = rank * v_loc
    col = torch.arange(v_loc, device=logits_loc.device)[None, :] + base
    masked = torch.where(col < vocab, logits_loc,
                         torch.full_like(logits_loc, float("-inf")))
    loc_mx = torch.amax(masked, dim=-1).detach()
    mx = torch.amax(all_gather_rows(loc_mx, group), dim=0)       # (T,)
    se = psum_exact(torch.sum(torch.exp(masked - mx[:, None]), dim=-1),
                    group)
    lse = mx + torch.log(se)
    ids = labels.to(torch.int64) - base
    ok = (ids >= 0) & (ids < v_loc)
    own = torch.gather(logits_loc, 1,
                       torch.clamp(ids, 0, v_loc - 1)[:, None])[:, 0]
    label_logit = psum_exact(torch.where(ok, own, torch.zeros_like(own)),
                             group)
    return lse - label_logit


def mlp_apply(p: Dict, x: torch.Tensor, act: str, policy: CommPolicy,
              use_bias: bool = False, layer: Optional[int] = None,
              group=None) -> torch.Tensor:
    """Dense MLP with the hidden sharded; the down-projection's partial
    sums go through the TP AllReduce."""
    h = x @ p["w1"]
    if use_bias:
        h = h + p["b1"]
    if act in ("swiglu", "geglu"):
        g = x @ p["w3"]
        if use_bias:
            g = g + p["b3"]
        h = (F.silu(h) if act == "swiglu" else gelu(h)) * g
    else:
        h = gelu(h)
    y = tp_psum(h @ p["w2"], policy, group, layer)
    if use_bias:
        y = y + p["b2"]
    return y.to(x.dtype)
