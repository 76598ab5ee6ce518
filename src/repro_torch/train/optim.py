"""AdamW with a cosine schedule on the flat ZeRO shards.

The optimizer state lives in the store's layout (``(n_stack, flat /
fsdp)`` a leaf): each rank updates only its own shard. All of it is
float32 elementwise math in the JAX package's order of operations (its
Python constants folded as Python floats, as JAX folds them before the
weak-typed multiply).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def tree_map(fn, *trees: Tree) -> Tree:
    """``fn`` over the leaves of nested ``{group: {name: tensor}}`` dicts
    of one structure (the first tree's)."""
    return {g: {n: fn(*(t[g][n] for t in trees)) for n in trees[0][g]}
            for g in trees[0]}


def lr_schedule(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine down to ``min_lr_frac * lr``
    at ``total_steps``; ``step`` a 0-d tensor, the result f32."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init_opt_state(store: Tree, cfg: OptimConfig, grad_ef: bool = False,
                   qgrad_ef: bool = False, fsdp: int = 1) -> Dict:
    """``m`` and ``v`` (zeros like the store), ``step``; ``grad_ef`` adds
    the pod EF residual ``ef`` (the store's shape), ``qgrad_ef`` the
    qgrad EF residual ``qef`` at the reduce-scatter's input shape, the
    full flat length: ``(n_stack, flat)``."""
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    state = {"m": tree_map(zeros, store), "v": tree_map(zeros, store),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=_device(store))}
    if grad_ef:
        state["ef"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), store)
    if qgrad_ef:
        state["qef"] = tree_map(lambda p: torch.zeros(
            (p.shape[0], p.shape[1] * fsdp), dtype=torch.float32,
            device=p.device), store)
    return state


def _device(tree: Tree) -> torch.device:
    return next(iter(next(iter(tree.values())).values())).device


def global_grad_norm(grads: Tree) -> torch.Tensor:
    """This rank's sum of squares (f32), leaf by leaf in the JAX pytree's
    order (sorted keys); the caller sums it over the mesh."""
    sq = torch.zeros((), dtype=torch.float32, device=_device(grads))
    for g in sorted(grads):
        for n in sorted(grads[g]):
            sq = sq + torch.sum(torch.square(grads[g][n].to(torch.float32)))
    return sq


#: values of a leaf that one pass of the update takes at a time: the
#: update is elementwise, so slices give the bits of the whole leaf, and
#: its temporaries stay a few slices large (a 525 M-value embedding leaf
#: would otherwise need gigabytes of them)
UPDATE_SLICE = 1 << 24


def adamw_update(store: Tree, grads: Tree, state: Dict, cfg: OptimConfig,
                 grad_norm: torch.Tensor) -> Tuple[Tree, Dict,
                                                   torch.Tensor]:
    """One AdamW step on the local shards, ``grad_norm`` the global L2
    norm -> (store, {"m", "v", "step"}, lr).

    The store and the moments are updated in place (as the JAX step
    donates them), a slice at a time, in the JAX package's order of
    operations; each gradient leaf is dropped from ``grads`` once used.
    """
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(grad_norm, min=1e-12),
                       max=1.0)
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=sf.device), sf)

    def upd(p, g, m, v):
        # m2 = b1 m + (1 - b1) gf;  v2 = b2 v + (1 - b2) gf gf
        # p -= lr (m2 / bc1 / (sqrt(v2 / bc2) + eps) + wd p)
        gf = g.to(torch.float32) * clip
        t = gf * (1 - cfg.b1)
        m.mul_(cfg.b1).add_(t)
        torch.mul(gf, 1 - cfg.b2, out=t)
        t.mul_(gf)
        v.mul_(cfg.b2).add_(t)
        del gf
        mh = m / bc1
        torch.div(v, bc2, out=t)
        t.sqrt_().add_(cfg.eps)
        mh.div_(t)
        torch.mul(p, cfg.weight_decay, out=t)
        mh.add_(t)
        p.sub_(mh.mul_(lr))

    for gname, gg in store.items():
        for name, p in gg.items():
            g = grads[gname][name]
            grads[gname][name] = None
            m, v = state["m"][gname][name], state["v"][gname][name]
            assert p.dtype == m.dtype == v.dtype == torch.float32
            pf, gf_, mf, vf = (a.reshape(-1) for a in (p, g, m, v))
            for i in range(0, pf.shape[0], UPDATE_SLICE):
                sl = slice(i, i + UPDATE_SLICE)
                upd(pf[sl], gf_[sl], mf[sl], vf[sl])
            del g
    return store, {"m": state["m"], "v": state["v"], "step": step}, lr
