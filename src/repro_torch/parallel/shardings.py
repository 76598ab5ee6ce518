"""Parameter specs, the port's random init, loading a JAX store, and the
flat ZeRO store of training with its FSDP gather.

Serving keeps each parameter in its logical TP-local shape, stacked over
pattern repeats: ``params[group][name]`` is ``(n_stack, *local_shape)``,
resident (``fsdp == 1``, no gather).

Training keeps the JAX package's flat ZeRO-3 store: a rank at
``(model m, data d)`` holds ``store[group][name]`` of shape ``(n_stack,
flat / fsdp)``, data shard ``d`` of rank ``m``'s TP-local values
flattened and zero-padded to :func:`repro_torch.parallel.plan.
flat_store_len` (whole quantization groups a shard). The forward gathers
a parameter over the data axis (:func:`gather_param`, optionally through
the wire codec: the ``qag`` site) and reshapes it; the gather's backward
is the exact reduce-scatter, which lands the gradient on the rank's
shard. A zero full-length ``delta`` added to the detached gathered
weights instead taps the full-length per-rank gradient, for the explicit
quantized reduce-scatter (the ``qgrad_rs`` site) that
:mod:`repro_torch.train.train_step` runs after the backward.

The JAX package stores every parameter as ``(n_stack, tp, flat)``;
:func:`load_jax_store` takes such a store (copied to numpy) into either
layout, so both packages run the same weights.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core.comm_config import CommConfig
from repro_torch.parallel.plan import ShardingPlan, flat_store_len

Params = Dict[str, Dict[str, torch.Tensor]]
#: the training store: ``store[group][name]`` (n_stack, flat / fsdp) f32
Store = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Global logical shape + how it maps to a TP rank."""
    shape: Tuple[int, ...]
    tp_dim: Optional[int] = None      # dim sharded over the TP ranks
    init: str = "fan_in"              # fan_in | zeros | ones | lru_lambda
    # experts: "in" = (E, d, F) with F over etp; "out" = (E, F, d).
    # E is sharded over ep; rank m = ep_idx*etp + tp_idx.
    moe_fold: Optional[str] = None

    def local_shape(self, plan: ShardingPlan) -> Tuple[int, ...]:
        if self.moe_fold is not None:
            m = plan.moe
            if self.moe_fold == "in":
                e, d, f = self.shape
                return (m.e_loc, d, f // m.etp)
            e, f, d = self.shape
            return (m.e_loc, f // m.etp, d)
        if self.tp_dim is None:
            return self.shape
        s = list(self.shape)
        assert s[self.tp_dim] % plan.tp == 0, (self.shape, self.tp_dim)
        s[self.tp_dim] //= plan.tp
        return tuple(s)

    def numel_loc(self, plan: ShardingPlan) -> int:
        return math.prod(self.local_shape(plan))

    def flat_len(self, plan: ShardingPlan) -> int:
        return flat_store_len(self.numel_loc(plan), plan.fsdp)


def _seed(seed: int, group: str, name: str, stack: int, rank: int) -> int:
    """Deterministic per-tensor seed (crc32: the same in every process)."""
    return zlib.crc32(f"{seed}/{group}/{name}/{stack}/{rank}".encode())


def init_params(cfg, plan: ShardingPlan, seed: int, device,
                dtype=torch.bfloat16, rank: int = 0) -> Params:
    """Random weights for one TP rank, made on ``device`` from ``seed``.

    The JAX package's init rules: ``fan_in`` specs are normal with std
    1/sqrt(fan_in), ``zeros`` specs (the attention and MLP output
    projections) zeros, ``ones`` specs (norm gains) ones, ``lru_lambda``
    specs (RG-LRU's decay) the inverse softplus of ``-log(u) / 8`` for
    ``u`` uniform on [0.9, 0.999], so that the recurrence's weight
    ``exp(-8 softplus(lambda))`` at a full gate is ``u``; any other
    init raises ValueError (:func:`_draw`). Each tensor has
    its own generator, seeded by a crc32 of (seed, group, name, stack
    index, rank), so the weights are the same in every process.
    Replicated parameters draw the same values on every rank; sliced ones
    (``tp_dim`` or ``moe_fold``) fold the rank in. A stack is drawn one
    slice at a time into one float32 temporary, scaled in place, so the
    temporary is one slice (738 MB for a (64, 2048, 1408) expert slice,
    21.5 GB for llama4-maverick's (128, 5120, 8192)), never the whole
    stack.
    """
    from repro_torch.models.model import param_groups
    out: Params = {}
    for gname, (n_stack, specs) in sorted(param_groups(cfg, plan).items()):
        out[gname] = {}
        for name, spec in sorted(specs.items()):
            shape = spec.local_shape(plan)
            t = torch.empty((n_stack, *shape), dtype=dtype, device=device)
            if spec.init == "ones":
                t.fill_(1.0)
            elif spec.init == "zeros":
                t.zero_()
            else:
                for i in range(n_stack):
                    t[i].copy_(_draw(spec, plan, seed, gname, name, i, rank,
                                     device))
            out[gname][name] = t
    return out


def _draw(spec: ParamSpec, plan: ShardingPlan, seed: int, gname: str,
          name: str, stack: int, rank: int, device) -> torch.Tensor:
    """One stack slice of a ``fan_in`` or ``lru_lambda`` parameter,
    float32 (see :func:`init_params`); ValueError for any other init."""
    if spec.init not in ("fan_in", "lru_lambda"):
        raise ValueError(f"{gname}/{name}: unknown init {spec.init!r}")
    shape = spec.local_shape(plan)
    r = rank if (spec.tp_dim is not None or spec.moe_fold is not None) else 0
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, gname, name, stack, r))
    if spec.init == "lru_lambda":
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32).mul_(0.999 - 0.9).add_(0.9)
        return torch.log(torch.exp(-torch.log(u) / 8.0) - 1.0)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).mul_(std)


def init_store(cfg, plan: ShardingPlan, seed: int, device, rank: int = 0,
               data_rank: int = 0) -> Store:
    """The training store of the rank at (model ``rank``, data
    ``data_rank``), float32 on ``device``: the weights of
    :func:`init_params` (the same seed gives the same values), flattened,
    zero-padded to the flat length, data shard ``data_rank``."""
    from repro_torch.models.model import param_groups
    out: Store = {}
    for gname, (n_stack, specs) in sorted(param_groups(cfg, plan).items()):
        out[gname] = {}
        for name, spec in sorted(specs.items()):
            flat = spec.flat_len(plan)
            shard = flat // plan.fsdp
            lo = data_rank * shard
            t = torch.zeros((n_stack, shard), dtype=torch.float32,
                            device=device)
            numel = spec.numel_loc(plan)
            if spec.init == "ones":
                t[:, :max(0, min(numel - lo, shard))] = 1.0
            elif spec.init != "zeros":
                for i in range(n_stack):
                    v = _draw(spec, plan, seed, gname, name, i, rank,
                              device).reshape(-1)[lo:lo + shard]
                    t[i, :v.shape[0]] = v
                    del v
            out[gname][name] = t
    return out


def load_jax_store(store_np, cfg, plan: ShardingPlan, device,
                   dtype=torch.float32, rank: int = 0,
                   data_rank: Optional[int] = None) -> Params:
    """JAX storage dict -> the port's parameters for TP rank ``rank``.

    ``store_np`` is ``{group: {name: ndarray (n_stack, tp, flat_len)}}``,
    as ``repro.parallel.shardings.build_store`` makes it and
    ``np.asarray`` copies it. With ``data_rank`` None: the serving layout,
    each parameter in its logical shape. With ``data_rank`` d: the
    training store of (model ``rank``, data d), each ``(n_stack, flat /
    fsdp)``, data shard d of the flat payload.
    """
    from repro_torch.models.model import param_groups
    out: Params = {}
    for gname, (n_stack, specs) in param_groups(cfg, plan).items():
        out[gname] = {}
        for name, spec in specs.items():
            arr = np.asarray(store_np[gname][name], dtype=np.float32)
            flat = spec.flat_len(plan)
            assert arr.shape == (n_stack, plan.tp, flat), (
                gname, name, arr.shape)
            if data_rank is None:
                shape = spec.local_shape(plan)
                vals = arr[:, rank, :math.prod(shape)].reshape(n_stack,
                                                               *shape)
            else:
                shard = flat // plan.fsdp
                vals = arr[:, rank, data_rank * shard:(data_rank + 1) * shard]
            out[gname][name] = torch.from_numpy(vals.copy()).to(
                device=device, dtype=dtype)
    return out


# ---------------------------------------------------------------------------
# FSDP gather (differentiable, optionally quantized)
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, cfg: Optional[CommConfig],
                group) -> torch.Tensor:
    from repro_torch.core.collectives import all_gather_rows
    if cfg is None or not cfg.enabled:
        return all_gather_rows(x, group).reshape(-1)
    wire = codec.encode(x, cfg)                       # (w,)
    allw = all_gather_rows(wire, group)               # (fsdp, w)
    return codec.decode(allw, cfg, x.shape[-1],
                        out_dtype=x.dtype).reshape(-1)


class _FsdpAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg, group):
        ctx.group = group
        return _all_gather(x, cfg, group)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.collectives import reduce_scatter_tiled
        return reduce_scatter_tiled(g, ctx.group), None, None


def fsdp_all_gather(x: torch.Tensor, cfg: Optional[CommConfig],
                    group) -> torch.Tensor:
    """(flat / fsdp,) -> (flat,) over the data axis ``group``: the plain
    all-gather, or with ``cfg`` enabled the wire codec's (the ZeRO++-style
    ``qag`` site: each rank's shard encoded once, the wires gathered and
    decoded). The backward is the exact reduce-scatter."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _FsdpAllGather.apply(x, cfg, group)
    return _all_gather(x, cfg, group)


def gather_param(flat_view: torch.Tensor, spec: ParamSpec,
                 plan: ShardingPlan, dtype, qag: Optional[CommConfig] = None,
                 group=None, delta: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """A rank's flat shard (flat / fsdp,) -> its logical TP-local array in
    ``dtype``, gathered over the data axis ``group`` when ``fsdp > 1``.

    ``delta`` (zeros of the full flat length) is the gradient tap of the
    explicit ``qgrad_rs`` pass: the gathered weights are detached and
    ``delta`` added, so the gradient w.r.t. ``delta`` is the full-length
    per-rank gradient, before any reduce-scatter.
    """
    if plan.fsdp == 1:
        flat = flat_view.reshape(-1)
    else:
        flat = fsdp_all_gather(flat_view.reshape(-1), qag, group)
    if delta is not None:
        flat = flat.detach() + delta.reshape(-1).to(flat.dtype)
    shape = spec.local_shape(plan)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


def gather_group(views: Dict[str, torch.Tensor], specs: Dict[str, ParamSpec],
                 plan: ShardingPlan, dtype, qag: Optional[CommConfig] = None,
                 group=None, deltas: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
    """:func:`gather_param` of every parameter of a block group, in name
    order (the same order on every rank)."""
    return {name: gather_param(views[name], specs[name], plan, dtype, qag,
                               group, None if deltas is None
                               else deltas[name])
            for name in sorted(specs)}
