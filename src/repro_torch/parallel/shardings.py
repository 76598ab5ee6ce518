"""Parameter specs, the port's random init, and loading a JAX store.

The port keeps each parameter in its logical TP-local shape, stacked over
pattern repeats: ``params[group][name]`` is ``(n_stack, *local_shape)``.
Serving runs with ``fsdp == 1`` (weights resident), so there is no FSDP
gather.

The JAX package stores every parameter flat, as ``(n_stack, tp, flat)``
with ``flat`` the rank's values zero-padded to
:func:`repro_torch.parallel.plan.flat_store_len`;
:func:`load_jax_store` unflattens such a store (copied to numpy) into the
port's layout, so both packages can run the same weights.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel.plan import ShardingPlan, flat_store_len

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Global logical shape + how it maps to a TP rank."""
    shape: Tuple[int, ...]
    tp_dim: Optional[int] = None      # dim sharded over the TP ranks
    init: str = "fan_in"              # fan_in | zeros | ones
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
    projections) zeros, ``ones`` specs (norm gains) ones. Each tensor has
    its own generator, seeded by a crc32 of (seed, group, name, stack
    index, rank), so the weights are the same in every process.
    Replicated parameters draw the same values on every rank; sliced ones
    (``tp_dim`` or ``moe_fold``) fold the rank in. A stack is drawn one
    slice at a time, so the float32 temporary is one slice (738 MB for
    a (64, 2048, 1408) expert slice), never the whole stack.
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
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                std = 1.0 / math.sqrt(max(fan_in, 1))
                r = rank if (spec.tp_dim is not None
                            or spec.moe_fold is not None) else 0
                for i in range(n_stack):
                    gen = torch.Generator(device=device)
                    gen.manual_seed(_seed(seed, gname, name, i, r))
                    t[i] = (torch.randn(shape, generator=gen, device=device,
                                        dtype=torch.float32) * std).to(dtype)
            out[gname][name] = t
    return out


def load_jax_store(store_np, cfg, plan: ShardingPlan, device,
                   dtype=torch.float32, rank: int = 0) -> Params:
    """JAX storage dict -> the port's parameters for TP rank ``rank``.

    ``store_np`` is ``{group: {name: ndarray (n_stack, tp, flat_len)}}``,
    as ``repro.parallel.shardings.build_store`` makes it and
    ``np.asarray`` copies it.
    """
    from repro_torch.models.model import param_groups
    out: Params = {}
    for gname, (n_stack, specs) in param_groups(cfg, plan).items():
        out[gname] = {}
        for name, spec in specs.items():
            arr = np.asarray(store_np[gname][name], dtype=np.float32)
            assert arr.shape == (n_stack, plan.tp, spec.flat_len(plan)), (
                gname, name, arr.shape)
            shape = spec.local_shape(plan)
            vals = arr[:, rank, :math.prod(shape)].reshape(n_stack, *shape)
            out[gname][name] = torch.from_numpy(vals.copy()).to(
                device=device, dtype=dtype)
    return out
