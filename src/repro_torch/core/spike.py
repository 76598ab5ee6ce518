"""Spike Reserving (paper Fig. 5): keep each group's min and max exact.

For each quantization group the minimum and maximum (the "spikes") are
stored exactly (value in the meta dtype, in-group index), and the other
values are quantized against the shrunk range. Dequantization scatters
the spikes back.

Election rules, equal to the JAX package's:

* the spike values are the NaN-propagating group min and max (in a
  group holding NaN, both its first NaN, bits and all);
* the min index is the first position equal to the min, the max index
  the first position equal to the max, or the second such position when
  the first collides with the min index (constant groups, duplicated
  extremes);
* in a group holding NaN, the NaNs are the matches: the first NaN takes
  the min slot and the second NaN, if any, the max slot. A group with
  exactly one NaN forfeits the max slot and points both indices at it;
* the shrunk range is the min over the group without the min slot and
  the max without the max slot, NaNs ignored; a group whose remaining
  values are all NaN gets a NaN scale and zero.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.quant import (cast_out, group_min_max, group_reshape,
                                    group_unreshape, scale_zero, to_code,
                                    to_meta, zmax, zmin)


class SpikeQuant(NamedTuple):
    codes: torch.Tensor       # (..., n_groups, group) uint8
    scale: torch.Tensor       # (..., n_groups) meta dtype
    zero: torch.Tensor        # (..., n_groups) meta dtype
    spike_vals: torch.Tensor  # (..., n_groups, 2) meta dtype  [min, max]
    spike_idx: torch.Tensor   # (..., n_groups, 2) int8 in-group positions


def _first(mask: torch.Tensor, pos: torch.Tensor, big: int) -> torch.Tensor:
    """First position where ``mask`` holds, ``big`` where it never does."""
    return torch.amin(torch.where(mask, pos, big), dim=-1)


def spike_quantize(x: torch.Tensor, bits: int, group: int,
                   meta_dtype="bfloat16") -> SpikeQuant:
    assert group <= 128, "in-group spike indices are int8 on the wire"
    xg = group_reshape(x.to(torch.float32), group)
    qmax = float(2 ** bits - 1)
    pos = torch.arange(group, dtype=torch.int64, device=xg.device)
    nan = torch.isnan(xg)

    vmin, vmax = group_min_max(xg)
    has_nan = torch.isnan(vmin)[..., None]
    eq_min = torch.where(has_nan, nan, xg == vmin[..., None])
    eq_max = torch.where(has_nan, nan, xg == vmax[..., None])
    imin = _first(eq_min, pos, group)
    imax1 = _first(eq_max, pos, group)
    imax2 = _first(eq_max & (pos != imax1[..., None]), pos, group)
    imax = torch.where(imax1 == imin, imax2, imax1)
    # single-NaN groups forfeit the max slot: point it at the min slot
    imax = torch.where(imax == group, imin, imax)
    min_mask = pos == imin[..., None]
    max_mask = pos == imax[..., None]

    inf = float("inf")
    mn = zmin(torch.where(min_mask | nan, inf, xg))
    mx = zmax(torch.where(max_mask | nan, -inf, xg))
    all_dropped = (mn == inf) & (mx == -inf)
    mn = torch.where(all_dropped, torch.nan, mn)
    mx = torch.where(all_dropped, torch.nan, mx)

    scale_w, zero_w = scale_zero(mn, mx, qmax, meta_dtype)
    s = scale_w.to(torch.float32)[..., None]
    z = zero_w.to(torch.float32)[..., None]
    # spike slots take the code of the shrunk minimum; decode overwrites
    codes = to_code((xg - z) / s, qmax)
    code_mn = to_code((mn[..., None] - z) / s, qmax)
    codes = torch.where(min_mask | max_mask, code_mn, codes)

    spike_vals = to_meta(torch.stack([vmin, vmax], dim=-1), meta_dtype)
    spike_idx = torch.stack([imin, imax], dim=-1).to(torch.int8)
    return SpikeQuant(codes, scale_w, zero_w, spike_vals, spike_idx)


def spike_dequantize(q: SpikeQuant, out_dtype=torch.float32) -> torch.Tensor:
    codes, scale, zero, spike_vals, spike_idx = q
    s = scale.to(torch.float32)[..., None]
    z = zero.to(torch.float32)[..., None]
    xg = codes.to(torch.float32) * s + z
    group = xg.shape[-1]
    pos = torch.arange(group, dtype=torch.int64, device=xg.device)
    idx = spike_idx.to(torch.int64)
    vals = spike_vals.to(torch.float32)
    for k in range(2):                 # the max slot wins a collision
        hit = pos == idx[..., k][..., None]
        xg = torch.where(hit, vals[..., k][..., None], xg)
    return cast_out(group_unreshape(xg), out_dtype)
