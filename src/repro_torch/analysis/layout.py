"""Wire-layout checker: prove the byte-offset table is a partition.

The port's copy of the JAX package's ``analysis/layout.py``: the wire
layout is the same byte for byte in both packages, so the rules and the
messages are the JAX package's (``LAYOUT-LANES`` included).

``CommConfig.wire_layout(n)`` is the single source of truth for where
every section of the on-link buffer lives; the plain codec, the CUDA
wire kernels and the peer worlds' receive rows all address through it. A bad table silently corrupts wire bytes (overlap), ships
uninitialised bytes (gap) or reads out of bounds — so the analyzer
proves, for every shipped width x group x spike x scale_int combination:

* **LAYOUT-BOUNDS**: every section starts at offset >= 0 and ends at or
  before the declared ``total``;
* **LAYOUT-OVERLAP**: no two sections share a byte;
* **LAYOUT-GAP**: the sections exactly cover ``[0, total)`` — no
  unaddressed byte ever crosses the link;
* **LAYOUT-LANES** (warning): a wire row width that is not a multiple
  of 128 bytes maps poorly onto TPU lane tiling (the JAX package's
  rule, kept so both packages give the same verdicts; the CUDA kernels
  address any width);
* **LAYOUT-SPIKEIDX**: the spike-index section must be able to address
  every in-group position — under ``scale_int`` the indices are 1 byte
  (int8 semantics in the codec), so a group beyond that range would
  silently wrap indices and scatter spikes into the wrong slots on
  decode. ``CommConfig.__post_init__`` rejects such configs at
  construction; the raw-value check here keeps the rule testable and
  guards any future layout that bypasses the dataclass.
"""
from __future__ import annotations

from itertools import product
from typing import List, Sequence, Tuple

from repro_torch.analysis.report import Diagnostic, err, warn
from repro_torch.core.comm_config import (BIT_UNITS, CommConfig, Section,
                                    WireLayout)

_LANE_BYTES = 128


def _sections(layout: WireLayout) -> List[Tuple[str, Section]]:
    out: List[Tuple[str, Section]] = []
    for unit, span in layout.planes:
        out.append((f"plane{unit}", span))
    out.append(("scale", layout.scale))
    out.append(("zero", layout.zero))
    if layout.spike_vals is not None:
        out.append(("spike_vals", layout.spike_vals))
    if layout.spike_idx is not None:
        out.append(("spike_idx", layout.spike_idx))
    return out


def check_layout(layout: WireLayout, subject: str,
                 lanes: bool = False) -> List[Diagnostic]:
    """Bounds / overlap / exact-cover for one concrete layout table.

    ``lanes`` additionally warns on non-128-byte row widths; it is only
    meaningful at real launch payload sizes (the generic sweep uses
    small payloads that are never lane-aligned), so launch-time checks
    opt in and the sweep leaves it off.
    """
    out: List[Diagnostic] = []
    secs = _sections(layout)
    for name, s in secs:
        if s.offset < 0 or s.nbytes < 0 or s.end > layout.total:
            out.append(err("LAYOUT-BOUNDS",
                           f"section {name} [{s.offset}, {s.end}) "
                           f"escapes the declared total {layout.total}",
                           subject))
    ordered = sorted(secs, key=lambda ns: ns[1].offset)
    cursor = 0
    for name, s in ordered:
        if s.offset < cursor:
            prev = [n for n, p in ordered if p.end > s.offset
                    and p.offset < s.offset]
            out.append(err("LAYOUT-OVERLAP",
                           f"section {name} starts at {s.offset} inside "
                           f"{'/'.join(prev) or 'the previous section'} "
                           f"(covered through {cursor})", subject))
        elif s.offset > cursor:
            out.append(err("LAYOUT-GAP",
                           f"bytes [{cursor}, {s.offset}) before section "
                           f"{name} are unaddressed", subject))
        cursor = max(cursor, s.end)
    if not out and cursor != layout.total:
        out.append(err("LAYOUT-GAP",
                       f"sections cover only [0, {cursor}) of the "
                       f"declared total {layout.total}", subject))
    if lanes and not out and layout.total % _LANE_BYTES:
        out.append(warn("LAYOUT-LANES",
                        f"wire row width {layout.total} is not a "
                        f"multiple of {_LANE_BYTES} bytes (TPU lane "
                        f"tiling may pad the transport row)", subject))
    return out


#: max in-group positions the spike-index wire encoding can address:
#: int8 on the wire under scale_int (spike.py's uint8 position lanes
#: carry a ``group`` sentinel and the codec treats stored indices as
#: signed), int16-range via the 2-byte meta dtype otherwise.
_SPIKE_IDX_CAPACITY = {1: 128, 2: 2 ** 15}


def check_spike_capacity(group: int, scale_int: bool,
                         subject: str = "") -> List[Diagnostic]:
    """LAYOUT-SPIKEIDX for raw (group, scale_int) values.

    Raw-valued so mutation fixtures can exercise combinations that
    ``CommConfig.__post_init__`` refuses to construct.
    """
    idx_bytes = 1 if scale_int else 2
    cap = _SPIKE_IDX_CAPACITY[idx_bytes]
    if group > cap:
        return [err("LAYOUT-SPIKEIDX",
                    f"group={group} exceeds the {idx_bytes}-byte "
                    f"spike-index range ({cap} positions): in-group "
                    f"indices would silently wrap on the wire",
                    subject)]
    return []


def check_config_layouts(cfg: CommConfig, payloads: Sequence[int],
                         subject: str = "",
                         lanes: bool = False) -> List[Diagnostic]:
    """One config's layout tables across representative payload sizes."""
    out: List[Diagnostic] = []
    for n in payloads:
        if n % cfg.group:
            continue
        sub = (subject + " " if subject else "") + \
            (f"bits={cfg.bits} group={cfg.group} spike={cfg.spike} "
             f"scale_int={cfg.scale_int} n={n}")
        out += check_layout(cfg.wire_layout(n), sub, lanes=lanes)
        if cfg.spike:
            out += check_spike_capacity(cfg.group, cfg.scale_int, sub)
    return out


def check_layouts() -> Tuple[List[Diagnostic], int]:
    """The full shipped sweep: every width 1-8 x group {32, 128} x spike
    x scale_int, at several group-multiple payload sizes (including the
    smallest, where rounding bugs bite). Returns (diags, checked)."""
    out: List[Diagnostic] = []
    checked = 0
    for bits, group, spike, scale_int in product(
            sorted(BIT_UNITS), (32, 128), (False, True), (False, True)):
        cfg = CommConfig(bits=bits, group=group, spike=spike,
                         scale_int=scale_int)
        payloads = (group, 4 * group, 31 * group)
        out += check_config_layouts(cfg, payloads)
        checked += len(payloads)
    return out, checked
