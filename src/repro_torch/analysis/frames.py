"""Frame conformance checker: the FRAME-* rules.

The port's copy of the JAX package's ``analysis/frames.py``, over the
port's :mod:`repro_torch.core.frame` (the same bytes). The sweep encodes
CPU tensors, so it runs the plain codec and the host CRC on any machine.

The self-describing frame (:mod:`repro_torch.core.frame`) is only worth its
16 bytes if the receiver can actually trust it, so the analyzer proves,
statically and on concrete buffers:

* **FRAME-HEADER**: the header a framed encode emits agrees with the
  config's ``wire_layout`` (bits/group/flags/theta/payload length), the
  header size constant matches the prefix+CRC split, and a clean frame
  round-trips self-describing;
* **FRAME-VERSION**: the version this binary writes is in its own
  supported-version table (a binary that cannot read what it writes is
  skewed against itself), and version-skewed buffers are rejected;
* **FRAME-COVERAGE**: the CRC32C passes the Castagnoli check vector and
  covers header+payload — proven the blunt way, by flipping every
  single byte of a framed row and demanding each flip is detected (a
  checksum computed over only part of the frame lets the uncovered
  region corrupt silently).

:func:`check_frame_row` is the fixture surface: it maps the typed
:class:`repro_torch.core.frame.FrameError` taxonomy onto rule ids so mutation
fixtures (and tooling fed a concrete malformed buffer) report through
the registry.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.report import Diagnostic, err
from repro_torch.core import frame
from repro_torch.core.comm_config import (FRAME_HEADER_BYTES, CommConfig,
                                    default_comm_config)


def check_frame_row(buf, cfg: Optional[CommConfig] = None,
                    subject: str = "") -> List[Diagnostic]:
    """Validate one concrete framed buffer; typed errors -> rule ids."""
    try:
        frame.frame_unwrap(np.asarray(buf), cfg)
    except frame.FrameVersionError as e:
        return [err("FRAME-VERSION", str(e), subject)]
    except frame.FrameChecksumError as e:
        return [err("FRAME-COVERAGE", str(e), subject)]
    except frame.FrameError as e:
        return [err("FRAME-HEADER", str(e), subject)]
    return []


def _framed_sweep() -> List[CommConfig]:
    return [
        default_comm_config(2, scale_int=True).with_framed(),
        default_comm_config(4).with_framed(),
        default_comm_config(8).with_framed(),
        default_comm_config(4).with_rotation().with_framed(),
    ]


def _check_one_config(cc: CommConfig, rng: np.random.RandomState
                      ) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    n = 2 * cc.group
    sub = (f"bits={cc.bits} group={cc.group} spike={cc.spike} "
           f"rot={cc.rotation} scale_int={cc.scale_int}")
    x = np.asarray(rng.standard_normal((2, n)), np.float32)
    wire = np.asarray(frame.frame_encode(torch.from_numpy(x), cc))
    if wire.shape[-1] != cc.wire_bytes(n):
        out.append(err("FRAME-HEADER",
                       f"framed encode produced {wire.shape[-1]} bytes, "
                       f"wire_bytes({n}) promises {cc.wire_bytes(n)}",
                       sub))
        return out
    hdr = frame.parse_header(wire[0])
    declared = (hdr.bits, hdr.group, hdr.spike, hdr.rotation,
                hdr.scale_int, hdr.theta)
    want = (cc.bits, cc.group, cc.spike, cc.rotation, cc.scale_int,
            cc.theta)
    if declared != want:
        out.append(err("FRAME-HEADER",
                       f"header declares {declared} (bits, group, spike, "
                       f"rotation, scale_int, theta), config is {want}",
                       sub))
    if hdr.payload_len != cc.wire_layout(n).total:
        out.append(err("FRAME-HEADER",
                       f"header declares a {hdr.payload_len}-byte "
                       f"payload, wire_layout({n}).total is "
                       f"{cc.wire_layout(n).total}", sub))
    out += check_frame_row(wire, cc, sub)      # clean frame must pass
    try:
        dec = frame.frame_decode(wire).numpy()   # self-describing
    except frame.FrameError as e:
        out.append(err("FRAME-HEADER",
                       f"self-describing decode of a clean frame raised "
                       f"{type(e).__name__}: {e}", sub))
        return out
    if dec.shape != x.shape or not np.all(np.isfinite(dec)):
        out.append(err("FRAME-HEADER",
                       "self-describing decode lost shape or produced "
                       "non-finite values", sub))
    return out


def _check_coverage(cc: CommConfig, rng: np.random.RandomState
                    ) -> Tuple[List[Diagnostic], int]:
    """Flip every byte of one framed row: each flip must be detected."""
    out: List[Diagnostic] = []
    n = 2 * cc.group
    sub = f"coverage bits={cc.bits} group={cc.group}"
    x = np.asarray(rng.standard_normal((1, n)), np.float32)
    wire = np.asarray(frame.frame_encode(torch.from_numpy(x), cc)).copy()
    for i in range(wire.shape[-1]):
        mut = wire.copy()
        mut[0, i] ^= 0x01
        if not check_frame_row(mut, cc):
            out.append(err("FRAME-COVERAGE",
                           f"single-bit flip at byte {i} of a "
                           f"{wire.shape[-1]}-byte frame went "
                           f"undetected", sub))
    return out, wire.shape[-1]


def check_frames() -> Tuple[List[Diagnostic], int]:
    """The static frame sweep for ``commcheck.core_report``."""
    out: List[Diagnostic] = []
    checked = 0
    if frame.crc32c(b"123456789") != 0xE3069283:
        out.append(err("FRAME-COVERAGE",
                       "CRC32C fails the Castagnoli check vector "
                       "0xE3069283", "crc32c"))
    checked += 1
    if FRAME_HEADER_BYTES != frame._PREFIX_BYTES + 4:
        out.append(err("FRAME-HEADER",
                       f"FRAME_HEADER_BYTES={FRAME_HEADER_BYTES} is out "
                       f"of sync with the {frame._PREFIX_BYTES}-byte "
                       f"prefix + 4-byte CRC", "header-size"))
    checked += 1
    if frame.FRAME_VERSION not in frame.SUPPORTED_VERSIONS:
        out.append(err("FRAME-VERSION",
                       f"this binary writes version "
                       f"{frame.FRAME_VERSION} but only decodes "
                       f"{frame.SUPPORTED_VERSIONS}", "version-table"))
    checked += 1
    rng = np.random.RandomState(0)
    for cc in _framed_sweep():
        out += _check_one_config(cc, rng)
        checked += 1
    cov, nbytes = _check_coverage(default_comm_config(4).with_framed(),
                                  rng)
    out += cov
    checked += nbytes
    return out, checked
