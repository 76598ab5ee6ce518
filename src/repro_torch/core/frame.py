"""Self-describing wire frames: header + CRC32C around the wire buffer.

The raw wire (:mod:`repro_torch.core.tilecodec`) is position-addressed:
both ends must share one ``CommConfig``, and a truncated or bit-flipped
buffer decodes into garbage. A frame makes the buffer self-describing,
byte for byte as the JAX package's ``core/frame.py``::

    byte  0-1   magic 0xFC 0x02
    byte  2     frame version (1)
    byte  3     bits
    byte  4-5   group, u16 little-endian
    byte  6     flags: bit0 spike, bit1 rotation, bit2 scale_int
    byte  7     theta
    byte  8-11  payload length in bytes, u32 little-endian
    byte 12-15  CRC32C (Castagnoli), u32 little-endian, computed over
                header bytes 0-11 + the entire payload

followed by the unmodified ``wire_layout`` payload. The header is a fixed
16 bytes (:data:`repro_torch.core.comm_config.FRAME_HEADER_BYTES`).

Two consumption modes:

* **host** (numpy arrays or CPU tensors: the pod-bridge ingress, tooling,
  tests): :func:`frame_unwrap` / :func:`frame_decode` validate everything
  and raise a *typed* :class:`FrameError` subclass on truncation, magic
  or layout mismatch, version skew, length disagreement, or checksum
  failure.
* **device** (the framed collectives, any device, no host sync):
  :func:`frame_check_rows` returns a per-row ``ok`` mask; the codec
  NaN-poisons the rows that fail, and passes the others through bit for
  bit. Where the buffer's width is wrong for the config it raises at
  once (:class:`FrameTruncatedError`, :class:`FrameLengthError`).

The per-row CRC (:func:`crc32c_rows`) runs the CUDA kernel
``fc_crc32c`` on a CUDA tensor and its plain version elsewhere
(:mod:`repro_torch.kernels.crc`, :mod:`repro_torch.kernels.ops`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.comm_config import (BIT_UNITS, FRAME_HEADER_BYTES,
                                          CommConfig, _wire_layout)
from repro_torch.kernels import crc as crc_kernel

FRAME_MAGIC = (0xFC, 0x02)
FRAME_VERSION = 1
#: versions this binary can decode (grows on compatible header changes).
SUPPORTED_VERSIONS = (1,)

_PREFIX_BYTES = 12          # header bytes covered by (and before) the CRC


class FrameError(ValueError):
    """Base class: a frame failed validation (never a garbage decode)."""


class FrameTruncatedError(FrameError):
    """Buffer shorter than the header, or than the declared payload."""


class FrameVersionError(FrameError):
    """Frame version not in :data:`SUPPORTED_VERSIONS` (rolling-deploy
    skew: reject loudly, let the sender renegotiate)."""


class FrameHeaderError(FrameError):
    """Bad magic, malformed layout fields, or header disagreeing with
    the receiver's expected ``CommConfig``."""


class FrameLengthError(FrameError):
    """Declared payload length disagrees with the buffer or with any
    valid ``wire_layout`` of the declared knobs."""


class FrameChecksumError(FrameError):
    """Stored CRC32C does not match header+payload (corruption)."""


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli): reflected polynomial 0x82F63B78
# ---------------------------------------------------------------------------

def crc32c(data) -> int:
    """Host CRC32C of a byte string / uint8 array (table-driven).

    Standard check value: ``crc32c(b"123456789") == 0xE3069283``.
    """
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = bytes(data)
    else:
        buf = np.asarray(data, np.uint8).reshape(-1).tobytes()
    return crc_kernel.update(crc_kernel.MASK, buf) ^ crc_kernel.MASK


def crc32c_rows(buf: torch.Tensor) -> torch.Tensor:
    """CRC32C of each leading row: (..., B) uint8 -> (...) int64 values
    0 .. 2^32 - 1, equal to :func:`crc32c` of each row. The kernel on a
    CUDA tensor, the plain version elsewhere."""
    from repro_torch.kernels import ops
    rows = buf.reshape(-1, buf.shape[-1])
    return ops.crc32c_rows(rows).reshape(buf.shape[:-1])


# ---------------------------------------------------------------------------
# header build / parse
# ---------------------------------------------------------------------------

class FrameHeader(NamedTuple):
    """Parsed frame header (CRC field excluded; validated separately)."""
    version: int
    bits: int
    group: int
    spike: bool
    rotation: bool
    scale_int: bool
    theta: int
    payload_len: int


def _flags(cfg: CommConfig) -> int:
    return (int(cfg.spike) | (int(cfg.rotation) << 1)
            | (int(cfg.scale_int) << 2))


def header_prefix(cfg: CommConfig, payload_len: int) -> np.ndarray:
    """The static 12 CRC-covered header bytes for one (cfg, length)."""
    assert 0 <= payload_len < 1 << 32, payload_len
    assert 0 <= cfg.theta < 256, cfg.theta
    assert cfg.group < 1 << 16, cfg.group
    h = np.zeros(_PREFIX_BYTES, np.uint8)
    h[0], h[1] = FRAME_MAGIC
    h[2] = FRAME_VERSION
    h[3] = cfg.bits
    h[4] = cfg.group & 0xFF
    h[5] = (cfg.group >> 8) & 0xFF
    h[6] = _flags(cfg)
    h[7] = cfg.theta
    h[8:12] = np.asarray([payload_len], "<u4").view(np.uint8)
    return h


def parse_header(row) -> FrameHeader:
    """First 16 bytes of one frame row -> :class:`FrameHeader`.

    Only raises on structural problems (magic/version); field agreement
    and CRC are the caller's checks so each failure class gets its own
    typed error.
    """
    row = np.asarray(row, np.uint8).reshape(-1)
    if row.shape[0] < FRAME_HEADER_BYTES:
        raise FrameTruncatedError(
            f"buffer holds {row.shape[0]} bytes, shorter than the "
            f"{FRAME_HEADER_BYTES}-byte frame header")
    if (int(row[0]), int(row[1])) != FRAME_MAGIC:
        raise FrameHeaderError(
            f"bad frame magic {int(row[0]):#04x} {int(row[1]):#04x} "
            f"(want {FRAME_MAGIC[0]:#04x} {FRAME_MAGIC[1]:#04x})")
    version = int(row[2])
    if version not in SUPPORTED_VERSIONS:
        raise FrameVersionError(
            f"frame version {version} not supported "
            f"(this binary decodes {SUPPORTED_VERSIONS})")
    flags = int(row[6])
    return FrameHeader(
        version=version, bits=int(row[3]),
        group=int(row[4]) | (int(row[5]) << 8),
        spike=bool(flags & 1), rotation=bool(flags & 2),
        scale_int=bool(flags & 4), theta=int(row[7]),
        payload_len=int(row[8:12].view("<u4")[0]))


def config_from_header(hdr: FrameHeader,
                       like: Optional[CommConfig] = None) -> CommConfig:
    """Reconstruct the codec knobs a frame declares (self-describing
    decode). Transport knobs (scheme, backend) come from ``like`` or the
    defaults: they are not wire properties."""
    if hdr.bits not in BIT_UNITS:
        raise FrameHeaderError(f"frame declares unsupported "
                               f"bits={hdr.bits}")
    base = like if like is not None else CommConfig()
    try:
        return dataclasses.replace(
            base, enabled=True, bits=hdr.bits, group=hdr.group,
            spike=hdr.spike, rotation=hdr.rotation,
            scale_int=hdr.scale_int, theta=hdr.theta, framed=True)
    except AssertionError as e:
        raise FrameHeaderError(f"frame declares an invalid layout: {e}")


def _payload_n(hdr: FrameHeader) -> int:
    """Recover the element count from the declared payload length.

    Bytes-per-group is linear in the group count for every shipped
    layout, so divide by the one-group cost and verify exactly."""
    if hdr.group < 4 or hdr.payload_len <= 0:
        raise FrameLengthError(
            f"cannot size a payload of {hdr.payload_len} bytes for "
            f"group={hdr.group}")
    per_group = _wire_layout(hdr.group, hdr.bits, hdr.group, hdr.spike,
                             hdr.scale_int).total
    n = hdr.payload_len // per_group * hdr.group
    if n <= 0 or _wire_layout(n, hdr.bits, hdr.group, hdr.spike,
                              hdr.scale_int).total != hdr.payload_len:
        raise FrameLengthError(
            f"declared payload length {hdr.payload_len} matches no "
            f"whole-group wire_layout of bits={hdr.bits} "
            f"group={hdr.group} spike={hdr.spike} "
            f"scale_int={hdr.scale_int}")
    return n


# ---------------------------------------------------------------------------
# wrap / check (any device, no host sync)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _prefix_register(cfg: CommConfig, payload_len: int) -> int:
    """The CRC register after the 12 prefix bytes (from 0xFFFFFFFF)."""
    return crc_kernel.update(crc_kernel.MASK,
                             header_prefix(cfg, payload_len).tobytes())


@functools.lru_cache(maxsize=256)
def _device_prefix(cfg: CommConfig, payload_len: int,
                   device: torch.device) -> torch.Tensor:
    """The 12 prefix bytes on ``device`` (copied there once)."""
    return torch.from_numpy(header_prefix(cfg, payload_len)).to(device)


def _payload_crc(rows: torch.Tensor, cfg: CommConfig) -> torch.Tensor:
    """(R, L) payload rows -> (R, 4) uint8: the little-endian CRC32C of
    each row's header prefix for ``cfg`` and its payload."""
    from repro_torch.kernels import ops
    crc = ops.crc32c_rows(rows, _prefix_register(cfg, rows.shape[1]),
                          ops.use_kernel(cfg, rows))
    return crc.view(torch.uint8).view(-1, 8)[:, :4]


def frame_wrap(payload: torch.Tensor, cfg: CommConfig) -> torch.Tensor:
    """(..., L) uint8 raw wire rows -> (..., 16 + L) framed rows, on the
    payload's device: the 12 static header bytes, the CRC per row, the
    payload."""
    lead, plen = payload.shape[:-1], payload.shape[-1]
    rows = payload.reshape(-1, plen)
    out = torch.empty((rows.shape[0], FRAME_HEADER_BYTES + plen),
                      dtype=torch.uint8, device=rows.device)
    out[:, _PREFIX_BYTES:FRAME_HEADER_BYTES] = _payload_crc(rows, cfg)
    out[:, :_PREFIX_BYTES] = _device_prefix(cfg, plen, rows.device)
    out[:, FRAME_HEADER_BYTES:] = rows
    return out.reshape(*lead, FRAME_HEADER_BYTES + plen)


def frame_check_rows(buf: torch.Tensor, cfg: CommConfig, n: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device validation: (..., 16+L) -> (payload (..., L), ok (...)).

    Static problems (truncation / wrong buffer width for this config)
    raise at once; data-dependent ones (corrupt header bytes, CRC
    mismatch) come back as ``ok=False`` per row for the caller to poison.
    ``payload`` is a view of ``buf``. A row whose header differs from the
    config's fails on its header whatever its CRC, so the CRC is taken
    over the config's header prefix and the row's payload.
    """
    want = _wire_layout(n, cfg.bits, cfg.group, cfg.spike,
                        cfg.scale_int).total
    got = buf.shape[-1]
    if got < FRAME_HEADER_BYTES or got - FRAME_HEADER_BYTES < want:
        raise FrameTruncatedError(
            f"framed buffer holds {got} bytes; need "
            f"{FRAME_HEADER_BYTES}+{want}")
    if got - FRAME_HEADER_BYTES != want:
        raise FrameLengthError(
            f"framed buffer payload is {got - FRAME_HEADER_BYTES} "
            f"bytes; this config's wire_layout({n}) is {want}")
    lead = buf.shape[:-1]
    rows = buf.reshape(-1, got)
    payload = rows[:, FRAME_HEADER_BYTES:]
    ok_head = (rows[:, :_PREFIX_BYTES]
               == _device_prefix(cfg, want, rows.device)).all(dim=1)
    ok_crc = (rows[:, _PREFIX_BYTES:FRAME_HEADER_BYTES]
              == _payload_crc(payload, cfg)).all(dim=1)
    return payload.reshape(*lead, want), (ok_head & ok_crc).reshape(lead)


# ---------------------------------------------------------------------------
# host ingress: typed errors
# ---------------------------------------------------------------------------

def _host_array(buf) -> np.ndarray:
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu":
            raise ValueError(f"the host ingress takes numpy arrays or CPU "
                             f"tensors, got a tensor on {buf.device} (on "
                             f"the device, codec.decode checks the frame)")
        if buf.dtype != torch.uint8:
            raise FrameHeaderError(f"framed wire must be uint8, "
                                   f"got {buf.dtype}")
        return buf.numpy()
    return np.asarray(buf)


def frame_unwrap(buf, cfg: Optional[CommConfig] = None,
                 ) -> Tuple[torch.Tensor, FrameHeader]:
    """Host validation: (..., 16+L) rows (numpy or a CPU tensor) ->
    (payload, a CPU uint8 tensor (..., L), header).

    Raises the typed :class:`FrameError` subclass for each malformed
    class: truncation, bad magic, version skew, length mismatch,
    header/config disagreement, checksum failure; it never returns a
    payload that failed any check. ``cfg`` (optional) additionally pins
    the expected layout knobs."""
    arr = _host_array(buf)
    if arr.dtype != np.uint8:
        raise FrameHeaderError(f"framed wire must be uint8, "
                               f"got {arr.dtype}")
    rows = arr.reshape(-1, arr.shape[-1]) if arr.ndim else \
        arr.reshape(1, -1)
    hdr = parse_header(rows[0])
    for r in range(1, rows.shape[0]):
        if not np.array_equal(rows[r, :_PREFIX_BYTES],
                              rows[0, :_PREFIX_BYTES]):
            raise FrameHeaderError(
                f"row {r} header disagrees with row 0 (one transfer, "
                f"one layout)")
    avail = arr.shape[-1] - FRAME_HEADER_BYTES
    if hdr.payload_len > avail:
        raise FrameTruncatedError(
            f"header declares a {hdr.payload_len}-byte payload but the "
            f"buffer holds only {avail}")
    if hdr.payload_len < avail:
        raise FrameLengthError(
            f"header declares a {hdr.payload_len}-byte payload but the "
            f"buffer holds {avail} (trailing bytes are not covered by "
            f"the checksum)")
    if cfg is not None:
        want = (cfg.bits, cfg.group, cfg.spike, cfg.rotation,
                cfg.scale_int, cfg.theta)
        got = (hdr.bits, hdr.group, hdr.spike, hdr.rotation,
               hdr.scale_int, hdr.theta)
        if want != got:
            raise FrameHeaderError(
                f"frame header {got} (bits, group, spike, rotation, "
                f"scale_int, theta) disagrees with the receiver's "
                f"config {want}")
    _payload_n(hdr)            # length must match a whole-group layout
    payload = torch.from_numpy(np.ascontiguousarray(
        rows[:, FRAME_HEADER_BYTES:]))
    stored = rows[:, _PREFIX_BYTES:FRAME_HEADER_BYTES].copy().view("<u4")
    init = crc_kernel.update(crc_kernel.MASK,
                             rows[0, :_PREFIX_BYTES].tobytes())
    computed = crc_kernel.crc32c_rows_plain(payload, init).numpy()
    for r in range(rows.shape[0]):
        if int(stored[r, 0]) != int(computed[r]):
            raise FrameChecksumError(
                f"row {r}: stored CRC32C {int(stored[r, 0]):#010x} != "
                f"computed {int(computed[r]):#010x} (corrupt header or "
                f"payload)")
    return payload.reshape(*arr.shape[:-1], hdr.payload_len), hdr


# ---------------------------------------------------------------------------
# full codec wrappers
# ---------------------------------------------------------------------------

def frame_encode(x: torch.Tensor, cfg: CommConfig) -> torch.Tensor:
    """(..., n) float -> (..., 16 + wire_layout(n).total) framed uint8."""
    from repro_torch.kernels import ops
    n = x.shape[-1]
    raw = ops.fused_encode_wire(x.reshape(-1, n), cfg.with_framed(False))
    return frame_wrap(raw, cfg).reshape(*x.shape[:-1], -1)


def frame_decode(buf, cfg: Optional[CommConfig] = None,
                 n: Optional[int] = None,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Host decode of a framed buffer, self-describing when ``cfg`` /
    ``n`` are omitted (the pod-bridge ingress: the frame header alone
    reconstructs the layout). Raises typed :class:`FrameError`\\ s."""
    from repro_torch.kernels import ops
    payload, hdr = frame_unwrap(buf, cfg)
    dec_cfg = cfg if cfg is not None else config_from_header(hdr)
    got_n = _payload_n(hdr)
    if n is not None and n != got_n:
        raise FrameLengthError(
            f"frame carries {got_n} numbers, caller expected {n}")
    lead = payload.shape[:-1]
    out = ops.fused_decode_wire(payload.reshape(-1, payload.shape[-1]),
                                dec_cfg.with_framed(False), got_n, out_dtype)
    return out.reshape(*lead, got_n)
