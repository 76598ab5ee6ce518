"""CRC32C of byte rows: the CUDA kernel ``fc_crc32c`` beside its plain
version.

The frame of :mod:`repro_torch.core.frame` carries a CRC32C (Castagnoli)
over its 12 header bytes and its payload, one a row. The JAX package
computes it byte by byte in ``lax.scan`` (``src/repro/core/frame.py:122
crc32c_rows``), not in a Pallas kernel, so this kernel replaces no TPU
kernel: it was added because the port's training path runs the CRC over
the pod site's wire rows (some 270 MB a row at llama3-8b's embedding
leaf, four times a leaf and step), where a byte loop of tensor ops cannot
keep up and no PyTorch call computes CRC32C.

It is memory-bound on an H100: the least time is the bytes read over
3.35 TB/s (:func:`bound_bytes`). The CRC register is linear over GF(2),
so a row splits into pieces whose registers, each computed from zero,
combine by the operator ``M^k`` of ``k`` zero bytes (zlib's
``crc32_combine``; :func:`zeros_op`, 32 words each, built here on the
host):

* a row of ``L`` bytes is taken as ``TILE``-byte tiles, left-padded with
  zero bytes to a whole number of tiles (leading zeros leave a register
  that starts from zero unchanged);
* each of a tile's ``THREADS`` chunks of ``CHUNK`` bytes gets its register
  from zero (the 256-entry table), shifted to the tile's end by
  ``M^((THREADS - 1 - c) CHUNK)``; the tile's register is the XOR of them;
* the row's tiles, left-padded with zero tiles to ``row_threads x
  per_thread``, are combined per thread by Horner's rule (``M^TILE``), then
  in a tree over the threads (``M^(TILE per_thread 2^k)`` at level k);
* the register of the bytes before the row (``init``, 0xFFFFFFFF for a
  plain CRC, the header prefix's register for a frame) enters as one
  host constant, ``M^L init ^ 0xFFFFFFFF``.

:func:`crc32c_rows_plain` runs the same chunks and the same combine with
tensor ops on any device; :func:`crc32c_rows` launches the kernel on a
CUDA tensor and raises for any other. :mod:`repro_torch.kernels.ops`
decides which one a tensor goes through. ``LAUNCHES`` counts the
kernel's launches (one a call: the tile pass and the row pass it
enqueues).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

SOURCE = "crc.cu"
POLY = 0x82F63B78               # CRC32C, reflected
MASK = 0xFFFFFFFF
CHUNK = 64                      # bytes a thread
THREADS = 128                   # chunks (threads) a tile
TILE = CHUNK * THREADS          # bytes a tile
MAX_ROW_THREADS = 1024          # threads of a row's combine

#: launches of the kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"crc32c": 0}


def reset_launches() -> None:
    LAUNCHES["crc32c"] = 0


def _make_table() -> Tuple[int, ...]:
    tbl = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        tbl.append(c)
    return tuple(tbl)


TABLE = _make_table()


def update(reg: int, data) -> int:
    """The raw register after ``data`` (bytes, or ints 0..255), byte by
    byte from ``reg``: no initial or final inversion."""
    for b in data:
        reg = (reg >> 8) ^ TABLE[(reg ^ b) & 0xFF]
    return reg


# ---------------------------------------------------------------------------
# GF(2) operators: 32 words, column i the image of bit i
# ---------------------------------------------------------------------------

def apply_op(op, v: int) -> int:
    """The operator ``op`` applied to the register ``v``."""
    r, i = 0, 0
    while v:
        if v & 1:
            r ^= op[i]
        v >>= 1
        i += 1
    return r


def _compose(a, b) -> Tuple[int, ...]:
    """``a`` after ``b``."""
    return tuple(apply_op(a, col) for col in b)


@functools.lru_cache(maxsize=None)
def _zeros_pow2(k: int) -> Tuple[int, ...]:
    """``M^(2^k)``: the register's map over 2^k zero bytes."""
    if k == 0:
        return tuple(update(1 << i, (0,)) for i in range(32))
    half = _zeros_pow2(k - 1)
    return _compose(half, half)


@functools.lru_cache(maxsize=4096)
def zeros_op(nbytes: int) -> Tuple[int, ...]:
    """``M^nbytes``: the register's map over ``nbytes`` zero bytes."""
    op = tuple(1 << i for i in range(32))
    k = 0
    while nbytes:
        if nbytes & 1:
            op = _compose(_zeros_pow2(k), op)
        nbytes >>= 1
        k += 1
    return op


class Plan(NamedTuple):
    """How a row of ``length`` bytes is cut (see the module docstring)."""
    length: int
    tiles: int              # TILE-byte tiles, the first left-padded
    pad: int                # zero bytes before the row's first byte
    row_threads: int        # threads of the row's combine (a power of 2)
    per_thread: int         # tiles a thread of the combine takes
    row_ops: Tuple[Tuple[int, ...], ...]   # M^TILE, then the tree's levels


@functools.lru_cache(maxsize=1024)
def plan(length: int) -> Plan:
    tiles = -(-length // TILE)
    row_threads = 1
    while row_threads < min(tiles, MAX_ROW_THREADS):
        row_threads *= 2
    per_thread = -(-tiles // row_threads)
    ops = [zeros_op(TILE)]
    k = 1
    while k < row_threads:
        ops.append(zeros_op(TILE * per_thread * k))
        k *= 2
    return Plan(length, tiles, tiles * TILE - length, row_threads,
                per_thread, tuple(ops))


@functools.lru_cache(maxsize=None)
def shift_ops() -> Tuple[Tuple[int, ...], ...]:
    """``M^((THREADS - 1 - c) CHUNK)`` for each chunk ``c`` of a tile."""
    return tuple(zeros_op((THREADS - 1 - c) * CHUNK) for c in range(THREADS))


def final_xor(length: int, init: int) -> int:
    """The host constant a row's register is XORed with: ``init`` carried
    over the row's bytes, and the final inversion."""
    return apply_op(zeros_op(length), init) ^ MASK


# ---------------------------------------------------------------------------
# the plain version (the CPU path, and what the kernel is held against)
# ---------------------------------------------------------------------------

def _apply_t(op: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Operators applied to int64 registers: ``op`` (..., 32) broadcast
    against ``v`` (...)."""
    out = torch.zeros_like(v)
    for i in range(32):
        out ^= ((v >> i) & 1) * op[..., i]
    return out


def _xor_halves(v: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (a power of 2), in a tree."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] ^ v[..., 1::2]
    return v[..., 0]


def crc32c_rows_plain(rows: torch.Tensor, init: int = MASK) -> torch.Tensor:
    """(R, L) uint8 -> (R,) int64 CRC32C values (0 .. 2^32 - 1) with tensor
    ops, on the device of ``rows``: the bytes follow a register ``init``
    (0xFFFFFFFF: the plain CRC of each row)."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise TypeError(f"crc32c_rows_plain: expected a 2-D uint8 tensor, "
                        f"got {rows.dtype} {tuple(rows.shape)}")
    r_n, length = rows.shape
    dev = rows.device
    cnst = final_xor(length, init)
    if length == 0:
        return torch.full((r_n,), cnst, dtype=torch.int64, device=dev)
    p = plan(length)
    virt = torch.zeros((r_n, p.tiles * TILE), dtype=torch.uint8, device=dev)
    virt[:, p.pad:] = rows
    virt = virt.view(r_n, p.tiles, THREADS, CHUNK)
    tbl = torch.tensor(TABLE, dtype=torch.int64, device=dev)
    reg = torch.zeros((r_n, p.tiles, THREADS), dtype=torch.int64, device=dev)
    for j in range(CHUNK):
        reg = (reg >> 8) ^ tbl[(reg ^ virt[..., j].to(torch.int64)) & 0xFF]
    del virt
    shift = torch.tensor(shift_ops(), dtype=torch.int64, device=dev)
    tile_regs = _xor_halves(_apply_t(shift, reg))           # (R, tiles)
    del reg
    lead = p.row_threads * p.per_thread - p.tiles
    tile_regs = torch.nn.functional.pad(tile_regs, (lead, 0))
    tile_regs = tile_regs.view(r_n, p.row_threads, p.per_thread)
    ops = torch.tensor(p.row_ops, dtype=torch.int64, device=dev)
    acc = torch.zeros((r_n, p.row_threads), dtype=torch.int64, device=dev)
    for i in range(p.per_thread):
        acc = _apply_t(ops[0], acc) ^ tile_regs[..., i]
    for level in range(1, len(p.row_ops)):
        acc = _apply_t(ops[level], acc[..., 0::2]) ^ acc[..., 1::2]
    return acc[..., 0] ^ cnst


# ---------------------------------------------------------------------------
# the CUDA launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    lib.fc_crc32c.argtypes = [ctypes.c_void_p] * 6
    lib.fc_crc32c.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1024)
def _params(rows: int, pitch: int, length: int, init: int):
    """Host argument arrays of one launch (copied into the kernels'
    parameters at launch; cached per shape, never written)."""
    p = plan(length)
    a = np.array([rows, pitch, length, p.tiles, p.pad, p.row_threads,
                  p.per_thread, final_xor(length, init)], dtype=np.int64)
    words: List[int] = [w for op in shift_ops() for w in op]
    row = [w for op in p.row_ops for w in op]
    words += row + [0] * (32 * 11 - len(row))
    return a, np.array(words, dtype=np.uint32)


def crc32c_rows(rows: torch.Tensor, init: int = MASK) -> torch.Tensor:
    """(R, L) uint8 rows on the card (any row stride, bytes contiguous) ->
    (R,) int64 CRC32C values; the bytes follow a register ``init``."""
    if rows.device.type != "cuda":
        raise ValueError(f"crc32c_rows: expected a CUDA tensor, got "
                         f"{rows.device}")
    if rows.dtype != torch.uint8 or rows.dim() != 2 or (
            rows.shape[1] > 1 and rows.stride(1) != 1):
        raise ValueError(f"crc32c_rows: expected 2-D uint8 rows of "
                         f"contiguous bytes, got {rows.dtype} "
                         f"{tuple(rows.shape)} strides {rows.stride()}")
    r_n, length = rows.shape
    out = torch.empty((r_n,), dtype=torch.int64, device=rows.device)
    if r_n == 0 or length == 0:
        return out.fill_(final_xor(length, init))
    a, ops = _params(r_n, rows.stride(0) if r_n > 1 else length, length,
                     init)
    scratch = torch.empty((r_n * plan(length).tiles,), dtype=torch.int32,
                          device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        rc = _lib().fc_crc32c(rows.data_ptr(), scratch.data_ptr(),
                              out.data_ptr(), a.ctypes.data, ops.ctypes.data,
                              stream)
    if rc != 0:
        raise RuntimeError(f"fc_crc32c launch failed: CUDA error {rc}")
    LAUNCHES["crc32c"] += 1
    return out


def bound_bytes(rows: int, length: int) -> int:
    """Bytes the kernel must move: each row's bytes read once, 8 bytes a
    row written."""
    return rows * (length + 8)
