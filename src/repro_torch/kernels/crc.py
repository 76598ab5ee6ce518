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
  that starts from zero unchanged); a tile is ``CHUNKS`` chunks of
  ``CHUNK`` = 68 bytes, an odd number of words;
* the rows' (row, tile) pairs, row-major, are cut into ``blocks`` runs
  of equal length (:func:`segments`; the kernel's blocks, one an SM);
  the part of a row in one run is a segment;
* in a segment, chunk ``c`` of every tile is one chain: its register is
  carried over the bytes to its next chunk by ``M^(TILE - CHUNK)`` (four
  byte tables, :func:`advance_tables`) and takes that chunk's bytes
  through the 256-entry table; at the segment's end it is shifted to the
  tile's end by ``M^((CHUNKS - 1 - c) CHUNK)`` (:func:`shift_ops`), and
  the XOR of the chains is the segment's register;
* a row's register is the XOR of its segments', each shifted over the
  ``z`` tiles after it by ``M^(z TILE)``, a product of the powers
  ``M^(2^j TILE)`` (:func:`tile_powers`);
* the register of the bytes before the row (``init``, 0xFFFFFFFF for a
  plain CRC, the header prefix's register for a frame) enters as one
  host constant, ``M^L init ^ 0xFFFFFFFF``.

The kernel feeds its tiles through a ring of ``STAGES`` tiles in shared
memory with bulk copies, which take 16-byte-aligned addresses and sizes:
rows whose address, pitch and length are multiples of 16 take it
(:func:`ring_path`), others a synchronous load of the same tiles.

:func:`crc32c_rows_plain` runs the same chunks, chains and combine with
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
CHUNK = 68                      # bytes a chunk: 17 words
CHUNKS = 1024                   # chunks a tile (256 threads x 4 chains)
TILE = CHUNK * CHUNKS           # bytes a tile
STAGES = 2                      # tiles in the kernel's ring
POWERS = 32                     # M^(2^j TILE), j < POWERS
#: runs the plain version cuts the rows into: the kernel's blocks on an
#: H100 (132 SMs, one block an SM)
BLOCKS = 132
MAX_BLOCKS = 1024               # the kernel's scratch: a word a segment

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


def _np_apply(op: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``op`` (32,) uint32 applied to each register of ``v`` (uint32)."""
    bits = (v[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return np.bitwise_xor.reduce(np.where(bits == 1, op, np.uint32(0)),
                                 axis=-1).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def shift_ops() -> np.ndarray:
    """(CHUNKS, 32) uint32: ``M^((CHUNKS - 1 - c) CHUNK)``, chain ``c``'s
    shift from its chunk's end to the tile's end."""
    step = np.array(zeros_op(CHUNK), np.uint32)
    ops = np.empty((CHUNKS, 32), np.uint32)
    cur = np.array([1 << i for i in range(32)], np.uint32)
    for c in range(CHUNKS - 1, -1, -1):
        ops[c] = cur
        cur = _np_apply(step, cur)
    ops.flags.writeable = False
    return ops


@functools.lru_cache(maxsize=None)
def advance_tables() -> np.ndarray:
    """(4, 256) uint32: ``M^(TILE - CHUNK)`` of each byte value at each of
    the register's four bytes (a chain's carry from chunk to chunk)."""
    op = np.array(zeros_op(TILE - CHUNK), np.uint32)
    b = np.arange(256, dtype=np.uint32)
    out = np.stack([_np_apply(op, b << (8 * j)) for j in range(4)])
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=None)
def tile_powers() -> np.ndarray:
    """(POWERS, 32) uint32: ``M^(2^j TILE)``."""
    out = [np.array(zeros_op(TILE), np.uint32)]
    for _ in range(POWERS - 1):
        out.append(_np_apply(out[-1], out[-1]))
    powers = np.stack(out)
    powers.flags.writeable = False
    return powers


def final_xor(length: int, init: int) -> int:
    """The host constant a row's register is XORed with: ``init`` carried
    over the row's bytes, and the final inversion."""
    return apply_op(zeros_op(length), init) ^ MASK


class Plan(NamedTuple):
    """How a row of ``length`` bytes is cut (see the module docstring)."""
    length: int
    tiles: int              # TILE-byte tiles, the first left-padded
    pad: int                # zero bytes before the row's first byte


@functools.lru_cache(maxsize=1024)
def plan(length: int) -> Plan:
    tiles = -(-length // TILE)
    return Plan(length, tiles, tiles * TILE - length)


def segments(rows: int, tiles: int, blocks: int = BLOCKS
             ) -> List[Tuple[int, int, int, int]]:
    """``(block, row, first, end)`` of each segment: ``B = min(blocks, rows
    x tiles)`` blocks, block ``b`` taking the (row, tile) pairs ``[b W / B,
    (b + 1) W / B)`` of the ``W = rows x tiles``, row-major; a segment is
    its tiles ``first`` to ``end`` (exclusive) of one row."""
    work = rows * tiles
    n = min(blocks, work)
    out = []
    for b in range(n):
        lo, hi = b * work // n, (b + 1) * work // n
        for r in range(lo // tiles, (hi - 1) // tiles + 1):
            out.append((b, r, max(lo, r * tiles) - r * tiles,
                        min(hi, (r + 1) * tiles) - r * tiles))
    return out


def ring_path(addr: int, pitch: int, length: int) -> bool:
    """Whether rows at ``addr``, ``pitch`` bytes apart, of ``length``
    bytes, take the kernel's ring: a bulk copy's addresses and sizes are
    multiples of 16 bytes."""
    return addr % 16 == 0 and pitch % 16 == 0 and length % 16 == 0


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


def _xor_last(v: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis, in a tree."""
    while v.shape[-1] > 1:
        if v.shape[-1] % 2:
            v = torch.nn.functional.pad(v, (0, 1))
        v = v[..., 0::2] ^ v[..., 1::2]
    return v[..., 0]


def crc32c_rows_plain(rows: torch.Tensor, init: int = MASK,
                      blocks: int = BLOCKS) -> torch.Tensor:
    """(R, L) uint8 -> (R,) int64 CRC32C values (0 .. 2^32 - 1) with tensor
    ops, on the device of ``rows``: the bytes follow a register ``init``
    (0xFFFFFFFF: the plain CRC of each row). ``blocks``: the runs the rows
    are cut into (:func:`segments`)."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise TypeError(f"crc32c_rows_plain: expected a 2-D uint8 tensor, "
                        f"got {rows.dtype} {tuple(rows.shape)}")
    r_n, length = rows.shape
    dev = rows.device
    cnst = final_xor(length, init)
    if length == 0 or r_n == 0:
        return torch.full((r_n,), cnst, dtype=torch.int64, device=dev)
    p = plan(length)
    segs = segments(r_n, p.tiles, blocks)
    # every tile, then one of zeros
    virt = torch.zeros((r_n * p.tiles + 1, TILE), dtype=torch.uint8,
                       device=dev)
    virt[:-1].view(r_n, p.tiles * TILE)[:, p.pad:] = rows
    # chains whose chunks all lie in the pad stay zero: rows of one tile
    # take only the others
    c0 = p.pad // CHUNK if p.tiles == 1 else 0
    virt = virt.view(-1, CHUNKS, CHUNK)[:, c0:]
    # a segment's tiles right-aligned, zero tiles before (a chain from zero
    # stays zero over them)
    steps = max(e - f for _, _, f, e in segs)
    idx = torch.full((len(segs), steps), r_n * p.tiles, dtype=torch.int64)
    for i, (_, r, f, e) in enumerate(segs):
        idx[i, steps - (e - f):] = torch.arange(r * p.tiles + f,
                                                r * p.tiles + e)
    idx = idx.to(dev)
    tbl = torch.tensor(TABLE, dtype=torch.int64, device=dev)
    adv = torch.from_numpy(advance_tables().astype(np.int64)).to(dev)
    reg = torch.zeros((len(segs), CHUNKS - c0), dtype=torch.int64,
                      device=dev)
    for s in range(steps):
        reg = (adv[0][reg & 0xFF] ^ adv[1][(reg >> 8) & 0xFF]
               ^ adv[2][(reg >> 16) & 0xFF] ^ adv[3][reg >> 24])
        data = virt[idx[:, s]]
        for j in range(CHUNK):
            reg = (reg >> 8) ^ tbl[(reg ^ data[..., j].to(torch.int64))
                                   & 0xFF]
        del data
    del virt
    shift = torch.from_numpy(shift_ops()[c0:].astype(np.int64)).to(dev)
    seg = _xor_last(_apply_t(shift, reg))                   # (segments,)
    zeros = torch.tensor([p.tiles - e for _, _, _, e in segs],
                         dtype=torch.int64, device=dev)
    powers = torch.from_numpy(tile_powers().astype(np.int64)).to(dev)
    for j in range(max(int(p.tiles).bit_length(), 1)):
        seg = torch.where(((zeros >> j) & 1) == 1,
                          _apply_t(powers[j], seg), seg)
    # XOR of each row's segments: the parity of each bit's count
    bit = torch.arange(32, dtype=torch.int64, device=dev)
    count = torch.zeros((r_n, 32), dtype=torch.int64, device=dev)
    count.index_add_(0, torch.tensor([r for _, r, _, _ in segs],
                                     device=dev), (seg[:, None] >> bit) & 1)
    return ((count & 1) << bit).sum(dim=1) ^ cnst


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


@functools.lru_cache(maxsize=None)
def _consts() -> np.ndarray:
    """The kernel's constants: word i of chain c's shift at i CHUNKS + c,
    the advance's tables, the tile powers."""
    out = np.ascontiguousarray(np.concatenate([
        shift_ops().T.reshape(-1), advance_tables().reshape(-1),
        tile_powers().reshape(-1)]), dtype=np.uint32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=1024)
def _params(rows: int, pitch: int, length: int, init: int, ring: bool):
    """Host argument array of one launch (copied into the kernels'
    parameters at launch; cached per shape, never written)."""
    p = plan(length)
    return np.array([rows, pitch, length, p.tiles, p.pad,
                     final_xor(length, init), int(ring),
                     rows + MAX_BLOCKS], dtype=np.int64)


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
    pitch = rows.stride(0) if r_n > 1 else length
    a = _params(r_n, pitch, length, init,
                ring_path(rows.data_ptr(), pitch, length))
    scratch = torch.empty((r_n + MAX_BLOCKS,), dtype=torch.int32,
                          device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        rc = _lib().fc_crc32c(rows.data_ptr(), scratch.data_ptr(),
                              out.data_ptr(), a.ctypes.data,
                              _consts().ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"fc_crc32c launch failed: CUDA error {rc}")
    LAUNCHES["crc32c"] += 1
    return out


def bound_bytes(rows: int, length: int) -> int:
    """Bytes the kernel must move: each row's bytes read once, 8 bytes a
    row written."""
    return rows * (length + 8)
