"""The wire-codec kernels: CUDA launch wrappers beside their plain versions.

Three CUDA C++ kernels for Hopper (``csrc/wire.cu``, built by
:mod:`repro_torch.kernels.build`) replace the Pallas TPU kernels:

===================  ===============================================  ============
wrapper              TPU kernel replaced                              bound (H100)
===================  ===============================================  ============
``encode_wire``      ``repro/kernels/wire.py:58 encode_wire``          bytes
                     (and ``emulate.py:86 encode_rows``)
``decode_wire``      ``repro/kernels/wire.py:100 decode_wire``         bytes
                     (and ``emulate.py:130 decode_rows``)
``decode_reduce``    ``repro/kernels/emulate.py:110                    bytes
                     decode_reduce_rows``
===================  ===============================================  ============

All three are memory-bound: the least time is the bytes read plus the
bytes written over 3.35 TB/s (:func:`bound_bytes`); a rotating config
adds ``2 * group`` f32 operations a value (:func:`bound_flops`).
All three give eight consecutive values of a row to a thread, as
``fc_ar`` does: ``fc_encode_wire`` in the paper's block of 512 threads
over 4096 values, the two decodes on one flat grid over the call's
rows x n / 8 items, each thread with one load a bit plane and one
aligned vector store (see the source's header).

Each wrapper launches its kernel on a CUDA tensor, or raises: for a
tensor elsewhere, and for what the kernel does not take (a group other
than 32/64/128, a framed config: the kernels read and write the raw
payload, and the codec wraps and checks the frame); it never falls back.
:mod:`repro_torch.kernels.ops` decides whether a tensor goes through a
kernel or through its plain PyTorch version (``*_plain``, the codec of
:mod:`repro_torch.core.tilecodec`). ``LAUNCHES`` counts the launches of
each kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.core import rotation, scale_codec, tilecodec
from repro_torch.core.quant import EPS, meta_dtype_of

SOURCE = "wire.cu"
KERNEL_GROUPS = (32, 64, 128)
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_THETA = 20

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"encode_wire": 0, "decode_wire": 0,
                            "decode_reduce": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def encode_plain(x: torch.Tensor, cfg) -> torch.Tensor:
    """(R, n) float -> (R, wire_bytes(n)) uint8 with tensor ops."""
    return tilecodec.encode_tile(x, **tilecodec.tile_kwargs(cfg, x.shape[-1]))


def decode_plain(wire: torch.Tensor, cfg, n: int,
                 out_dtype=torch.float32) -> torch.Tensor:
    """(R, wire_bytes(n)) uint8 -> (R, n) out_dtype with tensor ops."""
    return tilecodec.decode_tile(wire, out_dtype=out_dtype,
                                 **tilecodec.tile_kwargs(cfg, n))


def decode_reduce_plain(wire: torch.Tensor, cfg, n: int) -> torch.Tensor:
    """(R, wb) uint8 -> (1, n) f32: decode, then sum rows 0..R-1 in order
    starting from +0.0 (what the kernel does per element)."""
    parts = decode_plain(wire, cfg, n)
    acc = torch.zeros((1, n), dtype=torch.float32, device=wire.device)
    for r in range(parts.shape[0]):
        acc = acc + parts[r:r + 1]
    return acc


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    for name in ("fc_encode_wire", "fc_decode_wire", "fc_decode_reduce"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
    return lib


def _check_cfg(cfg) -> None:
    if cfg.framed:
        raise ValueError("the wire kernels take the raw payload: the codec "
                         "(core/codec.py) wraps and checks the frame, so "
                         "pass cfg.with_framed(False)")
    if cfg.group not in KERNEL_GROUPS:
        raise NotImplementedError(
            f"the CUDA wire kernels take group {KERNEL_GROUPS}, "
            f"got {cfg.group}")


def _check_cuda(t: torch.Tensor, dtype, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 2-D tensor, "
                         f"got shape {tuple(t.shape)}")


@functools.lru_cache(maxsize=256)
def _params(cfg, rows: int, n: int, out_kind: int = 0):
    """Host-side argument arrays of one launch (copied into the kernel's
    parameters at launch; cached per shape and config, never written)."""
    lay = cfg.wire_layout(n)
    units = [u for u, _ in lay.planes] + [0] * (3 - len(lay.planes))
    offs = [s.offset for _, s in lay.planes] + [0] * (3 - len(lay.planes))
    meta = meta_dtype_of(cfg.meta_dtype)
    a = np.array([rows, n, lay.total, cfg.group, cfg.bits, len(lay.planes),
                  *units, *offs, lay.scale.offset, lay.zero.offset,
                  lay.spike_vals.offset if lay.spike_vals else 0,
                  lay.spike_idx.offset if lay.spike_idx else 0,
                  int(cfg.spike), int(cfg.scale_int), cfg.theta,
                  int(meta == torch.float16), out_kind, int(cfg.rotation),
                  rotation.sign_seed(cfg.group)], dtype=np.int64)
    assert 2 <= cfg.theta <= _MAX_THETA, cfg.theta
    thr = np.zeros(_MAX_THETA, np.uint32)
    thr[:cfg.theta - 1] = scale_codec.mant_thresholds(cfg.theta)
    frac = np.zeros(_MAX_THETA, np.float32)
    frac[:cfg.theta] = scale_codec.frac_table(cfg.theta)
    f = np.array([EPS, scale_codec.MAG_MIN, rotation.hadamard_scale(
        cfg.group)], np.float32)
    return a, thr, frac, f


def _launch(name: str, src: torch.Tensor, dst: torch.Tensor, cfg,
            rows: int, n: int, out_kind: int = 0) -> None:
    a, thr, frac, f = _params(cfg, rows, n, out_kind)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        rc = getattr(_lib(), name)(
            src.data_ptr(), dst.data_ptr(), a.ctypes.data, thr.ctypes.data,
            frac.ctypes.data, f.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def encode_wire(x: torch.Tensor, cfg) -> torch.Tensor:
    """(R, n) f32 -> (R, wire_bytes(n)) uint8."""
    _check_cuda(x, torch.float32, "encode_wire")
    _check_cfg(cfg)
    rows, n = x.shape
    out = torch.empty((rows, cfg.wire_bytes(n)), dtype=torch.uint8,
                      device=x.device)
    _launch("fc_encode_wire", x, out, cfg, rows, n)
    LAUNCHES["encode_wire"] += 1
    return out


def decode_wire(wire: torch.Tensor, cfg, n: int,
                out_dtype=torch.float32) -> torch.Tensor:
    """(R, wire_bytes(n)) uint8 -> (R, n) out_dtype."""
    _check_cuda(wire, torch.uint8, "decode_wire")
    _check_cfg(cfg)
    if wire.shape[1] != cfg.wire_bytes(n):
        raise ValueError(f"decode_wire: wire width {wire.shape[1]} != "
                         f"{cfg.wire_bytes(n)} for n={n}")
    if out_dtype not in _OUT_KINDS:
        raise TypeError(f"decode_wire: unsupported out dtype {out_dtype}")
    rows = wire.shape[0]
    out = torch.empty((rows, n), dtype=out_dtype, device=wire.device)
    _launch("fc_decode_wire", wire, out, cfg, rows, n, _OUT_KINDS[out_dtype])
    LAUNCHES["decode_wire"] += 1
    return out


def decode_reduce(wire: torch.Tensor, cfg, n: int) -> torch.Tensor:
    """(R, wire_bytes(n)) uint8 -> (1, n) f32 sum of the decoded rows."""
    _check_cuda(wire, torch.uint8, "decode_reduce")
    _check_cfg(cfg)
    if wire.shape[1] != cfg.wire_bytes(n):
        raise ValueError(f"decode_reduce: wire width {wire.shape[1]} != "
                         f"{cfg.wire_bytes(n)} for n={n}")
    out = torch.empty((1, n), dtype=torch.float32, device=wire.device)
    _launch("fc_decode_reduce", wire, out, cfg, wire.shape[0], n)
    LAUNCHES["decode_reduce"] += 1
    return out


def bound_bytes(kernel: str, cfg, rows: int, n: int,
                out_itemsize: int = 4) -> int:
    """Bytes a kernel must move: each input read once, each output
    written once."""
    wb = cfg.wire_bytes(n)
    if kernel == "encode_wire":
        return rows * n * 4 + rows * wb
    if kernel == "decode_wire":
        return rows * wb + rows * n * out_itemsize
    if kernel == "decode_reduce":
        return rows * wb + n * 4
    raise KeyError(kernel)


def bound_flops(kernel: str, cfg, rows: int, n: int) -> int:
    """f32 operations a kernel must do beyond moving bytes: a rotating
    config's ``group`` products and ``group`` sums for each value (each
    row of decode_reduce is rotated back); none otherwise."""
    if not cfg.rotation:
        return 0
    assert kernel in LAUNCHES, kernel
    return rows * n * 2 * cfg.group
