"""The per-stage codec kernels' shared launch plumbing (``csrc/stage.cu``).

Three CUDA C++ kernels for Hopper replace the Pallas TPU kernels; their
wrappers live in modules named as the JAX package's:

====================================  ===========================================  =======
wrapper                               TPU kernel replaced                          bound
====================================  ===========================================  =======
``quant_pack.quant_pack``             ``repro/kernels/quant_pack.py:54``           bytes
``dequant_unpack.dequant_unpack``     ``repro/kernels/dequant_unpack.py:42``       bytes
``spike_reserve.spike_pack``          ``repro/kernels/spike_reserve.py:46``        bytes
====================================  ===========================================  =======

All three are memory-bound: the least time is the bytes read plus the
bytes written over 3.35 TB/s (:func:`bound_bytes`). ``LAUNCHES`` counts
the launches of each kernel. The kernels take groups of
``KERNEL_GROUPS`` and any number of rows; meta is bf16.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.core import bitsplit

SOURCE = "stage.cu"
KERNEL_GROUPS = (32, 64, 128)
IN_DTYPES = (torch.float32, torch.bfloat16)
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"quant_pack": 0, "dequant_unpack": 0,
                            "spike_pack": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    # pointers..., rows, n, bits, group, in_bf16 / out_kind, stream
    "fc_quant_pack": [_P] * 4 + [_L, _L, _I, _I, _I, _P],
    "fc_spike_pack": [_P] * 6 + [_L, _L, _I, _I, _I, _P],
    "fc_dequant_unpack": [_P] * 4 + [_L, _L, _I, _I, _I, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_config(what: str, bits: int, group: int, n: int) -> None:
    if group not in KERNEL_GROUPS:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes group {KERNEL_GROUPS}, got {group}")
    if not 1 <= bits <= 8:
        raise ValueError(f"{what}: bits must be 1..8, got {bits}")
    if n % group:
        raise ValueError(f"{what}: n={n} is not a multiple of group={group}")


def check_cuda(t: torch.Tensor, dtypes, shape, what: str,
               align: int = 16) -> None:
    """A contiguous CUDA tensor of one of ``dtypes`` and ``shape``, at an
    ``align``-byte aligned address (the kernels move values and plane
    bytes in vectors of up to 16 bytes)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: expected one of {dtypes}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor of shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{what}: the tensor's data is not {align}-byte "
                         f"aligned")


def launch(name: str, device, *args) -> None:
    """Call ``fc_<name>`` on the current stream of ``device``; raise on a
    nonzero CUDA error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = getattr(_lib(), f"fc_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"fc_{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def bound_bytes(kernel: str, bits: int, group: int, rows: int, n: int,
                itemsize: int = 4) -> int:
    """Bytes a kernel must move, each input read once and each output
    written once; ``itemsize`` is that of the float side (the input of
    the packs, the output of dequant_unpack)."""
    floats = rows * n * itemsize
    payload = rows * bitsplit.packed_nbytes(n, bits)
    meta = rows * (n // group) * 2 * 2                  # scale, zero bf16
    if kernel in ("quant_pack", "dequant_unpack"):
        return floats + payload + meta
    if kernel == "spike_pack":
        return floats + payload + meta + rows * (n // group) * (4 + 2)
    raise KeyError(kernel)
