"""Asymmetric group round-to-nearest quantization at any bit width.

The paper's base quantizer (Tables 1-2): per-group (last axis reshaped to
``(..., n_groups, group)``) asymmetric RTN. Scale and zero are rounded to
the wire's meta dtype first, and the codes are computed with those stored
values, so encode and decode agree on them.

Float details follow the JAX package exactly: ``torch.round`` rounds half
to even as ``jnp.round`` does, min/max propagate NaN and order -0.0 below
+0.0 (as XLA's minimum and maximum do), a NaN code becomes 0, and a NaN
rounded to the meta dtype keeps the bits ``jnp.astype`` keeps (see
:func:`to_meta`), except a NaN scale, which the codec makes by
arithmetic and writes canonical (see :func:`scale_zero`).
"""
from __future__ import annotations

import torch

EPS = 1e-12

META_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def meta_dtype_of(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return META_DTYPES[str(name)]


def to_meta(x: torch.Tensor, dtype) -> torch.Tensor:
    """float32 -> bf16/fp16 as ``jnp.astype`` converts, on any device.

    Numbers round to nearest even. A NaN keeps its sign and, in fp16, the
    top 9 bits of its payload, quieted: bf16 ``sign | 0x7FC0``, fp16
    ``sign | 0x7E00 | (mant >> 13)``. The bits are computed here, because
    PyTorch's own conversions of a NaN differ between its CPU kernels and
    CUDA.
    """
    dtype = meta_dtype_of(dtype)
    xf = x.to(torch.float32)
    bits = xf.to(dtype).view(torch.int16)
    u = xf.view(torch.int32)
    nan_bits = torch.where(u < 0, -0x8000, 0)
    if dtype == torch.bfloat16:
        nan_bits = nan_bits + 0x7FC0
    else:
        nan_bits = nan_bits + (0x7E00 | ((u >> 13) & 0x1FF))
    return torch.where(torch.isnan(xf), nan_bits.to(torch.int16),
                       bits).view(dtype)


def canonical_nan(x: torch.Tensor) -> torch.Tensor:
    """Every NaN -> 0x7FC00000. A NaN that arithmetic makes has bits that
    depend on the machine (x86 propagates an operand's NaN or makes
    0xFFC00000, CUDA makes 0x7FFFFFFF), so the codec writes one pattern."""
    return torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)


def to_code(t: torch.Tensor, qmax: float) -> torch.Tensor:
    """Rounded float codes -> uint8: clip to [0, qmax], NaN -> 0."""
    t = torch.clamp(torch.round(t), 0.0, qmax)
    return torch.where(torch.isnan(t), torch.zeros_like(t), t).to(
        torch.uint8)


def cast_out(x: torch.Tensor, dtype) -> torch.Tensor:
    """float32 -> an output dtype, with ``jnp.astype``'s NaN bits."""
    if dtype in (torch.bfloat16, torch.float16):
        return to_meta(x, dtype)
    return x.to(dtype)


def group_reshape(x: torch.Tensor, group: int) -> torch.Tensor:
    """(..., n) -> (..., n//group, group). n must divide."""
    n = x.shape[-1]
    assert n % group == 0, f"n={n} not divisible by group={group}"
    return x.reshape(*x.shape[:-1], n // group, group)


def group_unreshape(xg: torch.Tensor) -> torch.Tensor:
    return xg.reshape(*xg.shape[:-2], xg.shape[-2] * xg.shape[-1])


def zmin(t: torch.Tensor) -> torch.Tensor:
    """``amin`` over the last axis with -0.0 below +0.0: a zero minimum
    is -0.0 when the axis holds a -0.0 (PyTorch's own keeps whichever
    zero its order meets first)."""
    m = torch.amin(t, dim=-1)
    neg = ((t == 0) & torch.signbit(t)).any(-1)
    zero = torch.zeros_like(m)
    return torch.where(m == 0, torch.where(neg, -zero, zero), m)


def zmax(t: torch.Tensor) -> torch.Tensor:
    """``amax`` over the last axis with +0.0 above -0.0."""
    m = torch.amax(t, dim=-1)
    pos = ((t == 0) & ~torch.signbit(t)).any(-1)
    zero = torch.zeros_like(m)
    return torch.where(m == 0, torch.where(pos, zero, -zero), m)


def group_min_max(xg: torch.Tensor):
    """(..., group) -> NaN-propagating (min, max) over the last axis.

    In a group holding NaN both are its first NaN, with that element's
    bits: PyTorch's reductions return a NaN of their own on the CPU.
    """
    mn, mx = zmin(xg), zmax(xg)
    nan = torch.isnan(xg)
    first = torch.gather(xg, -1, nan.to(torch.uint8).argmax(-1, keepdim=True))
    has_nan = nan.any(-1)
    return (torch.where(has_nan, first[..., 0], mn),
            torch.where(has_nan, first[..., 0], mx))


def scale_zero(mn: torch.Tensor, mx: torch.Tensor, qmax: float,
               meta_dtype):
    """Group range -> (scale_w, zero_w) rounded to the meta dtype.

    The zero is the group minimum, an input value, so a NaN there keeps
    its input bits; a NaN scale comes out of arithmetic and is canonical.
    """
    # a full divisor tensor: PyTorch's CUDA division by a scalar
    # multiplies by its reciprocal, which is not IEEE division
    scale = (mx - mn) / torch.full_like(mx, qmax)
    scale_w = to_meta(canonical_nan(torch.clamp_min(scale, EPS)),
                      meta_dtype)
    return scale_w, to_meta(mn, meta_dtype)


def quantize(x: torch.Tensor, bits: int, group: int,
             meta_dtype="bfloat16"):
    """Asymmetric RTN. Returns (codes uint8, scale, zero), grouped shapes.

    codes: (..., n_groups, group) uint8 in [0, 2^bits-1]
    scale/zero: (..., n_groups) meta dtype
    """
    xg = group_reshape(x.to(torch.float32), group)
    qmax = float(2 ** bits - 1)
    mn, mx = group_min_max(xg)
    scale_w, zero_w = scale_zero(mn, mx, qmax, meta_dtype)
    s = scale_w.to(torch.float32)[..., None]
    z = zero_w.to(torch.float32)[..., None]
    return to_code((xg - z) / s, qmax), scale_w, zero_w


def dequantize(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
               out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`; returns the flat (..., n) tensor.

    ``codes * s + z`` is two roundings (a product, then a sum): PyTorch's
    eager ops never fuse them into one FMA, and the CUDA kernels use
    ``__fmul_rn``/``__fadd_rn`` to do the same.
    """
    s = scale.to(torch.float32)[..., None]
    z = zero.to(torch.float32)[..., None]
    xg = codes.to(torch.float32) * s + z
    return cast_out(group_unreshape(xg), out_dtype)
