"""The port's per-stage codec kernels (plain versions) held against JAX.

``repro_torch.kernels.ref`` is what the CPU runs and what
``chip_smoke.py`` holds the CUDA kernels ``fc_quant_pack``,
``fc_dequant_unpack`` and ``fc_spike_pack`` against on the card. Here the
same numpy inputs go through it and through the JAX package: its
``repro.kernels.ref`` oracles and its Pallas kernels in interpret mode.
Every comparison is bit for bit unless a test states its bound.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitsplit as jbitsplit
from repro.core import codec as jcodec
from repro.core.comm_config import CommConfig as JConfig
from repro.kernels import ref as jref
from repro.kernels.dequant_unpack import dequant_unpack as jdequant_unpack
from repro.kernels.quant_pack import quant_pack as jquant_pack
from repro.kernels.spike_reserve import spike_pack as jspike_pack
from repro_torch.core import bitsplit, codec, quant
from repro_torch.core.comm_config import CommConfig
from repro_torch.kernels import (dequant_unpack, fused_dequant_unpack,
                                 fused_quant_pack, fused_spike_pack, ops,
                                 quant_pack, ref, spike_reserve, stage)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import _tie_input  # noqa: E402
from test_torch_codec import _assert_within_fma_rounding  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

# (bits, group) of tests/test_kernels.py
SWEEP = [(8, 128), (6, 128), (5, 128), (4, 32), (3, 32), (2, 32), (7, 128)]
SHAPES = [(8, 4096), (16, 1024), (8, 256)]
OUTS = ("payload", "scale", "zero", "spike_vals", "spike_idx")


def _x(rows, n, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, n)) * 3).astype(np.float32)


def _both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx


def _np(t: torch.Tensor) -> np.ndarray:
    """A torch tensor's bytes as numpy (bf16 as its uint16 bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jnp(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return _np(a)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _assert_outs_equal(touts, jouts, what=""):
    for name, t, j in zip(OUTS, touts, jouts):
        np.testing.assert_array_equal(_np(t), _jnp(j),
                                      err_msg=f"{what} {name}")


# ---------------------------------------------------------------------------
# bitsplit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", range(1, 9))
def test_bitsplit_matches_jax(bits):
    """pack/unpack byte for byte, odd n included; pack_unit/unpack_unit
    for the widths that are units (1, 2, 4, 8)."""
    rng = np.random.default_rng(bits)
    for n in (3, 33, 1001):
        codes = rng.integers(0, 2 ** bits, (3, n), dtype=np.uint8)
        tp = bitsplit.pack(torch.from_numpy(codes), bits)
        jp = np.asarray(jbitsplit.pack(jnp.asarray(codes), bits))
        np.testing.assert_array_equal(tp.numpy(), jp)
        assert tp.shape[-1] == bitsplit.packed_nbytes(n, bits) == \
            jbitsplit.packed_nbytes(n, bits)
        np.testing.assert_array_equal(
            bitsplit.unpack(tp, bits, n).numpy(), codes)
        if bits in (1, 2, 4, 8):
            tu = bitsplit.pack_unit(torch.from_numpy(codes), bits)
            np.testing.assert_array_equal(
                tu.numpy(), np.asarray(jbitsplit.pack_unit(
                    jnp.asarray(codes), bits)))
            np.testing.assert_array_equal(
                bitsplit.unpack_unit(tu, bits, n).numpy(), codes)


# ---------------------------------------------------------------------------
# quant_pack, dequant_unpack, spike_pack against repro.kernels.ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,group", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_pack_and_dequant_match_jax_ref(bits, group, dtype):
    """Payload, scale and zero byte for byte; the dequantized values (f32,
    and bf16 at one shape) bit for bit against JAX's eager reference (both
    round the product before the add)."""
    for rows, n in SHAPES:
        jx, tx = _both(_x(rows, n, bits * 100 + n), dtype)
        touts = ref.quant_pack_ref(tx, bits, group)
        jouts = jref.quant_pack_ref(jx, bits, group)
        _assert_outs_equal(touts, jouts, f"{rows}x{n}")
        for out in ("float32", "bfloat16") if n == 1024 else ("float32",):
            td = ref.dequant_unpack_ref(*touts, bits, group, n,
                                        getattr(torch, out))
            jd = jref.dequant_unpack_ref(*jouts, bits, group, n,
                                         jnp.dtype(out))
            np.testing.assert_array_equal(_np(td), _jnp(jd))


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spike_pack_matches_jax_ref(bits, dtype):
    for rows, n in SHAPES:
        jx, tx = _both(_x(rows, n, bits + n), dtype)
        touts = ref.spike_pack_ref(tx, bits, 32)
        jouts = jref.spike_pack_ref(jx, bits, 32)
        _assert_outs_equal(touts, jouts, f"{rows}x{n}")
        td = ref.spike_unpack_ref(*touts, bits, 32, n)
        jd = jref.spike_unpack_ref(*jouts, bits, 32, n)
        np.testing.assert_array_equal(td.numpy().view(np.uint32),
                                      np.asarray(jd).view(np.uint32))


# ---------------------------------------------------------------------------
# against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,group,dtype", [(8, 128, "float32"),
                                              (5, 128, "bfloat16"),
                                              (3, 32, "float32")])
def test_quant_pack_matches_pallas_interpret(bits, group, dtype):
    """Bytes equal the Pallas kernel's; its jitted dequantize may contract
    ``codes * s + z`` into one FMA, so the port's two-rounding values are
    held within one rounding of the product."""
    rows, n = 8, 1024
    jx, tx = _both(_x(rows, n, bits), dtype)
    jouts = jquant_pack(jx, bits=bits, group=group, interpret=True)
    touts = ref.quant_pack_ref(tx, bits, group)
    _assert_outs_equal(touts, jouts)
    jd = np.asarray(jdequant_unpack(*jouts, bits=bits, group=group, n=n,
                                    interpret=True))
    td = ref.dequant_unpack_ref(*touts, bits, group, n).numpy()
    _assert_within_fma_rounding(td, jd, group)


@pytest.mark.parametrize("bits,dtype", [(2, "float32"), (4, "bfloat16")])
def test_spike_pack_matches_pallas_interpret(bits, dtype):
    jx, tx = _both(_x(8, 1024, bits + 7), dtype)
    jouts = jspike_pack(jx, bits=bits, group=32, interpret=True)
    _assert_outs_equal(ref.spike_pack_ref(tx, bits, 32), jouts)


@pytest.mark.parametrize("bits,group,spike", [(8, 128, False),
                                              (4, 32, False),
                                              (2, 32, True)])
def test_ties_pack_like_jax(bits, group, spike):
    """chip_smoke.py's tie input: (v - z) / s on k + 1/2 exactly or one
    float32 ulp beside it (where a division that is not correctly
    rounded, or a wrong half-to-even, would show). The plain packs equal
    JAX's reference and its Pallas kernels in interpret mode."""
    x = _tie_input(np, 4, 1024, bits, group, spike, bits)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if spike:
        touts = ref.spike_pack_ref(tx, bits, group)
        jrefs = jref.spike_pack_ref(jx, bits, group)
        jkern = jspike_pack(jx, bits=bits, group=group, interpret=True)
    else:
        touts = ref.quant_pack_ref(tx, bits, group)
        jrefs = jref.quant_pack_ref(jx, bits, group)
        jkern = jquant_pack(jx, bits=bits, group=group, interpret=True)
    _assert_outs_equal(touts, jrefs, "ref")
    _assert_outs_equal(touts, jkern, "pallas")
    codes = bitsplit.unpack(touts[0], bits, x.shape[1]).numpy().reshape(
        *touts[1].shape, group)
    s = touts[1].float().numpy()[..., None]
    z = touts[2].float().numpy()[..., None]
    t = (x.reshape(codes.shape) - z) / s            # float32, as the codec
    assert ((t - np.floor(t)) == 0.5).sum() > 0.2 * x.size   # ties hit
    mid = (t > 0.5) & (t < 2 ** bits - 1.5)
    assert (codes[mid] == np.rint(t[mid])).all()


# ---------------------------------------------------------------------------
# NaN bits in the meta dtype
# ---------------------------------------------------------------------------

NAN_BITS = (0x7FC00000, 0xFFC00000, 0x7FA12345, 0xFFE54321, 0x7F800001,
            0x7FFFFFFF)


def _nan_x(group: int) -> np.ndarray:
    """Gaussian rows, one NaN of each pattern, each alone in its group."""
    x = _x(2, 16 * group, 5)
    u = x.view(np.uint32)
    for i, b in enumerate(NAN_BITS):
        u[i % 2, (2 * i + 1) * group + 3] = b
    return x


@pytest.mark.parametrize("meta", ["bfloat16", "float16"])
def test_to_meta_nan_bits_match_jnp_astype(meta):
    """A NaN keeps the bits jnp.astype keeps: bf16 its sign, fp16 its
    sign and top payload bits, quieted (the old port wrote one canonical
    NaN, so the negative and payload NaNs here failed)."""
    u = np.array(NAN_BITS + (0x3F800000, 0xFF800000, 0x00000001),
                 np.uint32)
    x = u.view(np.float32)
    t = quant.to_meta(torch.from_numpy(x), meta).view(torch.int16).numpy()
    j = np.asarray(jnp.asarray(x).astype(meta)).view(np.int16)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("meta", ["bfloat16", "float16"])
@pytest.mark.parametrize("scale_int", [False, True])
def test_nan_inputs_encode_like_jax(meta, scale_int):
    """Negative and payload NaNs through the spike codec: every wire byte
    equals repro.core.codec.encode's (spike values carry the NaNs)."""
    x = _nan_x(32)
    kw = dict(bits=3, group=32, spike=True, meta_dtype=meta,
              scale_int=scale_int)
    jbuf = np.asarray(jcodec.encode(jnp.asarray(x), JConfig(
        backend="ref", **kw)))
    np.testing.assert_array_equal(
        codec.encode(torch.from_numpy(x), CommConfig(**kw)).numpy(), jbuf)


def test_nan_inputs_spike_pack_like_jax():
    x = _nan_x(32)
    jouts = jspike_pack(jnp.asarray(x), bits=2, group=32, interpret=True)
    _assert_outs_equal(ref.spike_pack_ref(torch.from_numpy(x), 2, 32),
                       jouts)


def test_nan_group_zero_carried_scale_canonical():
    """Without spikes a NaN group's zero is the NaN itself (its bits as
    jnp.astype keeps them) and its scale, made by arithmetic, the
    canonical 0x7FC0; JAX's scale there is whatever x86 arithmetic made.
    Everything else equals the JAX package's."""
    x = _nan_x(128)
    p, s, z = ref.quant_pack_ref(torch.from_numpy(x), 4, 128)
    jp, js, jz = (np.asarray(a) for a in jref.quant_pack_ref(
        jnp.asarray(x), 4, 128))
    np.testing.assert_array_equal(p.numpy(), jp)
    np.testing.assert_array_equal(_np(z), _jnp(jz))
    nan_group = np.isnan(x).reshape(2, -1, 128).any(-1)
    assert nan_group.sum() == len(NAN_BITS)
    np.testing.assert_array_equal(_np(s)[~nan_group], _jnp(js)[~nan_group])
    assert (_np(s)[nan_group] == 0x7FC0).all()


# ---------------------------------------------------------------------------
# the entry points: dispatch rules, launch counts, any row count
# ---------------------------------------------------------------------------

def test_entry_points_dispatch_rules():
    """None and False run the plain version on a CPU tensor and count no
    launch; True on a CPU tensor raises, as does every kernel wrapper."""
    x = torch.from_numpy(_x(4, 256, 1))
    stage.reset_launches()
    for use in (None, False):
        outs = fused_quant_pack(x, 4, 32, use_kernel=use)
        _assert_outs_equal(outs, ref.quant_pack_ref(x, 4, 32))
        assert torch.equal(
            fused_dequant_unpack(*outs, 4, 32, 256, use_kernel=use),
            ref.dequant_unpack_ref(*outs, 4, 32, 256))
        _assert_outs_equal(fused_spike_pack(x, 2, 32, use_kernel=use),
                           ref.spike_pack_ref(x, 2, 32))
    assert set(stage.LAUNCHES.values()) == {0}
    p, s, z = outs
    for call in (lambda: fused_quant_pack(x, 4, 32, use_kernel=True),
                 lambda: fused_dequant_unpack(p, s, z, 4, 32, 256,
                                              use_kernel=True),
                 lambda: fused_spike_pack(x, 2, 32, use_kernel=True),
                 lambda: quant_pack.quant_pack(x, 4, 32),
                 lambda: dequant_unpack.dequant_unpack(p, s, z, 4, 32, 256),
                 lambda: spike_reserve.spike_pack(x, 2, 32)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert set(stage.LAUNCHES.values()) == {0}
    assert ops.fused_quant_pack is fused_quant_pack


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.from_numpy(_x(2, 256, 2))
    with pytest.raises(NotImplementedError, match="group"):
        quant_pack.quant_pack(x, 4, 16)
    with pytest.raises(ValueError, match="bits"):
        spike_reserve.spike_pack(x, 9, 32)
    with pytest.raises(ValueError, match="multiple of group"):
        quant_pack.quant_pack(x[:, :96], 4, 64)


def test_entry_points_take_five_rows():
    """The 5-row case of tests/test_kernels.py: any row count, no
    padding."""
    x = _x(5, 256, 0)
    tx = torch.from_numpy(x)
    p, s, z = fused_quant_pack(tx, 4, 32)
    jp, js, jz = jref.quant_pack_ref(jnp.asarray(x), 4, 32)
    assert p.shape[0] == 5
    _assert_outs_equal((p, s, z), (jp, js, jz))
    y = fused_dequant_unpack(p, s, z, 4, 32, 256)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jref.dequant_unpack_ref(jp, js, jz, 4, 32,
                                                      256)))
    _assert_outs_equal(fused_spike_pack(tx, 2, 32),
                       jref.spike_pack_ref(jnp.asarray(x), 2, 32))


def test_bound_bytes_counts_each_byte_once():
    n = 4096
    assert stage.bound_bytes("quant_pack", 8, 128, 1, n) == \
        4 * n + n + 4 * (n // 128)
    assert stage.bound_bytes("dequant_unpack", 3, 32, 2, n, 2) == \
        2 * (2 * n + 3 * n // 8 + 4 * (n // 32))
    assert stage.bound_bytes("spike_pack", 2, 32, 1, n) == \
        4 * n + n // 4 + 10 * (n // 32)
