"""The PyTorch port's wire codec held against the JAX package.

Same inputs (numpy, fixed seeds) through both packages in one process.
Every comparison is bit for bit unless a test states its tolerance and
why. The CUDA kernels cannot run here; on the CPU every kernel wrapper
runs its plain PyTorch version, which is what these tests pin, and
``chip_smoke.py`` holds the kernels against that version on the card.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import quant as jquant
from repro.core import rotation as jrotation
from repro.core import scale_codec as jscale
from repro.core import spike as jspike
from repro.core import wordpack as jwordpack
from repro.core.comm_config import CommConfig as JConfig
from repro.core.comm_config import _wire_layout as j_wire_layout
from repro.kernels import emulate as jemulate
from repro_torch.core import (codec, quant, rotation, scale_codec, spike,
                              wordpack)
from repro_torch.core.comm_config import CommConfig, _wire_layout
from repro_torch.kernels import ops, wire

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "scripts"))
from gen_golden_wire import golden_cfg  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "golden",
                              "wire_vectors.npz"))
RAW_KEYS = [k for k in GOLDEN.files if k.startswith(("int", "a2a_int"))]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bits(a) -> np.ndarray:
    """Bit pattern of a float array (NaN-exact comparisons)."""
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.itemsize])


def _edge_x(seed=0) -> np.ndarray:
    """Gaussian rows with outliers, NaN groups (one and two NaNs), inf,
    constant groups and duplicated extremes (group-32 positions)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 512)) * 3).astype(np.float32)
    x[0, 7] = 41.0
    x[1, 100] = -36.0
    x[2, 0:128] = 0.75                      # constant groups
    x[2, 130] = x[2, 140] = 8.0             # duplicated max
    x[2, 131] = x[2, 141] = -8.0            # duplicated min
    x[3, 33] = np.nan                       # single NaN
    x[3, 70] = x[3, 80] = np.nan            # two NaNs
    x[3, 200] = np.inf
    x[3, 300] = -np.inf
    return x


# ---------------------------------------------------------------------------
# comm_config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", range(1, 9))
def test_wire_layout_equal(bits):
    for group in (32, 64, 128):
        for spike_on in (False, True):
            for scale_int in (False, True):
                for n in (group, 4 * group, 96 * group):
                    assert tuple(_wire_layout(n, bits, group, spike_on,
                                              scale_int)) == \
                        tuple(j_wire_layout(n, bits, group, spike_on,
                                            scale_int))
                kw = dict(bits=bits, group=group, spike=spike_on,
                          scale_int=scale_int)
                assert CommConfig(**kw).wire_bytes(4096) == \
                    JConfig(**kw).wire_bytes(4096)


@pytest.mark.parametrize("kw", [
    dict(bits=9), dict(bits=0), dict(group=2), dict(scheme="ring"),
    dict(spike=True, group=512), dict(spike=True, group=3),
    dict(spike=True, rotation=True), dict(rotation=True, group=96),
    dict(framed=True, scheme="fused"), dict(bits=3, group=64, spike=True),
    dict(enabled=False, bits=9), dict(rotation=True, group=64),
])
def test_post_init_rejections_match(kw):
    def rejects(cls):
        try:
            cls(**kw)
        except AssertionError:
            return True
        return False
    assert rejects(CommConfig) == rejects(JConfig)


def test_backend_names():
    assert CommConfig(backend="cuda").backend == "cuda"
    with pytest.raises(AssertionError):
        CommConfig(backend="pallas")


# ---------------------------------------------------------------------------
# codec primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unit", [1, 2, 4, 8])
def test_wordpack_planes(unit):
    rng = np.random.default_rng(unit)
    for n in (7, 33, 512):
        f = rng.integers(0, 1 << unit, (3, n)).astype(np.uint8)
        jp = np.asarray(jwordpack.pack_plane(jnp.asarray(f), unit))
        tp = wordpack.pack_plane(_t(f), unit).numpy()
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(
            wordpack.unpack_plane(_t(tp), unit, n).numpy(),
            np.asarray(jwordpack.unpack_plane(jnp.asarray(jp), unit, n)))


@pytest.mark.parametrize("bits", range(1, 9))
def test_wordpack_codes(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, (2, 96)).astype(np.uint8)
    jplanes = jwordpack.pack_codes(jnp.asarray(codes), bits)
    tplanes = wordpack.pack_codes(_t(codes), bits)
    for (ju, jp), (tu, tp) in zip(jplanes, tplanes):
        assert ju == tu
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    back = wordpack.unpack_codes(lambda i, u, nb: tplanes[i][1], bits, 96)
    np.testing.assert_array_equal(back.numpy(), codes)


@pytest.mark.parametrize("theta", [5, 10, 20])
def test_scale_codec_tables_and_all_codes(theta):
    assert scale_codec.mant_thresholds(theta) == \
        jscale._mant_thresholds(theta)
    assert scale_codec.frac_table(theta) == jscale._frac_table(theta)
    codes = np.arange(-128, 128, dtype=np.int8)
    np.testing.assert_array_equal(
        _bits(scale_codec.decode_scale(_t(codes), theta).numpy()),
        _bits(jscale.decode_scale(jnp.asarray(codes), theta)))
    scodes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        _bits(scale_codec.decode_signed(_t(scodes), theta).numpy()),
        _bits(jscale.decode_signed(jnp.asarray(scodes), theta)))


@pytest.mark.parametrize("theta", [5, 10, 20])
def test_scale_codec_encode_grid(theta):
    rng = np.random.default_rng(theta)
    grid = np.concatenate([
        np.exp2(rng.uniform(-80, 80, 20000)),
        np.exp2(np.arange(-70, 70) / theta),       # on/near code edges
        np.nextafter(np.exp2(np.arange(-70, 70) / theta), 0),
        [0.0, 1e-30, 1e-20, 1e-12, 1.0, 3.4e38, np.inf, np.nan],
    ]).astype(np.float32)
    signed = np.concatenate([grid, -grid, [-0.0, -np.nan]]).astype(
        np.float32)
    np.testing.assert_array_equal(
        scale_codec.encode_scale(_t(grid), theta).numpy(),
        np.asarray(jscale.encode_scale(jnp.asarray(grid), theta)))
    np.testing.assert_array_equal(
        scale_codec.encode_signed(_t(signed), theta).numpy(),
        np.asarray(jscale.encode_signed(jnp.asarray(signed), theta)))


@pytest.mark.parametrize("meta", ["bfloat16", "float16"])
@pytest.mark.parametrize("bits,group", [(8, 128), (5, 128), (4, 32),
                                        (2, 32), (3, 64), (1, 32)])
def test_quantize_bits_equal(bits, group, meta):
    x = _edge_x()
    jc, js, jz = jquant.quantize(jnp.asarray(x), bits, group,
                                 jnp.dtype(meta))
    tc, ts, tz = quant.quantize(_t(x), bits, group, meta)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_bits(ts.view(torch.int16).numpy()),
                                  _bits(np.asarray(js)))
    np.testing.assert_array_equal(_bits(tz.view(torch.int16).numpy()),
                                  _bits(np.asarray(jz)))
    np.testing.assert_array_equal(
        _bits(quant.dequantize(tc, ts, tz).numpy()),
        _bits(jquant.dequantize(jc, js, jz)))


@pytest.mark.parametrize("meta", ["bfloat16", "float16"])
@pytest.mark.parametrize("bits,group", [(2, 32), (3, 32), (4, 64),
                                        (8, 128), (2, 4)])
def test_spike_quantize_bits_equal(bits, group, meta):
    x = _edge_x()
    jq = jspike.spike_quantize(jnp.asarray(x), bits, group, jnp.dtype(meta))
    tq = spike.spike_quantize(_t(x), bits, group, meta)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    for tf, jf in ((tq.scale, jq.scale), (tq.zero, jq.zero),
                   (tq.spike_vals, jq.spike_vals)):
        np.testing.assert_array_equal(_bits(tf.view(torch.int16).numpy()),
                                      _bits(np.asarray(jf)))
    np.testing.assert_array_equal(tq.spike_idx.numpy(),
                                  np.asarray(jq.spike_idx))
    np.testing.assert_array_equal(
        _bits(spike.spike_dequantize(tq).numpy()),
        _bits(jspike.spike_dequantize(jq)))


def test_spike_edge_rules():
    """The documented election rules, on hand-built groups of 4."""
    x = np.array([[1.0, 5.0, 5.0, 1.0],          # duplicated extremes
                  [2.0, 2.0, 2.0, 2.0],          # constant group
                  [0.0, np.nan, 3.0, 1.0],       # one NaN: max forfeited
                  [np.nan, 1.0, np.nan, 2.0]],   # two NaNs take both
                 np.float32)
    q = spike.spike_quantize(_t(x), 2, 4)
    np.testing.assert_array_equal(q.spike_idx.reshape(4, 2).numpy(),
                                  [[0, 1], [0, 1], [1, 1], [0, 2]])


# ---------------------------------------------------------------------------
# the wire: goldens, scale_int, pallas interpret, decode
# ---------------------------------------------------------------------------

def _golden(key):
    stem = key[len("a2a_"):] if key.startswith("a2a_") else key
    bits = int(stem.split("_")[0][len("int"):])
    jc = golden_cfg(bits, stem.endswith("_sr"), stem.endswith("_rot"))
    cfg = CommConfig(bits=jc.bits, group=jc.group, spike=jc.spike,
                     rotation=jc.rotation, backend="ref")
    x = GOLDEN["xa"] if key.startswith("a2a_") else GOLDEN["x"]
    return cfg, jc, x


@pytest.mark.parametrize("key", RAW_KEYS)
def test_golden_encode_and_decode(key):
    """Raw keys: byte for byte. ``_rot`` keys: the rotation is an f32
    (g, g) matrix product whose summation order PyTorch and XLA choose
    differently, so a rotated value within rounding of a code boundary
    may take the neighbouring code: at most 1% of bytes may differ, and
    the decoded values then differ by at most one quantization step of
    the group (here < 0.6 on a 3-sigma input) plus f32 rounding."""
    cfg, jc, x = _golden(key)
    buf = codec.encode(_t(x), cfg).numpy()
    assert buf.shape == GOLDEN[key].shape
    dec = codec.decode(_t(GOLDEN[key]), cfg, x.shape[-1]).numpy()
    jdec = np.asarray(jcodec.decode(jnp.asarray(GOLDEN[key]), jc,
                                    x.shape[-1]))
    if cfg.rotation:
        assert np.mean(buf != GOLDEN[key]) <= 0.01
        np.testing.assert_allclose(dec, jdec, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(buf, GOLDEN[key])
        np.testing.assert_array_equal(_bits(dec), _bits(jdec))


def _ordered_rotate_np(xg, s, h):
    """The documented order, in numpy f32: out_j = sum_i (x_i s_i) h_ij,
    i increasing from +0.0, each product rounded before the add."""
    xs = (xg * s).astype(np.float32)
    acc = np.zeros_like(xs)
    for i in range(xg.shape[-1]):
        acc = (acc + (xs[..., i:i + 1] * h[i]).astype(np.float32)).astype(
            np.float32)
    return acc


@pytest.mark.parametrize("bits", range(2, 9))
def test_rotation_fixed_order_keeps_golden_bound(bits):
    """rotate/unrotate sum in one fixed order (the CUDA kernels' order):
    bit for bit the numpy loop of that order; within a few f32 roundings
    of JAX's (g, g) matrix product; and the ``_rot`` goldens encoded
    through it stay within test_golden_encode_and_decode's bound (at most
    1% of bytes differ, decode within 1e-5)."""
    key = f"int{bits}_rot"
    cfg, jc, x = _golden(key)
    g = cfg.group
    xt = _t(x)
    s = rotation.signs(g).numpy()
    h = rotation.hadamard(g).numpy()
    xg = x.reshape(x.shape[0], -1, g)
    np.testing.assert_array_equal(
        _bits(rotation.rotate(xt, g).numpy()),
        _bits(_ordered_rotate_np(xg, s, h).reshape(x.shape)))
    jr = np.asarray(jrotation.rotate(jnp.asarray(x), g))
    np.testing.assert_allclose(rotation.rotate(xt, g).numpy(), jr,
                               rtol=0, atol=1e-5 * np.abs(x).max())
    back = rotation.unrotate(rotation.rotate(xt, g), g).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-5 * np.abs(x).max())
    buf = codec.encode(xt, cfg).numpy()
    assert np.mean(buf != GOLDEN[key]) <= 0.01
    np.testing.assert_allclose(
        codec.decode(_t(GOLDEN[key]), cfg, x.shape[-1]).numpy(),
        np.asarray(jcodec.decode(jnp.asarray(GOLDEN[key]), jc,
                                 x.shape[-1])), rtol=0, atol=1e-5)


SCALE_INT_GRID = [(bits, 32 if bits <= 4 else 128, sp, 10)
                  for bits in range(1, 9) for sp in (False, True)] + \
    [(3, 64, False, 10), (3, 64, True, 10)] + \
    [(bits, 64, sp, theta) for bits in (2, 5, 8) for sp in (False, True)
     for theta in (5, 20)]


@pytest.mark.parametrize("bits,group,sp,theta", SCALE_INT_GRID)
def test_scale_int_matches_jax(bits, group, sp, theta):
    """No golden covers scale_int: held against repro.core.codec."""
    x = _edge_x(seed=bits * 7 + theta)
    jc = JConfig(bits=bits, group=group, spike=sp, scale_int=True,
                 theta=theta, backend="ref")
    cfg = CommConfig(bits=bits, group=group, spike=sp, scale_int=True,
                     theta=theta)
    jbuf = np.asarray(jcodec.encode(jnp.asarray(x), jc))
    np.testing.assert_array_equal(codec.encode(_t(x), cfg).numpy(), jbuf)
    np.testing.assert_array_equal(
        _bits(codec.decode(_t(jbuf), cfg, 512).numpy()),
        _bits(jcodec.decode(jnp.asarray(jbuf), jc, 512)))


def _assert_within_fma_rounding(td, jd, group, out_ulp=(0.0, 0.0)):
    """JAX's jitted decode (its "pallas" backend, kernels interpreted
    under jit) lets XLA's CPU backend contract ``codes * s + z`` into one
    FMA; the port, like JAX's eager ``"ref"`` decode, rounds the product
    first (and so do the CUDA kernels). The two differ by at most one
    rounding of the product: |d| <= ulp(codes*s) <= 2^-23 |codes*s|, and
    |codes*s| <= |value| + |z| <= |value| + max |value| of its group
    (z is the value of code 0). Twice that bound is asserted. Decoded
    into a narrower type, the two f32 values then round to neighbours at
    most: ``out_ulp`` = (relative, absolute) spacing of that type is
    added (bf16 (2^-7, 0); fp16 (2^-10, 2^-24), its subnormals')."""
    td, jd = np.asarray(td, np.float32), np.asarray(jd, np.float32)
    assert np.array_equal(np.isnan(td), np.isnan(jd))
    ok = np.isfinite(td) & np.isfinite(jd)
    np.testing.assert_array_equal(td[~ok], jd[~ok])
    a = np.abs(np.where(ok, jd, 0.0)).reshape(*jd.shape[:-1], -1, group)
    gmax = np.repeat(a.max(-1), group, axis=-1).reshape(jd.shape)
    bound = 2.0 ** -22 * (np.abs(jd) + gmax)
    bound = bound + out_ulp[0] * a.reshape(jd.shape) + out_ulp[1]
    assert np.all(np.abs(td[ok] - jd[ok]) <= bound[ok])


@pytest.mark.parametrize("bits,sp", [(5, False), (2, True), (8, False)])
def test_matches_jax_pallas_backend(bits, sp):
    """The JAX "pallas" backend (kernels in interpret mode) gives the
    same bytes as the port's plain codec; decode within one rounding of
    the product (see :func:`_assert_within_fma_rounding`)."""
    x = _edge_x(seed=bits)
    group = 128 if bits >= 5 else 32
    jc = JConfig(bits=bits, group=group, spike=sp, scale_int=True,
                 backend="pallas")
    cfg = CommConfig(bits=bits, group=group, spike=sp, scale_int=True)
    jbuf = np.asarray(jcodec.encode(jnp.asarray(x), jc))
    np.testing.assert_array_equal(codec.encode(_t(x), cfg).numpy(), jbuf)
    _assert_within_fma_rounding(
        codec.decode(_t(jbuf), cfg, 512).numpy(),
        np.asarray(jcodec.decode(jnp.asarray(jbuf), jc, 512)), group)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("meta", ["bfloat16", "float16"])
def test_decode_out_dtype_and_meta(out, meta):
    x = _edge_x(seed=3)
    jc = JConfig(bits=3, group=32, spike=True, meta_dtype=meta,
                 backend="ref")
    cfg = CommConfig(bits=3, group=32, spike=True, meta_dtype=meta)
    jbuf = np.asarray(jcodec.encode(jnp.asarray(x), jc))
    np.testing.assert_array_equal(codec.encode(_t(x), cfg).numpy(), jbuf)
    td = codec.decode(_t(jbuf), cfg, 512, getattr(torch, out))
    jd = jcodec.decode(jnp.asarray(jbuf), jc, 512, jnp.dtype(out))
    np.testing.assert_array_equal(
        _bits(td.view(torch.int16 if out == "bfloat16" else torch.int32)
              .numpy()), _bits(np.asarray(jd)))


def test_wrappers_plain_on_cpu_and_backend_rules():
    """On a CPU tensor the dispatching wrappers run the plain versions and
    count no launch; the kernel wrappers refuse a CPU tensor, and so does
    the 'cuda' backend, framed too (the frame's CRC32C then goes through
    the kernel); a framed config on the CPU frames the plain wire."""
    x = _t(_edge_x())
    cfg = CommConfig(bits=5, group=128, scale_int=True)
    wire.reset_launches()
    buf = ops.fused_encode_wire(x, cfg)
    assert torch.equal(buf, wire.encode_plain(x, cfg))
    assert torch.equal(ops.fused_decode_wire(buf, cfg, 512),
                       wire.decode_plain(buf, cfg, 512))
    assert torch.equal(ops.fused_decode_reduce(buf, cfg, 512),
                       wire.decode_reduce_plain(buf, cfg, 512))
    assert set(wire.LAUNCHES.values()) == {0}
    for call in (lambda: wire.encode_wire(x, cfg),
                 lambda: wire.decode_wire(buf, cfg, 512),
                 lambda: wire.decode_reduce(buf, cfg, 512)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    with pytest.raises(ValueError, match="CUDA tensor"):
        codec.encode(x, cfg.with_backend("cuda"))
    framed = cfg.with_framed()
    with pytest.raises(ValueError, match="CUDA tensor"):
        codec.encode(x, framed.with_backend("cuda"))
    fbuf = codec.encode(x, framed)
    assert torch.equal(fbuf[:, 16:], buf)
    with pytest.raises(ValueError, match="CUDA tensor"):
        codec.decode(fbuf, framed.with_backend("cuda"), 512)
    assert set(wire.LAUNCHES.values()) == {0}
    assert codec.wire_shape((3, 512), cfg) == (3, cfg.wire_bytes(512))


def test_qdq_wire_round_trip():
    x = _edge_x()
    x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    cfg = CommConfig(bits=8, group=128)
    jc = JConfig(bits=8, group=128, backend="ref")
    np.testing.assert_array_equal(
        codec.qdq_wire(_t(x), cfg).numpy(),
        np.asarray(jcodec.qdq_wire(jnp.asarray(x), jc)))


def _signed_zero_x() -> np.ndarray:
    """Groups of 32 whose min or max is a zero of either sign, in every
    order: -0 before +0, +0 before -0, only -0, zeros beside positives
    (the min a zero) and beside negatives (the max a zero)."""
    z, nz = 0.0, -0.0
    rows = []
    for lo, hi in ((nz, z), (z, nz)):
        rows.append([lo, hi] + [1.0 + i for i in range(30)])
        rows.append([-1.0 - i for i in range(30)] + [lo, hi])
        rows.append([lo, hi] * 16)
        rows.append([3.0, lo, 2.0, hi] + [0.5] * 28)
        rows.append([-3.0, lo, -2.0, hi] + [-0.5] * 28)
    rows.append([nz] * 32)
    rows.append([z] * 31 + [nz])
    return np.array(rows, np.float32).reshape(1, -1)


@pytest.mark.parametrize("scale_int", [False, True])
@pytest.mark.parametrize("sp", [False, True])
def test_signed_zero_groups_match_jax(sp, scale_int):
    """A group's min and max order -0.0 below +0.0, as XLA's minimum and
    maximum do: the zero meta and the spike values carry the sign JAX
    gives them, whatever the order of the zeros in the group."""
    x = _signed_zero_x()
    for bits in (2, 4, 8):
        kw = dict(bits=bits, group=32, spike=sp, scale_int=scale_int)
        got = codec.encode(_t(x), CommConfig(**kw)).numpy()
        want = np.asarray(jcodec.encode(jnp.asarray(x),
                                        JConfig(backend="ref", **kw)))
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


# the wire kernels' timing configs (chip_smoke.py TIME_CONFIGS) and the
# dispatch's int4 g32
ROWS_CFGS = [dict(bits=8, group=128), dict(bits=5, group=128, scale_int=True),
             dict(bits=2, group=32, spike=True),
             dict(bits=2, group=32, rotation=True), dict(bits=4, group=32)]
OUT_ULP = {"float32": (0.0, 0.0), "bfloat16": (2.0 ** -7, 0.0),
           "float16": (2.0 ** -10, 2.0 ** -24)}


def _rows_x(rows: int, seed: int) -> np.ndarray:
    """(rows, 512): every row's first group of 32 positive but for a -0.0
    (its min: a spike that holds -0.0), and a NaN in the last row."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, 512)) * 3).astype(np.float32)
    x[:, :32] = np.abs(x[:, :32])
    x[:, 5] = -0.0
    x[-1, 200] = np.nan
    return x


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
@pytest.mark.parametrize("kw", ROWS_CFGS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_plain_decodes_match_jax_rows(kw, rows):
    """The plain versions that the CUDA decodes are held to on the card,
    against the JAX kernels (interpret mode, as the JAX package's tests
    run them) on JAX's wire bytes of several rows.

    ``decode_plain`` against ``emulate.decode_rows`` in f32, bf16 and
    fp16: within one rounding of the product (the jitted decode's FMA,
    :func:`_assert_within_fma_rounding`), plus a step of the output type.

    ``decode_reduce_plain`` against ``emulate.decode_reduce_rows``: the
    port sums the decoded rows in row order from +0.0. JAX's jitted
    decode+reduce is XLA's ``jnp.sum(axis=0)`` fused with the decode:
    each term within one rounding of the product as above, and the R - 1
    adds of a reduction in another order, or of other terms, round apart
    by at most 2^-24 of a partial sum each, <= 2^-24 sum_r |v_r|. So
    |d| <= sum_r 2^-23 (|v_r| + gmax_r) + 2 (R - 1) 2^-24 sum_r |v_r|
    <= 2^-23 R sum_r (|v_r| + gmax_r); twice that is asserted. One
    difference is in the sign of a zero: for R = 1 XLA returns the row
    itself (the reduce of a size-1 axis is dropped), so a -0.0 stays
    -0.0 where the port's 0.0 + (-0.0) is +0.0 (ROADMAP Queue C)."""
    group = kw["group"]
    x = _rows_x(rows, seed=rows * 31 + kw["bits"])
    jc = JConfig(backend="ref", **kw)
    cfg = CommConfig(**kw)
    jbuf = jemulate.encode_rows(jnp.asarray(x), jc)
    tbuf = torch.from_numpy(np.array(jbuf))
    for out in ("float32", "bfloat16", "float16"):
        td = wire.decode_plain(tbuf, cfg, 512, getattr(torch, out))
        jd = jemulate.decode_rows(jbuf, jc, 512, out_dtype=jnp.dtype(out))
        assert td.shape == jd.shape == (rows, 512)
        _assert_within_fma_rounding(td.float().numpy(), jd, group,
                                    OUT_ULP[out])
    dec = wire.decode_plain(tbuf, cfg, 512).numpy()
    v = np.where(np.isfinite(dec), np.abs(dec), 0.0)
    gmax = np.repeat(v.reshape(rows, -1, group).max(-1), group, axis=-1)
    bound = 2.0 ** -22 * rows * (v + gmax).sum(0, keepdims=True)
    tr = wire.decode_reduce_plain(tbuf, cfg, 512).numpy()
    jr = np.asarray(jemulate.decode_reduce_rows(jbuf, jc, 512))
    assert tr.shape == jr.shape == (1, 512)
    # the last row's NaN, but for an Eq.-1 scale (a NaN scale has no code)
    assert np.isnan(tr).any() == (not cfg.scale_int)
    assert np.array_equal(np.isnan(tr), np.isnan(jr))
    ok = np.isfinite(tr)
    assert np.all(np.abs(tr[ok] - jr[ok]) <= bound[ok])
    # the port's sum starts at +0.0: no -0.0 comes out of it
    assert not np.signbit(tr[tr == 0]).any()
    # a spike restores position 5's -0.0 in every row; JAX's reduce of
    # one row keeps it, a sum of several makes it +0.0 in both packages
    if cfg.spike:
        neg = ((dec == 0) & np.signbit(dec)).all(0, keepdims=True)
        assert neg[0, 5]
        assert np.signbit(jr[neg]).all() == (rows == 1)
        assert np.signbit(jr[neg]).any() == (rows == 1)
