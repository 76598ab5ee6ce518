"""The framed wire (``repro_torch.core.frame``) held against the JAX
package's ``core/frame.py``, on the same seeded numpy inputs.

* CRC32C: the host ``crc32c`` and the per-row ``crc32c_rows`` (on the CPU,
  the plain version of the CUDA kernel ``fc_crc32c``: its chunks, chains,
  tiles, runs and GF(2) combine) against JAX's, at lengths L - 1, L and
  L + 1 around a word, 16 bytes, a chunk, a tile and the kernel's ring,
  cut into the H100's runs and into one, and after an initial register
  (a frame's header prefix); the wrapper's choice of the kernel's ring.
* ``frame_wrap`` bytes and ``frame_check_rows``' ``ok`` mask against
  JAX's, corrupt rows included.
* Every test of ``tests/test_frame.py`` on the frame, mirrored: each
  typed error of the host path, a flip of one bit in every byte of a
  frame (three configs) raising on the host path and NaN-poisoning
  exactly its row through ``codec.decode`` (the device path), clean rows
  bit-equal to the unframed decode, truncation as a static error, and the
  9 framed goldens byte for byte and self-describing.
* The policy's framed bridge (``with_framed_bridge``, ``pod_grad_config``)
  against JAX's; ``--framed-bridge`` on the launcher; a framed-bridge
  training run on two gloo ranks (pod = 2) bit-equal to the same bridge
  unframed and to paper's grad site (int8 g128 hierarchical, the two-step
  on one axis), and held against JAX's jitted framed train step.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import frame as jframe
from repro.core.comm_config import CommConfig as JConfig
from repro.core.policy import CommPolicy as JPolicy
from repro.core.policy import uniform as juniform
from repro.core.policy import with_framed_bridge as jwith_framed_bridge
from repro.train.train_step import pod_grad_config as jpod_grad_config
from repro_torch.core import codec, frame
from repro_torch.core.comm_config import FRAME_HEADER_BYTES, CommConfig
from repro_torch.core.policy import CommPolicy, paper_policy, uniform, \
    with_framed_bridge
from repro_torch.kernels import crc, ops
from repro_torch.train.train_step import pod_grad_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from gen_golden_wire import golden_cfg  # noqa: E402
import _torch_train_worker as worker  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

_DATA = np.load(os.path.join(ROOT, "tests", "golden", "wire_vectors.npz"))
FRAME_KEYS = sorted(k for k in _DATA.files if k.startswith("frame_"))

KW = dict(bits=4, group=32, framed=True)
CFG, JCFG = CommConfig(**KW), JConfig(backend="ref", **KW)
N = 64
FLIP_CFGS = {"int4": KW,
             "int2_sr_si": dict(bits=2, group=32, spike=True,
                                scale_int=True, framed=True),
             "int8_rot": dict(bits=8, group=128, rotation=True,
                              framed=True)}


def _x(rows=2, n=N, seed=0):
    return np.asarray(np.random.RandomState(seed)
                      .standard_normal((rows, n)), np.float32)


def _wire(cfg=CFG, rows=2, n=N, seed=0):
    return codec.encode(torch.from_numpy(_x(rows, n, seed)), cfg).numpy()


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# CRC32C
# ---------------------------------------------------------------------------

def test_crc32c_check_vector():
    assert frame.crc32c(b"123456789") == 0xE3069283 == \
        jframe.crc32c(b"123456789")
    buf = np.random.RandomState(3).randint(0, 256, 1000, np.uint8)
    assert frame.crc32c(buf) == jframe.crc32c(buf)


@pytest.mark.parametrize("length", [1, 2, 3, 57, 64, 65, 8191, 8193])
def test_crc32c_rows_match_jax(length):
    """The plain version (the kernel's chunks and combine) against JAX's
    traced ``crc32c_rows`` and its host ``crc32c``, three rows."""
    buf = np.random.RandomState(length).randint(0, 256, (3, length),
                                                np.uint8)
    got = frame.crc32c_rows(torch.from_numpy(buf)).numpy()
    want = np.asarray(jax.jit(jframe.crc32c_rows)(jnp.asarray(buf)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.tolist() == [jframe.crc32c(r) for r in buf]


def test_crc32c_rows_long_rows_and_initial_register():
    """A row of several tiles against JAX's host ``crc32c``; after an
    initial register, the CRC of the bytes before the rows and the rows,
    against JAX's; and a row cut into two runs whose segments span several
    tiles (chains carried from tile to tile) equal to its two halves, the
    second run after the first's register (one segment each)."""
    rng = np.random.RandomState(7)
    buf = rng.randint(0, 256, (2, 3 * crc.TILE + 17), np.uint8)
    got = crc.crc32c_rows_plain(torch.from_numpy(buf)).tolist()
    assert got == [jframe.crc32c(r) for r in buf]
    head = rng.randint(0, 256, 12, np.uint8)
    body = rng.randint(0, 256, (4, 300), np.uint8)
    init = crc.update(crc.MASK, head.tobytes())
    got = crc.crc32c_rows_plain(torch.from_numpy(body), init).tolist()
    assert got == [jframe.crc32c(np.concatenate([head, r])) for r in body]
    length = 5 * crc.TILE - 5
    assert [s[2:] for s in crc.segments(1, crc.plan(length).tiles, 2)] \
        == [(0, 2), (2, 5)]
    row = torch.from_numpy(rng.randint(0, 256, (1, length), np.uint8))
    half = length // 2
    assert crc.plan(half).tiles == crc.plan(length - half).tiles == 3
    first = int(crc.crc32c_rows_plain(row[:, :half], blocks=1)[0]) ^ crc.MASK
    assert crc.crc32c_rows_plain(row, blocks=2).tolist() == \
        crc.crc32c_rows_plain(row[:, half:], first, blocks=1).tolist()
    assert crc.crc32c_rows_plain(torch.zeros((2, 0), dtype=torch.uint8)
                                 ).tolist() == [0, 0]


#: L - 1, L, L + 1 around a word, the bulk copy's 16 bytes, a chunk, a
#: tile and the kernel's ring of tiles
BOUNDARY_LENGTHS = sorted({n + d for n in (4, 16, crc.CHUNK, crc.TILE,
                                           crc.STAGES * crc.TILE)
                           for d in (-1, 0, 1)})


@pytest.mark.parametrize("prefix", [0, 12])
@pytest.mark.parametrize("length", BOUNDARY_LENGTHS)
def test_crc32c_rows_plain_boundaries_match_jax(length, prefix):
    """The plain version at the cuts' boundaries, two rows, with the
    H100's runs and with one run (a segment crossing a row's end and, past
    a tile, a chain over several tiles), against JAX's jitted
    ``crc32c_rows`` and host ``crc32c`` of the bytes after a ``prefix``
    of header bytes (none: the plain CRC)."""
    rng = np.random.RandomState(length + prefix)
    head = rng.randint(0, 256, prefix, np.uint8)
    buf = rng.randint(0, 256, (2, length), np.uint8)
    init = crc.update(crc.MASK, head.tobytes())
    whole = np.concatenate([np.broadcast_to(head, (2, prefix)), buf], 1)
    want = np.asarray(jax.jit(jframe.crc32c_rows)(jnp.asarray(whole)))
    assert want.tolist() == [jframe.crc32c(r) for r in whole]
    for blocks in (crc.BLOCKS, 1):
        got = crc.crc32c_rows_plain(torch.from_numpy(buf), init, blocks)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_crc_ring_path_choice():
    """The wrapper's choice of the kernel's ring (bulk copies: address,
    pitch and length multiples of 16) for the views the frame hands it:
    contiguous rows and framed rows' payloads (16 + L apart) take it when L
    is a multiple of 16; an odd pitch (3 + L) or an odd length do not."""
    assert crc.ring_path(0, 32, 16) and crc.ring_path(4096, 4096, 4096)
    assert not crc.ring_path(8, 32, 16)
    assert not crc.ring_path(0, 40, 16)
    assert not crc.ring_path(0, 32, 20)

    def path(rows):
        pitch = rows.stride(0) if rows.shape[0] > 1 else rows.shape[1]
        return crc.ring_path(rows.data_ptr(), pitch, rows.shape[1])

    for length in (16, 4096, crc.TILE):
        base = torch.zeros((3, 16 + length), dtype=torch.uint8)
        assert base.data_ptr() % 16 == 0
        assert path(base[:, :length].contiguous())
        assert path(base[:, 16:])
        assert not path(torch.zeros((3, 3 + length),
                                    dtype=torch.uint8)[:, 3:])
        assert not path(base[:, 16:length + 15])
        assert not path(torch.zeros((3, 8 + length),
                                    dtype=torch.uint8)[:, :length])
        assert path(base[:1, 16:])


def test_crc_dispatch_refuses_cpu_for_the_kernel():
    """A CPU tensor goes to the plain version; the kernel's wrapper, or
    ``use_kernel=True``, refuses it (no fallback)."""
    rows = torch.zeros((2, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        crc.crc32c_rows(rows)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.crc32c_rows(rows, use_kernel=True)
    assert crc.LAUNCHES["crc32c"] == 0
    assert ops.crc32c_rows(rows).tolist() == [jframe.crc32c(bytes(5))] * 2


# ---------------------------------------------------------------------------
# wrap and check against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FLIP_CFGS))
def test_frame_wrap_and_check_rows_match_jax(name):
    kw = FLIP_CFGS[name]
    cfg, jcfg = CommConfig(**kw), JConfig(backend="ref", **kw)
    n = 2 * cfg.group
    x = _x(3, n, 5)
    raw = jcodec.encode(jnp.asarray(x), jcfg.with_framed(False))
    want = np.array(jframe.frame_wrap(raw, jcfg))
    got = frame.frame_wrap(torch.from_numpy(np.array(raw)), cfg).numpy()
    np.testing.assert_array_equal(got, want)
    bad = want.copy()
    bad[1, 3] ^= 0x04                           # header
    bad[2, FRAME_HEADER_BYTES + 5] ^= 0x80      # payload
    for buf in (want, bad):
        payload, ok = frame.frame_check_rows(torch.from_numpy(buf), cfg, n)
        jpayload, jok = jax.jit(lambda b: jframe.frame_check_rows(
            b, jcfg, n))(jnp.asarray(buf))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(payload.numpy(), np.asarray(jpayload))
    assert ok.tolist() == [True, False, False]


# ---------------------------------------------------------------------------
# clean frames: framed == header + the exact raw wire
# ---------------------------------------------------------------------------

def test_frame_payload_is_the_raw_wire():
    x = torch.from_numpy(_x())
    framed = codec.encode(x, CFG).numpy()
    raw = codec.encode(x, CFG.with_framed(False)).numpy()
    np.testing.assert_array_equal(framed[..., FRAME_HEADER_BYTES:], raw)
    assert framed.shape[-1] == CFG.wire_bytes(N) \
        == raw.shape[-1] + FRAME_HEADER_BYTES
    np.testing.assert_array_equal(
        framed, np.asarray(jcodec.encode(jnp.asarray(_x()), JCFG)))


def test_framed_roundtrip_bit_exact_with_raw():
    x = torch.from_numpy(_x())
    framed = codec.decode(torch.from_numpy(_wire()), CFG, N)
    raw_cfg = CFG.with_framed(False)
    raw = codec.decode(codec.encode(x, raw_cfg), raw_cfg, N)
    np.testing.assert_array_equal(_bits(framed), _bits(raw))
    # JAX's eager decode of the concrete buffer (its host path)
    np.testing.assert_array_equal(
        _bits(framed), _bits(jcodec.decode(jnp.asarray(_wire()), JCFG, N)))


def test_self_describing_decode_matches_pinned_config():
    wire = _wire()
    no_cfg = frame.frame_decode(wire)
    with_cfg = frame.frame_decode(torch.from_numpy(wire), CFG)
    np.testing.assert_array_equal(_bits(no_cfg), _bits(with_cfg))
    _, hdr = frame.frame_unwrap(wire)
    assert hdr == jframe.frame_unwrap(wire)[1]
    assert (hdr.bits, hdr.group, hdr.payload_len) == \
        (CFG.bits, CFG.group, CFG.wire_layout(N).total)
    assert frame.config_from_header(hdr) == CommConfig(**KW)


# ---------------------------------------------------------------------------
# malformed-buffer classes -> typed errors (the host path)
# ---------------------------------------------------------------------------

def _raises_like_jax(buf, err, cfg=None, jcfg=None):
    """The port's host path raises ``err``, JAX's its class of that name."""
    with pytest.raises(err):
        frame.frame_unwrap(buf, cfg)
    with pytest.raises(getattr(jframe, err.__name__)):
        jframe.frame_unwrap(buf, jcfg)


def test_truncated_below_header():
    _raises_like_jax(_wire()[:, :FRAME_HEADER_BYTES - 1],
                     frame.FrameTruncatedError)


def test_truncated_payload():
    _raises_like_jax(_wire()[:, :-5], frame.FrameTruncatedError)


def test_trailing_garbage_is_a_length_error():
    wire = _wire()
    padded = np.concatenate(
        [wire, np.zeros((wire.shape[0], 3), np.uint8)], axis=-1)
    _raises_like_jax(padded, frame.FrameLengthError)


def test_wrong_version():
    wire = _wire()
    wire[:, 2] = 99
    _raises_like_jax(wire, frame.FrameVersionError)


def test_bad_magic():
    wire = _wire()
    wire[:, 0] = 0x00
    _raises_like_jax(wire, frame.FrameHeaderError)


def test_config_disagreement():
    _raises_like_jax(_wire(), frame.FrameHeaderError, CFG.with_bits(8),
                     JCFG.with_bits(8))


def test_row_header_disagreement():
    wire = _wire()
    wire[1, :frame._PREFIX_BYTES] = frame.header_prefix(
        CFG.with_bits(2), wire.shape[-1] - FRAME_HEADER_BYTES)
    _raises_like_jax(wire, frame.FrameHeaderError)


def test_non_uint8_rejected():
    _raises_like_jax(_wire().astype(np.int32), frame.FrameHeaderError)
    with pytest.raises(frame.FrameHeaderError):
        frame.frame_unwrap(torch.from_numpy(_wire()).to(torch.int32))


def test_caller_length_disagreement():
    with pytest.raises(frame.FrameLengthError):
        frame.frame_decode(_wire(), CFG, n=2 * N)


@pytest.mark.parametrize("name", list(FLIP_CFGS))
def test_every_single_bit_flip_is_detected(name):
    """Full CRC coverage: one bit flipped in every byte of the frame
    (header and payload). The host path raises a typed FrameError, as
    JAX's does; the device path (``codec.decode``) NaN-poisons exactly
    that row and leaves the other rows bit-equal to the clean decode."""
    cfg = CommConfig(**FLIP_CFGS[name])
    n = 2 * cfg.group
    wire = _wire(cfg, rows=3, n=n)
    clean = codec.decode(torch.from_numpy(wire), cfg, n).numpy()
    assert np.all(np.isfinite(clean))
    for i in range(wire.shape[-1]):
        mut = wire.copy()
        mut[1, i] ^= 1 << (i % 8)
        with pytest.raises(frame.FrameError):
            frame.frame_unwrap(mut[1:2], cfg)
        out = codec.decode(torch.from_numpy(mut), cfg, n).numpy()
        assert np.all(np.isnan(out[1])), i
        np.testing.assert_array_equal(_bits(out[0::2]), _bits(clean[0::2]))


# ---------------------------------------------------------------------------
# the device path: per-row NaN poison, bit-exact on clean rows
# ---------------------------------------------------------------------------

def test_traced_clean_passthrough_bit_exact():
    wire = torch.from_numpy(_wire(rows=3))
    out = codec.decode(wire, CFG, N)
    raw = codec.decode(wire[:, FRAME_HEADER_BYTES:].contiguous(),
                       CFG.with_framed(False), N)
    np.testing.assert_array_equal(_bits(out), _bits(raw))
    assert torch.isfinite(out).all()
    for dt in (torch.bfloat16, torch.float16):
        got = codec.decode(wire, CFG, N, out_dtype=dt)
        assert got.dtype == dt and torch.equal(got, raw.to(dt))


def test_traced_poisons_exactly_the_corrupt_rows():
    wire = _wire(rows=3)
    host = codec.decode(torch.from_numpy(wire), CFG, N).numpy()
    bad = wire.copy()
    bad[1, FRAME_HEADER_BYTES + 7] ^= 0x10      # payload corruption
    bad[2, 4] ^= 0x01                           # header corruption
    out = codec.decode(torch.from_numpy(bad), CFG, N).numpy()
    np.testing.assert_array_equal(_bits(out[0]), _bits(host[0]))
    assert np.all(np.isnan(out[1])) and np.all(np.isnan(out[2]))
    jout = np.asarray(jax.jit(lambda b: jcodec.decode(b, JCFG, N))(
        jnp.asarray(bad)))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(jout))


def test_traced_truncation_is_a_static_error():
    wire = torch.from_numpy(_wire())
    with pytest.raises(frame.FrameTruncatedError):
        codec.decode(wire[:, :-4], CFG, N)
    with pytest.raises(frame.FrameTruncatedError):
        codec.decode(wire[:, :FRAME_HEADER_BYTES - 2], CFG, N)
    with pytest.raises(frame.FrameLengthError):
        codec.decode(torch.cat([wire, wire[:, :2]], dim=1), CFG, N)


def test_wire_kernels_take_the_raw_payload():
    """The wire kernels' wrappers refuse a framed config: the codec
    frames their raw payload."""
    from repro_torch.kernels import wire
    with pytest.raises(ValueError, match="raw payload"):
        wire._check_cfg(CFG)


# ---------------------------------------------------------------------------
# framed golden vectors
# ---------------------------------------------------------------------------

def _golden_cfg(key):
    stem = key[len("frame_"):]
    bits = int(stem.split("_")[0][len("int"):])
    jc = golden_cfg(bits, stem.endswith("_sr"), stem.endswith("_rot"))
    return CommConfig(bits=jc.bits, group=jc.group, spike=jc.spike,
                      rotation=jc.rotation, framed=True)


def test_framed_golden_keys_exist():
    assert FRAME_KEYS == sorted(
        f"frame_int{b}{t}" for b in (2, 4, 8)
        for t in ("", "_sr", "_rot"))


@pytest.mark.parametrize("key", FRAME_KEYS)
def test_framed_encode_matches_golden(key):
    """Byte for byte; decoded (device path) bit-equal to the unframed
    decode of the raw golden, and self-describing on the host."""
    cfg = _golden_cfg(key)
    x = torch.from_numpy(_DATA["x"])
    buf = codec.encode(x, cfg).numpy()
    np.testing.assert_array_equal(buf, _DATA[key])
    assert _DATA[key].shape[-1] == cfg.wire_bytes(x.shape[-1])
    raw_key = key[len("frame_"):]
    raw = codec.decode(torch.from_numpy(_DATA[raw_key]),
                       cfg.with_framed(False), x.shape[-1])
    dec = codec.decode(torch.from_numpy(_DATA[key]), cfg, x.shape[-1])
    np.testing.assert_array_equal(_bits(dec), _bits(raw))
    y = frame.frame_decode(_DATA[key])
    assert y.shape == x.shape and torch.isfinite(y).all()
    np.testing.assert_array_equal(_bits(y), _bits(raw))


# ---------------------------------------------------------------------------
# the bridge site and the launcher
# ---------------------------------------------------------------------------

def test_framed_bridge_policy_matches_jax():
    """with_framed_bridge installs the framed bridge config JAX installs,
    and pod_grad_config resolves it (else the grad site's)."""
    inner = dict(bits=4, group=32)
    for bits in (8, 4, 2):
        pol = with_framed_bridge(CommPolicy(grad=uniform(CommConfig(
            **inner))), bits=bits)
        jpol = jwith_framed_bridge(JPolicy(grad=juniform(JConfig(**inner))),
                                   bits=bits)
        got, want = pod_grad_config(pol), jpod_grad_config(jpol)
        fields = ("bits", "group", "spike", "rotation", "scale_int",
                  "theta", "scheme", "framed", "enabled")
        assert [getattr(got, f) for f in fields] == \
            [getattr(want, f) for f in fields]
        assert got.framed and got.scheme == "hier_pp"
    assert pod_grad_config(CommPolicy(grad=uniform(CommConfig(**inner)))) \
        == CommConfig(**inner)
    pol = with_framed_bridge(paper_policy(backend="ref"), 8)
    assert pod_grad_config(pol).backend == "ref"
    with pytest.raises(AssertionError):
        CommConfig(framed=True, scheme="fused")


def test_train_cli_framed_bridge_cpu():
    """``--mesh 1,1,2 --framed-bridge 4 --device cpu`` trains the smoke
    config on two gloo ranks, its losses finite."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3-8b", "--smoke", "--mesh", "1,1,2", "--framed-bridge", "4",
         "--steps", "2", "--device", "cpu", "--seq", "16", "--batch", "4",
         "--log-every", "1"], env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "framed: bridge +16 B/frame header" in out.stdout
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert np.isfinite(res["first_loss"]) and np.isfinite(res["last_loss"])


@pytest.fixture(scope="module")
def framed_run(tmp_path_factory):
    return worker.run(str(tmp_path_factory.mktemp("framed112")), "1,1,2",
                      ("framed",))


def test_framed_bridge_training_equals_unframed(framed_run):
    """Two gloo ranks at pod = 2, two steps from one store: the framed
    bridge (int8 g128 hier_pp in frames) gives the loss, grad norm and
    every parameter of the same bridge unframed, and of paper's grad site
    (int8 g128 hierarchical: the two-step on one axis), bit for bit; its
    CRC ran once an encode and once a decode."""
    ranks, _ = framed_run
    for r in ranks:
        keys = [k for k in r.files if k.startswith("eq/framed/")]
        assert len(keys) == 3 * worker.FRAMED_STEPS + int(r["eq/leaves"])
        for name in ("unframed", "paper"):
            for key in keys:
                other = key.replace("eq/framed/", f"eq/{name}/", 1)
                np.testing.assert_array_equal(
                    np.atleast_1d(r[key]).view(np.uint8),
                    np.atleast_1d(r[other]).view(np.uint8),
                    err_msg=f"{key} vs {other}")
        assert int(r["eq/framed_crc_calls"]) == \
            4 * int(r["eq/leaves"]) * worker.FRAMED_STEPS
        assert int(r["eq/unframed_crc_calls"]) == \
            int(r["eq/paper_crc_calls"]) == 0
        assert all(np.all(np.isfinite(r[k])) for k in keys)
    for key in ranks[0].files:
        if key.startswith("eq/") and "/store/" not in key:
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


def test_framed_bridge_train_steps_match_jax(framed_run):
    """JAX's jitted train step with ``with_framed_bridge(paper, 8)`` on a
    (pod 2, data 1, model 1) mesh of two fake CPU devices against two gloo
    ranks of the port, three steps from the same store, each step after
    the first from JAX's weights: loss, grad norm, store, m and v within
    paper's bounds (``worker.check``)."""
    ranks, want = framed_run
    worker.check(ranks, want["framed"], "framed")
