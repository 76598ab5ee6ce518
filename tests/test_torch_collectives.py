"""The port's quantized AllReduce held against the JAX package.

* tp = 1: ``repro_torch`` ``compressed_psum`` equals ``repro``'s under
  ``shard_map`` on one device, for the two_step and fused schemes (bit
  for bit, or within the stated FMA bound where XLA contracts).
* ``fused`` equals ``two_step`` bit for bit.
* Two gloo ranks (``tests/_torch_gloo_worker.py``, a ``FileStore`` under
  ``tmp_path``) equal a single-process replay of the schedule with the
  JAX codec.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.core import codec as jcodec
from repro.core import compressed_psum as jax_psum
from repro.core.comm_config import CommConfig as JConfig
from repro.launch.mesh import make_test_mesh
from repro_torch.core import collectives
from repro_torch.core.comm_config import NO_COMPRESSION, CommConfig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_gloo_worker as worker  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

CFGS = [dict(bits=8, group=128), dict(bits=5, group=128, scale_int=True),
        dict(bits=2, group=32, spike=True), dict(bits=3, group=32)]


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("scheme", ["two_step", "fused"])
@pytest.mark.parametrize("kw", CFGS)
def test_compressed_psum_tp1_matches_jax(kw, scheme):
    """A (3, 200) input pads to a tp*group multiple, as in JAX.

    int8 runs the JAX side eagerly (slow, but XLA fuses nothing) and must
    match bit for bit. The others run it under jit, where XLA's CPU
    backend contracts the dequantize ``codes * s + z`` into one FMA; with
    bf16 meta the two roundings agree on these inputs (bit for bit), with
    the f32 Eq.-1 scales of scale_int they differ by one rounding of the
    product in phase 1, which phase 2 can turn into one phase-2
    quantization step at most: |d| <= max|x| * 2 / 31 (int5) is
    asserted there, and exactness on the same config is asserted by
    test_scale_int_matches_jax (eager decode) in test_torch_codec.py.
    """
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 200)) * 2).astype(np.float32)
    x[1, 5] = 25.0
    jc = JConfig(scheme=scheme, backend="ref", **kw)
    f = compat.shard_map(lambda a: jax_psum(a, ("model",), jc),
                         mesh=make_test_mesh(1, 1), in_specs=P(),
                         out_specs=P(), check_vma=False)
    eager = kw["bits"] == 8
    want = np.asarray((f if eager else jax.jit(f))(jnp.asarray(x)))
    got = collectives.compressed_psum(
        torch.from_numpy(x), CommConfig(scheme=scheme, **kw)).numpy()
    if kw.get("scale_int"):
        assert np.abs(got - want).max() <= np.abs(x).max() * 2 / 31
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kw", CFGS)
def test_fused_equals_two_step(kw):
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal((4, 512)) * 3).astype(
        np.float32))
    a = collectives.compressed_psum(x, CommConfig(scheme="two_step", **kw))
    b = collectives.compressed_psum(x, CommConfig(scheme="fused", **kw))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    c = collectives.compressed_psum(x.to(torch.bfloat16),
                                    CommConfig(scheme="hier_pp", **kw))
    assert c.dtype == torch.bfloat16 and c.shape == x.shape


def test_exact_sites_pass_through():
    x = torch.randn(3, 5)
    assert collectives.compressed_psum(x, NO_COMPRESSION) is x
    assert collectives.compressed_psum(
        x, CommConfig(scheme="nccl")) is x


def _replay(x_all: np.ndarray, jc: JConfig) -> np.ndarray:
    """The two-step schedule over tp ranks, one process, JAX codec."""
    tp, n = x_all.shape
    chunk = n // tp
    wires = [np.asarray(jcodec.encode(jnp.asarray(x.reshape(tp, chunk)),
                                      jc)) for x in x_all]
    full = []
    for p in range(tp):                 # rank p owns chunk p
        acc = np.zeros(chunk, np.float32)
        for r in range(tp):
            acc = acc + np.asarray(jcodec.decode(jnp.asarray(wires[r][p]),
                                                 jc, chunk))
        w2 = jcodec.encode(jnp.asarray(acc), jc)
        full.append(np.asarray(jcodec.decode(w2, jc, chunk)))
    return np.concatenate(full)


def test_two_rank_gloo_matches_jax_replay(tmp_path):
    world = 2
    init = tmp_path / "store"
    script = os.path.join(os.path.dirname(__file__), "_torch_gloo_worker.py")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(world),
                               str(init), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    x_all = worker.inputs(world)     # the replay, while the ranks run
    wants = {name: _replay(x_all, JConfig(backend="ref", **kw))
             for name, kw in worker.CONFIGS.items()}
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0].decode())
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    for name, want in wants.items():
        for r in range(world):
            res = np.load(tmp_path / f"rank{r}.npz")
            for scheme in ("two_step", "fused"):
                np.testing.assert_array_equal(
                    _bits(res[f"{name}_{scheme}"]), _bits(want),
                    err_msg=f"rank {r} {name} {scheme}")
