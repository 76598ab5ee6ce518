"""Serving the qwen3-14b and llama3-8b smoke configs at tp = 2: the
port's gloo ranks against the JAX package on a (1, 2) mesh.

The JAX side runs in a subprocess of this file (``python
tests/test_torch_serve_tp.py jax OUT_DIR``) with two fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=2``): it builds the
weights (``build_store`` at tp = 2, float32, the zero-initialised output
projections filled from a seeded normal so that every TP site carries
data), the prefill's hidden states and greedy next tokens under
``shard_map``, and its jitted ``fused`` AllReduce on the gloo worker's
inputs, and saves them. Two gloo ranks (``tests/_torch_gloo_worker.py``
mode ``serve``) then load their shards of the same weights with
``load_jax_store(rank=r)`` and serve under paper/two_step, paper/fused
and bf16.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_gloo_worker as worker  # noqa: E402

TP = 2


def _jax_reference(out_dir: str, arch: str = "qwen3-14b") -> None:
    """The JAX side (run in its own process, see the module docstring),
    for the smoke config of ``arch``; the fused AllReduce's outputs for
    qwen3-14b's only."""
    import dataclasses
    import zlib

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.configs import get_smoke_config
    from repro.core import compressed_psum
    from repro.core.comm_config import CommConfig
    from repro.core.policy import BF16_POLICY, paper_policy, with_backend
    from repro.launch.mesh import make_test_mesh
    from repro.models import model as jmodel
    from repro.parallel import shardings as jshard
    from repro.parallel.plan import make_plan
    from repro.train import serve_step
    from repro.train.data import DataConfig, make_dataset

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    plan = make_plan(cfg, tp=TP, fsdp=1)
    mesh = make_test_mesh(1, TP)
    # a crc32 in place of the per-process salted hash(name) of build_store
    jshard.hash = lambda s: zlib.crc32(s.encode())
    store = jshard.build_store(jmodel.param_groups(cfg, plan), plan,
                               jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(7)
    out, store_np = {}, {}
    for g, arrs in sorted(store.items()):
        store_np[g] = {}
        for name, a in sorted(arrs.items()):
            a = np.array(a)
            if not a.any():                      # zero-init projections
                a = (rng.standard_normal(a.shape) * 0.05).astype(np.float32)
            store_np[g][name] = out[f"store/{g}/{name}"] = a
    jstore = jax.tree_util.tree_map(jnp.asarray, store_np)
    toks = jnp.asarray(make_dataset(DataConfig(
        vocab=cfg.vocab, seq_len=worker.SERVE_S,
        global_batch=worker.SERVE_B)).batch(0)["tokens"])
    for name, pol in (("paper", with_backend(paper_policy(), "ref")),
                      ("bf16", BF16_POLICY)):
        def hidden_fn(st, t, pol=pol):
            return jmodel.forward(st, t, cfg, plan, pol,
                                  dtype=jnp.float32)[0]
        h = compat.shard_map(hidden_fn, mesh=mesh,
                             in_specs=(jshard.store_spec(plan), P()),
                             out_specs=P(), check_vma=False)
        out[f"{name}/hidden"] = np.asarray(jax.jit(h)(jstore, toks))
        prefill = serve_step.make_prefill(cfg, plan, pol, mesh,
                                          worker.SERVE_B)
        out[f"{name}/token"] = np.asarray(prefill(jstore, {"tokens": toks}))
    x = jnp.asarray(worker.inputs(TP))
    for name, kw in worker.CONFIGS.items() if cfg.moe is None else ():
        jc = CommConfig(scheme="fused", backend="ref", **kw)
        f = compat.shard_map(
            lambda a, jc=jc: compressed_psum(a[0], ("model",), jc)[None],
            mesh=mesh, in_specs=P("model"), out_specs=P("model"),
            check_vma=False)
        out[f"ar/{name}"] = np.asarray(jax.jit(f)(x))
    np.savez(os.path.join(out_dir, "jax.npz"), **out)


def _run(cmd, env, timeout=240):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for c in cmd]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0].decode())
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return logs


#: the dense smoke configs served here, each with its worker mode
ARCH_MODES = {"qwen3-14b": "serve", "llama3-8b": "serve_llama"}


@pytest.fixture(scope="module", params=list(ARCH_MODES))
def served(tmp_path_factory, request):
    """The JAX reference, then two gloo ranks serving from its weights,
    for each dense arch: (jax.npz, [rank0.npz, rank1.npz])."""
    arch = request.param
    out = tmp_path_factory.mktemp("serve_tp")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    _run([[sys.executable, os.path.abspath(__file__), "jax", str(out),
           arch]], env)
    script = os.path.join(ROOT, "tests", "_torch_gloo_worker.py")
    _run([[sys.executable, script, str(r), str(TP), str(out / "store"),
           str(out), ARCH_MODES[arch]] for r in range(TP)], env)
    return (np.load(out / "jax.npz"),
            [np.load(out / f"rank{r}.npz") for r in range(TP)])


@pytest.mark.parametrize("run", list(worker.SERVE_RUNS))
def test_prefill_matches_jax(served, run):
    """Each rank's prefill hidden states agree with JAX's to 2e-4 of their
    max magnitude without the codec (float32 summation order and RoPE's
    last ulp differ). Under the paper policy an int8 site can turn such a
    difference, or JAX's FMA-contracted decode under jit (ROADMAP Queue
    C), into one code step of a group; the step moves that token's whole
    hidden state in the next layers, and later positions of its sequence
    through attention (here 2 of the 24 positions), so there the bound is
    one int8 step of the widest group (2 max|h| / 255) on every element.
    The greedy tokens over the vocabulary shards equal JAX's. Both ranks
    hold the same bits."""
    jax_out, ranks = served
    pol = run.split("/")[0]
    want = jax_out[f"{pol}/hidden"]
    hmax = np.abs(want).max()
    for r, res in enumerate(ranks):
        h = res[f"{run}/hidden"]
        np.testing.assert_array_equal(h.view(np.uint32),
                                      ranks[0][f"{run}/hidden"].view(
                                          np.uint32))
        diff = np.abs(h - want)
        bound = 2e-4 * hmax if pol == "bf16" else 2 * hmax / 255
        assert diff.max() <= bound, (r, diff.max(), bound)
        np.testing.assert_array_equal(res[f"{run}/token"],
                                      jax_out[f"{pol}/token"])


def test_fused_equals_two_step(served):
    """On each rank the fused AllReduce gives two_step's bits: the prefill
    hidden states, and every token of the served decode loop."""
    _, ranks = served
    for res in ranks:
        np.testing.assert_array_equal(
            res["paper/fused/hidden"].view(np.uint32),
            res["paper/two_step/hidden"].view(np.uint32))
        np.testing.assert_array_equal(res["paper/fused/generated"],
                                      res["paper/two_step/generated"])


@pytest.mark.parametrize("run", list(worker.SERVE_RUNS))
def test_ranks_generate_alike(served, run):
    """serve's decode loop (prompt teacher-forced, prefill/decode
    agreement checked inside) gives every rank the same tokens, each in
    the vocabulary."""
    _, ranks = served
    gen = ranks[0][f"{run}/generated"]
    assert gen.shape == (worker.SERVE_B, worker.SERVE_GEN)
    assert ((gen >= 0) & (gen < 512)).all()
    for res in ranks[1:]:
        np.testing.assert_array_equal(res[f"{run}/generated"], gen)


def test_greedy_first_maximum_wins(served):
    """A tie across the shards goes to the lower rank's column, as JAX's
    argmax over the gathered maxima does."""
    _, ranks = served
    for res in ranks:
        assert res["tie"].tolist() == [1, 5]


@pytest.mark.parametrize("name", list(worker.CONFIGS))
def test_plain_allreduce_matches_jax_fused(served, name):
    """The plain fused AllReduce at tp = 2 against JAX's jitted fused
    under shard_map (its phases interpreted on the CPU). The bytes of
    phase 1 agree; XLA contracts the dequantize into an FMA, one rounding
    of the product apart from the port's decode, which phase 2's
    re-quantization can turn into one step of its grid: bit for bit with
    bf16 scales on these inputs, within max|x| * 2 / 31 with the f32
    Eq.-1 scales (as test_torch_collectives.py's tp = 1 test)."""
    from repro_torch.core.comm_config import CommConfig
    from repro_torch.kernels import rdma
    jax_out, _ = served
    kw = worker.CONFIGS[name]
    x = worker.inputs(TP)
    got = rdma.fused_all_reduce_rdma_plain(torch.from_numpy(x),
                                           CommConfig(**kw))[0].numpy()
    want = jax_out[f"ar/{name}"]
    if kw.get("scale_int"):
        assert np.abs(got - want).max() <= np.abs(x).max() * 2 / 31
    else:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_serve_cli_mesh_cpu():
    """``--mesh 1,2 --device cpu`` serves end to end in two rank
    processes; ``--mesh 2,1`` (data parallelism) is refused."""
    from repro_torch.launch import serve as tserve
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    log = _run([[sys.executable, "-m", "repro_torch.launch.serve",
                 "--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                 "--mesh", "1,2", "--batch", "2", "--prompt-len", "6",
                 "--gen", "2", "--comm-scheme", "fused"]], env)[0]
    assert "[serve] OK (rank 0 of 2)" in log and "TTFT" in log
    with pytest.raises(NotImplementedError, match="data > 1"):
        tserve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                     "--mesh", "2,1"])


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _jax_reference(*sys.argv[2:4])
