"""Serving the qwen3-14b and llama3-8b smoke configs at tp = 2, and the
glm4-9b smoke config at tp = 4 (two kv heads: replicated, the decode
cache a sequence-sharded ring): the port's gloo ranks against the JAX
package on a (1, tp) mesh.

The JAX side runs in a subprocess of this file (``python
tests/test_torch_serve_tp.py jax OUT_DIR ARCH TP``) with tp fake CPU
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=TP``): it
builds the
weights (``build_store`` at tp = 2, float32, the zero-initialised output
projections filled from a seeded normal so that every TP site carries
data) and saves them first (``store.npz``), then the prefill's hidden
states and greedy next tokens under
``shard_map``, its jitted ``fused`` AllReduce on the gloo worker's
inputs, and (in replicate mode) its decode steps' tokens through the
prompt, and saves them. tp gloo ranks (``tests/_torch_gloo_worker.py`` mode
``serve``, ``serve_llama`` or ``serve_glm4``), started beside it, load
their shards of the same weights with ``load_jax_store(rank=r)`` once
``store.npz`` is there and serve under paper/two_step, paper/fused and
bf16.
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
from _torch_threads import one_torch_thread  # noqa: E402,F401

TP = 2


def _jax_reference(out_dir: str, arch: str = "qwen3-14b",
                   tp: int = TP) -> None:
    """The JAX side (run in its own process, see the module docstring),
    for the smoke config of ``arch`` at ``tp``; the fused AllReduce's
    outputs for the dense configs only."""
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
    plan = make_plan(cfg, tp=tp, fsdp=1)
    mesh = make_test_mesh(1, tp)
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
    # the ranks, started beside this process, wait for the store
    worker.save_npz(os.path.join(out_dir, "store.npz"), **out)
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
        if plan.kv_mode == "replicate":
            out[f"{name}/decode_tokens"] = _jax_decode(
                serve_step, cfg, plan, pol, mesh, jstore, np.asarray(toks))
    x = jnp.asarray(worker.inputs(tp))
    for name, kw in worker.CONFIGS.items() if cfg.moe is None else ():
        jc = CommConfig(scheme="fused", backend="ref", **kw)
        f = compat.shard_map(
            lambda a, jc=jc: compressed_psum(a[0], ("model",), jc)[None],
            mesh=mesh, in_specs=P("model"), out_specs=P("model"),
            check_vma=False)
        out[f"ar/{name}"] = np.asarray(jax.jit(f)(x))
    np.savez(os.path.join(out_dir, "jax.npz"), **out)


def _jax_decode(serve_step, cfg, plan, pol, mesh, jstore, toks):
    """JAX's decode steps through the prompt (teacher-forced) -> the
    greedy token after each position (B, S)."""
    import jax.numpy as jnp
    b, s = toks.shape
    clen = s + worker.serve_gen(plan)
    cache = serve_step.make_cache_init(cfg, plan, mesh, b, clen)()
    step = serve_step.make_decode_step(cfg, plan, pol, mesh, b, clen)
    out = []
    for i in range(s):
        nt, cache = step(jstore, cache, {"tokens": jnp.asarray(
            toks[:, i:i + 1], jnp.int32)})
        out.append(np.asarray(nt))
    return np.stack(out, 1)


def _run(cmd, env, timeout=240):
    """Run the commands ``cmd`` at once; when one fails, kill the others
    (a rank may be waiting for a file of the one that failed)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for c in cmd]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0].decode())
        finally:
            for q in procs if p.returncode else ():
                q.kill()
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return logs


#: the dense smoke configs served here, each with its worker mode and tp
ARCH_MODES = {"qwen3-14b": ("serve", TP), "llama3-8b": ("serve_llama", TP),
              "glm4-9b": ("serve_glm4", 4)}


_SERVED = {}


def _serve(arch: str, tmp_path_factory):
    """The JAX reference and, beside it, tp gloo ranks serving from its
    weights (each waits for its ``store.npz``), for ``arch`` (made once a
    process): (jax.npz, [rank0.npz, ...])."""
    if arch not in _SERVED:
        mode, tp = ARCH_MODES[arch]
        out = tmp_path_factory.mktemp("serve_tp")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={tp}")
        script = os.path.join(ROOT, "tests", "_torch_gloo_worker.py")
        _run([[sys.executable, os.path.abspath(__file__), "jax", str(out),
               arch, str(tp)]]
             + [[sys.executable, script, str(r), str(tp), str(out / "rdv"),
                 str(out), mode] for r in range(tp)], env)
        _SERVED[arch] = (np.load(out / "jax.npz"),
                         [np.load(out / f"rank{r}.npz") for r in range(tp)])
    return _SERVED[arch]


@pytest.fixture(scope="module", params=list(ARCH_MODES))
def served(tmp_path_factory, request):
    """Each dense arch's JAX reference and ranks (:func:`_serve`)."""
    return _serve(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def served_glm4(tmp_path_factory):
    """glm4-9b's at tp = 4 (replicate mode), the one run of ``served``."""
    return _serve("glm4-9b", tmp_path_factory)


@pytest.mark.parametrize("run", list(worker.SERVE_RUNS))
def test_prefill_matches_jax(served, run):
    """Each rank's prefill hidden states agree with JAX's to 2e-4 of their
    max magnitude without the codec (float32 summation order and RoPE's
    last ulp differ). Under the paper policy an int8 site can turn such a
    difference, or JAX's FMA-contracted decode under jit (ROADMAP Queue
    C), into one code step of a group; the step moves that token's whole
    hidden state in the next layers, and later positions of its sequence
    through attention (here 2 of the 24 positions at tp = 2, 4 at
    tp = 4), so there the bound is one int8 step of the widest group of a
    sum of tp partials (tp max|h| / 255: 2 max|h| / 255 at tp = 2; at
    tp = 4 measured 0.0119 max|h|, the bound 0.0157) on every element,
    and at most a quarter of the positions move by more than the float32
    bound. The greedy tokens over the vocabulary shards equal JAX's. All
    ranks hold the same bits."""
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
        bound = 2e-4 * hmax if pol == "bf16" else len(ranks) * hmax / 255
        assert diff.max() <= bound, (r, diff.max(), bound)
        assert np.mean(diff.max(-1) > 2e-4 * hmax) <= 0.25, r
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
def test_ranks_generate_alike(served, run, request):
    """serve's decode loop (prompt teacher-forced, prefill/decode
    agreement checked inside) gives every rank the same tokens, each in
    the vocabulary."""
    from repro_torch.parallel.plan import make_plan
    _, ranks = served
    arch = request.node.callspec.params["served"]
    plan = make_plan(worker.serve_config(arch), tp=ARCH_MODES[arch][1])
    gen = ranks[0][f"{run}/generated"]
    assert gen.shape == (worker.SERVE_B, worker.serve_gen(plan))
    assert ((gen >= 0) & (gen < 512)).all()
    for res in ranks[1:]:
        np.testing.assert_array_equal(res[f"{run}/generated"], gen)


def test_greedy_first_maximum_wins(served):
    """A tie across the shards goes to the lower rank's column, as JAX's
    argmax over the gathered maxima does."""
    _, ranks = served
    for res in ranks:
        assert res["tie"].tolist() == [1, 5]


def _jax_logits(jax_out, pol: str) -> np.ndarray:
    """JAX's prefill logits at every position (B, S, vocab), float64: its
    hidden states times the unembedding its store holds (the ranks'
    vocabulary shards in rank order)."""
    unemb = jax_out["store/out/unemb"][0]              # (tp, flat)
    tp = unemb.shape[0]
    v_loc = -(-512 // tp)
    rows = unemb[:, :v_loc * 256].reshape(tp * v_loc, 256)[:512]
    return jax_out[f"{pol}/hidden"].astype(np.float64) @ rows.T


@pytest.mark.parametrize("run", list(worker.SERVE_RUNS))
def test_ring_decode_matches_prefill(served_glm4, run):
    """glm4-9b at tp = 4 (replicate mode): the decode steps through the
    prompt, each through the sequence-sharded ring (the owner rank writes
    the position, q gathered, every rank's partials of every head sent
    to the head's rank and merged), give at every position the logits of
    JAX's prefill there (its hidden states times its unembedding): within
    2e-4 of their max magnitude without the codec (measured 8.3e-7),
    within 0.03 of it under the paper policy (the int8 code step of
    test_prefill_matches_jax moves 4 of the 24 positions; measured
    0.0147, the rest bit for bit), and the same greedy token where the
    top-2 margin exceeds twice the logits' difference. Every rank holds
    the same bits, and the merges number one a layer and decode step of
    serve's loop.

    JAX's own ring decode merges the partials of each rank's own heads
    as if they were one head's, so its tokens disagree with its prefill's
    (ROADMAP Queue C): on more than half of these positions (measured:
    all 24), where the port's agree on every position held."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.parallel.plan import make_plan
    jax_out, ranks = served_glm4
    pol = run.split("/")[0]
    want = _jax_logits(jax_out, pol)
    lmax = np.abs(want).max()
    got = ranks[0][f"{run}/decode_logits"].astype(np.float64)
    diff = np.abs(got - want)
    bound = (2e-4 if pol == "bf16" else 0.03) * lmax
    assert diff.max() <= bound, (diff.max(), bound)
    top2 = -np.sort(-want, axis=-1)[..., :2]
    held = (top2[..., 0] - top2[..., 1]) > 2 * diff.max(-1)
    assert held.mean() >= 0.5, held.mean()
    assert (got.argmax(-1) == want.argmax(-1))[held].all()
    jax_tokens = jax_out[f"{pol}/decode_tokens"]
    assert np.mean(jax_tokens != want.argmax(-1)) > 0.5
    cfg = get_smoke_config("glm4-9b")
    plan = make_plan(cfg, tp=len(ranks))
    steps = worker.SERVE_S + worker.serve_gen(plan) - 1
    for res in ranks:
        np.testing.assert_array_equal(
            res[f"{run}/decode_logits"].view(np.uint32),
            ranks[0][f"{run}/decode_logits"].view(np.uint32))
        assert int(res[f"{run}/ring_merges"]) == cfg.n_layers * steps


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
    x = worker.inputs(len(served[1]))
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
    processes. ``--mesh`` takes DATA,MODEL of positive sizes, data
    parallelism (DATA > 1) included (``tests/test_torch_serve_dp.py``
    serves it); anything else is refused."""
    from repro_torch.launch.mesh import parse_mesh
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    log = _run([[sys.executable, "-m", "repro_torch.launch.serve",
                 "--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                 "--mesh", "1,2", "--batch", "2", "--prompt-len", "6",
                 "--gen", "2", "--comm-scheme", "fused"]], env)[0]
    assert "[serve] OK (rank 0 of 2)" in log and "TTFT" in log
    assert parse_mesh("2,1") == (2, 1) and parse_mesh("4,2") == (4, 2)
    for bad in ("2,0", "0,1", "1,2,2"):
        with pytest.raises(ValueError, match="DATA,MODEL"):
            parse_mesh(bad)


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _jax_reference(*sys.argv[2:4], *map(int, sys.argv[4:5]))
