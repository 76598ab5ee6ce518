"""Data-parallel serving (``--mesh DATA,MODEL``, DATA > 1): the port's
gloo ranks against the JAX package's serve on the same mesh.

The qwen3-14b smoke config (float32) at ``--mesh 2,1`` and ``2,2``,
paper and aggressive. Both sides serve from the flat store that
``_torch_gloo_worker.numpy_store`` makes for the plan (``fsdp = 2``),
each block group gathered over the data axis at every prefill and decode
step: exact under paper, quantized at the ``qag`` site (int4 g32, Eq.-1
scales) under aggressive. The JAX side runs in a subprocess of this file
(``python tests/test_torch_serve_dp.py jax OUT_DIR``) on 4 fake CPU
devices, beside the port's rank processes (``tests/_torch_dp_worker.py``,
2 and 4 of them): for each mesh and policy its prefill hidden states
and greedy next tokens (``forward`` and ``greedy_next_token`` under
``shard_map``, the batch over ``data``), its ``make_decode_step`` loop
(the prompt
teacher-forced, then greedy generation; paper), and at ``2,1`` its
``make_prefill`` tokens of a batch of 3, which ``batch_spec`` replicates.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import _torch_dp_worker as dpw  # noqa: E402
import _torch_gloo_worker as gw  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

MESHES = ((2, 1), (2, 2))


def _jax_reference(out_dir: str) -> None:
    """The JAX side (its own process, 4 fake CPU devices)."""
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.configs import get_smoke_config
    from repro.core.policy import aggressive_policy, paper_policy, \
        with_backend
    from repro.launch.mesh import make_test_mesh
    from repro.models import model as jmodel
    from repro.parallel import shardings as jshard
    from repro.parallel.plan import make_plan
    from repro.train import serve_step
    from repro.train.train_step import batch_spec

    import dataclasses
    cfg = dataclasses.replace(get_smoke_config(dpw.ARCH), dtype="float32",
                              window=None)
    pols = {"paper": with_backend(paper_policy(), "ref"),
            "aggressive": with_backend(aggressive_policy(), "ref")}
    out = {}
    for data, model in MESHES:
        mesh = make_test_mesh(data, model)
        plan = make_plan(cfg, tp=model, fsdp=data)
        store = jax.tree_util.tree_map(jnp.asarray, gw.numpy_store(
            jmodel.param_groups(cfg, plan), plan))
        toks = jnp.asarray(dpw.batch())
        bspec = batch_spec(dpw.B, mesh)
        tag = f"{data},{model}"
        for name, pol in pols.items():
            def prefill_fn(st, t, pol=pol):
                h, unemb, _, _ = jmodel.forward(st, t, cfg, plan, pol,
                                                dtype=jnp.float32)
                return h, jmodel.greedy_next_token(h, unemb, cfg, plan)
            f = compat.shard_map(prefill_fn, mesh=mesh,
                                 in_specs=(jshard.store_spec(plan), bspec),
                                 out_specs=(bspec, bspec), check_vma=False)
            h, t = jax.jit(f)(store, toks)
            out[f"{tag}/{name}/hidden"] = np.asarray(h)
            out[f"{tag}/{name}/token"] = np.asarray(t)
        # JAX's serving steps (paper: the aggressive step's compile takes
        # ~15 s a mesh)
        clen = dpw.S + dpw.GEN
        cache = serve_step.make_cache_init(cfg, plan, mesh, dpw.B, clen)()
        step = serve_step.make_decode_step(cfg, plan, pols["paper"], mesh,
                                           dpw.B, clen)
        tok, gen = toks[:, :1], []
        for i in range(dpw.S + dpw.GEN - 1):
            nt, cache = step(store, cache, {"tokens": tok})
            if i + 1 < dpw.S:
                tok = toks[:, i + 1:i + 2]
            else:
                tok = nt[:, None].astype(jnp.int32)
                gen.append(np.asarray(nt))
        out[f"{tag}/paper/generated"] = np.stack(gen, 1)
        if model == 1:
            odd = jnp.asarray(dpw.batch(dpw.ODD_B))
            out["odd/spec"] = np.array(len(batch_spec(dpw.ODD_B, mesh)))
            prefill = serve_step.make_prefill(cfg, plan, pols["paper"], mesh,
                                              dpw.ODD_B)
            out["odd/token"] = np.asarray(prefill(store, {"tokens": odd}))
    np.savez(os.path.join(out_dir, "jax.npz"), **out)


def _run(cmds, env, timeout=300):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for c in cmds]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0].decode())
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return logs


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{"jax": jax.npz, (data, model): [rank npz, ...]}: the JAX
    subprocess and every mesh's rank processes, all at once."""
    out = tmp_path_factory.mktemp("serve_dp")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cmds = [[sys.executable, os.path.abspath(__file__), "jax", str(out)]]
    for data, model in MESHES:
        d = out / f"{data}x{model}"
        d.mkdir()
        cmds += [[sys.executable, os.path.join(ROOT, "_torch_dp_worker.py"),
                  str(r), str(data), str(model), str(d / "store"), str(d)]
                 for r in range(data * model)]
    _run(cmds, env)
    res = {"jax": np.load(out / "jax.npz")}
    for data, model in MESHES:
        res[(data, model)] = [np.load(out / f"{data}x{model}" / f"rank{r}.npz")
                              for r in range(data * model)]
    return res


def _replicas(ranks, model: int, key: str) -> np.ndarray:
    """The model-rank-0 rank of each replica's ``key``, concatenated in
    data order (the global batch)."""
    return np.concatenate([ranks[d * model][key]
                           for d in range(len(ranks) // model)])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]},{m[1]}")
@pytest.mark.parametrize("pol", dpw.POLICIES)
def test_prefill_matches_jax(served, mesh, pol):
    """Each replica's prefill hidden states (its rows of the batch)
    against JAX's on the same mesh. Every rank of a replica holds the
    same bits. paper (the gather exact): at tp = 1 within 2e-4 of max|h|
    (float32 order; measured 1.3e-7); at tp = 2 float32 order can move
    one int8 code of a sum of two partials (as in
    ``tests/test_torch_serve_tp.py``), which the next layer and the later
    positions of its row carry: within two such steps, 2 tp max|h| / 255
    (measured 0.0113 max|h| at position 5 of row 0 and the two after it;
    the bound 0.0157), and at most a quarter of the positions beyond the
    float32 bound (measured 3 of 32). aggressive (the weights quantized at
    ``qag`` on both sides, the TP sites at int5 with Eq.-1 scales, where
    float32 order moves more codes): within two int5 steps, 2 max|h| / 31
    (measured 0.0210 max|h| at 2,1 and 0.0280 at 2,2; the bound 0.0645).
    The greedy tokens equal JAX's."""
    data, model = mesh
    ranks, jx = served[mesh], served["jax"]
    tag = f"{data},{model}"
    for d in range(data):
        for m in range(1, model):
            np.testing.assert_array_equal(
                ranks[d * model + m][f"{pol}/hidden"].view(np.uint32),
                ranks[d * model][f"{pol}/hidden"].view(np.uint32))
    got = _replicas(ranks, model, f"{pol}/hidden")
    want = jx[f"{tag}/{pol}/hidden"]
    hmax = np.abs(want).max()
    diff = np.abs(got - want)
    if pol == "aggressive":
        bound = 2 * hmax / 31
    else:
        bound = 2e-4 * hmax if model == 1 else 2 * model * hmax / 255
        assert np.mean(diff.max(-1) > 2e-4 * hmax) <= 0.25
    assert diff.max() <= bound, diff.max() / hmax
    np.testing.assert_array_equal(_replicas(ranks, model, f"{pol}/token"),
                                  jx[f"{tag}/{pol}/token"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]},{m[1]}")
@pytest.mark.parametrize("pol", dpw.POLICIES)
def test_serve_matches_jax(served, mesh, pol):
    """``serve``'s decode loop (each replica its rows, prompt
    teacher-forced through the cache, prefill/decode agreement checked
    on each replica) gives, on every rank, the global batch's tokens
    gathered over the data axis: its first tokens JAX's greedy prefill
    tokens, and under paper every generated token JAX's
    ``make_decode_step`` loop's."""
    data, model = mesh
    ranks, jx = served[mesh], served["jax"]
    tag = f"{data},{model}"
    for res in ranks:
        np.testing.assert_array_equal(res[f"{pol}/first"],
                                      jx[f"{tag}/{pol}/token"])
        np.testing.assert_array_equal(res[f"{pol}/generated"],
                                      ranks[0][f"{pol}/generated"])
        if pol == "paper":
            np.testing.assert_array_equal(res[f"{pol}/generated"],
                                          jx[f"{tag}/{pol}/generated"])
    assert ranks[0][f"{pol}/generated"].shape == (dpw.B, dpw.GEN)


def test_dp_equals_alone_bit_for_bit(served):
    """At ``--mesh 2,1`` under paper (the gather exact) each replica's
    prefill logits and the decode steps' logits through the prompt equal,
    bit for bit, those of its rows served alone from the resident weights
    (the ``--mesh 1,1`` road)."""
    for res in served[(2, 1)]:
        for what in ("prefill", "decode"):
            a, b = res[f"alone/dp/{what}"], res[f"alone/alone/{what}"]
            assert a.shape == b.shape and np.isfinite(a).all()
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))


def test_odd_batch_is_replicated(served):
    """A batch of 3 at data = 2: JAX's ``batch_spec`` replicates it
    (``P()``), and so does the port: every replica serves all 3 rows, with
    the same bits, and generates the same tokens; its greedy prefill
    tokens are JAX's."""
    ranks, jx = served[(2, 1)], served["jax"]
    assert int(jx["odd/spec"]) == 0
    for res in ranks:
        assert res["odd/rows"].tolist() == [0, dpw.ODD_B]
        np.testing.assert_array_equal(res["odd/hidden"].view(np.uint32),
                                      ranks[0]["odd/hidden"].view(np.uint32))
        np.testing.assert_array_equal(res["odd/generated"],
                                      ranks[0]["odd/generated"])
        np.testing.assert_array_equal(res["odd/generated"][:, 0],
                                      jx["odd/token"])
    assert ranks[0]["odd/generated"].shape == (dpw.ODD_B, dpw.GEN)


@pytest.mark.parametrize("mesh", ["2,1", "2,2"])
def test_serve_cli_dp_cpu(mesh):
    """``--mesh D,M --device cpu`` (D > 1) serves end to end in D * M
    rank processes under aggressive (the ``qag`` gather), and
    ``parse_mesh`` takes it."""
    from repro_torch.launch.mesh import parse_mesh
    assert parse_mesh(mesh) == tuple(int(v) for v in mesh.split(","))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(os.path.dirname(ROOT), "src"))
    log = _run([[sys.executable, "-m", "repro_torch.launch.serve",
                 "--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                 "--mesh", mesh, "--batch", "4", "--prompt-len", "6",
                 "--gen", "2", "--policy", "aggressive"]], env)[0]
    n = int(mesh[0]) * int(mesh[2])
    assert f"[serve] OK (rank 0 of {n})" in log and "2 a replica" in log


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    sys.path.insert(0, os.path.join(os.path.dirname(ROOT), "src"))
    _jax_reference(sys.argv[2])
