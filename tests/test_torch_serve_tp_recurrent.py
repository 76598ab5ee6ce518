"""Serving the recurrentgemma-2b and xlstm-125m smoke configs at tp = 2:
the port's gloo ranks against the JAX package on a (1, 2) mesh.

recurrentgemma's single kv head is replicated at tp = 2 (the decode
cache a sequence-sharded ring); its RG-LRU channels and xlstm's heads are
sharded. Both packages run recurrentgemma with its window cut from the
smoke config's 64 to ``REC_WINDOW`` = 8, shorter than the 12-token
prompts, so that the decode's local ring (8 slots, 4 a rank) wraps
(``tests/test_torch_recurrent.py`` wraps the window of 64 at tp = 1).

The JAX side runs in one subprocess of this file for both archs
(``python tests/test_torch_serve_tp_recurrent.py jax OUT_DIR``, two fake
CPU devices): for each it builds the weights (``build_store`` at tp = 2,
float32, with a crc32 in place of the salted ``hash``; every
zero-initialised array, RG-LRU's gate vectors included, filled from a
seeded normal, the same values on every rank for a replicated one, as
xlstm's LayerNorm biases) and saves them first (``OUT_DIR/ARCH/
store.npz``), then the prefill's hidden states under paper and bf16, and
for xlstm its decode steps' tokens (the prompt teacher-forced, then
greedy), in ``OUT_DIR/ARCH/jax.npz``. Two gloo ranks
(``tests/_torch_gloo_worker.py`` mode ``serve_rec``), started beside it,
load their shards with ``load_jax_store(rank=r)`` once the stores are
there and serve both archs under paper/two_step, paper/fused and bf16.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_gloo_worker as worker  # noqa: E402
from test_torch_serve_tp import ROOT, TP, _run  # noqa: E402

ARCHS = worker.REC_ARCHS


def _jax_reference(out_dir: str) -> None:
    """The JAX side (run in its own process, see the module docstring)."""
    import dataclasses
    import zlib

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.configs import get_smoke_config
    from repro.core.policy import BF16_POLICY, paper_policy, with_backend
    from repro.launch.mesh import make_test_mesh
    from repro.models import model as jmodel
    from repro.parallel import shardings as jshard
    from repro.parallel.plan import make_plan
    from repro.train import serve_step
    from repro.train.data import DataConfig, make_dataset

    mesh = make_test_mesh(1, TP)
    # a crc32 in place of the per-process salted hash(name) of build_store
    jshard.hash = lambda s: zlib.crc32(s.encode())
    made = {}
    for arch in ARCHS:                # every arch's store first: the ranks,
        cfg = get_smoke_config(arch)  # started beside this, wait for them
        cfg = dataclasses.replace(cfg, dtype="float32", window=cfg.window
                                  and worker.REC_WINDOW)
        plan = make_plan(cfg, tp=TP, fsdp=1)
        groups = jmodel.param_groups(cfg, plan)
        store = jshard.build_store(groups, plan, jax.random.PRNGKey(0),
                                   jnp.float32)
        rng = np.random.default_rng(7)
        out, store_np = {}, {}
        for g, arrs in sorted(store.items()):
            store_np[g] = {}
            for name, a in sorted(arrs.items()):
                a = np.array(a)
                if not a.any():                  # zero-initialised
                    n, tp, flat = a.shape
                    # a replicated parameter (xlstm's LayerNorm biases)
                    # holds the same values on every rank
                    sliced = groups[g][1][name].tp_dim is not None
                    a = np.broadcast_to(rng.standard_normal(
                        (n, tp if sliced else 1, flat)) * 0.05,
                        a.shape).astype(np.float32)
                store_np[g][name] = out[f"store/{g}/{name}"] = a
        os.makedirs(os.path.join(out_dir, arch), exist_ok=True)
        worker.save_npz(os.path.join(out_dir, arch, "store.npz"), **out)
        made[arch] = cfg, plan, store_np, out
    for arch in ARCHS:
        cfg, plan, store_np, out = made[arch]
        jstore = jax.tree_util.tree_map(jnp.asarray, store_np)
        toks = make_dataset(DataConfig(
            vocab=cfg.vocab, seq_len=worker.SERVE_S,
            global_batch=worker.SERVE_B)).batch(0)["tokens"]
        for name, pol in (("paper", with_backend(paper_policy(), "ref")),
                          ("bf16", BF16_POLICY)):
            def hidden_fn(st, t, pol=pol):
                return jmodel.forward(st, t, cfg, plan, pol,
                                      dtype=jnp.float32)[0]
            h = compat.shard_map(hidden_fn, mesh=mesh,
                                 in_specs=(jshard.store_spec(plan), P()),
                                 out_specs=P(), check_vma=False)
            out[f"{name}/hidden"] = np.asarray(jax.jit(h)(
                jstore, jnp.asarray(toks)))
            if plan.kv_mode == "shard":         # JAX's ring decode is wrong
                out[f"{name}/decode_tokens"] = _jax_decode(
                    serve_step, cfg, plan, pol, mesh, jstore, toks)
        np.savez(os.path.join(out_dir, arch, "jax.npz"), **out)


def _jax_decode(serve_step, cfg, plan, pol, mesh, jstore, toks):
    """JAX's decode loop: the prompt teacher-forced, then greedy -> the
    token after each step, (B, S + gen - 1): the first S after each
    prompt position, the last gen the generated ones."""
    import jax.numpy as jnp
    b, s = toks.shape
    gen = worker.serve_gen(plan)
    cache = serve_step.make_cache_init(cfg, plan, mesh, b, s + gen)()
    step = serve_step.make_decode_step(cfg, plan, pol, mesh, b, s + gen)
    out, tok = [], toks[:, :1]
    for i in range(s + gen - 1):
        nt, cache = step(jstore, cache, {"tokens": jnp.asarray(
            tok, jnp.int32)})
        out.append(np.asarray(nt))
        tok = toks[:, i + 1:i + 2] if i + 1 < s else out[-1][:, None]
    return np.stack(out, 1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX reference and, beside it, two gloo ranks serving from its
    weights once it has saved them: {arch: (jax.npz, [rank0.npz,
    rank1.npz])}."""
    out = tmp_path_factory.mktemp("serve_tp_rec")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={TP}")
    script = os.path.join(ROOT, "tests", "_torch_gloo_worker.py")
    _run([[sys.executable, os.path.abspath(__file__), "jax", str(out)]]
         + [[sys.executable, script, str(r), str(TP), str(out / "rdv"),
             str(out), "serve_rec"] for r in range(TP)], env)
    return {a: (np.load(out / a / "jax.npz"),
                [np.load(out / a / f"rank{r}.npz") for r in range(TP)])
            for a in ARCHS}


def _jax_logits(jax_out, pol: str, d: int) -> np.ndarray:
    """JAX's prefill logits at every position (B, S, vocab), float64: its
    hidden states times the unembedding its store holds (the ranks'
    vocabulary shards in rank order)."""
    unemb = jax_out["store/out/unemb"][0]              # (tp, flat)
    v_loc = -(-512 // TP)
    rows = unemb[:, :v_loc * d].reshape(TP * v_loc, d)[:512]
    return jax_out[f"{pol}/hidden"].astype(np.float64) @ rows.T


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("run", list(worker.SERVE_RUNS))
def test_prefill_matches_jax(served, run, arch):
    """Each rank's prefill hidden states agree with JAX's: within 2e-4 of
    their max magnitude without the codec (float32 order; measured
    1.6e-6 at most). Under the paper policy an int8 site's code can flip
    where float32 order moves a sum of tp partials across a rounding
    boundary, and a recurrence carries the flip to every later position
    of its row (``tests/test_torch_recurrent.py``): within two int8 steps
    of the widest group of a sum of two partials, 4 max|h| / 255
    (measured: recurrentgemma 0.0071 max|h|, xlstm no flip, 1.2e-7). The
    greedy tokens over the vocabulary shards are JAX's (argmax of its
    logits), and both ranks hold the same bits."""
    jax_out, ranks = served[arch]
    pol = run.split("/")[0]
    want = jax_out[f"{pol}/hidden"]
    hmax = np.abs(want).max()
    for r, res in enumerate(ranks):
        h = res[f"{run}/hidden"]
        np.testing.assert_array_equal(h.view(np.uint32),
                                      ranks[0][f"{run}/hidden"].view(
                                          np.uint32))
        diff = np.abs(h - want).max()
        bound = 2e-4 * hmax if pol == "bf16" else 4 * hmax / 255
        assert diff <= bound, (r, diff, bound)
        np.testing.assert_array_equal(
            res[f"{run}/token"],
            _jax_logits(jax_out, pol, want.shape[-1])[:, -1].argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_equals_two_step(served, arch):
    """On each rank the fused AllReduce gives two_step's bits: the prefill
    hidden states, the decode steps' logits through the prompt (through
    recurrentgemma's ring), and every token of the served decode loop."""
    _, ranks = served[arch]
    for res in ranks:
        for key in ("hidden", "decode_logits"):
            np.testing.assert_array_equal(
                res[f"paper/fused/{key}"].view(np.uint32),
                res[f"paper/two_step/{key}"].view(np.uint32))
        np.testing.assert_array_equal(res["paper/fused/generated"],
                                      res["paper/two_step/generated"])


@pytest.mark.parametrize("run", list(worker.SERVE_RUNS))
def test_xlstm_decode_tokens_match_jax(served, run):
    """xlstm-125m at tp = 2 (its heads and states sharded, no positions):
    the decode steps through the prompt give JAX's decode token after
    every position, and serve's decode loop generates JAX's tokens;
    every rank the same."""
    jax_out, ranks = served["xlstm-125m"]
    want = jax_out[f"{run.split('/')[0]}/decode_tokens"]
    s = worker.SERVE_S
    for res in ranks:
        np.testing.assert_array_equal(
            res[f"{run}/decode_logits"].argmax(-1), want[:, :s])
        np.testing.assert_array_equal(res[f"{run}/generated"],
                                      want[:, s - 1:])


@pytest.mark.parametrize("run", list(worker.SERVE_RUNS))
def test_recurrentgemma_ring_decode_matches_prefill(served, run):
    """recurrentgemma-2b at tp = 2: its local block's single kv head is
    replicated, the decode cache a sequence-sharded ring of the window's
    8 slots (4 a rank), which wraps after position 7. The decode
    steps through the prompt give at every position the logits of JAX's
    prefill there (its hidden states times its unembedding): within 2e-4
    of their max magnitude without the codec (measured 1.8e-6); under
    the paper policy within 0.03 of it (flipped codes, see
    test_prefill_matches_jax; measured 0.0082); and the same greedy
    token where the top-2 margin exceeds twice the logits' difference.
    JAX's own ring decode is not the reference (ROADMAP Queue C). Every
    rank holds the same bits, and the ring merges number one a local
    block and decode step of serve's loop."""
    from repro_torch.parallel.plan import make_plan
    jax_out, ranks = served["recurrentgemma-2b"]
    pol = run.split("/")[0]
    want = _jax_logits(jax_out, pol, jax_out[f"{pol}/hidden"].shape[-1])
    lmax = np.abs(want).max()
    got = ranks[0][f"{run}/decode_logits"].astype(np.float64)
    diff = np.abs(got - want)
    bound = (2e-4 if pol == "bf16" else 0.03) * lmax
    assert diff.max() <= bound, (diff.max(), bound)
    top2 = -np.sort(-want, axis=-1)[..., :2]
    held = (top2[..., 0] - top2[..., 1]) > 2 * diff.max(-1)
    assert held.mean() >= 0.5, held.mean()
    assert (got.argmax(-1) == want.argmax(-1))[held].all()
    cfg = worker.serve_config("recurrentgemma-2b")
    plan = make_plan(cfg, tp=TP)
    assert plan.kv_mode == "replicate"
    steps = worker.SERVE_S + worker.serve_gen(plan) - 1
    for res in ranks:
        np.testing.assert_array_equal(
            res[f"{run}/decode_logits"].view(np.uint32),
            ranks[0][f"{run}/decode_logits"].view(np.uint32))
        assert int(res[f"{run}/ring_merges"]) == \
            cfg.layer_kinds.count("local") * steps


def test_serve_cli_mesh_cpu():
    """``--mesh 1,2 --device cpu`` serves both archs end to end in two
    rank processes each (both launched at once)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    logs = _run([[sys.executable, "-m", "repro_torch.launch.serve",
                  "--arch", arch, "--smoke", "--device", "cpu", "--mesh",
                  "1,2", "--batch", "2", "--prompt-len", "6", "--gen", "2",
                  "--comm-scheme", "fused"] for arch in ARCHS], env)
    for log in logs:
        assert "[serve] OK (rank 0 of 2)" in log and "TTFT" in log


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _jax_reference(sys.argv[2])
