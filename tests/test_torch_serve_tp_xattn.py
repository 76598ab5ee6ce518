"""Serving the whisper-tiny and llama-3.2-vision-11b smoke configs at
tp = 2: the port's gloo ranks against the JAX package on a (1, 2) mesh.

whisper's 2 heads and 2 kv heads are sharded, one a rank, with their
biases: ``bq``, ``bk``, ``bv`` and ``b1`` (and the cross block's
``xb*``) sharded with their weights, ``bo``, ``b2`` and the LayerNorm
biases replicated and added after the TP site. llama's 2 kv heads are
sharded, each rank's 2 q heads sharing its one. Both models attend to
the data stream's embeddings (whisper through its encoder, whose sites
cross the ranks too).

The JAX side runs in one subprocess of this file for both archs
(``python tests/test_torch_serve_tp_xattn.py jax OUT_DIR``, two fake CPU
devices): for each it makes the weights in JAX's store layout at tp = 2
(``_torch_gloo_worker.numpy_store``: every array from a seeded normal,
the same values on every rank for a replicated one), the prefill's
hidden states under paper and bf16 and its decode steps' tokens under
paper (the prompt teacher-forced, then greedy), and saves them in
``OUT_DIR/ARCH/jax.npz``. Beside it, two gloo ranks
(``tests/_torch_gloo_worker.py`` mode ``serve_xattn``) make the same
weights from the port's ``param_groups``, load their shards with
``load_jax_store(rank=r)`` and serve both archs under paper/two_step,
paper/fused and bf16.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_gloo_worker as worker  # noqa: E402
from test_torch_serve_tp import ROOT, TP, _run  # noqa: E402
from test_torch_serve_tp_recurrent import _jax_logits  # noqa: E402

ARCHS = worker.XATTN_ARCHS


def _jax_reference(out_dir: str) -> None:
    """The JAX side (run in its own process, see the module docstring)."""
    import dataclasses

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
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        plan = make_plan(cfg, tp=TP, fsdp=1)
        store_np = worker.numpy_store(jmodel.param_groups(cfg, plan), plan)
        out = {"store/out/unemb": store_np["out"]["unemb"],
               "store_digest": worker.store_digest(store_np)}
        jstore = jax.tree_util.tree_map(jnp.asarray, store_np)
        batch = make_dataset(DataConfig(
            vocab=cfg.vocab, seq_len=worker.SERVE_S,
            global_batch=worker.SERVE_B, enc_ctx=cfg.encoder.n_ctx,
            d_model=cfg.d_model)).batch(0)
        toks, emb = batch["tokens"], batch["enc_embeds"]
        pol_paper = with_backend(paper_policy(), "ref")
        for name, pol in (("paper", pol_paper), ("bf16", BF16_POLICY)):
            def hidden_fn(st, t, e, pol=pol):
                return jmodel.forward(st, t, cfg, plan, pol, enc_embeds=e,
                                      dtype=jnp.float32)[0]
            h = compat.shard_map(hidden_fn, mesh=mesh,
                                 in_specs=(jshard.store_spec(plan), P(),
                                           P()),
                                 out_specs=P(), check_vma=False)
            out[f"{name}/hidden"] = np.asarray(jax.jit(h)(
                jstore, jnp.asarray(toks), jnp.asarray(emb)))
        # one decode loop: test_torch_xattn.py holds bf16's at tp = 1
        out["paper/decode_tokens"] = _jax_decode(
            serve_step, cfg, plan, pol_paper, mesh, jstore, toks, emb)
        os.makedirs(os.path.join(out_dir, arch), exist_ok=True)
        np.savez(os.path.join(out_dir, arch, "jax.npz"), **out)


def _jax_decode(serve_step, cfg, plan, pol, mesh, jstore, toks, emb):
    """JAX's decode loop, every step given ``emb``: the prompt
    teacher-forced, then greedy -> the token after each step, (B, S +
    gen - 1)."""
    import jax.numpy as jnp
    b, s = toks.shape
    gen = worker.serve_gen(plan)
    cache = serve_step.make_cache_init(cfg, plan, mesh, b, s + gen)()
    step = serve_step.make_decode_step(cfg, plan, pol, mesh, b, s + gen)
    out, tok = [], toks[:, :1]
    for i in range(s + gen - 1):
        nt, cache = step(jstore, cache, {"tokens": jnp.asarray(
            tok, jnp.int32), "enc_embeds": jnp.asarray(emb)})
        out.append(np.asarray(nt))
        tok = toks[:, i + 1:i + 2] if i + 1 < s else out[-1][:, None]
    return np.stack(out, 1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX reference and, beside it, two gloo ranks serving the same
    weights: {arch: (jax.npz, [rank0.npz, rank1.npz])}, each side's store
    digest equal."""
    out = tmp_path_factory.mktemp("serve_tp_xattn")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={TP}")
    script = os.path.join(ROOT, "tests", "_torch_gloo_worker.py")
    _run([[sys.executable, os.path.abspath(__file__), "jax", str(out)]]
         + [[sys.executable, script, str(r), str(TP), str(out / "store"),
             str(out), "serve_xattn"] for r in range(TP)], env)
    res = {a: (np.load(out / a / "jax.npz"),
               [np.load(out / a / f"rank{r}.npz") for r in range(TP)])
           for a in ARCHS}
    for jax_out, ranks in res.values():
        for r in ranks:
            np.testing.assert_array_equal(r["store_digest"],
                                          jax_out["store_digest"])
    return res


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("run", list(worker.SERVE_RUNS))
def test_prefill_matches_jax(served, run, arch):
    """Each rank's prefill hidden states agree with JAX's: within 2e-4 of
    their max magnitude without the codec (float32 order; measured
    1.3e-6 at most, llama's). Under the paper policy an int8 site's code
    can flip where float32 order moves a sum of the two ranks' partials
    across a rounding boundary (a flip in whisper's encoder reaches every
    position of its row through the cross-attention): within two int8
    steps of a site's widest group, 4 max|h| / 255 (measured: whisper
    0.0091 max|h| over 13 positions of a row, llama 0.0030 at one). The greedy tokens over the vocabulary shards are
    JAX's (argmax of its logits), and both ranks hold the same bits."""
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
    hidden states (the encoder's sites included), the decode steps'
    logits through the prompt, and every token of the served decode
    loop."""
    _, ranks = served[arch]
    for res in ranks:
        for key in ("hidden", "decode_logits"):
            np.testing.assert_array_equal(
                res[f"paper/fused/{key}"].view(np.uint32),
                res[f"paper/two_step/{key}"].view(np.uint32))
        np.testing.assert_array_equal(res["paper/fused/generated"],
                                      res["paper/two_step/generated"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("run", ["paper/two_step", "paper/fused"])
def test_decode_tokens_match_jax(served, run, arch):
    """Under the paper policy the decode steps through the prompt (the
    embeddings given at every step, whisper's encoder re-run each time)
    give JAX's decode token after every position, and serve's decode loop
    generates JAX's tokens; every rank the same."""
    jax_out, ranks = served[arch]
    want = jax_out["paper/decode_tokens"]
    s = worker.SERVE_S
    for res in ranks:
        np.testing.assert_array_equal(
            res[f"{run}/decode_logits"].argmax(-1), want[:, :s])
        np.testing.assert_array_equal(res[f"{run}/generated"],
                                      want[:, s - 1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_matches_jax_prefill(served, arch):
    """Without the codec the decode steps through the prompt give at
    every position the logits of JAX's prefill there (its hidden states
    times its unembedding): within 2e-4 of their max magnitude (float32
    order, the cache against the full sequence; measured 1.7e-6 at
    most), and JAX's greedy token at every position; every rank the same
    bits. (``tests/test_torch_xattn.py`` holds the bf16 decode loop
    against JAX's at tp = 1.)"""
    jax_out, ranks = served[arch]
    want = _jax_logits(jax_out, "bf16", jax_out["bf16/hidden"].shape[-1])
    got = ranks[0]["bf16/decode_logits"].astype(np.float64)
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for res in ranks:
        np.testing.assert_array_equal(
            res["bf16/decode_logits"].view(np.uint32),
            ranks[0]["bf16/decode_logits"].view(np.uint32))


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _jax_reference(sys.argv[2])
