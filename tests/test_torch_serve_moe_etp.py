"""Serving an MoE model whose experts are both spread and sharded over
the ranks (ep = 2, etp = 2 at tp = 4): four gloo ranks of the port
against the JAX package on a (1, 4) mesh of fake CPU devices.

The model is ``tests/_torch_etp_worker.py``'s (grok-1's smoke config with
2 experts, 4 kv heads and capacity factor 0.5). The JAX side runs in a
subprocess of this file (``python tests/test_torch_serve_moe_etp.py jax
OUT_DIR``): it builds the weights (``build_store`` at tp = 4 with a crc32
in place of the salted ``hash``, float32, the zero-initialised output
projections filled from a seeded normal; saved first, ``store.npz``),
the prefill's hidden states
under ``shard_map`` for each policy with the routes each device dropped
(its routing lines replayed on each MoE layer's input, the count sent
out by ``jax.debug.callback``), and its decode steps' tokens through the
prompt. Four rank processes of the port (``_torch_etp_worker.py serve``),
started beside it, load their shards with ``load_jax_store(rank=r)``
once the store is there, join the mesh
with the plan's ep and etp subgroups, and serve under paper/two_step,
paper/fused (the emulated fused schedules around the gloo hops of the
subgroups), aggressive (``ep_slice``) and bf16.
"""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import _torch_etp_worker as worker  # noqa: E402
from test_torch_serve_tp import _run  # noqa: E402

#: JAX's policy of each run (fused gives two_step's bits in both packages)
JAX_POLICY = {"paper/two_step": "paper", "paper/fused": "paper",
              "aggressive": "aggressive", "bf16": "bf16"}


def _jax_reference(out_dir: str) -> None:
    """The JAX side (its own process, four fake CPU devices)."""
    import zlib

    from _torch_train_worker import save_npz

    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.configs import get_smoke_config
    from repro.core.policy import (BF16_POLICY, aggressive_policy,
                                   paper_policy, with_backend)
    from repro.launch.mesh import make_test_mesh
    from repro.models import model as jmodel
    from repro.models import moe as jmoe
    from repro.parallel import shardings as jshard
    from repro.parallel.plan import make_plan
    from repro.train import serve_step

    cfg = worker.etp_config(get_smoke_config(worker.ARCH))
    plan = make_plan(cfg, tp=worker.TP, fsdp=1)
    mesh = make_test_mesh(1, worker.TP)
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
    save_npz(os.path.join(out_dir, "store.npz"), **out)
    jstore = jax.tree_util.tree_map(jnp.asarray, store_np)
    toks = jnp.asarray(worker.prompts())
    drops = []
    moe_apply = jmoe.moe_apply

    def counted(p, x, cfg, plan, policy, prefix="moe_", layer=None):
        """moe_apply, after sending out the routes this device drops: the
        routing lines of ``repro.models.moe.moe_apply``, on its slice
        under ``ep_slice``."""
        m, mp = cfg.moe, plan.moe
        xt = x.reshape(-1, x.shape[-1])
        t = xt.shape[0]
        if policy.ep_slice and mp.ep > 1:
            ts = -(-t // mp.ep)
            xt = jnp.pad(xt, ((0, ts * mp.ep - t), (0, 0)))
            xt = lax.dynamic_slice_in_dim(
                xt, lax.axis_index("model") // mp.etp * ts, ts, 0)
        probs = jax.nn.softmax(jnp.einsum(
            "td,de->te", xt.astype(jnp.float32),
            p[prefix + "router"].astype(jnp.float32)), axis=-1)
        re = lax.top_k(probs, m.top_k)[1].reshape(-1)
        pos = jnp.take_along_axis(jnp.cumsum(jax.nn.one_hot(
            re, m.n_experts, dtype=jnp.int32), axis=0) - 1, re[:, None],
            axis=1)[:, 0]
        dropped = jnp.sum(pos >= jmoe.capacity(xt.shape[0], cfg))
        jax.debug.callback(lambda i, n: drops.append((int(i), int(n))),
                           lax.axis_index("model"), dropped)
        return moe_apply(p, x, cfg, plan, policy, prefix, layer)

    jmoe.moe_apply = counted
    pols = {"paper": with_backend(paper_policy(), "ref"),
            "aggressive": with_backend(aggressive_policy(), "ref"),
            "bf16": BF16_POLICY}
    for name, pol in pols.items():
        def hidden_fn(st, t, pol=pol):
            return jmodel.forward(st, t, cfg, plan, pol,
                                  dtype=jnp.float32)[0]
        h = compat.shard_map(hidden_fn, mesh=mesh,
                             in_specs=(jshard.store_spec(plan), P()),
                             out_specs=P(), check_vma=False)
        drops.clear()
        out[f"{name}/hidden"] = np.asarray(jax.jit(h)(jstore, toks))
        jax.effects_barrier()
        per_rank = np.zeros(worker.TP, np.int64)
        for i, n in drops:
            per_rank[i] += n
        assert len(drops) == worker.TP * cfg.layer_kinds.count("moe")
        out[f"{name}/prefill_dropped"] = per_rank
    for name in ("paper", "bf16"):
        clen = worker.S + worker.GEN
        cache = serve_step.make_cache_init(cfg, plan, mesh, worker.B,
                                           clen)()
        step = serve_step.make_decode_step(cfg, plan, pols[name], mesh,
                                           worker.B, clen)
        got = []
        for i in range(worker.S):
            nt, cache = step(jstore, cache, {"tokens": toks[:, i:i + 1]})
            got.append(np.asarray(nt))
        out[f"{name}/decode_tokens"] = np.stack(got, 1)
    np.savez(os.path.join(out_dir, "jax.npz"), **out)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX reference and, beside it, four gloo ranks serving from its
    weights once it has saved them: (jax.npz, [rank0.npz, ...])."""
    out = tmp_path_factory.mktemp("serve_moe_etp")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{worker.TP}")
    script = os.path.join(ROOT, "_torch_etp_worker.py")
    _run([[sys.executable, os.path.abspath(__file__), "jax", str(out)]]
         + [[sys.executable, script, "serve", str(r), str(worker.TP),
             str(out / "rdv"), str(out)] for r in range(worker.TP)], env)
    return (np.load(out / "jax.npz"),
            [np.load(out / f"rank{r}.npz") for r in range(worker.TP)])


def _config(package):
    """The model of both sides, from ``package``'s smoke config."""
    mod = __import__(f"{package}.configs", fromlist=["get_smoke_config"])
    return worker.etp_config(mod.get_smoke_config(worker.ARCH))


def test_plan_and_subgroups_match_jax(served):
    """The port's plan factorises tp = 4 as JAX's does (ep = 2, etp = 2,
    one expert a rank, each sharded two ways), and each rank's ep and
    etp subgroups hold the ranks of JAX's ``ep_groups`` and
    ``etp_groups`` group that holds it, the rank at its position there
    (``ep_idx``, ``tp_idx``)."""
    from repro.parallel.plan import make_plan as jmake_plan
    from repro_torch.parallel.plan import make_plan
    want = jmake_plan(_config("repro"), tp=worker.TP, fsdp=1).moe
    got = make_plan(_config("repro_torch"), tp=worker.TP).moe
    assert (got.ep, got.etp, got.e_loc, got.ef_loc) == (2, 2, 1, 256)
    assert got.ep_groups == want.ep_groups == ((0, 2), (1, 3))
    assert got.etp_groups == want.etp_groups == ((0, 1), (2, 3))
    _, ranks = served
    for r, res in enumerate(ranks):
        ep = next(g for g in want.ep_groups if r in g)
        etp = next(g for g in want.etp_groups if r in g)
        assert tuple(res["ep_ranks"]) == ep
        assert tuple(res["etp_ranks"]) == etp
        assert tuple(res["sub_index"]) == (ep.index(r), etp.index(r)) == (
            r // want.etp, r % want.etp)


def test_jax_store_unflattens_per_rank(served):
    """The JAX store at ep = 2, etp = 2 unflattens on each rank of the
    port (``load_jax_store(rank=r)``) to the arrays that JAX's
    ``gather_param`` makes of rank r's shard, bit for bit: the experts
    as (e_loc, d, d_ff / etp) and (e_loc, d_ff / etp, d), different on
    every rank; the router and the norms the same on every rank."""
    import jax.numpy as jnp
    import torch
    from repro.models.model import param_groups as jparam_groups
    from repro.parallel import shardings as jshard
    from repro.parallel.plan import make_plan as jmake_plan
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.shardings import load_jax_store
    from _torch_train_worker import read_store
    jax_out, _ = served
    store = read_store(jax_out)
    jcfg, cfg = _config("repro"), _config("repro_torch")
    jplan, plan = jmake_plan(jcfg, tp=worker.TP, fsdp=1), make_plan(
        cfg, tp=worker.TP)
    groups = jparam_groups(jcfg, jplan)
    mine = [load_jax_store(store, cfg, plan, "cpu", torch.float32, rank=r)
            for r in range(worker.TP)]
    for g, (n_stack, specs) in groups.items():
        for name, spec in specs.items():
            for r in range(worker.TP):
                for i in range(n_stack):
                    want = np.asarray(jshard.gather_param(
                        jnp.asarray(store[g][name][i, r]), spec, jplan,
                        jnp.float32))
                    got = mine[r][g][name][i].numpy()
                    assert got.shape == want.shape, (g, name)
                    np.testing.assert_array_equal(got.view(np.uint32),
                                                  want.view(np.uint32))
    w1 = "L0_moe_w1"
    assert mine[0]["pattern"][w1].shape[1:] == (1, 256, 256)
    assert not np.array_equal(mine[0]["pattern"][w1].numpy(),
                              mine[1]["pattern"][w1].numpy())
    for r in range(1, worker.TP):
        np.testing.assert_array_equal(
            mine[r]["pattern"]["L0_moe_router"].numpy(),
            mine[0]["pattern"]["L0_moe_router"].numpy())


def _jax_logits(jax_out, pol: str) -> np.ndarray:
    """JAX's prefill logits at the last position (B, vocab), float64: its
    hidden states times its unembedding (the ranks' vocabulary shards in
    rank order)."""
    unemb = jax_out["store/out/unemb"][0]              # (tp, flat)
    v_loc = -(-512 // worker.TP)
    rows = unemb[:, :v_loc * 256].reshape(worker.TP * v_loc, 256)[:512]
    return jax_out[f"{pol}/hidden"][:, -1].astype(np.float64) @ rows.T


@pytest.mark.parametrize("run", list(worker.RUNS))
def test_etp_prefill_matches_jax(served, run):
    """Each rank's prefill hidden states agree with JAX's: within 2e-4 of
    their max magnitude without the codec (float32 summation order),
    within one code step of the widest group of a sum of tp partials
    under the quantized policies (tp max|h| / 255 at int8, paper; tp
    max|h| / 31 at int5, aggressive's TP sites), with at most a quarter
    of the positions beyond the float32 bound (a code step moves one
    token, and its sequence's later positions through attention, as in
    ``tests/test_torch_serve_tp.py``). The greedy next token over the
    whole vocabulary equals JAX's, and every rank holds the same bits.
    Measured: bf16 1.0e-6 of max|h|, aggressive 1.9e-7, paper 0.0068
    (the bound 0.0157; 3 of the 24 positions beyond 2e-4)."""
    jax_out, ranks = served
    pol = JAX_POLICY[run]
    want = jax_out[f"{pol}/hidden"]
    hmax = np.abs(want).max()
    steps = {"paper": 255, "aggressive": 31}
    bound = (2e-4 * hmax if pol == "bf16"
             else worker.TP * hmax / steps[pol])
    token = _jax_logits(jax_out, pol).argmax(-1)
    for r, res in enumerate(ranks):
        h = res[f"{run}/hidden"]
        np.testing.assert_array_equal(h.view(np.uint32),
                                      ranks[0][f"{run}/hidden"].view(
                                          np.uint32))
        diff = np.abs(h - want)
        assert diff.max() <= bound, (r, diff.max(), bound)
        assert np.mean(diff.max(-1) > 2e-4 * hmax) <= 0.25, r
    mine = _jax_logits({**jax_out, f"{pol}/hidden": ranks[0][
        f"{run}/hidden"]}, pol).argmax(-1)
    np.testing.assert_array_equal(mine, token)


@pytest.mark.parametrize("run", list(worker.RUNS))
def test_etp_dropped_routes_match_jax(served, run):
    """The routes each rank drops over capacity at prefill equal those of
    its JAX device (each rank its own slice of the tokens under
    ``ep_slice``), and the capacity does drop routes; serve's prefill
    drops as many."""
    jax_out, ranks = served
    want = jax_out[f"{JAX_POLICY[run]}/prefill_dropped"]
    got = np.array([int(res[f"{run}/prefill_dropped"]) for res in ranks])
    np.testing.assert_array_equal(got, want)
    assert want.min() > 0
    for res in ranks:
        assert int(res[f"{run}/dropped"][0]) == int(
            res[f"{run}/prefill_dropped"])


def test_etp_fused_equals_two_step(served):
    """On each rank the fused schedules (the dispatch over the ep subgroup,
    the within-expert AllReduce over the etp subgroup, the TP sites over
    the model axis) give two_step's bits: the prefill hidden states,
    every token of the served decode loop, and the routes dropped at
    prefill and decode."""
    _, ranks = served
    for res in ranks:
        np.testing.assert_array_equal(
            res["paper/fused/hidden"].view(np.uint32),
            res["paper/two_step/hidden"].view(np.uint32))
        for key in ("generated", "dropped"):
            np.testing.assert_array_equal(res[f"paper/fused/{key}"],
                                          res[f"paper/two_step/{key}"])


@pytest.mark.parametrize("run", list(worker.RUNS))
def test_etp_ranks_generate_alike(served, run):
    """serve's decode loop gives every rank the same tokens, each in the
    vocabulary. Where every rank routes every token (all runs but
    aggressive's ``ep_slice``), the ranks drop the same routes, and the
    decode's capacity (one slot an expert at batch 2) drops some."""
    _, ranks = served
    gen = ranks[0][f"{run}/generated"]
    assert gen.shape == (worker.B, worker.GEN)
    assert ((gen >= 0) & (gen < 512)).all()
    for res in ranks:
        np.testing.assert_array_equal(res[f"{run}/generated"], gen)
        if run != "aggressive":
            np.testing.assert_array_equal(res[f"{run}/dropped"],
                                          ranks[0][f"{run}/dropped"])
            assert int(res[f"{run}/dropped"][1]) > 0


@pytest.mark.parametrize("run", list(worker.DECODED))
def test_etp_decode_matches_jax(served, run):
    """The decode steps through the prompt (kv heads sharded, so JAX's
    decode is sound here) give JAX's greedy token at every position
    whose top-2 margin exceeds twice the bound of
    :func:`test_etp_prefill_matches_jax` on the logits, and those are at
    least half of the positions; every rank holds the same bits.
    Measured: bf16 equal at all 24 positions, paper at 23 (the other's
    margin 0.0035 of the largest logit, inside one int8 step); 16 and 24
    positions held."""
    jax_out, ranks = served
    pol = JAX_POLICY[run]
    got = ranks[0][f"{run}/decode_logits"].astype(np.float64)
    lmax = np.abs(got).max()
    top2 = -np.sort(-got, axis=-1)[..., :2]
    tol = 2e-4 if pol == "bf16" else worker.TP / 255
    held = (top2[..., 0] - top2[..., 1]) > 2 * tol * lmax
    assert held.mean() >= 0.5, held.mean()
    want = jax_out[f"{pol}/decode_tokens"]
    assert (got.argmax(-1) == want)[held].all()
    for res in ranks:
        np.testing.assert_array_equal(
            res[f"{run}/decode_logits"].view(np.uint32),
            ranks[0][f"{run}/decode_logits"].view(np.uint32))


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    sys.path.insert(0, os.path.join(os.path.dirname(ROOT), "src"))
    _jax_reference(sys.argv[2])
