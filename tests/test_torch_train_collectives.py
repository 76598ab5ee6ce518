"""The training path's pieces held against the JAX package: the
collectives' backward rules, the optimizer, checkpoints.

* The collectives that carry a backward (``tests/_torch_train_worker.py``
  ``COLL_CASES``: ``compressed_psum`` with and without ``bwd_cfg``, with
  hier_pp and fused, and over two axes (hierarchical, hier_pp and
  two_step with an outer wire of its own, and with a framed 8-bit outer
  wire over a 4-bit inner tier, hierarchical_all_reduce's small-remainder
  branch included); ``grad_all_reduce``; the
  quantized reduce-scatter and all-gather; ``fsdp_all_gather``, plain
  and with ``qag``; the EF pair (and the EF AllReduce under framed
  hier_pp); ``moe_apply``'s collectives: the
  dispatch ``autograd.Function`` under two_step and fused, the combine's
  all-to-all, ``ep_slice``'s tiled all-gather and its aux loss's mean,
  ``psum_exact / tp`` for ``lax.pmean``) on four gloo ranks, outputs,
  residuals and input gradients, against JAX's ``custom_vjp``s and
  ``lax`` collectives under ``shard_map`` on four fake CPU devices (run in a
  subprocess of this file: ``python tests/test_torch_train_collectives.py
  jax OUT_DIR``), each rank's gradient from ``jax.vjp`` of its own output.
* ``lr_schedule`` and ``adamw_update`` on numpy inputs, in this process.
* Checkpoints, both ways, with numpy files only.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_train_worker as worker  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

WORLD = 4


def _jax_reference(out_dir: str) -> None:
    """The JAX side: every case of COLL_CASES on a (1, WORLD) mesh."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.core import collectives as J
    from repro.core.comm_config import CommConfig
    from repro.launch.mesh import make_test_mesh
    from repro.parallel.shardings import fsdp_all_gather

    mesh = make_test_mesh(1, WORLD)
    # the two-axis cases: ranks 2d + m on a (data 2, model 2) mesh, the
    # inner axis "model" (pairs of consecutive ranks), the outer "data"
    mesh2 = make_test_mesh(2, WORLD // 2)
    outer = CommConfig(backend="ref", **worker.COLL_OUTER)
    framed_outer = CommConfig(backend="ref", **worker.COLL_FRAMED_OUTER)
    inp = {k: jnp.asarray(v) for k, v in
           worker.coll_inputs(WORLD).items()}
    out = {}
    for case, (fn, kw, bkw) in worker.COLL_CASES.items():
        cfg = None if kw is None else CommConfig(backend="ref", **kw)
        bwd = None if bkw is None else CommConfig(backend="ref", **bkw)
        framed = (framed_outer.with_framed(False)
                  if case in worker.COLL_EAGER else framed_outer)
        ct = {"qrs": "ct_rs", "qrs_ef": "ct_rs"}.get(
            fn, "ct_ag" if fn in worker.COLL_GATHERS else "ct")
        two = fn in ("ef", "qrs_ef")

        def f(x, r, fn=fn, cfg=cfg, bwd=bwd, framed=framed):
            if fn == "psum":
                return J.compressed_psum(x, ("model",), cfg, None, bwd)
            if fn == "psum2":
                return J.compressed_psum(x, ("model", "data"), cfg, None,
                                         bwd, outer)
            if fn == "psum2f":
                return J.compressed_psum(x, ("model", "data"), cfg, None,
                                         bwd, framed)
            if fn == "hrem":
                return J.hierarchical_all_reduce(
                    x[:worker.COLL_REM_N], "model", "data", cfg, framed)
            if fn == "gar":
                return J.grad_all_reduce({"w": x}, ("model",), cfg)["w"]
            if fn == "qrs":
                return J.quantized_reduce_scatter(x, "model", cfg)
            if fn == "qag":
                return J.quantized_all_gather(x, "model", cfg)
            if fn == "fsdp":
                return fsdp_all_gather(x, "model", cfg)
            if fn == "dispatch":
                return J.dispatch_all_to_all(
                    x.reshape(WORLD, -1, worker.COLL_D), "model",
                    cfg).reshape(-1)
            if fn == "a2a":
                return lax.all_to_all(x.reshape(WORLD, -1, worker.COLL_D),
                                      "model", 0, 0, tiled=True).reshape(-1)
            if fn == "gather":
                return lax.all_gather(x.reshape(-1, worker.COLL_D), "model",
                                      axis=0, tiled=True).reshape(-1)
            if fn == "pmean":
                return lax.pmean(x, "model")
            if fn == "ef":
                return J.compressed_psum_ef(x, r, ("model",), cfg)
            return J.quantized_reduce_scatter_ef(x, r, "model", cfg)

        def body(x, r, c, f=f, two=two, fwd=fn in worker.COLL_FORWARD_ONLY):
            x, r, c = x[0], r[0], c[0]
            if fwd:
                return (f(x, r)[None],)
            y, vjp = jax.vjp(f, x, r)
            if two:
                gx, gr = vjp((c, jnp.zeros_like(y[1])))
                return (y[0][None], y[1][None], gx[None], gr[None])
            gx, _ = vjp(c)
            return y[None], gx[None]

        n_out = 4 if two else 1 if fn in worker.COLL_FORWARD_ONLY else 2
        two_axes = fn in ("psum2", "psum2f", "hrem")
        rows = P(("data", "model")) if two_axes else P("model")
        sm = compat.shard_map(body, mesh=mesh2 if two_axes else mesh,
                              in_specs=(rows,) * 3,
                              out_specs=(rows,) * n_out, check_vma=False)
        big = fn not in worker.COLL_GATHERS
        args = (inp["x"] if big else inp["xk"], inp["r"], inp[ct])
        if case in worker.COLL_EAGER:
            with jax.disable_jit():
                res = sm(*args)
        else:
            res = jax.jit(sm)(*args)
        out[f"{case}/out"] = np.asarray(res[0])
        if two:
            out[f"{case}/res"] = np.asarray(res[1])
            out[f"{case}/grad"] = np.asarray(res[2])
            out[f"{case}/grad_r"] = np.asarray(res[3])
        elif n_out == 2:
            out[f"{case}/grad"] = np.asarray(res[1])
    np.savez(os.path.join(out_dir, "jax.npz"), **out)


def _run(cmds, env, timeout=180):
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


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_coll")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    script = os.path.join(ROOT, "tests", "_torch_train_worker.py")
    _run([[sys.executable, os.path.abspath(__file__), "jax", str(out)]] +
         [[sys.executable, script, "coll", str(r), str(WORLD),
           str(out / "store"), str(out)] for r in range(WORLD)], env)
    return (np.load(out / "jax.npz"),
            [np.load(out / f"coll{r}.npz") for r in range(WORLD)])


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("case", list(worker.COLL_CASES))
def test_collective_forward_and_backward_match_jax(coll, case):
    """Each rank's output, residual and input gradients against JAX's
    row for that rank.

    The gradients are exact sums, all-gathers and reduce-scatters of the
    cotangent (or, under ``bwd_cfg``, the compressed sum of it): bit for
    bit, except that four ranks' exact sums may add in another order
    (1e-6 of the largest). The forward wires hold JAX's bits where JAX's
    jitted decode gives the port's (the bf16-scale configs here), and
    differ by the FMA contraction of JAX's decode under jit elsewhere
    (ROADMAP Queue C): one rounding of the product in a decoded value,
    which the two-step's phase 2 (or the EF's re-quantization) can turn
    into one code step of that value's group, 2 R max|x| / (2^b - 1) at
    most (R ranks' sum, b the narrowest wire of the case), on at most 1%
    of the values. The EF residual is the wire's error, so such a step
    moves it by as much. Measured: every output of the bf16-scale cases
    bit for bit; the Eq.-1 cases within 1.1e-6; the two-axis case with a
    4-bit outer wire one outer code step (1.02) on a few values.

    The framed case of ``worker.COLL_EAGER`` (the two-step over two axes
    with a 4-bit inner tier) is held against JAX's eager run of the same
    call with the frames removed, its output bit for bit (see
    COLL_EAGER).
    """
    jax_out, ranks = coll
    fn, kw, bkw = worker.COLL_CASES[case]
    bits = (kw or {}).get("bits", 8)
    if fn == "psum2":                 # the outer hop's wire, if narrower
        bits = min(bits, worker.COLL_OUTER["bits"])
    for r, res in enumerate(ranks):
        for key in ("out", "res", "grad", "grad_r"):
            k = f"{case}/{key}"
            if k not in jax_out.files:
                assert k not in res.files
                continue
            got, want = res[k], jax_out[k][r]
            assert got.shape == want.shape, (k, got.shape, want.shape)
            if np.array_equal(_bits(got), _bits(want)):
                continue
            assert case not in worker.COLL_EAGER or key != "out", (r, k)
            d = np.abs(got - want)
            scale = np.abs(want).max()
            if key in ("grad", "grad_r") and bkw is None:
                assert d.max() <= 1e-6 * scale, (r, k, d.max(), scale)
            else:
                xmax = max(np.abs(worker.coll_inputs(WORLD)[
                    "x" if fn not in worker.COLL_GATHERS else "xk"]).max(), 1)
                step = 2 * WORLD * xmax / (2 ** bits - 1)
                assert d.max() <= step, (r, k, d.max(), step)
                assert np.mean(d > 1e-6 * scale) <= 0.01, (r, k)


def test_framed_collectives_equal_unframed_twins(coll):
    """Each framed case (the bridge's outer wire framed over two axes under
    two_step, hierarchical and hier_pp, hierarchical_all_reduce's
    small-remainder branch, and the pod site's EF under framed hier_pp)
    gives on every rank the output (and residual) of the same call with
    every wire unframed, bit for bit: the frame is pure envelope."""
    _, ranks = coll
    cases = [c for c in worker.COLL_CASES if f"{c}/twin" in ranks[0].files]
    assert len(cases) == 5, cases
    for res in ranks:
        for case in cases:
            np.testing.assert_array_equal(
                _bits(res[f"{case}/out"]), _bits(res[f"{case}/twin"]),
                err_msg=case)
            if f"{case}/res" in res.files:
                np.testing.assert_array_equal(
                    _bits(res[f"{case}/res"]),
                    _bits(res[f"{case}/twin_res"]), err_msg=case)


def test_ef_residuals_sum_to_the_error(coll):
    """The two-step EF's residuals (phase 1 everywhere, phase 2 at the
    owned chunk) sum over the ranks to the AllReduce's whole error:
    sum_r (x_r + r_r) - out."""
    _, ranks = coll
    inp = worker.coll_inputs(WORLD)
    for case in ("ef_two_step", "ef_hierpp"):
        total = (inp["x"] + inp["r"]).astype(np.float64).sum(0)
        err = total - ranks[0][f"{case}/out"].astype(np.float64)
        got = sum(r[f"{case}/res"].astype(np.float64) for r in ranks)
        assert np.abs(got - err).max() <= 1e-5 * np.abs(total).max(), case


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_jax():
    """Warm-up and cosine, float32, at every step of a short schedule and
    past its end: within 4 float32 roundings of JAX's (the libraries'
    float32 cos may differ in its last ulp, which the products after it
    carry)."""
    import jax.numpy as jnp
    from repro.train.optim import OptimConfig as JOpt
    from repro.train.optim import lr_schedule as jlr
    from repro_torch.train.optim import OptimConfig, lr_schedule
    for kw in (dict(lr=1e-3, warmup_steps=2, total_steps=20),
               dict(lr=3e-4, warmup_steps=5, total_steps=9,
                    min_lr_frac=0.3)):
        for s in range(0, 25):
            want = float(jlr(JOpt(**kw), jnp.asarray(s, jnp.int32)))
            got = float(lr_schedule(OptimConfig(**kw),
                                    torch.tensor(s, dtype=torch.int32)))
            assert abs(got - want) <= 2 ** -21 * abs(want), (kw, s)


def test_adamw_update_matches_jax():
    """Three AdamW steps on numpy leaves (one with gradients past the
    clip, one with zeros): store, m and v within 2 float32 roundings of
    JAX's (its jit may contract a multiply-add), lr equal."""
    import jax
    import jax.numpy as jnp
    from repro.train.optim import OptimConfig as JOpt
    from repro.train.optim import adamw_update as jadam
    from repro.train.optim import init_opt_state as jinit
    from repro_torch.train.optim import (OptimConfig, adamw_update,
                                         init_opt_state)
    rng = np.random.default_rng(5)
    shapes = {"a": {"w": (2, 300)}, "b": {"u": (1, 64), "z": (1, 8)}}
    p = {g: {n: rng.standard_normal(s).astype(np.float32)
             for n, s in d.items()} for g, d in shapes.items()}
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jst = jinit(jp, JOpt(**kw))
    tp = {g: {n: torch.from_numpy(v.copy()) for n, v in d.items()}
          for g, d in p.items()}
    tst = init_opt_state(tp, OptimConfig(**kw))
    for i in range(3):
        g = {gn: {n: (rng.standard_normal(s) * (3.0 if gn == "a" else 0.1)
                      ).astype(np.float32) for n, s in d.items()}
             for gn, d in shapes.items()}
        g["b"]["z"][:] = 0
        norm = np.float32(np.sqrt(sum(float((v.astype(np.float64) ** 2
                                             ).sum())
                                      for d in g.values()
                                      for v in d.values())))
        jp, jst, jlr_ = jadam(jp, jax.tree_util.tree_map(jnp.asarray, g),
                              jst, JOpt(**kw), jnp.asarray(norm))
        tg = {gn: {n: torch.from_numpy(v) for n, v in d.items()}
              for gn, d in g.items()}
        tp, tst, tlr = adamw_update(tp, tg, tst, OptimConfig(**kw),
                                    torch.tensor(norm))
        assert float(tlr) == float(jlr_), i
        assert int(tst["step"]) == int(jst["step"]) == i + 1
        for gn, d in shapes.items():
            for n in d:
                for got, want in ((tp[gn][n], jp[gn][n]),
                                  (tst["m"][gn][n], jst["m"][gn][n]),
                                  (tst["v"][gn][n], jst["v"][gn][n])):
                    want = np.asarray(want)
                    tol = 2 * 2 ** -23 * np.maximum(np.abs(want), 1e-30)
                    assert (np.abs(got.numpy() - want) <= tol).all(), (
                        i, gn, n)


@pytest.mark.parametrize("fsdp", [2, 4])
def test_flat_store_matches_jax_at_fsdp(fsdp):
    """Every parameter's stored flat length and local shape equal the JAX
    package's at fsdp = 2 and 4 (tp 1, 2 and 4, llama3-8b and qwen3-14b at
    full width and smoke size; glm4-9b's replicated kv heads, command-r's
    LayerNorm biases, moonshot's expert leaves), so that a data shard of
    a JAX store is the port's shard."""
    from repro.configs import get_config as jget
    from repro.configs import get_smoke_config as jsmoke
    from repro.models.model import param_groups as jgroups
    from repro.parallel.plan import make_plan as jplan
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import param_groups
    from repro_torch.parallel.plan import make_plan
    for arch in ("llama3-8b", "qwen3-14b", "glm4-9b", "command-r-35b",
                 "moonshot-v1-16b-a3b"):
        for cfg, jcfg in ((get_config(arch), jget(arch)),
                          (get_smoke_config(arch), jsmoke(arch))):
            for tp in (1, 2, 4):
                plan, jp = make_plan(cfg, tp, fsdp), jplan(jcfg, tp, fsdp)
                groups, jg = param_groups(cfg, plan), jgroups(jcfg, jp)
                assert groups.keys() == jg.keys()
                for g, (n_stack, specs) in groups.items():
                    assert n_stack == jg[g][0] and specs.keys() == \
                        jg[g][1].keys()
                    for name, sp in specs.items():
                        jsp = jg[g][1][name]
                        assert sp.local_shape(plan) == jsp.local_shape(jp)
                        assert sp.flat_len(plan) == jsp.flat_len(jp)
                        assert sp.flat_len(plan) % (fsdp * 128) == 0


def test_train_step_under_no_grad():
    """A train step computes its gradients whatever the caller's grad
    mode: called with autograd off (as a serving caller leaves it), it
    gives the bits of a step called with autograd on."""
    from repro_torch.parallel.axis import MeshAxes
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.shardings import init_store
    from repro_torch.train.data import DataConfig, make_dataset
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import local_batch, make_train_step_fn
    cfg = worker.train_config()
    plan, mesh = make_plan(cfg, tp=1), MeshAxes()
    batch = local_batch(make_dataset(DataConfig(
        vocab=cfg.vocab, seq_len=8, global_batch=2)).batch(0), mesh, "cpu")
    out = []
    for grad_mode in (True, False):
        store = init_store(cfg, plan, 0, "cpu")
        opt = init_opt_state(store, worker.opt_config())
        step = make_train_step_fn(cfg, plan, worker.policies()["paper"],
                                  worker.opt_config(), mesh)
        with torch.set_grad_enabled(grad_mode):
            store, opt, metrics = step(store, opt, batch)
        assert float(metrics["grad_norm"]) > 0
        out.append(store["embed"]["tok"])
    assert torch.equal(out[0], out[1])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(rng, shapes):
    return {g: {n: rng.standard_normal(s).astype(np.float32)
                for n, s in d.items()} for g, d in shapes.items()}


def test_checkpoint_round_trips_with_jax(tmp_path):
    """A file the JAX launcher's ``save`` wrote restores in the port, each
    (model, data) rank taking its slice (qef at the full flat length a
    data rank); the port's ``save`` of one rank's state writes the JAX
    layout, which JAX's ``restore`` reads back equal."""
    from repro.train import checkpoint as jck
    from repro_torch.train import checkpoint as tck
    rng = np.random.default_rng(3)
    tp, fsdp, flat = 2, 2, 256
    shapes = {"embed": {"tok": (1, tp, flat)},
              "pattern": {"L0_wq": (2, tp, flat), "L0_n1_gain": (2, tp,
                                                                 flat)}}
    store = _tree(rng, shapes)
    opt = {"m": _tree(rng, shapes), "v": _tree(rng, shapes),
           "ef": _tree(rng, shapes),
           "qef": _tree(rng, {g: {n: (s[0], s[1], s[2] * fsdp)
                                  for n, s in d.items()}
                              for g, d in shapes.items()}),
           "step": np.asarray(7, np.int32)}
    path = str(tmp_path / "jax.npz")
    jck.save(path, store, opt, step=7)
    for m in range(tp):
        for d in range(fsdp):
            st, op, step = tck.restore(path, "cpu", rank=m, data_rank=d,
                                       fsdp=fsdp)
            assert step == 7 and int(op["step"]) == 7
            k = flat // fsdp
            np.testing.assert_array_equal(
                st["pattern"]["L0_wq"].numpy(),
                store["pattern"]["L0_wq"][:, m, d * k:(d + 1) * k])
            np.testing.assert_array_equal(
                op["qef"]["embed"]["tok"].numpy(),
                opt["qef"]["embed"]["tok"][:, m, d * flat:(d + 1) * flat])
    # one rank (tp = fsdp = 1): the port writes, JAX reads
    one = {g: {n: v[:, :1] for n, v in d.items()} for g, d in store.items()}
    st = {g: {n: torch.from_numpy(v[:, 0].copy()) for n, v in d.items()}
          for g, d in one.items()}
    op = {"m": st, "v": st, "step": torch.tensor(3, dtype=torch.int32)}
    path2 = str(tmp_path / "port.npz")
    tck.save(path2, st, op, step=3)
    jstore, jopt, jstep = jck.restore(path2)
    assert jstep == 3 and int(jopt["step"]) == 3
    for g, d in one.items():
        for n, v in d.items():
            np.testing.assert_array_equal(np.asarray(jstore[g][n]), v)
            np.testing.assert_array_equal(np.asarray(jopt["m"][g][n]), v)


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _jax_reference(sys.argv[2])
