"""One rank of the port's training run on gloo, held against JAX's.

    python tests/_torch_train_worker.py RANK MESH INIT_FILE OUT_DIR \
        POLICIES [ARCH [SEQ]]
    python tests/_torch_train_worker.py jax MESH OUT_DIR POLICIES \
        [ARCH [SEQ]]
    python tests/_torch_train_worker.py coll RANK WORLD INIT_FILE OUT_DIR

``MESH`` is ``DATA,MODEL[,POD]`` (as the launchers take it), ``POLICIES``
a comma-separated list of :data:`POLICIES` keys, ``ARCH`` the smoke
config trained (:data:`ARCH` by default; an MoE model's aux loss enters
the loss), ``SEQ`` its sequence length (:data:`SEQ` by default). A model
with an encoder or cross-attention blocks trains on the stream's stub
frontend embeddings (``enc_embeds``) on both sides
(:func:`data_config`). ``OUT_DIR`` holds the
JAX side (written by ``tests/test_torch_train*.py``): ``init.npz``, the
global store both packages start from (``store/GROUP/NAME``, JAX's
``(n_stack, tp, flat)`` arrays), and ``jax_POLICY.npz``, JAX's metrics and
state after each of :data:`STEPS` steps (``STEP/loss``,
``STEP/grad_norm``, ``STEP/lr``, ``STEP/store/...``, ``STEP/m/...``,
``STEP/v/...``, ``STEP/ef/...``, ``STEP/qef/...``).

The ``jax`` mode writes them: the JAX package builds the store
(``build_store`` with a crc32 in place of its per-process salted
``hash``, the zero-initialised output projections filled from a seeded
normal so that every TP site carries data) and trains each policy with
its jitted ``make_train_step`` on a mesh of fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count``).

The ``coll`` mode is one rank of ``tests/test_torch_train_collectives.py``:
the collectives with a backward (:data:`COLL_CASES`) on every rank's row
of :func:`coll_inputs`, their outputs and input gradients saved as
``OUT_DIR/coll{RANK}.npz``.

The rank joins the mesh (:func:`repro_torch.launch.mesh.init_mesh`
on the CPU), loads its ``(model, data)`` shard of the initial store
(``load_jax_store(data_rank=...)``) and trains each policy for
:data:`STEPS` steps on the same batches, each step after the first from
JAX's store after the step before (its optimizer state is its own).
After each step it holds every tree of its state against the same slice
of JAX's, and checks its EF residuals' sum rule over the ranks
(:func:`ef_sums`). It saves, as ``rankR.npz``, its metrics, for each
(policy, step, tree) each leaf's :func:`leaf_stats` and for ``ef`` and
``qef`` each leaf's sum rule; :func:`check` asserts on them.
"""
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "src"))

STEPS = 3
BATCH, SEQ = 8, 16
ARCH = "llama3-8b"             # the default smoke config trained
TREES = ("store", "m", "v", "ef", "qef")


def policies():
    from repro_torch.core.policy import (BF16_POLICY, aggressive_policy,
                                         depth_policy, paper_policy)
    return {"bf16": BF16_POLICY, "paper": paper_policy(),
            "depth": depth_policy(), "aggressive": aggressive_policy(),
            "aggressive_ef": dataclasses.replace(aggressive_policy(),
                                                 grad_ef=True),
            "framed": framed_policies()["framed"]}


def train_config(arch: str = ARCH):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def opt_config():
    from repro_torch.train.optim import OptimConfig
    return OptimConfig(lr=1e-3, warmup_steps=2, total_steps=20)


def data_config(config_cls, cfg, seq: int = SEQ):
    """The stream of a run (``config_cls``: either package's
    ``DataConfig``): BATCH x ``seq`` tokens, and for a model with an
    encoder or cross-attention blocks the stub frontend's embeddings
    (BATCH, n_ctx, d_model), as both launchers give them."""
    enc = cfg.encoder.n_ctx if (cfg.is_enc_dec or cfg.has_cross) else None
    return config_cls(vocab=cfg.vocab, seq_len=seq, global_batch=BATCH,
                      enc_ctx=enc, d_model=cfg.d_model)


def read_store(npz) -> dict:
    store = {}
    for key in npz.files:
        if key.startswith("store/"):
            _, g, name = key.split("/")
            store.setdefault(g, {})[name] = npz[key]
    return store


def save_npz(path: str, **arrays) -> None:
    """``np.savez`` to ``path`` by a rename, so that a reader never sees
    it half written."""
    tmp = path[:-len(".npz")] + ".part.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def wait_load(path: str, timeout: float = 240):
    """``np.load(path)`` once the JAX side has written it (it fails the
    run when it fails: the test kills the ranks then)."""
    import time
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.05)
    return np.load(path)


def leaf_stats(got: np.ndarray, want: np.ndarray,
               start: np.ndarray = None) -> np.ndarray:
    """One leaf of the port's state against JAX's -> [rel, ratio]: the L2
    norm of the difference over that of JAX's value (of its change since
    ``start``, for the store), and the L2 norm of the port's value
    (change) over JAX's. Where JAX's is zero: 0 if the port's is too,
    else infinite."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    if start is not None:
        got, want = got - start, want - start
    nd, nr, ng = (float(np.linalg.norm(a)) for a in (got - want, want, got))
    if not nr:
        return np.array([0.0 if nd == 0 else np.inf] * 2)
    return np.array([nd / nr, ng / nr])


def ef_tap(calls: list):
    """Wrap the train step's EF collectives so that each call records its
    kind (``ef`` for ``compressed_psum_ef``, ``qef`` for
    ``quantized_reduce_scatter_ef``), its input with the residual added
    (``x + residual``, as the collective forms it) and its output, in
    call order (the sorted leaves)."""
    from repro_torch.train import train_step as ts

    def tap(kind, fn):
        def wrapped(x, residual, cfg, group=None):
            xe = (x.detach().float() + residual.detach().float()).double()
            out, res = fn(x, residual, cfg, group)
            calls.append((kind, xe, out.detach().double()))
            return out, res
        return wrapped

    ts.compressed_psum_ef = tap("ef", ts.compressed_psum_ef)
    ts.quantized_reduce_scatter_ef = tap(
        "qef", ts.quantized_reduce_scatter_ef)


def ef_sums(calls: list, opt: dict, mesh) -> dict:
    """{"ef" / "qef": [per leaf]} the residuals' sum rule after a step,
    from the calls :func:`ef_tap` recorded: the sum over the collective's
    ranks of the new residuals in the optimizer state must equal the sum
    of the inputs (with the old residuals) less the output, the
    collective's whole error (the two-step's phase-1 and owned phase-2
    errors; the reduce-scatter's one quantization), each leaf's largest
    difference over the largest summed input."""
    from repro_torch.core.collectives import all_gather_tiled, all_reduce_sum
    out = {}
    for kind, group in (("ef", mesh.pod), ("qef", mesh.data)):
        mine = [c for c in calls if c[0] == kind]
        if not mine:
            continue
        assert len(mine) == len(leaves(opt[kind])), (kind, len(mine))
        stats = []
        for (g, n), (_, xe, o) in zip(leaves(opt[kind]), mine):
            tot = all_reduce_sum(xe, group)
            if kind == "qef":             # each rank holds its chunk
                o = all_gather_tiled(o, group)
            res = all_reduce_sum(opt[kind][g][n].double(), group)
            stats.append(float((tot - o - res).abs().max()
                               / tot.abs().max()))
        out[kind] = np.array(stats)
    return out


def run(out_dir: str, mesh_spec: str, names, timeout: float = 240,
        arch: str = ARCH, seq: int = SEQ):
    """The JAX reference, then the port's ranks, of ``names`` on
    ``mesh_spec`` for ``arch``'s smoke config at ``seq`` tokens a row ->
    ([rank npz, ...], {name: jax npz})."""
    import subprocess
    dims = [int(v) for v in mesh_spec.split(",")]
    world = dims[0] * dims[1] * (dims[2] if len(dims) > 2 else 1)
    me = os.path.abspath(__file__)
    env = dict(os.environ, OMP_NUM_THREADS="1", XLA_FLAGS=(
        f"--xla_force_host_platform_device_count={world}"))
    # the JAX side and the ranks at once: a rank waits for each file of
    # the JAX side when it first needs it (:func:`wait_load`)
    cmds = [[sys.executable, me, "jax", mesh_spec, out_dir, ",".join(names),
             arch, str(seq)]]
    cmds += [[sys.executable, me, str(r), mesh_spec,
              os.path.join(out_dir, "rendezvous"), out_dir, ",".join(names),
              arch, str(seq)] for r in range(world)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for c in cmds]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0].decode())
        finally:
            for q in procs if p.returncode else ():
                q.kill()
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return ([np.load(os.path.join(out_dir, f"rank{r}.npz"))
             for r in range(world)],
            {n: np.load(os.path.join(out_dir, f"jax_{n}.npz"))
             for n in names})


#: per policy: the bound on loss and grad norm (relative), and on each
#: leaf's relative L2 difference (leaf_stats "rel") of the store's change
#: and of ``m`` and ``v``, at every step (``check`` says where they come
#: from)
BOUNDS = {"bf16": dict(loss=1e-6, grad_norm=1e-6, store=1e-2, moments=1e-4),
          "paper": dict(loss=3e-4, grad_norm=2e-3, store=0.5, moments=0.05),
          "depth": dict(loss=3e-4, grad_norm=2e-3, store=0.5, moments=0.4),
          "aggressive": dict(loss=3e-4, grad_norm=2e-3, store=0.5,
                             moments=0.4)}
BOUNDS["aggressive_ef"] = BOUNDS["aggressive"]
BOUNDS["framed"] = BOUNDS["paper"]
#: per arch, the leaves whose gradient is zero in exact arithmetic, so
#: that both packages' are float32 rounding noise and Adam turns it into
#: steps of either sign: a key bias (``bk``, ``xbk``: the softmax over
#: the keys is invariant to adding ``q . bk`` to every score) and the
#: sLSTM's input-gate bias (``sl_bi``: a constant added to every input
#: gate scales every weight of the normaliser ``c / n`` alike). Their
#: ``m`` is held by its size (:data:`ZERO_GRAD`) in place of its
#: difference, and their ``v`` and store change by none
ZERO_GRAD_LEAVES = {"xlstm-125m": ("pattern/L1_sl_bi",),
                    "whisper-tiny": ("encoder/bk", "pattern/L0_bk",
                                     "pattern/L0_xbk")}
#: such a leaf's ``m`` norm, the port's and JAX's, over the norm of
#: JAX's whole ``m``
ZERO_GRAD = 1e-5
#: the EF residuals' sum rule (:func:`ef_sums`), relative
EF_SUM = 1e-6
#: each EF residual leaf's L2 norm within this factor of JAX's
EF_NORM = 4.0


def check(ranks, want, name: str, arch: str = ARCH) -> None:
    """Hold every rank's run of policy ``name`` against JAX's ``want``,
    every step (each step starts from JAX's weights, so the runs cannot
    drift apart; the moments and residuals are each package's own).

    Without the codec (bf16) the packages differ only in float32
    summation order: loss and grad norm to 1e-6, ``m`` and ``v`` to 1e-4
    of each leaf's L2 norm (measured 2e-6), the store's change to 1e-2
    (6e-4: where a gradient is within rounding of zero, Adam moves the
    element the other way by 2 lr). Under a quantized policy such a
    difference moves a value across a rounding boundary of some wire now
    and then, one code step of its group, and JAX's jitted decode rounds
    differently from the port's (ROADMAP Queue C); the step moves every
    gradient downstream a little. Measured at (2, 2, 2) and (1, 2, 1)
    (``BOUNDS`` holds 1.2-5x each): loss 8.1e-5, grad norm 3.8e-4, the
    store's change 0.28, ``m`` and ``v`` 0.016 (paper), 0.19 (depth),
    0.21 (aggressive). Planted faults read far above: the store never
    updated 1.0; the model axis's sum of the replicated gradients
    dropped: ``m`` 0.79, ``v`` 0.86; ``m`` without its history: 0.7.

    The EF residuals are quantization errors, which a flipped code or a
    group's moved range replaces wholesale, so against JAX's they differ
    by 1.3-2.9 of their norm per leaf even at step 0: they are held by
    their sum rule (:func:`ef_sums`, to 1e-6; measured 9e-8; the
    phase-2 error dropped 0.25, on the wrong chunk 0.30, the residual not
    fed back 0.41, ``qef`` not carried 6e-3) and by their size (each
    leaf's norm within 4x of JAX's; measured 0.32-2.7), and they exist
    exactly where JAX's do.

    The store's change is compared over the parameters, not the flat
    store's padding (the rank's main loop drops it): a shard that holds
    both, as whisper-tiny's biases at (2, 2), quantizes the padding's zero
    gradient to a fraction of a code step of either sign, which Adam
    turns into a step of +-lr (whisper's ``encoder/bv`` at step 0: 0.998
    with the padding, 0.17 without; its ``m`` 0.012).

    A leaf of :data:`ZERO_GRAD_LEAVES` (``arch``'s) has a gradient of
    rounding noise on both sides (measured: xlstm's ``sl_bi`` 2.7e-7
    against 8-230 for the other leaves of its block, one sLSTM on the
    CPU; in training its ``m`` 6.2e-10 of the whole ``m`` in JAX, 2.6e-10
    in the port): its ``m`` must stay within :data:`ZERO_GRAD` of the
    whole ``m`` on both sides, and its other differences are not held.
    """
    bd = BOUNDS[name]
    zero = set(ZERO_GRAD_LEAVES.get(arch, ()))
    for i in range(STEPS):
        rows = {t: sorted(tuple(f.split("/")[2:]) for f in want.files
                          if f.startswith(f"{i}/{t}/")) for t in TREES}
        m_all = np.sqrt(sum(float(np.sum(want[f"{i}/m/{g}/{n}"]
                                         .astype(np.float64) ** 2))
                            for g, n in rows["m"]))
        for r, res in enumerate(ranks):
            tag = f"{name} step {i} rank {r}"
            for k in ("loss", "grad_norm"):
                got, exp = float(res[f"{name}/{i}/{k}"]), float(
                    want[f"{i}/{k}"])
                assert np.isfinite(got) and abs(got - exp) <= bd[k] * abs(
                    exp), (tag, k, got, exp)
            for tree in TREES:
                key = f"{name}/{i}/{tree}"
                has = any(f.startswith(f"{i}/{tree}/") for f in want.files)
                assert (key in res.files) == has, (tag, tree)
                if not has:
                    continue
                rel, ratio = res[key].T
                if tree in ("ef", "qef"):
                    sums = res[f"{key}_sum"]
                    assert sums.max() <= EF_SUM, (tag, tree, sums.max())
                    assert (ratio.min() >= 1 / EF_NORM
                            and ratio.max() <= EF_NORM), (
                        tag, tree, ratio.min(), ratio.max())
                    continue
                held = np.array([f"{g}/{n}" not in zero
                                 for g, n in rows[tree]])
                assert len(held) == len(rel), (tag, tree)
                b = bd["store" if tree == "store" else "moments"]
                assert rel[held].max() <= b, (tag, tree, rel[held].max(), b)
                if tree != "m":
                    continue
                for j in np.flatnonzero(~held):
                    g, n = rows[tree][j]
                    jm = float(np.linalg.norm(want[f"{i}/m/{g}/{n}"]))
                    assert max(jm, jm * ratio[j]) <= ZERO_GRAD * m_all, (
                        tag, g, n, jm, ratio[j], m_all)


def leaves(tree) -> list:
    """(group, name) of every leaf of a state tree, sorted: the rows of
    a tree's statistics."""
    return [(g, n) for g in sorted(tree) for n in sorted(tree[g])]


def local(arr: np.ndarray, plan, m: int, d: int) -> np.ndarray:
    """A JAX ``(n_stack, tp, flat)`` state array -> the ``(n_stack,
    flat / fsdp)`` shard of model rank ``m``, data rank ``d``."""
    k = arr.shape[2] // plan.fsdp
    return arr[:, m, d * k:(d + 1) * k]


def jax_reference(mesh_spec: str, out_dir: str, names,
                  arch: str = ARCH, seq: int = SEQ) -> None:
    """The JAX side (its own process, with enough fake devices)."""
    import zlib

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.core import policy as jpolicy
    from repro.launch.mesh import make_test_mesh
    from repro.models import model as jmodel
    from repro.parallel import shardings as jshard
    from repro.parallel.plan import make_plan
    from repro.train.data import DataConfig, make_dataset, to_device
    from repro.train.optim import OptimConfig
    from repro.train.train_step import (init_train_state, make_train_step,
                                        wants_grad_ef, wants_qgrad_ef)
    dims = [int(v) for v in mesh_spec.split(",")]
    data, model, pod = dims[0], dims[1], dims[2] if len(dims) > 2 else 0
    mesh = make_test_mesh(data=data, model=model, pod=pod)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    plan = make_plan(cfg, tp=model, fsdp=data)
    oc = OptimConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    jshard.hash = lambda s: zlib.crc32(s.encode())
    store0 = jshard.build_store(jmodel.param_groups(cfg, plan), plan,
                                jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(7)
    init, store_np = {}, {}
    for g, arrs in sorted(store0.items()):
        store_np[g] = {}
        for name, a in sorted(arrs.items()):
            a = np.array(a)
            if not a.any():                      # zero-init projections
                a = (rng.standard_normal(a.shape) * 0.05).astype(np.float32)
            store_np[g][name] = init[f"store/{g}/{name}"] = a
    save_npz(os.path.join(out_dir, "init.npz"), **init)
    pols = {"bf16": jpolicy.BF16_POLICY, "paper": jpolicy.paper_policy(),
            "depth": jpolicy.depth_policy(),
            "aggressive": jpolicy.aggressive_policy()}
    pols["aggressive_ef"] = dataclasses.replace(pols["aggressive"],
                                                grad_ef=True)
    pols["framed"] = jpolicy.with_framed_bridge(pols["paper"], 8)
    sh = NamedSharding(mesh, jshard.STORE_SPEC)
    ds = make_dataset(data_config(DataConfig, cfg, seq))

    def put(x):                   # placed as the step returns them
        return jax.device_put(x, sh if x.ndim == 3
                              else NamedSharding(mesh, P()))

    def flat(tree, prefix, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, f"{prefix}{k}/", out)
            else:
                out[prefix + k] = np.asarray(v)

    for name in names:
        pol = jpolicy.with_backend(pols[name], "ref")
        store = jax.tree_util.tree_map(lambda a: put(jnp.asarray(a)),
                                       store_np)
        step = make_train_step(cfg, plan, pol, oc, mesh, global_batch=BATCH)
        opt = jax.tree_util.tree_map(put, init_train_state(
            store, oc, grad_ef=wants_grad_ef(pol, mesh),
            qgrad_ef=wants_qgrad_ef(pol, plan), fsdp=plan.fsdp))
        res = {}
        for i in range(STEPS):
            # the stub embeddings at the model's float32, as the port takes
            # them (to_device's default rounds them to bf16)
            store, opt, m = step(store, opt, to_device(ds.batch(i),
                                                       jnp.float32))
            for k, v in m.items():
                res[f"{i}/{k}"] = np.asarray(v)
            flat(store, f"{i}/store/", res)
            flat({k: v for k, v in opt.items() if k != "step"}, f"{i}/",
                 res)
        save_npz(os.path.join(out_dir, f"jax_{name}.npz"), **res)


COLL_N, COLL_K = 2048, 512
#: case -> (function, config keywords, backward config keywords)
COLL_CASES = {
    "psum": ("psum", dict(bits=8, group=128), None),
    "psum_bwd": ("psum", dict(bits=8, group=128), dict(bits=8, group=128)),
    "psum_hierpp": ("psum", dict(bits=4, group=32, spike=True,
                                 scale_int=True, scheme="hier_pp"), None),
    "psum_fused": ("psum", dict(bits=8, group=128, scheme="fused"), None),
    "qrs": ("qrs", dict(bits=8, group=128), None),
    "qag": ("qag", dict(bits=4, group=32, scale_int=True), None),
    "fsdp": ("fsdp", dict(bits=4, group=32, scale_int=True), None),
    "fsdp_exact": ("fsdp", None, None),
    "ef_two_step": ("ef", dict(bits=2, group=32, spike=True), None),
    "ef_hierpp": ("ef", dict(bits=4, group=32, spike=True, scale_int=True,
                             scheme="hier_pp"), None),
    "ef_fused": ("ef", dict(bits=8, group=128, scheme="fused"), None),
    "qrs_ef": ("qrs_ef", dict(bits=8, group=128), None),
    "grad_all_reduce": ("gar", dict(bits=8, group=128,
                                    scheme="hierarchical"), None),
    # two axes: inner = pairs of consecutive ranks, outer = across pairs
    "hier2": ("psum2", dict(bits=8, group=128, scheme="hierarchical"),
              dict(bits=8, group=128)),
    "hier2_pp": ("psum2", dict(bits=8, group=128, scheme="hier_pp"), None),
    "two_step2_outer": ("psum2", dict(bits=8, group=128), None),
    # the framed bridge: an 8-bit framed outer wire (COLL_FRAMED_OUTER)
    # over a 4-bit inner tier, each scheme; hierarchical_all_reduce's
    # small-remainder branch (the outer hop a quantized all-gather and a
    # local sum: n / inner = 128 values, no multiple of outer * group),
    # forward only; the pod site with error feedback, framed hier_pp
    "framed2": ("psum2f", dict(bits=4, group=32), None),
    "framed2_hier": ("psum2f", dict(bits=4, group=32, scheme="hierarchical"),
                     None),
    "framed2_hierpp": ("psum2f", dict(bits=4, group=32, scheme="hier_pp"),
                       None),
    "framed2_remainder": ("hrem", dict(bits=4, group=32,
                                       scheme="hierarchical"), None),
    "ef_framed_hierpp": ("ef", dict(bits=8, group=128, scheme="hier_pp",
                                    framed=True), None),
    # moe_apply's collectives: the dispatch (paper's int4 g32 wire, two
    # schedules), the combine's all-to-all, ep_slice's tiled all-gather of
    # the outputs and its aux loss's mean over the ranks
    "dispatch": ("dispatch", dict(bits=4, group=32), None),
    "dispatch_fused": ("dispatch", dict(bits=4, group=32, scheme="fused"),
                       None),
    "combine": ("a2a", None, None),
    "ep_gather": ("gather", None, None),
    "aux_mean": ("pmean", None, None),
}
#: the (tp, rows, d) blocks of a dispatch or combine case's input row
COLL_D = 256
#: the functions whose input is ``xk`` and cotangent ``ct_ag``
COLL_GATHERS = ("qag", "fsdp", "gather")
#: the outer (bridge) wire of the two-axis cases
COLL_OUTER = dict(bits=4, group=32, spike=True)
#: the framed outer wire of the ``psum2f`` and ``hrem`` cases
COLL_FRAMED_OUTER = dict(bits=8, group=128, framed=True)
#: values of the ``hrem`` case's input (the first of each rank's row)
COLL_REM_N = 256
#: the functions without a backward (no custom VJP in JAX either)
COLL_FORWARD_ONLY = ("hrem",)
#: the cases held against JAX's eager run (``jax.disable_jit``) of the
#: same call with the frames removed, bit for bit: the two-step over two
#: axes with the 4-bit inner tier, where JAX's jitted run differs from its
#: own eager run in 2.1% of the values (a phase-2 code step of the inner
#: tier; the port equals the eager run, ROADMAP Queue C). JAX's eager
#: framed decode would scan every wire byte in Python; its own check holds
#: its framed run equal to its unframed run bit for bit
#: (tests/_multidev_script.py check_framed_bridge). The other framed cases
#: equal JAX's jitted framed run bit for bit.
COLL_EAGER = ("framed2",)


def framed_twin(fn: str, cfg):
    """A framed case's unframed twin: the case's call with every framed
    wire unframed (``psum2f`` / ``hrem``: the outer wire; ``ef``: the
    config), or None for an unframed case."""
    from repro_torch.core.comm_config import CommConfig
    if fn in ("psum2f", "hrem"):
        return cfg, CommConfig(**COLL_FRAMED_OUTER).with_framed(False)
    if fn == "ef" and cfg.framed:
        return cfg.with_framed(False), None
    return None


def coll_inputs(world: int):
    """Every rank's input row, residual and cotangents (numpy, seeded)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((world, COLL_N)) * 2).astype(np.float32)
    x[1, 37] = 40.0
    return {"x": x,
            "r": (rng.standard_normal((world, COLL_N)) * 0.01).astype(
                np.float32),
            "xk": rng.standard_normal((world, COLL_K)).astype(np.float32),
            "ct": rng.standard_normal((world, COLL_N)).astype(np.float32),
            "ct_rs": rng.standard_normal((world, COLL_N // world)).astype(
                np.float32),
            "ct_ag": rng.standard_normal((world, world * COLL_K)).astype(
                np.float32)}


def coll_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """One rank of the collectives' gloo run (mode ``coll``)."""
    import torch.distributed as dist
    from repro_torch.core import collectives as C
    from repro_torch.core.comm_config import CommConfig
    from repro_torch.parallel.shardings import fsdp_all_gather
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    from repro_torch.parallel.axis import ModelAxis
    g = dist.group.WORLD
    pairs = [dist.new_group(r) for r in ([0, 1], [2, 3])]   # inner axis
    cross = [dist.new_group(r) for r in ([0, 2], [1, 3])]   # outer axis
    axes = (ModelAxis(pairs[rank // 2], rank % 2, 2),
            ModelAxis(cross[rank % 2], rank // 2, 2))
    inp = {k: torch.from_numpy(v[rank]) for k, v in
           coll_inputs(world).items()}
    out = {}
    try:
        for case, (fn, kw, bkw) in COLL_CASES.items():
            cfg = None if kw is None else CommConfig(**kw)
            bwd = None if bkw is None else CommConfig(**bkw)
            big = fn not in COLL_GATHERS
            twin = framed_twin(fn, cfg)
            if fn == "hrem":
                with torch.no_grad():
                    for key, outer in (("out", COLL_FRAMED_OUTER),
                                       ("twin", None)):
                        out[f"{case}/{key}"] = C.hierarchical_all_reduce(
                            inp["x"][:COLL_REM_N], axes[0], axes[1], cfg,
                            CommConfig(**outer) if outer else twin[1]
                        ).numpy()
                continue
            if twin is not None:      # the same call, every wire unframed
                with torch.no_grad():
                    if fn == "ef":
                        y, res = C.compressed_psum_ef(inp["x"], inp["r"],
                                                      twin[0], g)
                        out[f"{case}/twin_res"] = res.numpy()
                    else:
                        y = C.compressed_psum(inp["x"], twin[0], axes, bwd,
                                              twin[1])
                    out[f"{case}/twin"] = y.numpy()
            x = (inp["x"] if big else inp["xk"]).clone().requires_grad_()
            r = inp["r"].clone().requires_grad_()
            if fn == "psum2f":
                y = C.compressed_psum(x, cfg, axes, bwd,
                                      CommConfig(**COLL_FRAMED_OUTER))
            elif fn == "psum":
                y = C.compressed_psum(x, cfg, g, bwd)
            elif fn == "psum2":
                y = C.compressed_psum(x, cfg, axes, bwd,
                                      CommConfig(**COLL_OUTER))
            elif fn == "gar":
                y = C.grad_all_reduce({"a": {"w": x}}, [g], cfg)["a"]["w"]
            elif fn == "qrs":
                y = C.quantized_reduce_scatter(x, cfg, g)
            elif fn == "qag":
                y = C.quantized_all_gather(x, cfg, g)
            elif fn == "fsdp":
                y = fsdp_all_gather(x, cfg, g)
            elif fn == "dispatch":
                y = C.dispatch_all_to_all(x.reshape(world, -1, COLL_D), cfg,
                                          g).reshape(-1)
            elif fn == "a2a":
                y = C.all_to_all_rows(x.reshape(world, -1, COLL_D),
                                      g).reshape(-1)
            elif fn == "gather":
                y = C.all_gather_rows(x.reshape(-1, COLL_D), g).reshape(-1)
            elif fn == "pmean":
                y = C.psum_exact(x, g) / world
            elif fn == "ef":
                y, res = C.compressed_psum_ef(x, r, cfg, g)
            else:
                y, res = C.quantized_reduce_scatter_ef(x, r, cfg, g)
            ct = {"qrs": "ct_rs", "qrs_ef": "ct_rs"}.get(
                fn, "ct_ag" if fn in COLL_GATHERS else "ct")
            y.backward(inp[ct])
            out[f"{case}/out"] = y.detach().numpy()
            out[f"{case}/grad"] = x.grad.numpy()
            if fn in ("ef", "qrs_ef"):
                out[f"{case}/res"] = res.detach().numpy()
                out[f"{case}/grad_r"] = r.grad.numpy()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"coll{rank}.npz"), **out)


FRAMED_STEPS = 2


def framed_policies():
    """paper with ``--framed-bridge 8``, the same bridge unframed, and
    paper itself (its grad site int8 g128 hierarchical). With ``framed``
    among the policies of a --mesh 1,1,2 run, each rank also trains the
    three from one store (:func:`framed_equality`)."""
    from repro_torch.core.policy import (paper_policy, uniform,
                                         with_framed_bridge)
    framed = with_framed_bridge(paper_policy(), 8)
    return {"framed": framed,
            "unframed": dataclasses.replace(framed, bridge=uniform(
                framed.bridge.base.with_framed(False))),
            "paper": paper_policy()}


def framed_equality(mesh) -> dict:
    """On this rank of --mesh 1,1,2: each of :func:`framed_policies` for
    FRAMED_STEPS steps from the seed-0 store -> its metrics and store
    after the steps (``eq/{policy}/...``), each run's CRC calls (one a
    framed encode and one a framed decode) and the number of leaves."""
    from repro_torch.kernels import ops
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.shardings import init_store
    from repro_torch.train.data import DataConfig, make_dataset
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import local_batch, make_train_step_fn
    cpu = torch.device("cpu")
    cfg = train_config()
    plan = make_plan(cfg, tp=1, fsdp=1)
    ds = make_dataset(data_config(DataConfig, cfg))
    calls = [0]
    crc_rows = ops.crc32c_rows

    def counted(*a, **k):
        calls[0] += 1
        return crc_rows(*a, **k)

    ops.crc32c_rows = counted
    out = {}
    try:
        for name, policy in framed_policies().items():
            calls[0] = 0
            store = init_store(cfg, plan, 0, cpu)
            opt = init_opt_state(store, opt_config())
            step = make_train_step_fn(cfg, plan, policy, opt_config(), mesh)
            for i in range(FRAMED_STEPS):
                store, opt, metrics = step(store, opt, local_batch(
                    ds.batch(i), mesh, cpu))
                for k, v in metrics.items():
                    out[f"eq/{name}/{i}/{k}"] = v.numpy()
            for g, n in leaves(store):
                out[f"eq/{name}/store/{g}/{n}"] = store[g][n].numpy()
            out[f"eq/{name}_crc_calls"] = np.asarray(calls[0])
        out["eq/leaves"] = np.asarray(len(leaves(store)))
    finally:
        ops.crc32c_rows = crc_rows
    return out


def main():
    if sys.argv[1] == "coll":
        return coll_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                         sys.argv[5])
    if sys.argv[1] == "jax":
        return jax_reference(sys.argv[2], sys.argv[3],
                             sys.argv[4].split(","), *sys.argv[5:6],
                             *map(int, sys.argv[6:7]))
    rank, mesh_spec = int(sys.argv[1]), sys.argv[2]
    init_file, out_dir = sys.argv[3], sys.argv[4]
    names = sys.argv[5].split(",")
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.model import param_groups
    from repro_torch.parallel.axis import axis_rank
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.shardings import load_jax_store
    from repro_torch.train.data import DataConfig, make_dataset
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import (local_batch, make_train_step_fn,
                                              wants_grad_ef, wants_qgrad_ef)
    data, model, pod = mesh_lib.parse_train_mesh(mesh_spec)
    cpu = torch.device("cpu")
    mesh = mesh_lib.init_mesh(data, model, pod, rank, init_file, cpu, 0)
    cfg = train_config(*sys.argv[6:7])
    seq = int(sys.argv[7]) if len(sys.argv) > 7 else SEQ
    plan = make_plan(cfg, tp=model, fsdp=data)
    m, d = axis_rank(mesh.model), axis_rank(mesh.data)
    init = wait_load(os.path.join(out_dir, "init.npz"))
    store_np = read_store(init)
    ds = make_dataset(data_config(DataConfig, cfg, seq))
    numel = {g: {n: sp.numel_loc(plan) for n, sp in specs.items()}
             for g, (_, specs) in param_groups(cfg, plan).items()}
    out, calls = {}, []
    ef_tap(calls)
    try:
        for name in names:
            policy = policies()[name]
            want = None                   # JAX's, waited for when needed
            store = load_jax_store(store_np, cfg, plan, cpu, rank=m,
                                   data_rank=d)
            opt = init_opt_state(store, opt_config(),
                                 grad_ef=wants_grad_ef(policy, mesh),
                                 qgrad_ef=wants_qgrad_ef(policy, plan),
                                 fsdp=plan.fsdp)
            step = make_train_step_fn(cfg, plan, policy, opt_config(), mesh)
            for i in range(STEPS):
                # every step starts from JAX's weights: step 0 from the
                # init (as load_jax_store sliced it), the others from
                # JAX's store after the step before
                src, start = (init, "store") if i == 0 else (
                    want, f"{i - 1}/store")
                for g, n in leaves(store) if i else ():
                    store[g][n].copy_(torch.from_numpy(local(
                        src[f"{start}/{g}/{n}"], plan, m, d)))
                store, opt, metrics = step(store, opt, local_batch(
                    ds.batch(i), mesh, cpu))
                if want is None:
                    want = wait_load(os.path.join(out_dir,
                                                  f"jax_{name}.npz"))
                for k, v in metrics.items():
                    out[f"{name}/{i}/{k}"] = v.numpy()
                for tree, st in ef_sums(calls, opt, mesh).items():
                    out[f"{name}/{i}/{tree}_sum"] = st
                calls.clear()
                state = {"store": store, **opt}
                for tree in TREES:
                    if tree not in state:
                        continue
                    stats = []
                    for g, n in leaves(state[tree]):
                        sl = local(want[f"{i}/{tree}/{g}/{n}"], plan, m, d)
                        got = state[tree][g][n].numpy().reshape(sl.shape)
                        s0 = None
                        if tree == "store":
                            # the parameters' change: the flat store's
                            # padding is no parameter, and Adam moves it by
                            # +-lr on the sign of its decoded gradient, a
                            # fraction of a code step of zero on each side
                            s0 = local(src[f"{start}/{g}/{n}"], plan, m, d)
                            k = sl.shape[1]
                            keep = np.arange(d * k, (d + 1) * k) < numel[g][n]
                            got, sl, s0 = got[:, keep], sl[:, keep], \
                                s0[:, keep]
                        stats.append(leaf_stats(got, sl, s0))
                    out[f"{name}/{i}/{tree}"] = np.stack(stats)
        if "framed" in names and mesh_spec == "1,1,2":
            out.update(framed_equality(mesh))
    finally:
        mesh_lib.close_mesh(mesh)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
