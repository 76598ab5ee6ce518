"""grok-1-314b and llama4-maverick-400b-a17b: the port against the JAX
package at tp = 1.

grok-1 is the first ported config with GeGLU experts (the tanh GELU of
``repro_torch.models.layers.gelu``), llama4-maverick the first with top-1
routing and with two block kinds inside one pattern repeat (``dense``,
``moe``: the ``L0_`` / ``L1_`` parameter names and the global layer index
each block's sites resolve at). Both packages run the same float32
weights (``build_store`` with a crc32 in place of the salted ``hash``,
the zero-initialised output projections filled from a seeded normal, as
``tests/test_torch_serve.py`` does), on the same prompts.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.policy import BF16_POLICY as JBF16
from repro.core.policy import depth_policy as jdepth
from repro.core.policy import paper_policy as jpaper
from repro.core.policy import with_backend as jwith_backend
from repro.launch.mesh import make_test_mesh
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.parallel import shardings as jshard
from repro.parallel.plan import make_plan as jmake_plan
from repro.train import serve_step as jserve
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.policy import BF16_POLICY, depth_policy, paper_policy
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import moe
from repro_torch.models.model import forward, greedy_next_token
from repro_torch.parallel.plan import make_plan
from repro_torch.parallel.shardings import load_jax_store
from repro_torch.train import serve_step
from repro_torch.train.data import DataConfig, make_dataset
from _torch_threads import one_torch_thread  # noqa: E402,F401

ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
B, S, GEN = 2, 12, 3
POLICIES = {"paper": (lambda: jwith_backend(jpaper(), "ref"), paper_policy),
            "bf16": (lambda: JBF16, lambda: BF16_POLICY)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _store(jcfg, jplan):
    """JAX's float32 store of ``jcfg`` on ``jplan`` as numpy, its zero
    initialised output projections filled from a seeded normal."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jshard, "hash", lambda s: zlib.crc32(s.encode()),
                   raising=False)
        store = jshard.build_store(jmodel.param_groups(jcfg, jplan), jplan,
                                   jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(7)
    out = {}
    for g, arrs in sorted(store.items()):
        out[g] = {}
        for name, a in sorted(arrs.items()):
            a = np.array(a)
            if not a.any():                      # zero-init projections
                a = (rng.standard_normal(a.shape) * 0.05).astype(np.float32)
            out[g][name] = a
    return out


@pytest.fixture(scope="module")
def setups():
    """arch -> its smoke config's setup in both packages (built once)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = dataclasses.replace(jax_smoke_config(arch),
                                       dtype="float32")
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      dtype="float32")
            jplan = jmake_plan(jcfg, tp=1, fsdp=1)
            plan = make_plan(cfg, tp=1)
            store_np = _store(jcfg, jplan)
            cache[arch] = dict(
                jcfg=jcfg, cfg=cfg, jplan=jplan, plan=plan,
                jstore=jax.tree_util.tree_map(jnp.asarray, store_np),
                params=load_jax_store(store_np, cfg, plan, "cpu",
                                      torch.float32),
                prompts=make_dataset(DataConfig(
                    vocab=cfg.vocab, seq_len=S,
                    global_batch=B)).batch(0)["tokens"],
                mesh=make_test_mesh(1, 1))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """The full and smoke configs equal JAX's field by field (every field
    of the port's schema, the MoE config's too), and the registry serves
    both ids."""
    assert arch in ARCH_IDS
    for got, want in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if f.name == "moe":
                g, w = dataclasses.asdict(g), dataclasses.asdict(w)
            assert g == w, (arch, f.name, g, w)
    full = get_config(arch)
    assert (full.moe.top_k, full.act) == {
        "grok-1-314b": (2, "geglu"),
        "llama4-maverick-400b-a17b": (1, "swiglu")}[arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pol", list(POLICIES))
def test_prefill_hidden_and_next_token(setups, pol, arch):
    """The prefill's hidden states agree with JAX's: within 2e-4 of their
    max magnitude without the codec (float32 summation order; measured
    1.3e-6 at most), as in ``tests/test_torch_serve.py``. Under the paper
    policy a TP site's int8 code can flip where a value lies at a rounding
    boundary: llama4-maverick's layer-0 MLP site gets inputs 3e-7 apart
    at position 7 of row 0 and gives outputs one code step apart
    (0.00635). In an MoE model that step reaches the next layer's int4
    dispatch, whose codes then flip too, and the step moves the token's
    later layers and its row's later positions through attention
    (measured: 5 of the 24 positions beyond the float32 bound, by up to
    0.025 max|h|). So there, as in ``tests/test_torch_serve_tp.py``, at
    most a quarter of the positions may move beyond the float32 bound,
    each element within one int4 step of the widest dispatch group
    (2 max|h| / 15). The greedy next tokens are equal."""
    s = setups(arch)
    jpol, tpol = POLICIES[pol]

    def hidden_fn(store, toks):
        return jmodel.forward(store, toks, s["jcfg"], s["jplan"], jpol(),
                              dtype=jnp.float32)[0]

    jh = compat.shard_map(hidden_fn, mesh=s["mesh"],
                          in_specs=(jshard.store_spec(s["jplan"]), P()),
                          out_specs=P(), check_vma=False)
    want = np.asarray(jax.jit(jh)(s["jstore"], jnp.asarray(s["prompts"])))
    toks = torch.from_numpy(s["prompts"])
    with torch.no_grad():
        h = forward(s["params"], toks, s["cfg"], s["plan"], tpol(),
                    dtype=torch.float32)[0].numpy()
    hmax = np.abs(want).max()
    diff = np.abs(h - want)
    if pol == "bf16":
        assert diff.max() <= 2e-4 * hmax, diff.max() / hmax
    else:
        assert np.mean(diff.max(-1) > 2e-4 * hmax) <= 0.25
        assert diff.max() <= 2 * hmax / 15
    jprefill = jserve.make_prefill(s["jcfg"], s["jplan"], jpol(), s["mesh"],
                                   B)
    want_tok = np.asarray(jprefill(s["jstore"],
                                   {"tokens": jnp.asarray(s["prompts"])}))
    got_tok = greedy_next_token(serve_step.make_prefill(
        s["cfg"], s["plan"], tpol())(s["params"], toks), s["plan"]).numpy()
    np.testing.assert_array_equal(got_tok, want_tok)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pol", list(POLICIES))
def test_decode_tokens_match_jax(setups, pol, arch):
    """The decode loop (the prompt teacher-forced through the cache, then
    greedy) gives JAX's token at every step; at batch 2 the decode's
    capacity is 2 slots an expert (grok-1, top-2 of 4) or 1
    (llama4-maverick, top-1 of 4)."""
    s = setups(arch)
    jpol, tpol = POLICIES[pol]
    clen = S + GEN
    jstep = jserve.make_decode_step(s["jcfg"], s["jplan"], jpol(),
                                    s["mesh"], B, clen)
    jcache = jserve.make_cache_init(s["jcfg"], s["jplan"], s["mesh"], B,
                                    clen)()
    tstep = serve_step.make_decode_step(s["cfg"], s["plan"], tpol())
    tcache = serve_step.make_cache_init(s["cfg"], s["plan"], B, clen,
                                        "cpu")()
    prompts = s["prompts"]
    tok = prompts[:, :1]
    for i in range(S + GEN - 1):
        jn, jcache = jstep(s["jstore"], jcache,
                           {"tokens": jnp.asarray(tok, jnp.int32)})
        tl, tcache = tstep(s["params"], tcache, torch.tensor(tok))
        np.testing.assert_array_equal(
            greedy_next_token(tl, s["plan"]).numpy(), np.asarray(jn),
            err_msg=f"step {i}")
        tok = prompts[:, i + 1:i + 2] if i + 1 < S else np.asarray(jn)[:, None]


def _values(seed: int, shape, scale: float = 3.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gelu_matches_jax(dtype):
    """The port's tanh GELU against ``jax.nn.gelu(approximate=True)`` on
    2^20 normal values (std 3) and a grid over [-12, 12]: bf16 bit for bit
    (JAX's formula op for op, each op rounded to bf16, its constants
    too); float32 within 2^-22 max(|x|, 1), where the two tanh
    implementations differ (measured 2.4e-7)."""
    x = np.concatenate([_values(0, 1 << 20),
                        np.linspace(-12, 12, 200001, dtype=np.float32)])
    jd, td = DTYPES[dtype]
    want = np.asarray(jax.jit(jlayers.gelu)(jnp.asarray(x, jd)).astype(
        jnp.float32))
    got = tlayers.gelu(torch.from_numpy(x).to(td)).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    else:
        assert (np.abs(got - want) <= 2 ** -22 * np.maximum(
            np.abs(x), 1)).all()


def _mlp_inputs(d: int = 256, f: int = 512):
    x = _values(1, (2, 6, d), 1.0)
    return x, {k: _values(i + 2, shape, 1 / np.sqrt(shape[0]))
               for i, (k, shape) in enumerate(
                   (("w1", (d, f)), ("w3", (d, f)), ("w2", (f, d))))}


def _shard_map1(fn, n_in: int, n_out: int = 1):
    out = P() if n_out == 1 else (P(),) * n_out
    return jax.jit(compat.shard_map(fn, mesh=make_test_mesh(1, 1),
                                    in_specs=(P(),) * n_in, out_specs=out,
                                    check_vma=False))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlp_geglu_matches_jax(dtype):
    """``mlp_apply`` with ``act="geglu"`` against JAX's at tp = 1 (no
    codec): float32 within 1e-5 of the output's max magnitude (the
    matmuls' summation order; measured 5.1e-7), bf16 within one bf16
    rounding of it, 2^-8 (measured: bit for bit). A SwiGLU in place of
    the GeGLU reads 0.127 of it."""
    x, w = _mlp_inputs()
    jd, td = DTYPES[dtype]

    def jfn(x, w1, w2, w3):
        return jlayers.mlp_apply({"w1": w1, "w2": w2, "w3": w3}, x, "geglu",
                                 JBF16, layer=0)

    want = np.asarray(_shard_map1(jfn, 4)(*(jnp.asarray(a, jd) for a in (
        x, w["w1"], w["w2"], w["w3"]))).astype(jnp.float32))
    with torch.no_grad():
        got = tlayers.mlp_apply({k: torch.from_numpy(v).to(td)
                                 for k, v in w.items()},
                                torch.from_numpy(x).to(td), "geglu",
                                BF16_POLICY, layer=0).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_geglu_matches_jax(setups, dtype):
    """``moe_apply`` of grok-1's smoke MoE layer (4 GeGLU experts, top-2)
    against JAX's at tp = 1 under bf16 (no codec), on tokens that lean
    towards expert 0 so that its queue overflows (the same routes kept
    in both): float32 within 2e-4 of the output's max magnitude
    (measured 6.0e-7), bf16 within two bf16 roundings of it, 2^-7 (the
    experts' bf16 matmuls round a sum apart now and then; measured
    7.0e-4, 0.13% of the values not bit for bit). The aux losses agree
    to 1e-5 relative (measured: float32 exactly, bf16 6.6e-8)."""
    s = setups("grok-1-314b")
    jd, td = DTYPES[dtype]
    p = {k: v[0].numpy() for k, v in s["params"]["pattern"].items()
         if k.startswith("L0_moe_")}
    p = {k[len("L0_"):]: v for k, v in p.items()}
    lean = p["moe_router"][:, 0] / np.linalg.norm(p["moe_router"][:, 0])
    x = (_values(21, (24, 256), 1.0) + 3 * lean).reshape(2, 12, 256)
    names = sorted(p)

    def jfn(x, *ws):
        return jmoe.moe_apply(dict(zip(names, ws)), x, s["jcfg"],
                              s["jplan"], JBF16, layer=0)

    want, jaux = (np.asarray(a).astype(np.float32) for a in _shard_map1(
        jfn, 1 + len(names), 2)(jnp.asarray(x, jd),
                                *(jnp.asarray(p[n], jd) for n in names)))
    stats = {}
    with torch.no_grad():
        got, aux = moe.moe_apply(
            {n: torch.from_numpy(p[n]).to(td) for n in names},
            torch.from_numpy(x).to(td), s["cfg"], s["plan"],
            BF16_POLICY.bind(2), layer=0, stats=stats)
    assert int(stats["dropped"]) > 0
    got = got.float().numpy()
    tol = 2e-4 if dtype == "float32" else 2 ** -7
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_route_top1_matches_jax():
    """``route`` at top-1 (llama4-maverick's smoke config) against the
    JAX package's routing lines (``lax.top_k``): the same expert, the
    same queue positions and kept routes, and a renormalised weight of
    exactly 1. Ties go to the lower expert in both: the router's columns
    1 and 3 are equal, and so are columns 0 and 2 for the tokens of the
    second half, whose projection on column 1 is made zero."""
    cfg = get_smoke_config("llama4-maverick-400b-a17b")
    jcfg = jax_smoke_config("llama4-maverick-400b-a17b")
    assert cfg.moe.top_k == 1
    rng = np.random.default_rng(5)
    router = rng.standard_normal((256, 4)).astype(np.float32)
    router[:, 3] = router[:, 1]
    router[:, 2] = router[:, 0]
    x = rng.standard_normal((40, 256)).astype(np.float32)
    c1 = router[:, 1] / np.dot(router[:, 1], router[:, 1])
    x[20:] -= np.outer(x[20:] @ router[:, 1], c1).astype(np.float32) * 2
    x[20:] += np.outer(np.abs(x[20:] @ router[:, 0]) + 1,
                       router[:, 0] / np.dot(router[:, 0], router[:, 0])
                       ).astype(np.float32)
    xj, rj = jnp.asarray(x), jnp.asarray(router)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xj, rj), axis=-1)
    topv, topi = lax.top_k(probs, 1)
    topv = topv / jnp.maximum(jnp.sum(topv, -1, keepdims=True), 1e-9)
    re = topi.reshape(-1)
    pos = jnp.take_along_axis(jnp.cumsum(jax.nn.one_hot(
        re, 4, dtype=jnp.int32), axis=0) - 1, re[:, None], axis=1)[:, 0]
    keep = pos < jmoe.capacity(40, jcfg)
    ti, tv, tpos, tkeep, _ = moe.route(torch.from_numpy(x),
                                       torch.from_numpy(router), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(topi))
    assert set(ti[:, 0].tolist()) == {0, 1}        # the lower of each tie
    np.testing.assert_array_equal(tv.numpy(), np.ones((40, 1), np.float32))
    np.testing.assert_array_equal(np.asarray(topv), tv.numpy())
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    assert moe.capacity(40, cfg) == jmoe.capacity(40, jcfg) == 16
    assert not tkeep.all()


@pytest.mark.parametrize("arch", ARCHS)
def test_pattern_layout_matches_jax(arch):
    """Parameter groups, names, shapes and sharding at full width equal
    JAX's ``param_groups`` (tp 1 and 16); and with the smoke config's
    pattern repeated 3 times under a depth policy (each repeat its own
    traced segment in JAX), every block runs in the same order, with
    the same kind, the same parameter names (the ``L{j}_`` prefix of
    the pattern's block j stripped), and the same global layer index
    (the one its sites resolve their configs at) as in JAX."""
    for tp in (1, 16):
        got = tmodel.param_groups(get_config(arch),
                                  make_plan(get_config(arch), tp=tp))
        want = jmodel.param_groups(jax_config(arch),
                                   jmake_plan(jax_config(arch), tp=tp,
                                              fsdp=1))
        assert sorted(got) == sorted(want)
        for g, (n, specs) in got.items():
            assert n == want[g][0], g
            assert sorted(specs) == sorted(want[g][1]), g
            for name, sp in specs.items():
                w = want[g][1][name]
                assert (sp.shape, sp.tp_dim, sp.init, sp.moe_fold) == (
                    w.shape, w.tp_dim, w.init, w.moe_fold), (g, name)
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               pattern_repeats=3)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              pattern_repeats=3)
    jplan, plan = jmake_plan(jcfg, tp=1, fsdp=1), make_plan(cfg, tp=1)
    assert len(jmodel.policy_segments(
        jcfg, jdepth().bind(jcfg.n_layers))) == 3
    store_np = _store(jcfg, jplan)
    toks = np.zeros((1, 4), np.int64)
    seen = {"jax": [], "port": []}

    def tap(mod, key):
        orig = mod.apply_block

        def wrapped(kind, p, x, **kw):
            seen[key].append((kind, kw["layer"], tuple(sorted(p))))
            return orig(kind, p, x, **kw)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "apply_block", tap(jmodel, "jax"))
        mp.setattr(tmodel, "apply_block", tap(tmodel, "port"))
        jax.jit(compat.shard_map(
            lambda st, t: jmodel.forward(st, t, jcfg, jplan,
                                         jwith_backend(jdepth(), "ref"),
                                         dtype=jnp.float32)[0],
            mesh=make_test_mesh(1, 1),
            in_specs=(jshard.store_spec(jplan), P()), out_specs=P(),
            check_vma=False))(jax.tree_util.tree_map(jnp.asarray, store_np),
                              jnp.asarray(toks, jnp.int32))
        with torch.no_grad():
            forward(load_jax_store(store_np, cfg, plan, "cpu"),
                    torch.from_numpy(toks), cfg, plan, depth_policy(),
                    dtype=torch.float32)
    assert seen["port"] == seen["jax"]
    assert [(k, i) for k, i, _ in seen["port"]] == list(
        zip(cfg.layer_kinds, range(cfg.n_layers)))
