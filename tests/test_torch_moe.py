"""MoE serving on the moonshot smoke config: the port against the JAX
package.

The JAX package builds the weights (``build_store``, float32) and the port
carries them over with ``load_jax_store``. The expert and attention/MLP
output projections, which both packages initialise to zero, are filled
with seeded random values first, so that every expert's output and every
TP site carries data. Inputs are made with numpy from fixed seeds.

Routing is discrete: an f32 router logit that differs in its last bit can
flip a near-tie in the top-k. So the routing (experts, positions, kept
routes) is compared first and must be identical, and the inputs are
checked to hold their top-k margins well clear of f32 rounding.
"""
import dataclasses
import os
import subprocess
import sys
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
from repro.core import collectives as jcoll
from repro.core.comm_config import CommConfig as JConfig
from repro.core.policy import BF16_POLICY as JBF16
from repro.core.policy import aggressive_policy as jaggressive
from repro.core.policy import paper_policy as jpaper
from repro.core.policy import with_backend as jwith_backend
from repro.core.policy import with_scheme as jwith_scheme
from repro.launch.mesh import make_test_mesh
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.parallel import shardings as jshard
from repro.parallel.plan import make_plan as jmake_plan
from repro.train import serve_step as jserve
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import collectives
from repro_torch.core.comm_config import CommConfig
from repro_torch.core.policy import (BF16_POLICY, aggressive_policy,
                                     paper_policy, with_scheme)
from repro_torch.models import layers as tlayers
from repro_torch.models import moe
from repro_torch.models.model import forward, layer_params
from repro_torch.parallel.plan import make_plan
from repro_torch.parallel.shardings import load_jax_store
from repro_torch.train import serve_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_gloo_worker as worker  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "moonshot-v1-16b-a3b"
B, S, DECODE_STEPS = 2, 8, 3
POLICIES = {
    "paper/two_step": (lambda: jwith_backend(jpaper(), "ref"),
                       paper_policy),
    "paper/fused": (lambda: jwith_scheme(jwith_backend(jpaper(), "ref"),
                                         "fused"),
                    lambda: with_scheme(paper_policy(), "fused")),
    "aggressive": (lambda: jwith_backend(jaggressive(), "ref"),
                   aggressive_policy),
    "bf16": (lambda: JBF16, lambda: BF16_POLICY),
}


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jplan = jmake_plan(jcfg, tp=1, fsdp=1)
    # build_store folds ``hash(name)`` into each key, and str hashes are
    # salted per process: a crc32 in its place fixes the weights
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jshard, "hash", lambda s: zlib.crc32(s.encode()),
                   raising=False)
        store = jshard.build_store(jmodel.param_groups(jcfg, jplan), jplan,
                                   jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(7)
    store_np = {}
    for g, arrs in store.items():
        store_np[g] = {}
        for name, a in arrs.items():
            a = np.array(a)
            if not a.any():                    # zero-init projections
                a = (rng.standard_normal(a.shape) * 0.05).astype(np.float32)
            store_np[g][name] = a
    plan = make_plan(cfg, tp=1)
    params = load_jax_store(store_np, cfg, plan, "cpu", torch.float32)
    moe_p = dict(layer_params(params, cfg)[1][1])
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (B, S))
    return dict(jcfg=jcfg, cfg=cfg, jplan=jplan, plan=plan,
                jstore=jax.tree_util.tree_map(jnp.asarray, store_np),
                params=params, moe_p=moe_p, prompts=prompts,
                mesh=make_test_mesh(1, 1))


def _hidden(seed: int, t: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((1, t, d)).astype(
        np.float32)


def _jax_route(x, router, jcfg):
    """The routing lines of ``repro.models.moe.moe_apply`` (f32 logits,
    softmax, top-k, renormalised weights, one-hot cumsum positions)."""
    m = jcfg.moe
    xt = x.reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", xt, router)
    probs = jax.nn.softmax(logits, axis=-1)
    topv, topi = lax.top_k(probs, m.top_k)
    topv = topv / jnp.maximum(jnp.sum(topv, -1, keepdims=True), 1e-9)
    re = topi.reshape(-1)
    onehot = jax.nn.one_hot(re, m.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1, re[:, None],
                              axis=1)[:, 0]
    keep = pos < jmoe.capacity(xt.shape[0], jcfg)
    return (np.asarray(topi), np.asarray(topv), np.asarray(pos),
            np.asarray(keep), np.asarray(probs))


def _margin_ok(probs: np.ndarray, k: int) -> None:
    """The k-th and (k+1)-th router probabilities of every token lie well
    apart (1e-4 relative, ~1000x f32 rounding), so no last-bit
    difference can flip the top-k."""
    srt = -np.sort(-probs, axis=-1)
    gap = (srt[:, k - 1] - srt[:, k]) / srt[:, k - 1]
    assert gap.min() > 1e-4, gap.min()


@pytest.mark.parametrize("tokens", [1, 2, 4, 7, 24, 64, 512, 4096])
def test_capacity_matches_jax(tokens):
    for get_t, get_j in ((get_smoke_config, jax_smoke_config),
                         (get_config, jax_config)):
        assert moe.capacity(tokens, get_t(ARCH)) == \
            jmoe.capacity(tokens, get_j(ARCH))
    full = get_config(ARCH)
    assert moe.capacity(512, full) == 64 and moe.capacity(4, full) == 1


@pytest.mark.parametrize("seed,t", [(11, 16), (12, 2), (13, 48)])
def test_routing_matches_jax(setup, seed, t):
    s = setup
    x = _hidden(seed, t, s["cfg"].d_model)
    router = s["moe_p"]["moe_router"].numpy()
    topi, topv, pos, keep, probs = _jax_route(jnp.asarray(x),
                                              jnp.asarray(router), s["jcfg"])
    _margin_ok(probs, s["cfg"].moe.top_k)
    ti, tv, tpos, tkeep, _ = moe.route(torch.from_numpy(x[0]),
                                       torch.from_numpy(router), s["cfg"])
    np.testing.assert_array_equal(ti.numpy(), topi)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    # the weights: f32 rounding of softmax and the renormalising sum
    np.testing.assert_allclose(tv.numpy(), topv, rtol=1e-5, atol=0)


def _jax_moe(s, pol, x):
    """JAX ``moe_apply`` of layer 1 under shard_map on one device."""
    p = {k: jnp.asarray(v.numpy()) for k, v in s["moe_p"].items()
         if k.startswith("moe_")}

    def fn(p, x):
        return jmoe.moe_apply(p, x, s["jcfg"], s["jplan"], pol, layer=1)

    f = jax.jit(compat.shard_map(fn, mesh=s["mesh"], in_specs=(P(), P()),
                                 out_specs=(P(), P()), check_vma=False))
    out, aux = f(p, jnp.asarray(x))
    return np.asarray(out), float(aux)


@pytest.mark.parametrize("pol", list(POLICIES))
def test_moe_apply_matches_jax(setup, pol):
    """Identical routing and an identical dispatch buffer give identical
    wire bytes, so the quantized dispatch adds no difference: the outputs
    agree to 2e-4 of their largest magnitude (float32 order of the expert
    products and the softmax), and so do the aux losses."""
    s = setup
    jpol, tpol = POLICIES[pol]
    # tokens leaning towards expert 0, so that its queue overflows
    router = s["moe_p"]["moe_router"].numpy()
    lean = router[:, 0] / np.linalg.norm(router[:, 0])
    x = (_hidden(21, 24, s["cfg"].d_model) + 4 * lean).reshape(2, 12, -1)
    _, _, _, keep, probs = _jax_route(
        jnp.asarray(x), jnp.asarray(s["moe_p"]["moe_router"].numpy()),
        s["jcfg"])
    _margin_ok(probs, s["cfg"].moe.top_k)
    assert not keep.all()                 # the capacity drops routes here
    want, jaux = _jax_moe(s, jpol(), x)
    stats = {}
    with torch.no_grad():
        got, aux = moe.moe_apply(s["moe_p"], torch.from_numpy(x), s["cfg"],
                                 s["plan"], tpol().bind(2), layer=1,
                                 stats=stats)
    assert int(stats["dropped"]) == int((~keep).sum())
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-4 * np.abs(want).max(), rtol=0)
    assert abs(float(aux) - jaux) <= 2e-4 * abs(jaux)


def test_dispatch_buffer_matches_jax_bits(setup, monkeypatch):
    """The dispatch buffer is built as JAX builds it: every route added
    into +0.0, a dropped one as x * 0 into slot cap - 1 of its expert. A
    kept -0.0 becomes +0.0 there, and a dropped route holding +inf and
    -inf turns its experts' last slots NaN where it holds them. Tokens
    lean towards experts 0 and 1, so both queues are full before the
    last token, whose infinities (against router rows signed so that its
    logits are +inf for experts 0, 1 and -inf for 2, 3) route it to
    experts 0 and 1 in both packages, with NaN weights that the combine
    drops (JAX's ``rw * keep`` with a boolean ``keep`` is a select). The
    dispatch buffer equals JAX's bit for bit (bf16 policy: no codec); the
    layer output is NaN where JAX's is (the token whose kept route sits
    in a NaN slot) and elsewhere agrees to 1e-5 of the largest
    magnitude: XLA and PyTorch sum the expert products in different
    float32 orders on the CPU (about 1e-6 of it measured)."""
    s = setup
    d = s["cfg"].d_model
    router = s["moe_p"]["moe_router"].numpy().copy()
    ji, jn = 3, 17                        # the +inf and -inf elements
    router[ji] = np.abs(router[ji]) * [1, 1, -1, -1]
    router[jn] = np.abs(router[jn]) * [-1, -1, 1, 1]
    lean = sum(router[:, e] / np.linalg.norm(router[:, e]) for e in (0, 1))
    x = _hidden(22, 24, d) + 4 * lean
    x[0, 0, 5] = -0.0                     # kept: the first token's routes
    x[0, -1, ji], x[0, -1, jn] = np.inf, -np.inf
    x = x.astype(np.float32).reshape(2, 12, d)
    topi, _, pos, keep, _ = _jax_route(jnp.asarray(x), jnp.asarray(router),
                                       s["jcfg"])
    assert keep[:2].all() and not keep[-2:].any()
    assert sorted(topi[-1].tolist()) == [0, 1]
    p = dict(s["moe_p"], moe_router=torch.from_numpy(router))

    jbufs, tbufs = [], []

    def jax_tap(buf, *a, **k):
        jax.debug.callback(lambda b: jbufs.append(np.asarray(b)), buf)
        return jcoll.dispatch_all_to_all(buf, *a, **k)

    def torch_tap(buf, *a, **k):
        tbufs.append(buf.clone())
        return collectives.dispatch_all_to_all(buf, *a, **k)

    monkeypatch.setattr(jmoe, "dispatch_all_to_all", jax_tap)
    monkeypatch.setattr(moe, "dispatch_all_to_all", torch_tap)
    want, _ = _jax_moe(dict(s, moe_p=p), JBF16, x)
    with torch.no_grad():
        got, _ = moe.moe_apply(p, torch.from_numpy(x), s["cfg"], s["plan"],
                               BF16_POLICY.bind(2), layer=1)
    jbuf, tbuf = jbufs[-1], tbufs[-1].numpy()
    cap = jmoe.capacity(24, s["jcfg"])
    e_slots = jbuf.reshape(4, cap, d)
    assert np.isnan(e_slots[0, cap - 1, [ji, jn]]).all()
    assert np.isnan(e_slots[1, cap - 1, [ji, jn]]).all()
    first = e_slots[topi[0, 0], pos[0]]
    assert first[5] == 0 and not np.signbit(first[5])
    np.testing.assert_array_equal(_bits(tbuf), _bits(jbuf))
    got = got.numpy()
    nan = np.isnan(want)
    assert nan.any() and not nan.all()
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=0,
                               atol=1e-5 * np.abs(want[~nan]).max())


def _jax_serve(s, pol, clen):
    """(prefill hidden states (B, S, d), [decode logits (B, vocab)] for
    DECODE_STEPS teacher-forced steps) from the JAX package."""
    jcfg, jplan, mesh = s["jcfg"], s["jplan"], s["mesh"]
    sspec = jshard.store_spec(jplan)

    def prefill(store, toks):
        return jmodel.forward(store, toks, jcfg, jplan, pol,
                              dtype=jnp.float32)[0]

    _, cspecs = jserve.decode_cache_specs(jcfg, jplan, mesh, B, clen)

    def step(store, caches, toks):
        h, unemb, _, caches = jmodel.forward(store, toks, jcfg, jplan, pol,
                                             caches=caches,
                                             dtype=jnp.float32)
        return jnp.einsum("bd,vd->bv", h[:, -1], unemb), caches

    hp = jax.jit(compat.shard_map(prefill, mesh=mesh, in_specs=(sspec, P()),
                                  out_specs=P(), check_vma=False))(
        s["jstore"], jnp.asarray(s["prompts"]))
    jstep = jax.jit(compat.shard_map(step, mesh=mesh,
                                     in_specs=(sspec, cspecs, P()),
                                     out_specs=(P(), cspecs),
                                     check_vma=False))
    caches = jserve.make_cache_init(jcfg, jplan, mesh, B, clen)()
    logits = []
    for i in range(DECODE_STEPS):
        lg, caches = jstep(s["jstore"], caches,
                           jnp.asarray(s["prompts"][:, i:i + 1]))
        logits.append(np.asarray(lg))
    return np.asarray(hp), logits


@pytest.mark.parametrize("pol", list(POLICIES))
def test_prefill_and_decode_match_jax(setup, pol):
    """The smoke model at batch 2: prefill (16 tokens, capacity 16) and
    decode (2 tokens, capacity 2) drop no route, so both see every
    token, and the decode steps check the KV cache of the MoE model.

    The prefill's hidden states and every decode step's logits agree to
    2e-4 of their largest magnitude (float32 order in the matmuls, RMS
    norm, softmax and RoPE; about 1e-6 measured). A quantized site could
    turn such a difference into a code step where a value lies at a
    rounding boundary (test_torch_serve.py allows one); on these inputs
    none does, so none is allowed."""
    s = setup
    jpol, tpol = POLICIES[pol]
    clen = S + DECODE_STEPS
    want_h, want_logits = _jax_serve(s, jpol(), clen)
    toks = torch.from_numpy(s["prompts"])
    stats = {}
    with torch.no_grad():
        h = forward(s["params"], toks, s["cfg"], s["plan"], tpol(),
                    dtype=torch.float32, stats=stats)[0].numpy()
        step = serve_step.make_decode_step(s["cfg"], s["plan"], tpol(),
                                           stats=stats)
        caches = serve_step.make_cache_init(s["cfg"], s["plan"], B, clen,
                                            "cpu")()
        got_logits = []
        for i in range(DECODE_STEPS):
            lg, caches = step(s["params"], caches, toks[:, i:i + 1])
            got_logits.append(lg.numpy()[:, :s["cfg"].vocab])
    assert int(stats["dropped"]) == 0
    for name, got, want in [("prefill", h, want_h)] + [
            (f"decode {i}", g, w) for i, (g, w) in
            enumerate(zip(got_logits, want_logits))]:
        np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                                   atol=2e-4 * np.abs(want).max())


# Moonshot's routing at the smoke widths: 64 experts, top-6 and the
# capacity rule of the full config, 2 MoE layers after the dense one; a
# batch of 4 x 64 tokens makes 1536 routes a layer for 64 slots x 32.
WIDE_B, WIDE_S = 4, 64


@pytest.fixture(scope="module")
def wide():
    def widen(c):
        return dataclasses.replace(
            c, dtype="float32", pattern_repeats=2,
            moe=dataclasses.replace(c.moe, n_experts=64, top_k=6))
    jcfg, cfg = widen(jax_smoke_config(ARCH)), widen(get_smoke_config(ARCH))
    full = get_config(ARCH).moe
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.capacity_factor) == (
        full.n_experts, full.top_k, full.capacity_factor)
    jplan = jmake_plan(jcfg, tp=1, fsdp=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jshard, "hash", lambda s: zlib.crc32(s.encode()),
                   raising=False)
        store = jshard.build_store(jmodel.param_groups(jcfg, jplan), jplan,
                                   jax.random.PRNGKey(1), jnp.float32)
    rng = np.random.default_rng(8)
    store_np = {g: {name: np.array(a) if np.any(a) else (
        rng.standard_normal(a.shape) * 0.05).astype(np.float32)
        for name, a in arrs.items()} for g, arrs in store.items()}
    plan = make_plan(cfg, tp=1)
    return dict(jcfg=jcfg, cfg=cfg, jplan=jplan, plan=plan,
                jstore=jax.tree_util.tree_map(jnp.asarray, store_np),
                params=load_jax_store(store_np, cfg, plan, "cpu",
                                      torch.float32),
                prompts=np.random.default_rng(4).integers(
                    0, cfg.vocab, (WIDE_B, WIDE_S)))


@pytest.mark.parametrize("pol", ["paper/two_step", "aggressive"])
def test_routing_drops_at_width_match_jax(wide, pol, monkeypatch):
    """The prefill's dropped routes, layer by layer, under the paper and
    aggressive policies, on the same weights in both packages.

    - Every TP site of the port with bf16 scales (paper), given JAX's
      input at that site, returns JAX's output bit for bit: the codec
      adds no difference of its own. (With Eq.-1 f32 scales, aggressive,
      JAX's jitted decode contracts the product into an FMA, which
      ``tests/test_torch_codec.py`` bounds: Queue C.)
    - The port's ``stats`` (routes, dropped) equal the drops of JAX's
      routing (:func:`_jax_route`) on the port's MoE input: exact.
    - Against the drops of JAX's routing on JAX's own MoE input: the two
      forwards' inputs differ by float32 order (attention, matmuls), and
      an int8 site turns a value within that of a code boundary into a
      code step (Queue C, "measured agreement bounds"), which moves some
      tokens' top-k. Each route that moves to another expert changes each
      of two queues by one, so the drops differ by at most the number of
      routes that moved (on these weights: paper one route in 1536 at
      the first MoE layer, from routes of 3 tokens; aggressive none)."""
    s = wide
    jpol, tpol = POLICIES[pol]
    jins, tins, tdrops, jsites, tsites = [], [], [], [], []
    jorig, torig = jmoe.moe_apply, moe.moe_apply
    jpsum, tpsum = jlayers.compressed_psum, tlayers.compressed_psum

    def jax_tap(p, x, *a, **k):
        # the repeated layers run in a scan: one trace, a callback a layer
        jax.debug.callback(lambda v, r: jins.append(
            (np.asarray(v), np.asarray(r))), x, p["moe_router"])
        return jorig(p, x, *a, **k)

    def jax_site(x, *a, **k):
        y = jpsum(x, *a, **k)
        jax.debug.callback(lambda u, v: jsites.append(
            (np.asarray(u), np.asarray(v))), x, y)
        return y

    def torch_tap(p, x, *a, stats=None, **k):
        st = {}
        out = torig(p, x, *a, stats=st, **k)
        tins.append(x.reshape(-1, x.shape[-1]).numpy().copy())
        tdrops.append((int(st["routes"]), int(st["dropped"])))
        stats["routes"] = stats.get("routes", 0) + st["routes"]
        stats["dropped"] = stats.get("dropped", 0) + st["dropped"]
        return out

    def torch_site(x, cfg, *a, **k):
        tsites.append(cfg)
        return tpsum(x, cfg, *a, **k)

    monkeypatch.setattr(jmoe, "moe_apply", jax_tap)
    monkeypatch.setattr(moe, "moe_apply", torch_tap)
    monkeypatch.setattr(jlayers, "compressed_psum", jax_site)
    monkeypatch.setattr(tlayers, "compressed_psum", torch_site)
    sspec = jshard.store_spec(s["jplan"])
    jax.jit(compat.shard_map(
        lambda st, t: jmodel.forward(st, t, s["jcfg"], s["jplan"], jpol(),
                                     dtype=jnp.float32)[0],
        mesh=make_test_mesh(1, 1), in_specs=(sspec, P()), out_specs=P(),
        check_vma=False))(s["jstore"], jnp.asarray(s["prompts"]))
    stats = {}
    with torch.no_grad():
        forward(s["params"], torch.from_numpy(s["prompts"]), s["cfg"],
                s["plan"], tpol(), dtype=torch.float32, stats=stats)
        assert len(jsites) == len(tsites) > 0
        for i, ((x, y), cfg) in enumerate(zip(jsites, tsites)):
            if cfg.scale_int:
                continue                  # Eq.-1 scales: see the docstring
            got = tpsum(torch.from_numpy(np.array(x)), cfg).numpy()
            np.testing.assert_array_equal(_bits(got), _bits(y),
                                          err_msg=f"TP site {i}")
    assert len(jins) == len(tins) == len(tdrops) == 2
    k = s["cfg"].moe.top_k
    routes = WIDE_B * WIDE_S * k
    router = [jnp.asarray(r) for _, r in jins]
    for layer, ((jx, _), tx, got) in enumerate(zip(jins, tins, tdrops)):
        ti, _, _, tkeep, _ = _jax_route(jnp.asarray(tx), router[layer],
                                        s["jcfg"])
        assert tkeep.size == routes and not tkeep.all(), layer
        assert got == (routes, int((~tkeep).sum())), layer
        ji, _, _, jkeep, _ = _jax_route(jnp.asarray(jx), router[layer],
                                        s["jcfg"])
        moved = sum(k - len(set(a) & set(b)) for a, b in zip(ji, ti))
        assert abs(int((~jkeep).sum()) - got[1]) <= moved, layer
    assert int(stats["dropped"]) == sum(d for _, d in tdrops)


# a training step's tokens: phase moe_train's global batch (8 x 512)
TRAIN_B, TRAIN_S = 8, 512


def test_training_drops_at_width_match_jax(wide, monkeypatch):
    """The training forward's dropped routes, layer by layer (paper, 64
    experts, top-6, a training step's 8 x 512 tokens: 24576 routes a layer
    for 64 slots x 480), on the same weights in both packages.

    - The port's ``stats`` of ``forward_train`` (the checkpointed blocks
      over the flat store, as the train step runs them) equal the drops
      of JAX's routing (:func:`_jax_route`) on the port's MoE input of
      each layer: exact.
    - Against the drops of JAX's routing on JAX's own training forward's
      MoE input (``forward`` on the store, as JAX's train step calls it):
      within the routes that moved to another expert, as in
      :func:`test_routing_drops_at_width_match_jax`."""
    from repro_torch.models.model import forward_train
    s = wide
    jpol, tpol = POLICIES["paper/two_step"]
    jins, tins, tdrops = [], [], []
    jorig, torig = jmoe.moe_apply, moe.moe_apply

    def jax_tap(p, x, *a, **k):
        jax.debug.callback(lambda v, r: jins.append(
            (np.asarray(v), np.asarray(r))), x, p["moe_router"])
        return jorig(p, x, *a, **k)

    def torch_tap(p, x, *a, stats=None, **k):
        st = {}
        out = torig(p, x, *a, stats=st, **k)
        tins.append(x.reshape(-1, x.shape[-1]).detach().numpy().copy())
        tdrops.append((int(st["routes"]), int(st["dropped"])))
        stats["routes"] = stats.get("routes", 0) + st["routes"]
        stats["dropped"] = stats.get("dropped", 0) + st["dropped"]
        return out

    monkeypatch.setattr(jmoe, "moe_apply", jax_tap)
    monkeypatch.setattr(moe, "moe_apply", torch_tap)
    tokens = np.random.default_rng(9).integers(0, s["cfg"].vocab,
                                               (TRAIN_B, TRAIN_S))
    sspec = jshard.store_spec(s["jplan"])
    jax.jit(compat.shard_map(
        lambda st, t: jmodel.forward(st, t, s["jcfg"], s["jplan"], jpol(),
                                     dtype=jnp.float32)[0],
        mesh=make_test_mesh(1, 1), in_specs=(sspec, P()), out_specs=P(),
        check_vma=False))(s["jstore"], jnp.asarray(tokens))
    store = load_jax_store(
        {g: {n: np.asarray(a) for n, a in arrs.items()}
         for g, arrs in s["jstore"].items()}, s["cfg"], s["plan"], "cpu",
        data_rank=0)
    stats = {}
    with torch.no_grad():
        forward_train(store, torch.from_numpy(tokens), s["cfg"], s["plan"],
                      tpol(), dtype=torch.float32, stats=stats)
    n_moe = s["cfg"].layer_kinds.count("moe")
    assert len(jins) == len(tins) == len(tdrops) == n_moe == 2
    routes = TRAIN_B * TRAIN_S * s["cfg"].moe.top_k
    for layer, ((jx, router), tx, got) in enumerate(zip(jins, tins,
                                                        tdrops)):
        ti, _, _, tkeep, _ = _jax_route(jnp.asarray(tx), jnp.asarray(router),
                                        s["jcfg"])
        assert tkeep.size == routes and not tkeep.all(), layer
        assert got == (routes, int((~tkeep).sum())), layer
        ji, _, _, jkeep, _ = _jax_route(jnp.asarray(jx), jnp.asarray(router),
                                        s["jcfg"])
        moved = sum(s["cfg"].moe.top_k - len(set(a) & set(b))
                    for a, b in zip(ji, ti))
        assert abs(int((~jkeep).sum()) - got[1]) <= moved, layer
    assert int(stats["dropped"]) == sum(d for _, d in tdrops)


A2A_CFGS = [dict(bits=4, group=32), dict(bits=4, group=32, scale_int=True),
            dict(bits=2, group=32, spike=True), dict(bits=8, group=128)]


def _a2a_input(d: int, dtype) -> torch.Tensor:
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((1, 6, d)) * 2).astype(np.float32)
    x[0, 2, 7] = 40.0
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("kw,dtype", [(A2A_CFGS[0], torch.float32),
                                      (A2A_CFGS[0], torch.bfloat16),
                                      (A2A_CFGS[2], torch.bfloat16)])
def test_quantized_all_to_all_pads_like_jax(kw, dtype):
    """d = 200 is no group multiple: the payload is zero-padded to 224
    for the codec and sliced back, as in JAX, and decoded straight into
    the payload dtype. Bit for bit against JAX's on one rank, run eagerly
    so that XLA fuses no multiply-add into the dequantize (which makes
    it slow: the paper's int4 g32 dispatch and int2 spike only)."""
    x = _a2a_input(200, dtype)
    got = collectives.quantized_all_to_all(x, CommConfig(**kw))
    assert got.shape == x.shape and got.dtype == dtype
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    f = compat.shard_map(
        lambda a: jcoll.quantized_all_to_all(a, "model",
                                             JConfig(backend="ref", **kw)),
        mesh=make_test_mesh(1, 1), in_specs=P(), out_specs=P(),
        check_vma=False)
    want = np.asarray(f(jnp.asarray(x.float().numpy()).astype(jdt)))
    np.testing.assert_array_equal(
        got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
        .numpy(), want.view(np.int16 if dtype == torch.bfloat16
                            else np.int32))


def test_quantized_all_to_all_exact_sites_pass_through():
    """Scheme ``nccl`` and a disabled config are the exact all-to-all:
    with one rank, the payload itself, and no wire kernel runs."""
    from repro_torch.core.comm_config import NO_COMPRESSION
    x = _a2a_input(200, torch.bfloat16)
    for cfg in (CommConfig(bits=4, group=32, scheme="nccl"),
                NO_COMPRESSION):
        assert collectives.dispatch_all_to_all(x, cfg) is x


@pytest.mark.parametrize("d", [256, 200])
@pytest.mark.parametrize("kw", A2A_CFGS)
def test_fused_all_to_all_equals_two_step(kw, d):
    x = _a2a_input(d, torch.bfloat16)
    a = collectives.quantized_all_to_all(x, CommConfig(**kw))
    b = collectives.quantized_all_to_all(x, CommConfig(scheme="fused", **kw))
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.fixture(scope="module")
def gloo_moe(tmp_path_factory):
    """Two gloo ranks (a FileStore under a temporary directory) run the
    MoE layer at ep = 2 (``tests/_torch_gloo_worker.py`` mode ``moe``)."""
    tmp = tmp_path_factory.mktemp("gloo_moe")
    script = os.path.join(os.path.dirname(__file__), "_torch_gloo_worker.py")
    procs = [subprocess.Popen([sys.executable, script, str(r), "2",
                               str(tmp / "store"), str(tmp), "moe"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0].decode())
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _moe_ep1(policy, x, n_experts: int = 4):
    cfg = worker.moe_config(n_experts)
    with torch.no_grad():
        y, aux = moe.moe_apply(worker.moe_params(cfg), x, cfg,
                               make_plan(cfg, tp=1),
                               policy.bind(cfg.n_layers), layer=1)
    return y.numpy(), float(aux)


@pytest.mark.parametrize("scheme", ["two_step", "fused"])
def test_two_rank_ep_equals_ep1(gloo_moe, scheme):
    """ep = 2, each rank two of the four experts: the dispatch All2All
    (quantized) and the combine (exact) cross the ranks, and every rank's
    output equals the one-rank layer's bit for bit."""
    cfg = worker.moe_config()
    want, want_aux = _moe_ep1(worker.moe_policies()[scheme],
                              worker.moe_input(cfg))
    for r, res in enumerate(gloo_moe):
        np.testing.assert_array_equal(_bits(res[scheme]), _bits(want),
                                      err_msg=f"rank {r}")
        assert float(res[scheme + "_aux"]) == want_aux


def test_two_rank_ep_slice(gloo_moe):
    """With ``ep_slice`` each rank routes and dispatches its half of the
    tokens (capacity of 6 tokens, not 12) and the halves are gathered:
    the output equals the one-rank layer run on each half by itself, to
    float32 rounding of the expert products (whose batch shapes differ:
    1e-5 of the largest magnitude), and the aux loss is the ranks'
    mean."""
    cfg = worker.moe_config()
    x = worker.moe_input(cfg).reshape(1, 12, -1)
    pol = worker.moe_policies()["ep_slice"]
    halves = [_moe_ep1(pol, x[:, i * 6:(i + 1) * 6]) for i in range(2)]
    want = np.concatenate([h for h, _ in halves], axis=1).reshape(2, 6, -1)
    want_aux = (halves[0][1] + halves[1][1]) / 2
    for r, res in enumerate(gloo_moe):
        np.testing.assert_allclose(res["ep_slice"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"rank {r}")
        assert abs(float(res["ep_slice_aux"]) - want_aux) <= 1e-6 * want_aux


def test_two_rank_etp(gloo_moe):
    """3 experts over 2 ranks: ep = 1, etp = 2, each rank half of every
    expert's hidden, and the partial sums go through the within-expert
    AllReduce (exact here). Equal to the one-rank layer to float32
    rounding of the split products (1e-5 of the largest magnitude)."""
    cfg = worker.moe_config(3)
    assert make_plan(cfg, tp=2).moe.etp == 2
    want, want_aux = _moe_ep1(worker.moe_policies()["etp"],
                              worker.moe_input(cfg), n_experts=3)
    for r, res in enumerate(gloo_moe):
        np.testing.assert_allclose(res["etp"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"rank {r}")
        assert float(res["etp_aux"]) == want_aux
