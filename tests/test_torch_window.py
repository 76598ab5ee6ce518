"""``window_override``: every self-attention block but a local one
attends over the last W positions, the port against the JAX package at
tp = 1 (JAX's ``forward`` under a jitted ``shard_map`` on one CPU
device, one compile a shape), float32, on the qwen3-14b smoke config
(dense blocks) with the weights of ``_torch_gloo_worker.numpy_store``.

The prefill, the decode steps through the prompt and past it (greedy
tokens fed back) on a ring of ``cache_len`` slots below prompt +
generated, so that it wraps: a ring of W slots (each slot then inside
the window) and of W + 3 (three slots outside it, masked), an ``enc``
block (not causal) with the window, and a planted fault: the decode
mask without the window fails the comparison.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.policy import BF16_POLICY as JBF16
from repro.launch.mesh import make_test_mesh
from repro.models import model as jmodel
from repro.parallel.plan import make_plan as jmake_plan
from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import BF16_POLICY
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.parallel.plan import make_plan
from repro_torch.parallel.shardings import load_jax_store
from repro_torch.train import serve_step
from repro_torch.train.data import DataConfig, make_dataset

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_gloo_worker as gw  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "qwen3-14b"
B, S, GEN, W = 2, 12, 4, 5
#: float32 summation order (the einsums' and the softmax's) between the
#: packages, relative to the largest magnitude; measured 9.3e-7 (prefill
#: hidden states), 9.7e-7 (decode logits)
REL = 2e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jplan, plan = jmake_plan(jcfg, tp=1, fsdp=1), make_plan(cfg, tp=1)
    store = gw.numpy_store(jmodel.param_groups(jcfg, jplan), jplan)
    toks = make_dataset(DataConfig(vocab=cfg.vocab, seq_len=S,
                                   global_batch=B)).batch(0)["tokens"]
    return dict(jcfg=jcfg, cfg=cfg, jplan=jplan, plan=plan,
                jstore=jax.tree_util.tree_map(jnp.asarray, store),
                params=load_jax_store(store, cfg, plan, "cpu",
                                      torch.float32),
                unemb=store["out"]["unemb"][0, 0].reshape(
                    plan.vocab_pad, cfg.d_model)[:cfg.vocab],
                toks=toks, mesh=make_test_mesh(1, 1))


def _jax(s, fn, *args):
    """``fn(*args)`` under a jitted shard_map on the (1, 1) mesh."""
    return jax.jit(compat.shard_map(
        fn, mesh=s["mesh"], in_specs=(P(),) * len(args), out_specs=P(),
        check_vma=False))(*args)


def _jax_hidden(s, toks, window):
    return np.asarray(_jax(s, lambda st, t: jmodel.forward(
        st, t, s["jcfg"], s["jplan"], JBF16, window_override=window,
        dtype=jnp.float32)[0], s["jstore"], jnp.asarray(toks)))


def _torch_hidden(s, toks, window):
    with torch.no_grad():
        return tmodel.forward(s["params"], torch.from_numpy(toks), s["cfg"],
                              s["plan"], BF16_POLICY, dtype=torch.float32,
                              window_override=window)[0].numpy()


def test_prefill_window_matches_jax(setup):
    """The prefill with ``window_override`` = W equals JAX's to REL of
    max|h| at every position; without a window it is another function
    (the positions past W move by more than a tenth of max|h|), which the
    port also gives as JAX does."""
    s = setup
    for window in (W, None):
        want = _jax_hidden(s, s["toks"], window)
        got = _torch_hidden(s, s["toks"], window)
        hmax = np.abs(want).max()
        assert np.abs(got - want).max() <= REL * hmax, (window, np.abs(
            got - want).max() / hmax)
        if window is None:
            moved = np.abs(got - windowed).max(-1) / hmax
            assert (moved[:, :W] <= REL).all()
            assert (moved[:, W:] > 0.1).all(), moved
        windowed = got


def _jax_decode(s, cache_len):
    """JAX's decode loop at tp = 1 (one jitted step): the prompt
    teacher-forced, then GEN greedy tokens -> (logits after each step
    (B, S + GEN - 1, vocab), generated (B, GEN))."""
    jcfg, jplan = s["jcfg"], s["jplan"]
    caches = jmodel.init_caches(jcfg, jplan, B, cache_len, jnp.float32)

    def step(st, c, t):
        h, _, _, nc = jmodel.forward(st, t, jcfg, jplan, JBF16, caches=c,
                                     window_override=W, dtype=jnp.float32)
        return h, nc

    f = jax.jit(compat.shard_map(step, mesh=s["mesh"],
                                 in_specs=(P(), P(), P()),
                                 out_specs=(P(), P()), check_vma=False))
    logits, gen = [], []
    tok = s["toks"][:, :1]
    for i in range(S + GEN - 1):
        h, caches = f(s["jstore"], caches, jnp.asarray(tok, jnp.int32))
        lg = np.asarray(h)[:, -1].astype(np.float64) @ s["unemb"].T
        logits.append(lg)
        if i + 1 < S:
            tok = s["toks"][:, i + 1:i + 2]
        else:
            gen.append(lg.argmax(-1))
            tok = gen[-1][:, None]
    return np.stack(logits, 1), np.stack(gen, 1)


def _torch_decode(s, cache_len):
    """The port's decode loop, as :func:`_jax_decode` -> (logits,
    generated, the caches' slot positions)."""
    cfg, plan = s["cfg"], s["plan"]
    step = serve_step.make_decode_step(cfg, plan, BF16_POLICY,
                                       window_override=W)
    caches = serve_step.make_cache_init(cfg, plan, B, cache_len, "cpu")()
    logits, gen = [], []
    tok = torch.from_numpy(s["toks"][:, :1])
    for i in range(S + GEN - 1):
        lg, caches = step(s["params"], caches, tok)
        lg = lg[:, :cfg.vocab].double().numpy()
        logits.append(lg)
        if i + 1 < S:
            tok = torch.from_numpy(s["toks"][:, i + 1:i + 2])
        else:
            gen.append(lg.argmax(-1))
            tok = torch.from_numpy(gen[-1][:, None])
    return np.stack(logits, 1), np.stack(gen, 1), [
        c["slot_pos"] for c in caches["layers"]]


def _hold(got, want, gen_got, gen_want):
    """The logits within REL of their max magnitude, every greedy token
    equal."""
    lmax = np.abs(want).max()
    assert np.abs(got - want).max() <= REL * lmax, np.abs(
        got - want).max() / lmax
    np.testing.assert_array_equal(gen_got, gen_want)


_JAX_DECODE = {}


def _jax_decode_cached(s, cache_len):
    if cache_len not in _JAX_DECODE:
        _JAX_DECODE[cache_len] = _jax_decode(s, cache_len)
    return _JAX_DECODE[cache_len]


@pytest.mark.parametrize("cache_len", [W, W + 3])
def test_decode_past_a_wrapped_ring_matches_jax(setup, cache_len):
    """The decode steps with ``window_override`` = W on a ring of
    ``cache_len`` slots (W: every slot inside the window; W + 3: three
    slots outside it, masked), S + GEN - 1 steps past its wrap, greedy
    tokens fed back: the logits within REL of JAX's (measured 9.7e-7),
    every generated token JAX's, and each step's logits the windowed
    prefill's at that position (measured 6.9e-7). Every block's ring
    holds the last ``cache_len`` positions."""
    s = setup
    want, gen_want = _jax_decode_cached(s, cache_len)
    got, gen_got, slots = _torch_decode(s, cache_len)
    _hold(got, want, gen_got, gen_want)
    prefill = _torch_hidden(s, s["toks"], W).astype(np.float64) @ \
        s["unemb"].T
    np.testing.assert_allclose(got[:, :S], prefill, rtol=0,
                               atol=REL * np.abs(prefill).max())
    last = S + GEN - 2
    for sp in slots:
        assert sp.shape == (cache_len,)
        assert sorted(sp.tolist()) == list(range(last - cache_len + 1,
                                                 last + 1))


def test_decode_mask_without_window_fails(setup, monkeypatch):
    """A planted fault: the decode's mask without the window (the
    self-attention given ``window=None`` at decode). On the ring of W + 3
    slots, which holds positions outside the window, the comparison with
    JAX fails."""
    s = setup
    want, gen_want = _jax_decode_cached(s, W + 3)
    real = tattn.self_attention

    def no_window_at_decode(*a, **kw):
        if kw.get("cache") is not None:
            kw["window"] = None
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "self_attention", no_window_at_decode)
    got, gen_got, _ = _torch_decode(s, W + 3)
    with pytest.raises(AssertionError):
        _hold(got, want, gen_got, gen_want)


def test_enc_block_with_window_matches_jax(setup):
    """An ``enc`` block (self-attention not causal) given the window
    through ``apply_block(window_override=W)``: each query sees the keys
    after it and those fewer than W before it, as JAX computes it
    (within REL of max|x|); it differs from the block without the
    window."""
    s = setup
    cfg, plan = s["cfg"], s["plan"]
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    p = {k: v[0] for k, v in s["params"]["pattern"].items()
         if k.startswith("L0_")}
    jp = {k[3:]: jnp.asarray(v.numpy()) for k, v in p.items()}
    tp = {k[3:]: v for k, v in p.items()}
    pos = np.arange(S)
    outs = {}
    for window in (W, None):
        want = np.asarray(_jax(s, lambda xx, pp, window=window:
                               jmodel.apply_block(
                                   "enc", pp, xx, positions=jnp.asarray(pos),
                                   enc_out=None, cfg=s["jcfg"],
                                   plan=s["jplan"], policy=JBF16,
                                   window_override=window, cache=None)[0],
                               jnp.asarray(x), jp))
        with torch.no_grad():
            got = tmodel.apply_block(
                "enc", tp, torch.from_numpy(x),
                positions=torch.from_numpy(pos), cfg=cfg, plan=plan,
                policy=BF16_POLICY, cache=None,
                window_override=window)[0].numpy()
        xmax = np.abs(want).max()
        assert np.abs(got - want).max() <= REL * xmax, np.abs(
            got - want).max() / xmax
        outs[window] = got
    assert np.abs(outs[W] - outs[None]).max() > 0.01 * np.abs(
        outs[None]).max()
