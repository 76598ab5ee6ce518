"""recurrentgemma-2b (RG-LRU + sliding-window attention) and xlstm-125m
(mLSTM / sLSTM, no positions): the port against the JAX package at
tp = 1, float32.

Both packages run the same weights: JAX's ``build_store`` (with a crc32
in place of the salted ``hash``), its zero-initialised arrays (the output
projections, and RG-LRU's gate vectors and conv bias, which would hold
the gates at a constant 0.5) filled from a seeded normal, as
``tests/test_torch_moe_archs.py`` does. The mixers' unit tests hold
``rglru_apply``, ``_causal_conv``, ``mlstm_apply`` and ``slstm_apply``,
the associative scan, the windowed ``blockwise_attention`` and the
activations in JAX's formulas against the JAX package's on seeded numpy
inputs.
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
from repro.core.policy import paper_policy as jpaper
from repro.core.policy import with_backend as jwith_backend
from repro.launch.mesh import make_test_mesh
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import recurrent as jrec
from repro.parallel import shardings as jshard
from repro.parallel.plan import make_plan as jmake_plan
from repro.train import serve_step as jserve
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.policy import BF16_POLICY, paper_policy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import recurrent as trec
from repro_torch.models.model import forward, greedy_next_token
from repro_torch.parallel.plan import make_plan
from repro_torch.parallel.shardings import (ParamSpec, init_params,
                                            init_store, load_jax_store)
from repro_torch.train import serve_step
from repro_torch.train.data import DataConfig, make_dataset

ARCHS = ("recurrentgemma-2b", "xlstm-125m")
#: the decode runs through more positions than the smoke window (64), so
#: that the local block's ring wraps; the mixers' unit tests run MIX_S
B, S, GEN, MIX_S = 2, 68, 4, 24
POLICIES = {"paper": (lambda: jwith_backend(jpaper(), "ref"), paper_policy),
            "bf16": (lambda: JBF16, lambda: BF16_POLICY)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its CPU ops are small, and beside
    the other test workers a thread pool costs more than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _store(jcfg, jplan):
    """JAX's float32 store of ``jcfg`` on ``jplan`` as numpy, its zero
    initialised arrays filled from a seeded normal."""
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
            if not a.any():                      # zero-initialised
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
    of the port's schema, ``window``, ``lru_width``, ``conv_width``,
    ``learned_pos`` and ``max_pos`` among them), the registry serves both
    ids, and the plan's recurrent widths (``lru_loc``, ``nh_lstm_pad``,
    ``nh_lstm_loc``) equal JAX's at tp 1, 2, 8 and 16 (xlstm's 4 heads
    padded to 8 and 16)."""
    assert arch in ARCH_IDS
    for got, want in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), (
                arch, f.name)
        for tp in (1, 2, 8, 16):
            p, q = make_plan(got, tp=tp), jmake_plan(want, tp=tp, fsdp=1)
            assert (p.lru_loc, p.nh_lstm_pad, p.nh_lstm_loc) == (
                q.lru_loc, q.nh_lstm_pad, q.nh_lstm_loc), (arch, tp)
    full = get_config(arch)
    assert (full.window, full.rope_theta, full.learned_pos) == {
        "recurrentgemma-2b": (2048, 10000.0, True),
        "xlstm-125m": (None, None, False)}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_layout_matches_jax(arch):
    """Parameter groups, names, shapes, sharding and init rules at full
    width equal JAX's ``param_groups`` at tp 1 and 16 (``rg_lam``'s
    ``lru_lambda``; ``sl_wout``, the output projection, apart from
    ``sl_wo``, the output gate's input weights; no position table)."""
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
    names = {n for _, specs in got.values() for n in specs}
    assert sorted(got["embed"][1]) == ["tok"]            # no positions
    assert ({"L0_ml_wo", "L1_sl_wo", "L1_sl_wout"} <= names
            if arch == "xlstm-125m" else
            {"L0_rg_lam", "L2_wq", "suf0_rec", "suf1_rec"}
            <= names | set(got))


def _values(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


ACTS = {"softplus": (jax.nn.softplus, tlayers.softplus),
        "log_sigmoid": (jax.nn.log_sigmoid, tlayers.log_sigmoid),
        "sigmoid": (jax.nn.sigmoid, tlayers.sigmoid)}


@pytest.mark.parametrize("name", list(ACTS))
def test_activations_match_jax(name):
    """softplus, log_sigmoid and sigmoid in JAX's formulas against
    ``jax.nn``'s (jitted) on 2^20 normal values of std 10 and a grid over
    [-100, 100], and on NaN and the infinities: NaN where JAX's is NaN;
    in float32 within 2^-21 relative of JAX's (exp and log1p are other
    implementations; measured 2.7e-7), in bf16 bit for bit; both where
    JAX's value is a normal number. Below 2^-126, where XLA flushes
    subnormal results to zero, within 2^-126. ``F.softplus`` (its
    threshold of 20) is not JAX's softplus."""
    jf, tf = ACTS[name]
    x = np.concatenate([_values(0, 1 << 20, 10.0),
                        np.linspace(-100, 100, 200001, dtype=np.float32),
                        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0],
                                 np.float32)])
    tiny = np.finfo(np.float32).tiny
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax.jit(jf)(jnp.asarray(x, jd)).astype(
            jnp.float32))
        got = tf(torch.from_numpy(x).to(td)).float().numpy()
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        w, g = want[~nan], got[~nan]
        normal = np.abs(w) >= tiny
        if jd == jnp.float32:
            g, w = g[g != w], w[g != w]               # the infinities too
            normal = np.abs(w) >= tiny
            assert (np.abs(g - w)[normal]
                    <= 2 ** -21 * np.abs(w)[normal]).all()
        else:
            np.testing.assert_array_equal(g[normal], w[normal])
        with np.errstate(invalid="ignore"):         # inf - inf: equal
            assert (np.abs(g - w)[~normal] <= tiny).all()


@pytest.mark.parametrize("s", [1, 2, 3, 7, 20])
def test_associative_scan_matches_jax(s):
    """The port's ``associative_scan`` under RG-LRU's combine against
    ``lax.associative_scan``, op by op (eager): bit for bit, which only
    JAX's order of combination gives (a sequential loop differs here in
    the last bits). Jitted, XLA may contract ``a2 * b1 + b2`` into one
    rounding: within 2^-20 of the scan's max magnitude (measured 1.1e-7
    at most)."""
    a = np.random.default_rng(s).uniform(0.5, 1.0, (2, s, 8)).astype(
        np.float32)
    b = _values(s + 100, (2, s, 8))

    def combine(c1, c2):
        (a1, b1), (a2, b2) = c1, c2
        return a1 * a2, a2 * b1 + b2

    got = trec.associative_scan(trec._lru_combine, [torch.from_numpy(a),
                                                    torch.from_numpy(b)])
    eager = lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)),
                                 axis=1)
    for g, w in zip(got, eager):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jit = jax.jit(lambda x, y: lax.associative_scan(combine, (x, y),
                                                    axis=1))(a, b)
    h = got[1].numpy()
    assert np.abs(h - np.asarray(jit[1])).max() <= 2 ** -20 * np.abs(h).max()


def _jax_apply(fn, n_in: int, n_out: int):
    """``fn`` under shard_map on a (1, 1) mesh, jitted."""
    out = (P(),) * n_out if n_out > 1 else P()
    return jax.jit(compat.shard_map(fn, mesh=make_test_mesh(1, 1),
                                    in_specs=(P(),) * n_in, out_specs=out,
                                    check_vma=False))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    """``_causal_conv`` against JAX's, full sequence and one decode step
    from a seeded float32 history: bit for bit in float32 and in bf16 (the
    taps' products and sums in the input's dtype, in JAX's order), and
    the new history equal to JAX's."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    u, w, b = _values(1, (2, 9, 16)), _values(2, (4, 16)), _values(3, (16,))
    st = np.array(jnp.asarray(_values(4, (2, 3, 16)), jd).astype(
        jnp.float32))                                  # the dtype's values
    for state in (None, st):
        uu = u[:, :1] if state is not None else u
        args = [jnp.asarray(v, jd) for v in (uu, w, b)]
        want = jrec._causal_conv(*args, None if state is None
                                 else jnp.asarray(state))
        got = trec._causal_conv(*(torch.from_numpy(v).to(td)
                                  for v in (uu, w, b)),
                                None if state is None
                                else torch.from_numpy(state))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(
                g.float().numpy(), np.asarray(w_.astype(jnp.float32)))


def _mixer_params(arch: str, kind: str, setups):
    """Block ``kind``'s parameters of the smoke config (JAX's filled
    store), unprefixed, as numpy."""
    s = setups(arch)
    j = s["cfg"].pattern.index(kind)
    pre = f"L{j}_"
    return {k[len(pre):]: v[0].numpy()
            for k, v in s["params"]["pattern"].items() if k.startswith(pre)}


MIXERS = {"rec": ("recurrentgemma-2b", "rg_", jrec.rglru_apply,
                  trec.rglru_apply, ("h", "conv")),
          "mlstm": ("xlstm-125m", "ml_", jrec.mlstm_apply,
                    trec.mlstm_apply, ("c", "n", "m")),
          "slstm": ("xlstm-125m", "sl_", jrec.slstm_apply,
                    trec.slstm_apply, ("c", "n", "h", "m"))}


def _seeded_state(kind: str, cfg, plan, seed: int):
    """A state of the decode step's shapes from a seeded normal (the
    stabiliser ``m`` a small number, the conv history the inputs')."""
    init = {"rec": trec.rglru_init_state, "mlstm": trec.mlstm_init_state,
            "slstm": trec.slstm_init_state}[kind](cfg, plan, B, "cpu")
    out = {}
    for i, (k, v) in enumerate(sorted(init.items())):
        a = _values(seed + i, tuple(v.shape))
        out[k] = np.abs(a) if k == "n" else a
    return out


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_matches_jax(setups, kind):
    """``rglru_apply``, ``mlstm_apply`` and ``slstm_apply`` (the smoke
    configs' weights, gate vectors filled) against JAX's at tp = 1 on
    seeded inputs, no codec: the full sequence (S = 24; RG-LRU through
    the associative scan, the cells through the sequential loop) within
    2e-5 of the output's max magnitude (float32 matmul and einsum order;
    measured at most 1.1e-6, RG-LRU's), and one decode step from a seeded
    state: the output within 2e-5 of its max magnitude (measured 8.9e-7
    at most), each part of the new state, written in place, within 2e-5
    of its max magnitude (measured 3.0e-7 at most)."""
    arch, prefix, jfn, tfn, keys = MIXERS[kind]
    s = setups(arch)
    cfg, plan, jcfg, jplan = s["cfg"], s["plan"], s["jcfg"], s["jplan"]
    p = _mixer_params(arch, kind, setups)
    names = sorted(n for n in p if n.startswith(prefix))
    x = _values(11, (B, MIX_S, cfg.d_model))

    def jfull(x, *ws):
        return jfn(dict(zip(names, ws)), x, jcfg, jplan, JBF16, layer=0)[0]

    want = np.asarray(_jax_apply(jfull, 1 + len(names), 1)(
        x, *(p[n] for n in names)))
    tp = {n: torch.from_numpy(p[n]) for n in names}
    with torch.no_grad():
        got = tfn(tp, torch.from_numpy(x), cfg, plan, BF16_POLICY.bind(1),
                  layer=0).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()

    st = _seeded_state(kind, cfg, plan, 40)

    def jstep(x, *rest):
        ws, sv = rest[:len(names)], rest[len(names):]
        y, new = jfn(dict(zip(names, ws)), x, jcfg, jplan, JBF16,
                     state=dict(zip(sorted(st), sv)), layer=0)
        return (y,) + tuple(new[k] for k in sorted(st))

    wy, *wst = _jax_apply(jstep, 1 + len(names) + len(st), 1 + len(st))(
        x[:, :1], *(p[n] for n in names), *(st[k] for k in sorted(st)))
    state = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    with torch.no_grad():
        gy = tfn(tp, torch.from_numpy(x[:, :1]), cfg, plan,
                 BF16_POLICY.bind(1), state=state, layer=0).numpy()
    wy = np.asarray(wy)
    assert np.abs(gy - wy).max() <= 2e-5 * np.abs(wy).max()
    assert sorted(state) == sorted(keys)
    for k, w in zip(sorted(st), wst):
        w = np.asarray(w, np.float32)
        g = state[k].numpy()
        assert np.abs(g - w).max() <= 2e-5 * max(np.abs(w).max(), 1e-30), k


def test_windowed_attention_matches_jax():
    """``blockwise_attention`` with a window of 5 against JAX's (causal,
    window 5) over 3 chunks of 16 keys and a short last chunk (S = 40):
    within 1e-6 of the output's max magnitude (float32; measured
    8.7e-8), and with no window the full causal attention, which differs
    from the windowed one by far more."""
    q, k, v = (_values(i, (2, 40, 3, 8)) for i in (21, 22, 23))
    pos = np.arange(40)
    got = tattn.blockwise_attention(*(torch.from_numpy(a)
                                      for a in (q, k, v)),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(pos), 5,
                                    chunk=16).numpy()
    want = np.asarray(jattn.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v, pos, pos)), causal=True,
        window=5, chunk=16))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    full = tattn.blockwise_attention(*(torch.from_numpy(a)
                                       for a in (q, k, v)),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(pos), chunk=16).numpy()
    assert np.abs(full - want).max() > 0.1 * np.abs(want).max()


def test_lru_lambda_init_and_unknown_init():
    """``rg_lam`` draws (``init_params`` and ``init_store``, the same
    values) make the recurrence weight ``exp(-8 softplus(lambda))`` at a
    full gate lie in [0.9, 0.999] (within float32 rounding, 1e-6); and an
    init the port does not know raises in both rather than falling
    through to the fan-in normal."""
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              dtype="float32")
    plan = make_plan(cfg, tp=1)
    params = init_params(cfg, plan, 3, "cpu", torch.float32)
    store = init_store(cfg, plan, 3, "cpu")
    lam = params["pattern"]["L0_rg_lam"]
    a = torch.exp(-8.0 * tlayers.softplus(lam))
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    assert float(a.max() - a.min()) > 0.05              # a spread of draws
    np.testing.assert_array_equal(
        store["pattern"]["L0_rg_lam"][:, :lam.shape[-1]].numpy(),
        lam.numpy())
    bad = {"rg_lam": ParamSpec((4,), init="orthogonal")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodel, "param_groups",
                   lambda c, p: {"embed": (1, bad)})
        for fn in (lambda: init_params(cfg, plan, 0, "cpu"),
                   lambda: init_store(cfg, plan, 0, "cpu")):
            with pytest.raises(ValueError, match="unknown init"):
                fn()


@pytest.mark.parametrize("arch", ARCHS)
def test_training_raises_for_the_recurrent_kinds(arch):
    """The training CLI trains the recurrent and sliding-window kinds
    (``python -m repro_torch.launch.train --arch ARCH --smoke --device
    cpu --steps 2``): finite losses and grad norms; and ``--n-micro 2``
    gives ``--n-micro 1``'s step-0 loss within 1e-6 relative (the two
    halves' mean losses averaged). ``tests/test_torch_train_recurrent.py``
    holds the steps against JAX's."""
    from repro_torch.launch import train as tlaunch
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--seq", "32", "--batch", "4", "--log-every", "1"]
    losses = []
    for n_micro in ("1", "2"):
        hist = tlaunch.main(argv + ["--n-micro", n_micro])["history"]
        assert len(hist) == 2
        assert all(np.isfinite([h["loss"], h["grad_norm"]]).all()
                   for h in hist)
        losses.append(hist[0]["loss"])
    assert abs(losses[1] - losses[0]) <= 1e-6 * abs(losses[0])


def _jax_hidden(s, jpol):
    def hidden_fn(store, toks):
        return jmodel.forward(store, toks, s["jcfg"], s["jplan"], jpol,
                              dtype=jnp.float32)[0]

    jh = compat.shard_map(hidden_fn, mesh=s["mesh"],
                          in_specs=(jshard.store_spec(s["jplan"]), P()),
                          out_specs=P(), check_vma=False)
    return np.asarray(jax.jit(jh)(s["jstore"], jnp.asarray(s["prompts"])))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pol", list(POLICIES))
def test_prefill_hidden_and_next_token(setups, pol, arch):
    """The prefill's hidden states (S = 68, past recurrentgemma's smoke
    window of 64) agree with JAX's: within 2e-4 of their max magnitude
    without the codec (float32 summation order; measured 2.6e-6,
    recurrentgemma's). Under the paper policy an int8 site's code can
    flip where float32 order moves a value across a rounding boundary (as
    in ``tests/test_torch_moe_archs.py``), and a recurrence carries the
    flip to every later position of the row (recurrentgemma: 85 of the
    136 positions beyond the float32 bound), where later sites can flip
    again: within two int8 steps of a site's widest group, 4 max|h| / 255
    (measured 0.0089 max|h|; xlstm 0.0046, 3 positions). The greedy next
    tokens equal JAX's (its logits from its own hidden states and
    unembedding) in every row whose top-2 margin exceeds twice the row's
    largest logit difference: every row without the codec; under the
    paper policy recurrentgemma's row 1 is not held (a margin of 0.0085
    against a difference of 0.0178)."""
    s = setups(arch)
    jpol, tpol = POLICIES[pol]
    want = _jax_hidden(s, jpol())
    toks = torch.from_numpy(s["prompts"])
    with torch.no_grad():
        h, unemb, _, _ = forward(s["params"], toks, s["cfg"], s["plan"],
                                 tpol(), dtype=torch.float32)
    h = h.numpy()
    hmax = np.abs(want).max()
    diff = np.abs(h - want)
    if pol == "bf16":
        assert diff.max() <= 2e-4 * hmax, diff.max() / hmax
    else:
        assert diff.max() <= 4 * hmax / 255
    w_unemb = s["params"]["out"]["unemb"][0].numpy()
    jl = want[:, -1] @ w_unemb.T
    tl = serve_step.make_prefill(s["cfg"], s["plan"], tpol())(
        s["params"], toks)
    got_tok = greedy_next_token(tl, s["plan"]).numpy()
    top2 = -np.sort(-jl, axis=-1)[:, :2]
    held = top2[:, 0] - top2[:, 1] > 2 * np.abs(tl.numpy() - jl).max(-1)
    assert held.all() or pol == "paper"
    np.testing.assert_array_equal(got_tok[held], jl.argmax(-1)[held])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_tokens_match_jax(setups, arch):
    """The decode loop without the codec (the prompt of S = 68
    teacher-forced through the caches, then GEN greedy tokens) gives
    JAX's token at every step. recurrentgemma's local block keeps a ring
    of its window's 64 slots, which wraps after position 63, and every
    slot then holds a position within the window. (Under the paper policy
    a code flipped by float order, see the prefill test, can swap a near
    tie: at S = 80 one token of 166 at a top-2 margin of 0.0021;
    ``tests/test_torch_serve_tp_recurrent.py`` holds the paper decode at
    tp = 2.)"""
    s = setups(arch)
    jpol, tpol = POLICIES["bf16"]
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
    kinds = s["cfg"].layer_kinds
    for kind, cache in zip(kinds, tcache["layers"]):
        if kind == "local":
            w = s["cfg"].window
            assert cache["slot_pos"].shape == (w,)
            last = S + GEN - 2
            assert (cache["slot_pos"] > last - w).all()
        else:
            assert sorted(cache) == sorted(
                {"rec": "conv h", "mlstm": "c m n",
                 "slstm": "c h m n"}[kind].split())
