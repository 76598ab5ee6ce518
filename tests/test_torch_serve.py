"""Serving the qwen3-14b, llama3-8b, glm4-9b and command-r-35b smoke
configs (command-r's with LayerNorm): the port against the JAX package.

The JAX package builds the weights (``build_store``, float32), the port
carries them over with ``load_jax_store``, and both run in float32 on the
same prompts. The JAX store zero-initialises the attention and MLP output
projections (and LayerNorm's biases); they are filled with seeded random
values in both stores first, so that every TP AllReduce site carries
data and every bias leaf is carried across non-zero.
"""
import dataclasses
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.policy import BF16_POLICY as JBF16
from repro.core.policy import paper_policy as jpaper
from repro.core.policy import with_backend as jwith_backend
from repro.launch.mesh import make_test_mesh
from repro.models import model as jmodel
from repro.parallel import shardings as jshard
from repro.parallel.plan import make_plan as jmake_plan
from repro.train import serve_step as jserve
from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import BF16_POLICY, paper_policy
from repro_torch.launch import serve as tserve
from repro_torch.models.model import (forward, greedy_next_token,
                                      next_token_logits)
from repro_torch.parallel.plan import make_plan
from repro_torch.parallel.shardings import load_jax_store
from repro_torch.train import serve_step
from repro_torch.train.data import DataConfig, make_dataset
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, GEN = 2, 12, 3
POLICIES = {"paper": (lambda: jwith_backend(jpaper(), "ref"), paper_policy),
            "bf16": (lambda: JBF16, lambda: BF16_POLICY)}
ARCHS = ("qwen3-14b", "llama3-8b", "glm4-9b", "command-r-35b")


@pytest.fixture(scope="module")
def setups():
    """arch -> its setup (built once a module)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _setup(arch)
        return cache[arch]
    return get


@pytest.fixture(scope="module")
def setup(setups):
    return setups("qwen3-14b")


def _setup(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jplan = jmake_plan(jcfg, tp=1, fsdp=1)
    # build_store folds ``hash(name)`` into each parameter's key, and str
    # hashes are salted per process: a crc32 in its place makes the
    # weights the same in every process.
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
            if not a.any():                      # zero-init projections
                a = (rng.standard_normal(a.shape) * 0.05).astype(np.float32)
            store_np[g][name] = a
    jstore = jax.tree_util.tree_map(jnp.asarray, store_np)
    plan = make_plan(cfg, tp=1)
    params = load_jax_store(store_np, cfg, plan, "cpu", torch.float32)
    prompts = make_dataset(DataConfig(vocab=cfg.vocab, seq_len=S,
                                      global_batch=B)).batch(0)["tokens"]
    return dict(jcfg=jcfg, cfg=cfg, jplan=jplan, plan=plan, jstore=jstore,
                params=params, prompts=prompts,
                mesh=make_test_mesh(1, 1))


def test_data_matches_jax(setup):
    from repro.train.data import DataConfig as JDataConfig
    from repro.train.data import make_dataset as jmake_dataset
    want = jmake_dataset(JDataConfig(vocab=512, seq_len=S,
                                     global_batch=B)).batch(0)["tokens"]
    np.testing.assert_array_equal(setup["prompts"], want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pol", ["paper", "bf16"])
def test_prefill_hidden_and_next_token(setups, pol, arch):
    """Hidden states agree to 2e-4 (relative to their max magnitude): the
    packages differ in float32 summation order (matmuls, RMS norm,
    softmax) and in the last ulp of pow/cos/sin in RoPE. Under the paper
    policy an int8 site turns such a difference into one code step where
    a value lies at a rounding boundary: at most 0.5% of the elements may
    then differ by up to one int8 step of the widest group (2 max|h| /
    255). Next tokens are equal."""
    s = setups(arch)
    jpol, tpol = POLICIES[pol]

    def hidden_fn(store, toks):
        h, _, _, _ = jmodel.forward(store, toks, s["jcfg"], s["jplan"],
                                    jpol(), dtype=jnp.float32)
        return h

    jh = compat.shard_map(hidden_fn, mesh=s["mesh"],
                          in_specs=(jshard.store_spec(s["jplan"]), P()),
                          out_specs=P(), check_vma=False)
    want_h = np.asarray(jax.jit(jh)(s["jstore"], jnp.asarray(s["prompts"])))
    toks = torch.from_numpy(s["prompts"])
    with torch.no_grad():
        h, unemb, _, _ = forward(s["params"], toks, s["cfg"], s["plan"],
                                 tpol(), dtype=torch.float32)
    hmax = np.abs(want_h).max()
    diff = np.abs(h.numpy() - want_h)
    if pol == "bf16":
        assert diff.max() <= 2e-4 * hmax
    else:
        assert np.mean(diff > 2e-4 * hmax) <= 0.005
        assert diff.max() <= 2 * hmax / 255
    jprefill = jserve.make_prefill(s["jcfg"], s["jplan"], jpol(), s["mesh"],
                                   B)
    want_tok = np.asarray(jprefill(s["jstore"],
                                   {"tokens": jnp.asarray(s["prompts"])}))
    got_tok = greedy_next_token(serve_step.make_prefill(
        s["cfg"], s["plan"], tpol())(s["params"], toks), s["plan"]).numpy()
    np.testing.assert_array_equal(got_tok, want_tok)
    np.testing.assert_array_equal(
        greedy_next_token(next_token_logits(h, unemb, s["cfg"], s["plan"]),
                          s["plan"]).numpy(), want_tok)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pol", ["paper", "bf16"])
def test_decode_tokens_match_jax(setups, pol, arch):
    """The decode loop (prompt teacher-forced through the cache, then
    greedy) gives the JAX tokens at every step: argmaxes of logits that
    agree as in the prefill test."""
    s = setups(arch)
    jpol, tpol = POLICIES[pol]
    clen = S + GEN
    jinit = jserve.make_cache_init(s["jcfg"], s["jplan"], s["mesh"], B, clen)
    jstep = jserve.make_decode_step(s["jcfg"], s["jplan"], jpol(),
                                    s["mesh"], B, clen)
    tstep = serve_step.make_decode_step(s["cfg"], s["plan"], tpol())
    tcache = serve_step.make_cache_init(s["cfg"], s["plan"], B, clen,
                                        "cpu")()
    jcache = jinit()
    prompts = s["prompts"]
    tok = prompts[:, :1]
    for i in range(S + GEN - 1):
        jn, jcache = jstep(s["jstore"], jcache,
                           {"tokens": jnp.asarray(tok, jnp.int32)})
        tl, tcache = tstep(s["params"], tcache, torch.tensor(tok))
        tn = greedy_next_token(tl, s["plan"])
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn),
                                      err_msg=f"step {i}")
        tok = prompts[:, i + 1:i + 2] if i + 1 < S else np.asarray(jn)[:, None]
    assert tcache["pos"] == S + GEN - 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """``layer_norm`` against JAX's on the same rows: float32 within 2
    float32 roundings of the output's magnitude (the mean and variance
    sum in another order), bf16 within one bf16 rounding (the two may
    round a float32 value at a tie apart) on at most 1% of the values
    and bit for bit elsewhere. A constant row (variance 0) gives the
    bias exactly, and the variance is the population's: eps 1e-5 on a
    row of +-1 gives 1 / sqrt(1 + 1e-5), not the sample variance's.
    Measured: float32 4.8e-7 off at most (the bound 8.4e-7), bf16 bit
    for bit; the sample variance in place of the population's reads
    6.6e-3 (float32) and moves 30% of the bf16 values."""
    from repro.models.layers import layer_norm as jlayer_norm
    from repro_torch.models.layers import layer_norm
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 256)) * 3 + 1).astype(np.float32)
    x[1] = 2.5                                     # constant row
    x[2] = np.where(np.arange(256) % 2, 1.0, -1.0)
    gain = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(256)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jlayer_norm(jnp.asarray(x, jd), jnp.asarray(gain, jd),
                                  jnp.asarray(bias, jd)).astype(jnp.float32))
    got = layer_norm(torch.from_numpy(x).to(td), torch.from_numpy(gain).to(
        td), torch.from_numpy(bias).to(td)).float().numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    bias_d = torch.from_numpy(bias).to(td).float().numpy()
    np.testing.assert_array_equal(got[1], bias_d)
    g_d = torch.from_numpy(gain).to(td).float().numpy()
    np.testing.assert_allclose(got[2], (np.where(np.arange(256) % 2, 1, -1)
                                        / np.sqrt(1 + 1e-5)) * g_d + bias_d,
                               rtol=1e-2 if dtype == "bfloat16" else 1e-6)
    d = np.abs(got - want)
    if dtype == "float32":
        assert d.max() <= 2 * 2 ** -23 * np.abs(want).max()
    else:
        assert np.mean(d > 0) <= 0.01
        assert (d <= 2 ** -8 * np.abs(want) + 1e-30).all()


def test_serve_cli_cpu_and_device_default(monkeypatch):
    """--device defaults to CUDA: without a GPU the launcher raises
    instead of running on the CPU; --device cpu runs the smoke config
    end to end (prefill/decode agreement included: the output
    projections are zero, so the two paths give bit-identical logits and
    every row is held)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen3-14b", "--smoke"])
    res = tserve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6", "--gen", "2",
                       "--policy", "aggressive", "--comm-scheme", "fused"])
    assert res["agreement"]["rows_held"] == 2
    assert res["agreement"]["rel_divergence"] == [0.0, 0.0]
    assert res["generated"].shape == (2, 2)


def _smoke_with_data(seed: int = 0):
    """The bf16 smoke config with its zero-initialised output projections
    filled from a fan-in normal, so that every site carries data."""
    from repro_torch.parallel.shardings import init_params
    cfg = get_smoke_config("qwen3-14b")
    plan = make_plan(cfg, tp=1)
    params = init_params(cfg, plan, seed, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for t in params["pattern"].values():
        if not t.any():
            t.copy_(torch.randn(t.shape, generator=gen) / t.shape[-2] ** 0.5)
    return cfg, plan, params


@pytest.mark.parametrize("fault", [None, "values_lost", "positions_lost"])
def test_agreement_check_catches_cache_faults(monkeypatch, fault):
    """With data at every site, prefill and decode logits differ by
    rounding only, and serve's agreement check passes under the most
    quantized policy (int5 g128, Eq.-1 scales). A decode cache that loses
    the earlier positions' values, or the positions themselves, moves the
    logits by about their spread: the check raises."""
    from repro_torch.models import attention as attn
    cfg, plan, params = _smoke_with_data()
    if fault is not None:
        orig = attn.self_attention

        def broken(*args, cache=None, **kw):
            out = orig(*args, cache=cache, **kw)
            if cache is not None:
                if fault == "values_lost":
                    cache["v"].zero_()
                else:
                    cache["slot_pos"].fill_(-1)
            return out

        monkeypatch.setattr(attn, "self_attention", broken)
    run = lambda: tserve.serve(  # noqa: E731
        params, cfg, plan, tserve.build_policy("aggressive"), batch=4,
        prompt_len=16, gen=2, device=torch.device("cpu"), log=lambda *a: 0)
    if fault is None:
        agree = run()["agreement"]
        assert max(agree["rel_divergence"]) <= tserve.AGREEMENT_REL_TOL
    else:
        with pytest.raises(AssertionError, match="diverge"):
            run()


def test_agreement_rows_held():
    """Token agreement is required exactly where the logit difference
    cannot move the argmax: a flipped token in such a row raises, a flip
    in a row whose top-2 margin is within twice the difference does
    not."""
    p = torch.tensor([[5.0, 1.0, 0.0, -1.0], [2.0, 1.99, 0.0, -1.0]])
    d = p + torch.tensor([[0.0, 0.01, 0.0, 0.0], [0.0, 0.02, 0.0, 0.0]])
    res = tserve.prefill_decode_agreement(p, d, p.argmax(-1), d.argmax(-1),
                                          vocab=4)
    assert res["rows_held"] == 1 and d.argmax(-1).tolist() == [0, 1]
    with pytest.raises(AssertionError, match="post-prompt token"):
        tserve.prefill_decode_agreement(p, d, p.argmax(-1),
                                        torch.tensor([1, 1]), vocab=4)


POLICY_FILES = sorted(
    os.path.join(ROOT, "configs", "policies", f)
    for f in os.listdir(os.path.join(ROOT, "configs", "policies")))


@pytest.mark.parametrize("path", POLICY_FILES)
def test_policy_files_resolve_like_jax(path):
    """The shipped JSON policies load unchanged and bind the same config
    at every (site, layer) of the 40-layer model; the stock policies and
    the startup banner agree too."""
    from repro.core import policy as jpolicy
    from repro_torch.core import policy as tpolicy
    pairs = [(jpolicy.load_policy_file(path), tpolicy.load_policy_file(path)),
             (jpolicy.paper_policy(), tpolicy.paper_policy()),
             (jpolicy.aggressive_policy(), tpolicy.aggressive_policy()),
             (jpolicy.depth_policy(), tpolicy.depth_policy()),
             (jpolicy.BF16_POLICY, tpolicy.BF16_POLICY)]
    for jp, tp in pairs:
        for site in tpolicy.SITES:
            for layer in [None, *range(40)]:
                jc = jp.resolve(site, layer, 40)
                tc = tp.resolve(site, layer, 40)
                assert (jc is None) == (tc is None)
                if jc is not None:
                    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tpolicy.describe_policy(tp, 40) == \
            jpolicy.describe_policy(jp, 40)
