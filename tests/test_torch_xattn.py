"""whisper-tiny (encoder-decoder, learned positions, biased projections)
and llama-3.2-vision-11b (image cross-attention): the port against the
JAX package at tp = 1, float32.

Both packages run the same weights, made in JAX's store layout from a
seeded normal (``_torch_gloo_worker.numpy_store``: no array zero,
the output projections ``wo``, ``xwo``, ``w2``, every bias and the
LayerNorm biases included). The stub frontend's embeddings come from the
data stream, which draws them after the tokens from the same generator
in both packages.
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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_recurrent import _jax_apply, _values  # noqa: E402
from _torch_gloo_worker import numpy_store  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.policy import BF16_POLICY as JBF16  # noqa: E402
from repro.core.policy import depth_policy as jdepth  # noqa: E402
from repro.core.policy import paper_policy as jpaper  # noqa: E402
from repro.core.policy import with_backend as jwith_backend  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.parallel import shardings as jshard  # noqa: E402
from repro.parallel.plan import make_plan as jmake_plan  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import serve_step as jserve  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, \
    get_smoke_config  # noqa: E402
from repro_torch.core.policy import (BF16_POLICY, depth_policy,  # noqa: E402
                                     paper_policy)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.model import forward, greedy_next_token  # noqa: E402
from repro_torch.parallel.plan import make_plan  # noqa: E402
from repro_torch.parallel.shardings import load_jax_store  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402
from repro_torch.train.data import DataConfig, make_dataset  # noqa: E402

ARCHS = ("whisper-tiny", "llama-3.2-vision-11b")
B, S, GEN = 2, 12, 3
POLICIES = {"paper": (lambda: jwith_backend(jpaper(), "ref"), paper_policy),
            "bf16": (lambda: JBF16, lambda: BF16_POLICY),
            "depth": (lambda: jwith_backend(jdepth(), "ref"), depth_policy)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module (see test_torch_recurrent.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg):
    return make_dataset(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                   enc_ctx=cfg.encoder.n_ctx,
                                   d_model=cfg.d_model)).batch(0)


@pytest.fixture(scope="module")
def setups():
    """arch -> its smoke config's setup in both packages, JAX's jitted
    prefill (per policy) and decode step cached in it (built once)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = dataclasses.replace(jax_smoke_config(arch),
                                       dtype="float32")
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      dtype="float32")
            jplan = jmake_plan(jcfg, tp=1, fsdp=1)
            plan = make_plan(cfg, tp=1)
            store_np = numpy_store(jmodel.param_groups(jcfg, jplan), jplan)
            batch = _batch(cfg)
            cache[arch] = dict(
                jcfg=jcfg, cfg=cfg, jplan=jplan, plan=plan,
                jstore=jax.tree_util.tree_map(jnp.asarray, store_np),
                params=load_jax_store(store_np, cfg, plan, "cpu",
                                      torch.float32),
                prompts=batch["tokens"], embeds=batch["enc_embeds"],
                mesh=make_test_mesh(1, 1), jit={})
        return cache[arch]
    return get


def _fields(c):
    """A config's fields, the nested EncoderConfig as a dict (the two
    packages' classes differ)."""
    return {f.name: (dataclasses.asdict(getattr(c, f.name))
                     if dataclasses.is_dataclass(getattr(c, f.name))
                     else getattr(c, f.name))
            for f in dataclasses.fields(c)}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """The full and smoke configs equal JAX's field by field (every field
    of the port's schema, ``encoder`` as an ``EncoderConfig`` of equal
    fields among them), the properties ``is_enc_dec``, ``has_cross`` and
    ``layer_kinds`` equal JAX's, and the registry serves both ids."""
    assert arch in ARCH_IDS
    for got, want in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        gf, wf = _fields(got), _fields(want)
        assert gf == {k: wf[k] for k in gf}, arch
        assert (got.is_enc_dec, got.has_cross, got.layer_kinds) == (
            want.is_enc_dec, want.has_cross, want.layer_kinds)
    full = get_config(arch)
    assert (full.is_enc_dec, full.has_cross, full.encoder.n_ctx) == {
        "whisper-tiny": (True, True, 1500),
        "llama-3.2-vision-11b": (False, True, 1600)}[arch]


@pytest.mark.parametrize("arch,tp", [("whisper-tiny", 1), ("whisper-tiny", 2),
                                     ("llama-3.2-vision-11b", 1),
                                     ("llama-3.2-vision-11b", 2),
                                     ("llama-3.2-vision-11b", 8)])
def test_param_layout_matches_jax(arch, tp):
    """Parameter groups, names, shapes, sharding and init rules at full
    width equal JAX's ``param_groups``: whisper's ``pos`` table in
    ``embed``, its ``encoder`` (4 stacked ``enc`` blocks) and
    ``encoder_extra`` (``ef_``, ``enc_pos``) groups, the cross block's
    ``x``-prefixed names and their biases; llama's ``xattn`` blocks."""
    got = tmodel.param_groups(get_config(arch),
                              make_plan(get_config(arch), tp=tp))
    want = jmodel.param_groups(jax_config(arch),
                               jmake_plan(jax_config(arch), tp=tp, fsdp=1))
    assert sorted(got) == sorted(want)
    for g, (n, specs) in got.items():
        assert n == want[g][0], g
        assert sorted(specs) == sorted(want[g][1]), g
        for name, sp in specs.items():
            w = want[g][1][name]
            assert (sp.shape, sp.tp_dim, sp.init, sp.moe_fold) == (
                w.shape, w.tp_dim, w.init, w.moe_fold), (g, name)
    names = set(got["pattern"][1])
    if arch == "whisper-tiny":
        assert got["embed"][1]["pos"].shape == (32768, 384)
        assert got["encoder"][0] == 4
        assert sorted(got["encoder_extra"][1]) == ["ef_bias", "ef_gain",
                                                   "enc_pos"]
        assert {"L0_xwq", "L0_xbk", "L0_xbo", "L0_n3_bias", "L0_bo",
                "L0_b2"} <= names
    else:
        assert "pos" not in got["embed"][1] and "encoder" not in got
        assert {"L0_xwq", "L0_xwo", "L1_wq"} <= names
        assert "L0_wq" not in names


@pytest.mark.parametrize("arch", ARCHS)
def test_data_stream_matches_jax(arch):
    """The data stream's ``tokens``, ``labels`` and ``enc_embeds`` equal
    JAX's ``make_dataset`` byte for byte (two steps)."""
    cfg = get_smoke_config(arch)
    kw = dict(vocab=cfg.vocab, seq_len=S, global_batch=B,
              enc_ctx=cfg.encoder.n_ctx, d_model=cfg.d_model)
    got, want = make_dataset(DataConfig(**kw)), jdata.make_dataset(
        jdata.DataConfig(**kw))
    for step in (0, 1):
        g, w = got.batch(step), want.batch(step)
        assert sorted(g) == sorted(w) == ["enc_embeds", "labels", "tokens"]
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])
    assert "enc_embeds" not in make_dataset(DataConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B)).batch(0)


def test_noncausal_attention_matches_jax():
    """``blockwise_attention(causal=False)`` against JAX's over 2 chunks of
    16 keys and a short last one (Skv = 40, S = 24, unpadded in the port,
    padded with ``kpos = -1`` in JAX): within 1e-6 of the output's max
    magnitude (float32; measured 2.0e-7); with queries at position 0, as
    the cross-attention gives them, too. The causal mask there (every
    query sees key 0 alone) differs from it by far more."""
    q = _values(31, (2, 24, 3, 8))
    k, v = (_values(i, (2, 40, 3, 8)) for i in (32, 33))
    kpos = np.arange(40)
    for qpos in (np.arange(24), np.zeros(24, np.int64)):
        got = tattn.blockwise_attention(
            *(torch.from_numpy(a) for a in (q, k, v, qpos, kpos)),
            chunk=16, causal=False).numpy()
        want = np.asarray(jax.jit(
            jattn.blockwise_attention, static_argnums=(5, 6, 7))(
                *(jnp.asarray(a) for a in (q, k, v, qpos, kpos)), False,
                None, 16))
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    causal = tattn.blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v, qpos, kpos)),
        chunk=16).numpy()
    assert np.abs(causal - want).max() > 0.1 * np.abs(want).max()


def _block_params(setups, arch: str, j: int):
    p = setups(arch)["params"]["pattern"]
    pre = f"L{j}_"
    return {k[len(pre):]: v[0] for k, v in p.items() if k.startswith(pre)}


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_matches_jax(setups, arch):
    """``cross_attention`` (the smoke configs' filled weights: whisper's
    biases, llama's 2 kv heads for 4 q heads through ``_per_q_head``)
    against JAX's at tp = 1, no codec, on a seeded x (B, 7, d) and
    encoder output (B, 40, d): within 2e-5 of the output's max magnitude
    (float32 matmul order; measured 6.0e-7 at most); every query attends
    to every key, so changing the last encoder position moves every
    output."""
    s = setups(arch)
    cfg, plan, jcfg, jplan = s["cfg"], s["plan"], s["jcfg"], s["jplan"]
    p = _block_params(setups, arch, 0)
    names = sorted(n for n in p if n.startswith("x"))
    x = _values(41, (B, 7, cfg.d_model))
    enc = _values(42, (B, 40, cfg.d_model))

    def jfn(x, enc, *ws):
        return jattn.cross_attention(dict(zip(names, ws)), x, enc, jcfg,
                                     jplan, JBF16, prefix="x", layer=0)

    want = np.asarray(_jax_apply(jfn, 2 + len(names), 1)(
        x, enc, *(p[n].numpy() for n in names)))
    with torch.no_grad():
        got = tattn.cross_attention(p, torch.from_numpy(x),
                                    torch.from_numpy(enc), cfg, plan,
                                    BF16_POLICY.bind(1), layer=0).numpy()
        enc2 = enc.copy()
        enc2[:, -1] += _values(44, (cfg.d_model,))
        moved = tattn.cross_attention(p, torch.from_numpy(x),
                                      torch.from_numpy(enc2), cfg, plan,
                                      BF16_POLICY.bind(1), layer=0).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    assert (np.abs(moved - got).max(-1) > 0).all()


def _get(params):
    return lambda g, i: {k: v[i] for k, v in params[g].items()}


def test_encode_matches_jax(setups):
    """whisper's ``_encode`` (``enc_pos`` added, 2 non-causal ``enc``
    blocks with biases, the ``ef_`` LayerNorm) against JAX's at tp = 1 on
    the stream's embeddings: without the codec within 2e-5 of the
    output's max magnitude (measured 6.4e-7); and the first frame's
    output depends on the last frame (the encoder is not causal)."""
    s = setups("whisper-tiny")
    cfg, plan, jcfg, jplan = s["cfg"], s["plan"], s["jcfg"], s["jplan"]

    def jfn(store, emb):
        return jmodel._encode(store, jcfg, jplan, JBF16.bind(jcfg.n_layers),
                              emb, None)

    f = jax.jit(compat.shard_map(jfn, mesh=s["mesh"],
                                 in_specs=(jshard.store_spec(jplan), P()),
                                 out_specs=P(), check_vma=False))
    want = np.asarray(f(s["jstore"], jnp.asarray(s["embeds"])))
    emb = torch.from_numpy(s["embeds"])
    with torch.no_grad():
        got = tmodel._encode(_get(s["params"]), emb, cfg, plan,
                             BF16_POLICY.bind(cfg.n_layers), group=None,
                             rank=0).numpy()
        emb2 = emb.clone()                  # (a uniform shift: LayerNorm's)
        emb2[:, -1] += torch.from_numpy(_values(43, (cfg.d_model,)))
        moved = tmodel._encode(_get(s["params"]), emb2, cfg, plan,
                               BF16_POLICY.bind(cfg.n_layers), group=None,
                               rank=0).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    assert np.abs(moved[:, 0] - got[:, 0]).max() > 1e-3


def _jax_hidden(s, pol: str):
    if pol not in s["jit"]:
        jpol = POLICIES[pol][0]()

        def hidden_fn(store, toks, emb):
            return jmodel.forward(store, toks, s["jcfg"], s["jplan"], jpol,
                                  enc_embeds=emb, dtype=jnp.float32)[0]

        s["jit"][pol] = jax.jit(compat.shard_map(
            hidden_fn, mesh=s["mesh"],
            in_specs=(jshard.store_spec(s["jplan"]), P(), P()),
            out_specs=P(), check_vma=False))
    return np.asarray(s["jit"][pol](s["jstore"], jnp.asarray(s["prompts"]),
                                    jnp.asarray(s["embeds"])))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pol", ["paper", "bf16"])
def test_prefill_hidden_and_next_token(setups, pol, arch):
    """The prefill's hidden states (S = 12, the stream's embeddings)
    agree with JAX's: within 2e-4 of their max magnitude without the
    codec (float32 summation order, the encoder's and cross-attention's
    keys of 64 and 32 positions; measured 1.2e-6 at most). Under the
    paper policy an int8 site's code can flip where float32 order moves
    a value across a rounding boundary (test_torch_recurrent.py): within
    two int8 steps of a site's widest group, 4 max|h| / 255 (a code
    flipped in whisper's encoder output would reach all of its row's
    positions through the cross-attention). Measured: whisper 1.8e-7, no
    flip; llama 0.0037 max|h| at one position.
    The greedy next tokens equal JAX's (its logits
    from its hidden states and unembedding) in every row whose top-2
    margin exceeds twice the row's largest logit difference (every row
    here)."""
    s = setups(arch)
    want = _jax_hidden(s, pol)
    tpol = POLICIES[pol][1]()
    toks, emb = torch.from_numpy(s["prompts"]), torch.from_numpy(s["embeds"])
    with torch.no_grad():
        h = forward(s["params"], toks, s["cfg"], s["plan"], tpol,
                    dtype=torch.float32, enc_embeds=emb)[0].numpy()
    hmax = np.abs(want).max()
    bound = 2e-4 * hmax if pol == "bf16" else 4 * hmax / 255
    assert np.abs(h - want).max() <= bound
    jl = want[:, -1] @ s["params"]["out"]["unemb"][0].numpy().T
    tl = serve_step.make_prefill(s["cfg"], s["plan"], tpol)(
        s["params"], toks, emb)
    top2 = -np.sort(-jl, axis=-1)[:, :2]
    held = top2[:, 0] - top2[:, 1] > 2 * np.abs(tl.numpy() - jl).max(-1)
    assert held.all()
    np.testing.assert_array_equal(
        greedy_next_token(tl, s["plan"]).numpy(), jl.argmax(-1))
    with pytest.raises(ValueError, match="enc_embeds"):
        forward(s["params"], toks, s["cfg"], s["plan"], tpol,
                dtype=torch.float32)


def test_depth_policy_encoder_sites_at_no_layer(setups):
    """Under ``depth_policy()`` (TP int8 g128 at the first and last block,
    int4 g32 between and at ``layer=None``) whisper's prefill agrees with
    JAX's under its ``depth_policy()``: every position within two int8
    steps of max|h|, 4 max|h| / 255 (room for a code flipped by float32
    order at an int8 decoder site), and at least half of the positions
    within 2e-4 of it (measured: all 24 within 2.4e-7). The encoder's
    sites resolve at ``layer=None`` (int4, the schedule's base), as JAX's
    do: resolved at block 0 instead (int8) the hidden states move by
    0.021 of max|h| and no position is within 2e-4, which both bounds
    catch."""
    s = setups("whisper-tiny")
    want = _jax_hidden(s, "depth")
    toks, emb = torch.from_numpy(s["prompts"]), torch.from_numpy(s["embeds"])
    hmax = np.abs(want).max()

    def held():
        with torch.no_grad():
            h = forward(s["params"], toks, s["cfg"], s["plan"],
                        depth_policy(), dtype=torch.float32,
                        enc_embeds=emb)[0].numpy()
        d = np.abs(h - want).max(-1)
        return (d.max() <= 4 * hmax / 255
                and (d <= 2e-4 * hmax).mean() >= 0.5)

    assert held()
    real = tmodel.apply_block

    def at_block0(kind, *a, **kw):
        if kind == "enc":
            kw["layer"] = 0
        return real(kind, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodel, "apply_block", at_block0)
        assert not held()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_tokens_match_jax(setups, arch):
    """The decode loop without the codec (the prompt of S = 12
    teacher-forced through the caches, then GEN greedy tokens; the
    stream's embeddings given at every step, the encoder re-run each
    time) gives JAX's token at every step; the port's caches: a kv ring
    a ``dec`` or ``dense`` block, none (``{}``) an ``xattn`` block."""
    s = setups(arch)
    clen = S + GEN
    jpol = POLICIES["bf16"][0]()
    jstep = jserve.make_decode_step(s["jcfg"], s["jplan"], jpol, s["mesh"],
                                    B, clen)
    jcache = jserve.make_cache_init(s["jcfg"], s["jplan"], s["mesh"], B,
                                    clen)()
    tstep = serve_step.make_decode_step(s["cfg"], s["plan"], BF16_POLICY)
    tcache = serve_step.make_cache_init(s["cfg"], s["plan"], B, clen,
                                        "cpu")()
    prompts, emb = s["prompts"], s["embeds"]
    temb = torch.from_numpy(emb)
    tok = prompts[:, :1]
    for i in range(S + GEN - 1):
        jn, jcache = jstep(s["jstore"], jcache,
                           {"tokens": jnp.asarray(tok, jnp.int32),
                            "enc_embeds": jnp.asarray(emb)})
        tl, tcache = tstep(s["params"], tcache, torch.tensor(tok), temb)
        np.testing.assert_array_equal(
            greedy_next_token(tl, s["plan"]).numpy(), np.asarray(jn),
            err_msg=f"step {i}")
        tok = prompts[:, i + 1:i + 2] if i + 1 < S else np.asarray(jn)[:, None]
    assert tcache["pos"] == S + GEN - 1
    for kind, cache in zip(s["cfg"].layer_kinds, tcache["layers"]):
        if kind == "xattn":
            assert cache == {}
        else:
            assert sorted(cache) == ["k", "slot_pos", "v"]
            assert cache["slot_pos"].shape == (clen,)


def test_learned_position_read_at_decode(setups):
    """A whisper decode step at position ``pos`` adds row ``pos`` of the
    learned table (and a step past the table its last row, clipped as
    JAX's): changing row 3 moves the logits of a step at position 3,
    changing row 5 does not."""
    s = setups("whisper-tiny")
    cfg, plan = s["cfg"], s["plan"]
    step = serve_step.make_decode_step(cfg, plan, BF16_POLICY)
    toks = torch.from_numpy(s["prompts"][:, :1])
    emb = torch.from_numpy(s["embeds"])

    def logits(params, pos):
        caches = serve_step.make_cache_init(cfg, plan, B, 8, "cpu")()
        caches["pos"] = pos
        return step(params, caches, toks, emb)[0]

    base = logits(s["params"], 3)
    for row, moves in ((3, True), (5, False)):
        params = {g: dict(v) for g, v in s["params"].items()}
        table = params["embed"]["pos"].clone()
        table[0, row] += 1.0
        params["embed"]["pos"] = table
        assert bool((logits(params, 3) != base).any()) == moves, row
    last = cfg.max_pos - 1
    np.testing.assert_array_equal(logits(s["params"], last + 5).numpy(),
                                  logits(s["params"], last).numpy())


def test_init_block_cache_by_kind():
    """``init_block_cache``: an ``xattn`` block gets no cache (``{}``, as
    JAX's), a ``dec`` block a kv ring, also in replicate mode at tp = 4
    (llama's 2 kv heads), where an xattn ring would need the cache
    length to divide by tp."""
    cfg = get_smoke_config("whisper-tiny")
    plan = make_plan(cfg, tp=1)
    ring = tmodel.init_block_cache("dec", cfg, plan, B, 10, torch.float32,
                                   "cpu")
    assert sorted(ring) == ["k", "slot_pos", "v"]
    assert ring["k"].shape == (B, 10, cfg.n_kv_heads, cfg.hd)
    vcfg = get_smoke_config("llama-3.2-vision-11b")
    vplan = make_plan(vcfg, tp=4)
    assert vplan.kv_mode == "replicate"
    assert tmodel.init_block_cache("xattn", vcfg, vplan, B, 7,
                                   torch.float32, "cpu") == {}


def test_site_row_bytes_counts_encoder_tokens():
    """``site_row_bytes`` sizes whisper's model world for batch x n_ctx
    tokens (its encoder's sites: 4 x 1500 x 384 values, f32, padded to a
    tp x 128 multiple, a rank's chunk), above the prompt's 4 x 128; a
    model with cross-attention and no encoder layers (llama-3.2-vision)
    for batch x seq."""
    for tp in (1, 2):
        cfg = get_config("whisper-tiny")
        rows = tmesh.site_row_bytes(cfg, make_plan(cfg, tp=tp), 4, 128)
        assert rows.model == 4 * (-(-4 * 1500 * 384 // (tp * 128)) * 128)
    vcfg = get_config("llama-3.2-vision-11b")
    rows = tmesh.site_row_bytes(vcfg, make_plan(vcfg, tp=2), 4, 128)
    assert rows.model == 4 * 4 * 128 * 4096 // 2


@pytest.mark.parametrize("arch", ARCHS)
def test_training_raises_for_the_cross_kinds(arch):
    """The training CLI trains the ``enc``, ``dec`` and ``xattn`` kinds
    (``python -m repro_torch.launch.train --arch ARCH --smoke --device
    cpu --steps 2``): finite losses and grad norms, the batch's stub
    embeddings reaching the model float32 at (rows, n_ctx, d_model) in
    every forward; and ``--n-micro 2`` gives ``--n-micro 1``'s step-0
    loss within 1e-6 relative, each half with its rows' embeddings.
    ``tests/test_torch_train_xattn.py`` holds the steps against JAX's."""
    from repro_torch.launch import train as tlaunch
    from repro_torch.train import train_step
    cfg = get_smoke_config(arch)
    seen = []
    fwd = train_step.forward_train

    def recorded(*a, enc_embeds=None, **k):
        seen.append((enc_embeds.dtype, tuple(enc_embeds.shape)))
        return fwd(*a, enc_embeds=enc_embeds, **k)

    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--seq", "32", "--batch", "4", "--log-every", "1"]
    losses = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_step, "forward_train", recorded)
        for n_micro in (1, 2):
            seen.clear()
            hist = tlaunch.main(argv + ["--n-micro", str(n_micro)])[
                "history"]
            assert len(hist) == 2
            assert all(np.isfinite([h["loss"], h["grad_norm"]]).all()
                       for h in hist)
            assert seen == [(torch.float32, (4 // n_micro,
                                             cfg.encoder.n_ctx,
                                             cfg.d_model))] * 2 * n_micro
            losses.append(hist[0]["loss"])
    assert abs(losses[1] - losses[0]) <= 1e-6 * abs(losses[0])
