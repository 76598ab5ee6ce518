"""One rank of a gloo run of the port's collectives.

    python tests/_torch_gloo_worker.py RANK WORLD INIT_FILE OUT_DIR [MODE]

MODE ``allreduce`` (the default): every rank draws the same (WORLD, N)
input from a fixed seed, all-reduces its own row under each config in
``CONFIGS`` and both schemes, and saves the results as
``OUT_DIR/rank{RANK}.npz`` for the test to hold against a single-process
replay with the JAX codec.

MODE ``moe``: the moonshot smoke config's MoE layer at ep = WORLD, each
rank holding its slice of the experts of :func:`moe_params`, on the same
tokens (:func:`moe_input`) everywhere: ``moe_apply`` under the paper
policy with the two_step and the fused dispatch, and with ``ep_slice``.
Then the same layer with 3 experts, which makes ep = 1 and etp = WORLD:
each rank holds its slice of every expert's hidden (key ``etp``).

MODE ``serve``: the qwen3-14b smoke config (float32) at tp = WORLD, each
rank holding its shard of the JAX-initialised weights that
``OUT_DIR/store.npz`` holds (``store/GROUP/NAME`` keys, written by
``tests/test_torch_serve_tp.py``'s JAX side, which runs beside the
ranks, before its own work), on a
:class:`~repro_torch.parallel.axis.ModelAxis` over the gloo group: for
each run of :data:`SERVE_RUNS`, the prefill's hidden states, its greedy
next token over the vocabulary shards, and ``serve``'s decode loop (the
prompt teacher-forced through the cache, then generation). Also the
greedy choice on :func:`tie_logits`, whose two shards tie.

MODE ``serve_llama``: the same for the llama3-8b smoke config.

MODE ``serve_glm4``: the same for the glm4-9b smoke config, whose two kv
heads are replicated at WORLD = 4 (the decode cache a sequence-sharded
ring, :func:`serve_gen` tokens generated), with the ring merges' count
(``attention.RING_MERGES``) a served run and the logits of the decode
steps through the prompt (:func:`decode_logits`).

MODE ``serve_moe``: the same for the moonshot smoke config (float32;
``tests/test_torch_serve_tp_moe.py`` writes its ``jax.npz``), its experts
spread over the ranks (ep = WORLD), with the routes dropped over
capacity at prefill and decode.

MODE ``serve_rec``: the same for the recurrentgemma-2b and xlstm-125m
smoke configs, one after the other (``tests/test_torch_serve_tp_recurrent.
py`` writes ``OUT_DIR/ARCH/store.npz``; each rank saves
``OUT_DIR/ARCH/rank{RANK}.npz``), recurrentgemma's window cut to
:data:`REC_WINDOW` so that the decode's local ring wraps within the
prompt, with the logits of the decode steps through the prompt
(:func:`decode_logits`) for both.

MODE ``serve_xattn``: the same for the whisper-tiny and llama-3.2-vision-11b
smoke configs, each forward given the data stream's ``enc_embeds`` (B,
n_ctx, d_model), with the logits of the decode steps through the prompt
(:func:`decode_logits`) for both; the weights are :func:`numpy_store`'s,
made here (``tests/test_torch_serve_tp_xattn.py`` makes the same for the
JAX side, which runs beside the ranks), and each rank saves its store's
:func:`store_digest`.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.core.collectives import quantized_all_reduce  # noqa: E402
from repro_torch.core.comm_config import CommConfig  # noqa: E402

N = 1024
CONFIGS = {"int8": dict(bits=8, group=128),
           "int5_si": dict(bits=5, group=128, scale_int=True),
           "int2_sr": dict(bits=2, group=32, spike=True)}


def save_npz(path: str, **arrays) -> None:
    """``np.savez`` to ``path`` by a rename, so that a reader never sees
    it half written."""
    tmp = path[:-len(".npz")] + ".part.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def wait_load(path: str, timeout: float = 240):
    """``np.load(path)`` once the JAX side has written it (the JAX side
    runs beside the ranks; a test kills the ranks when it fails)."""
    import time
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.05)
    return np.load(path)


def inputs(world: int) -> np.ndarray:
    rng = np.random.default_rng(2024)
    x = (rng.standard_normal((world, N)) * 2).astype(np.float32)
    x[0, 17] = 30.0
    return x


def moe_config(n_experts: int = 4):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, n_experts=n_experts))


def moe_params(cfg):
    """Layer 1's (the MoE block's) weights at tp = 1, with the zero
    initialised expert output projection filled from a fan-in normal."""
    from repro_torch.models.model import layer_params
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.shardings import init_params
    params = init_params(cfg, make_plan(cfg, tp=1), 0, "cpu", torch.float32)
    p = dict(layer_params(params, cfg)[1][1])
    gen = torch.Generator().manual_seed(1)
    p["moe_w2"] = torch.randn(p["moe_w2"].shape, generator=gen) / \
        p["moe_w2"].shape[-2] ** 0.5
    return p


def moe_input(cfg) -> torch.Tensor:
    rng = np.random.default_rng(31)
    return torch.from_numpy(rng.standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32))


def moe_policies():
    """The ep runs' policies, and the etp run's: the paper's dispatch
    with an exact within-expert AllReduce."""
    import dataclasses
    from repro_torch.core.comm_config import NO_COMPRESSION
    from repro_torch.core.policy import paper_policy, with_scheme
    return {"two_step": paper_policy(),
            "fused": with_scheme(paper_policy(), "fused"),
            "ep_slice": dataclasses.replace(paper_policy(), ep_slice=True),
            "etp": dataclasses.replace(paper_policy(), tp=NO_COMPRESSION)}


def run_moe(rank: int, world: int) -> dict:
    from repro_torch.models.moe import moe_apply
    from repro_torch.parallel.plan import make_plan
    cfg = moe_config()
    plan = make_plan(cfg, tp=world)
    e_loc = plan.moe.e_loc
    p = {k: (v[rank * e_loc:(rank + 1) * e_loc]
             if k in ("moe_w1", "moe_w2", "moe_w3") else v)
         for k, v in moe_params(cfg).items()}
    pols = moe_policies()
    out = {}
    with torch.no_grad():
        for name in ("two_step", "fused", "ep_slice"):
            y, aux = moe_apply(p, moe_input(cfg), cfg, plan,
                               pols[name].bind(cfg.n_layers), layer=1,
                               group=dist.group.WORLD, rank=rank)
            out[name], out[name + "_aux"] = y.numpy(), aux.numpy()
        cfg = moe_config(n_experts=3)
        plan = make_plan(cfg, tp=world)
        f = plan.moe.ef_loc
        hid = {"moe_w1": (2, f), "moe_w3": (2, f), "moe_w2": (1, f)}
        p = {k: (v.narrow(hid[k][0], rank * f, f) if k in hid else v)
             for k, v in moe_params(cfg).items()}
        y, aux = moe_apply(p, moe_input(cfg), cfg, plan,
                           pols["etp"].bind(cfg.n_layers), layer=1,
                           group=dist.group.WORLD, rank=rank)
        out["etp"], out["etp_aux"] = y.numpy(), aux.numpy()
    return out


SERVE_B, SERVE_S, SERVE_GEN = 2, 12, 3
REC_ARCHS = ("recurrentgemma-2b", "xlstm-125m")
XATTN_ARCHS = ("whisper-tiny", "llama-3.2-vision-11b")
#: the modes that serve several archs, one after the other, each in its
#: own ``OUT_DIR/ARCH``
MULTI_MODES = {"serve_rec": REC_ARCHS, "serve_xattn": XATTN_ARCHS}
#: mode serve_rec's local window (the smoke config's 64 cut), shorter
#: than the prompt, so that the decode's local ring wraps
REC_WINDOW = 8
SERVE_RUNS = {"paper/two_step": ("paper", None),
              "paper/fused": ("paper", "fused"),
              "bf16": ("bf16", None)}


SERVE_ARCHS = {"serve": "qwen3-14b", "serve_llama": "llama3-8b",
               "serve_glm4": "glm4-9b", "serve_moe": "moonshot-v1-16b-a3b"}


def numpy_store(groups, plan, seed: int = 7) -> dict:
    """Weights in the JAX package's store layout, ``{group: {name:
    (n_stack, tp, flat_len)}}`` float32, for ``groups`` (either package's
    ``param_groups``: the same names and specs), from a seeded normal: a
    norm gain 1 + 0.05 N, a matrix N / sqrt(fan_in) (``shape[-2]``, as
    JAX's init), any other array (the biases) 0.05 N, so that no array is
    zero; a replicated parameter the same on every rank. Unlike JAX's
    ``build_store`` it compiles nothing."""
    rng = np.random.default_rng(seed)
    out = {}
    for g, (n, specs) in sorted(groups.items()):
        out[g] = {}
        for name, sp in sorted(specs.items()):
            flat = sp.flat_len(plan)
            sliced = sp.tp_dim is not None or sp.moe_fold is not None
            a = rng.standard_normal((n, plan.tp if sliced else 1, flat))
            if sp.init == "ones":
                a = 1.0 + 0.05 * a
            elif len(sp.shape) > 1:
                a = a / np.sqrt(sp.local_shape(plan)[-2])
            else:
                a = 0.05 * a
            out[g][name] = np.broadcast_to(
                a, (n, plan.tp, flat)).astype(np.float32)
    return out


def store_digest(store: dict) -> np.ndarray:
    """Each array's float64 sum, in sorted (group, name) order."""
    return np.array([a.astype(np.float64).sum() for g in sorted(store)
                     for _, a in sorted(store[g].items())])


def serve_gen(plan) -> int:
    """Tokens generated: SERVE_GEN, or in replicate mode the fewest from
    SERVE_GEN up that make the cache (prompt + generated) a multiple of
    tp, which the sequence-sharded ring needs."""
    gen = SERVE_GEN
    while plan.kv_mode == "replicate" and (SERVE_S + gen) % plan.tp:
        gen += 1
    return gen


def serve_config(arch: str = "qwen3-14b"):
    """The smoke config of ``arch`` in float32 (a local window cut to
    :data:`REC_WINDOW`)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, dtype="float32", window=cfg.window
                               and REC_WINDOW)


def tie_logits(rank: int) -> torch.Tensor:
    """A rank's (2, 3) shard: row 0 ties at 5.0 (rank 0's columns 1 and
    2, rank 1's column 0; the first wins: token 1); row 1's maximum is
    rank 1's column 2 (token 5). Ranks from 2 up hold zeros."""
    if rank > 1:
        return torch.zeros(2, 3)
    return torch.tensor([[[0., 5., 5.], [1., 0., 0.]],
                         [[5., 0., 0.], [0., 0., 2.]]])[rank]


def run_serve(rank: int, world: int, out_dir: str,
              arch: str = "qwen3-14b", store=None) -> dict:
    import types
    from repro_torch.launch.serve import build_policy, serve
    from repro_torch.models import attention
    from repro_torch.models.model import forward, greedy_next_token
    from repro_torch.parallel.axis import ModelAxis
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.shardings import load_jax_store
    from repro_torch.train.data import DataConfig, make_dataset
    from repro_torch.train.serve_step import make_prefill
    if store is None:                 # the JAX side writes it first
        data = wait_load(os.path.join(out_dir, "store.npz"))
        store = {}
        for key in data.files:
            if key.startswith("store/"):
                _, g, name = key.split("/")
                store.setdefault(g, {})[name] = data[key]
    cfg = serve_config(arch)
    plan = make_plan(cfg, tp=world)
    params = load_jax_store(store, cfg, plan, "cpu", torch.float32,
                            rank=rank)
    axis = ModelAxis(dist.group.WORLD, rank, world)
    batch = make_dataset(DataConfig(
        vocab=cfg.vocab, seq_len=SERVE_S, global_batch=SERVE_B,
        enc_ctx=cfg.encoder.n_ctx if cfg.has_cross else None,
        d_model=cfg.d_model)).batch(0)
    toks = torch.from_numpy(batch["tokens"])
    emb = (torch.from_numpy(batch["enc_embeds"]) if "enc_embeds" in batch
           else None)
    out = {"tie": greedy_next_token(
        tie_logits(rank), types.SimpleNamespace(tp=world, v_loc=3),
        axis).numpy()}
    with torch.no_grad():
        for name, (pol, scheme) in SERVE_RUNS.items():
            policy = build_policy(pol, scheme=scheme)
            out[f"{name}/hidden"] = forward(
                params, toks, cfg, plan, policy, dtype=torch.float32,
                group=axis, enc_embeds=emb)[0].numpy()
            out[f"{name}/token"] = greedy_next_token(
                make_prefill(cfg, plan, policy, group=axis)(params, toks,
                                                            emb),
                plan, axis).numpy()
            attention.reset_ring_merges()
            res = serve(params, cfg, plan, policy, batch=SERVE_B,
                        prompt_len=SERVE_S, gen=serve_gen(plan),
                        device=torch.device("cpu"), log=lambda *a: None,
                        group=axis)
            out[f"{name}/generated"] = res["generated"]
            out[f"{name}/ring_merges"] = np.array(attention.RING_MERGES)
            if (plan.kv_mode == "replicate"
                    or arch in REC_ARCHS + XATTN_ARCHS):
                out[f"{name}/decode_logits"] = decode_logits(
                    params, cfg, plan, policy, axis, toks, emb)
            if cfg.moe is not None:
                out[f"{name}/dropped"] = np.array(
                    [res["dropped_prefill"], res["dropped_decode"]])
    return out


def decode_logits(params, cfg, plan, policy, axis, toks,
                  emb=None) -> np.ndarray:
    """The decode steps through the prompt ``toks`` (B, S) (each given
    the encoder's embeddings ``emb``, if any) -> the logits after each
    position over the whole vocabulary (B, S, vocab)."""
    from repro_torch.core.collectives import all_gather_rows
    from repro_torch.train.serve_step import (make_cache_init,
                                              make_decode_step)
    b, s = toks.shape
    step = make_decode_step(cfg, plan, policy, group=axis)
    caches = make_cache_init(cfg, plan, b, s + serve_gen(plan), "cpu")()
    out = []
    for i in range(s):
        logits, caches = step(params, caches, toks[:, i:i + 1], emb)
        full = all_gather_rows(logits, axis).transpose(0, 1).reshape(b, -1)
        out.append(full[:, :cfg.vocab].numpy())
    return np.stack(out, 1)


def run_allreduce(rank: int, world: int) -> dict:
    x = torch.from_numpy(inputs(world)[rank])
    out = {}
    for name, kw in CONFIGS.items():
        for scheme in ("two_step", "fused"):
            cfg = CommConfig(scheme=scheme, **kw)
            out[f"{name}_{scheme}"] = quantized_all_reduce(
                x, cfg, dist.group.WORLD).numpy()
    return out


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, out_dir = sys.argv[3], sys.argv[4]
    mode = sys.argv[5] if len(sys.argv) > 5 else "allreduce"
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        if mode in MULTI_MODES:
            for arch in MULTI_MODES[mode]:
                d = os.path.join(out_dir, arch)
                store, extra = None, {}
                if mode == "serve_xattn":
                    from repro_torch.models.model import param_groups
                    from repro_torch.parallel.plan import make_plan
                    cfg = serve_config(arch)
                    plan = make_plan(cfg, tp=world)
                    store = numpy_store(param_groups(cfg, plan), plan)
                    extra["store_digest"] = store_digest(store)
                    os.makedirs(d, exist_ok=True)
                np.savez(os.path.join(d, f"rank{rank}.npz"),
                         **run_serve(rank, world, d, arch, store), **extra)
            return
        if mode == "moe":
            out = run_moe(rank, world)
        elif mode in SERVE_ARCHS:
            out = run_serve(rank, world, out_dir, SERVE_ARCHS[mode])
        else:
            out = run_allreduce(rank, world)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
