"""One rank of the port's data-parallel serving on gloo.

    python tests/_torch_dp_worker.py RANK DATA MODEL INIT_FILE OUT_DIR

The qwen3-14b smoke config (float32) at ``--mesh DATA,MODEL``: the rank
joins the mesh with :func:`repro_torch.launch.mesh.init_mesh` (the
launcher's own), loads its shard of the flat store that
:func:`_torch_gloo_worker.numpy_store` makes for the plan (``fsdp =
DATA``, the JAX package's layout, the same in every process) and, under
each policy of :data:`POLICIES`, saves its replica's prefill hidden
states (``forward`` on the store, every block group gathered over the
data axis), the greedy next tokens, and ``serve``'s decode loop (the
global batch's first and generated tokens, gathered over the data axis).
At ``MODEL == 1`` it also serves its replica's rows alone from the
resident weights (the ``--mesh 1,1`` road): the prefill logits and the
decode steps' logits through the prompt on both roads (key ``alone/``).
At ``DATA == 2`` a batch of :data:`ODD_B` rows (which the data axis
does not divide: every replica serves all of them) is served too (key
``odd/``). Each rank writes ``OUT_DIR/rank{RANK}.npz``.
"""
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
sys.path.insert(0, HERE)

import _torch_gloo_worker as gw  # noqa: E402

ARCH = "qwen3-14b"
B, S, GEN = 4, 8, 3
ODD_B = 3
POLICIES = ("paper", "aggressive")


def config():
    return gw.serve_config(ARCH)


def batch(b: int = B):
    from repro_torch.train.data import DataConfig, make_dataset
    cfg = config()
    return make_dataset(DataConfig(vocab=cfg.vocab, seq_len=S,
                                   global_batch=b)).batch(0)["tokens"]


def _decode_logits(params, cfg, plan, policy, toks, axes, flat):
    """The decode steps through the prompt ``toks`` (B_loc, S) -> the
    logits over the whole vocabulary after each position (B_loc, S,
    vocab)."""
    from repro_torch.core.collectives import all_gather_rows
    from repro_torch.train.serve_step import (make_cache_init,
                                              make_decode_step)
    b, s = toks.shape
    step = make_decode_step(cfg, plan, policy, group=axes.model,
                            data_group=axes.data if flat else None,
                            flat=flat)
    caches = make_cache_init(cfg, plan, b, s, "cpu")()
    out = []
    for i in range(s):
        logits, caches = step(params, caches, toks[:, i:i + 1])
        if axes.model is not None:
            logits = all_gather_rows(logits, axes.model).transpose(
                0, 1).reshape(b, -1)
        out.append(logits[:, :cfg.vocab].numpy())
    return np.stack(out, 1)


def run(rank: int, data: int, model: int, init_file: str) -> dict:
    from repro_torch.launch import mesh
    from repro_torch.launch.serve import build_policy, serve
    from repro_torch.models.model import (forward, greedy_next_token,
                                          param_groups)
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.shardings import load_jax_store
    from repro_torch.train.serve_step import local_rows, make_prefill
    cfg = config()
    plan = make_plan(cfg, tp=model, fsdp=data)
    _, d, m = mesh.mesh_coord(rank, data, model)
    axes = mesh.init_mesh(data, model, 0, rank, init_file,
                          torch.device("cpu"),
                          mesh.site_row_bytes(cfg, plan, B, S))
    out = {}
    try:
        store_np = gw.numpy_store(param_groups(cfg, plan), plan)
        store = load_jax_store(store_np, cfg, plan, "cpu", torch.float32,
                               rank=m, data_rank=d)
        toks = torch.from_numpy(batch())
        mine = toks[local_rows(B, axes.data)]
        kw = dict(group=axes.model, data_group=axes.data)
        with torch.no_grad():
            for name in POLICIES:
                policy = build_policy(name)
                out[f"{name}/hidden"] = forward(
                    store, mine, cfg, plan, policy, dtype=torch.float32,
                    flat=True, **kw)[0].numpy()
                out[f"{name}/token"] = greedy_next_token(
                    make_prefill(cfg, plan, policy, **kw)(store, mine),
                    plan, axes.model).numpy()
                res = serve(store, cfg, plan, policy, batch=B, prompt_len=S,
                            gen=GEN, device=torch.device("cpu"),
                            log=lambda *a: None, **kw)
                out[f"{name}/first"] = res["first_tokens"]
                out[f"{name}/generated"] = res["generated"]
            if model == 1:
                policy = build_policy("paper")
                params = load_jax_store(store_np, cfg, plan, "cpu",
                                        torch.float32)
                for road, w, flat in (("dp", store, True),
                                      ("alone", params, False)):
                    prefill = make_prefill(
                        cfg, plan, policy, flat=flat,
                        data_group=axes.data if flat else None)
                    out[f"alone/{road}/prefill"] = prefill(w, mine).numpy()
                    out[f"alone/{road}/decode"] = _decode_logits(
                        w, cfg, plan, policy, mine, axes, flat)
            if data == 2 and model == 1:
                policy = build_policy("paper")
                odd = torch.from_numpy(batch(ODD_B))
                rows = local_rows(ODD_B, axes.data)
                out["odd/rows"] = np.array([rows.start, rows.stop])
                out["odd/hidden"] = forward(
                    store, odd[rows], cfg, plan, policy,
                    dtype=torch.float32, flat=True, **kw)[0].numpy()
                out["odd/generated"] = serve(
                    store, cfg, plan, policy, batch=ODD_B, prompt_len=S,
                    gen=GEN, device=torch.device("cpu"),
                    log=lambda *a: None, **kw)["generated"]
    finally:
        mesh.close_mesh(axes)
    return out


def main():
    rank, data, model = (int(v) for v in sys.argv[1:4])
    init_file, out_dir = sys.argv[4:6]
    out = run(rank, data, model, init_file)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
