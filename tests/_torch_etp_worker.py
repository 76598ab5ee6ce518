"""Rank processes for the MoE config whose experts are both spread and
sharded over the ranks: ep = 2, etp = 2 at tp = 4.

    python tests/_torch_etp_worker.py serve RANK WORLD INIT_FILE OUT_DIR
    python tests/_torch_etp_worker.py train ARGS...

The config is grok-1's smoke config with 2 experts (so that
``gcd(2, 4)`` gives ep = 2, etp = 2), 4 kv heads (sharded at tp = 4,
where JAX's decode is sound; its replicated-kv decode is not) and
capacity factor 0.5 (two experts at top-2 take every token twice, so at
the smoke's 1.25 no queue ever overflows; at 0.5 the capacity drops
routes at prefill and decode). :func:`etp_config` builds it from either
package's smoke config, so that both run the same model.

``serve``: one rank of ``tests/test_torch_serve_moe_etp.py``. It joins
the mesh (``launch/mesh.py::init_mesh`` with the plan's MoE subgroups,
gloo), loads its shard of the JAX-initialised weights that
``OUT_DIR/store.npz`` holds (``store/GROUP/NAME``; the JAX side, which
runs beside the ranks, writes it before its own work), and for each run of
:data:`RUNS` saves the prefill's hidden states and the routes it dropped,
serve's generated tokens and dropped routes, and (for :data:`DECODED`)
the logits of the decode steps through the prompt, as
``OUT_DIR/rank{RANK}.npz``, with the ranks of its ep and etp subgroups.

``train``: one process of ``tests/_torch_train_worker.py`` (its own
arguments follow), for :data:`ARCH` with :func:`etp_config` applied in
both packages, :data:`TRAIN_STEPS` steps, and the port's mesh built with
the plan's MoE subgroups.
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
sys.path.insert(0, HERE)

ARCH = "grok-1-314b"
TP = 4
TRAIN_STEPS = 2
#: run -> (policy, scheme)
RUNS = {"paper/two_step": ("paper", None),
        "paper/fused": ("paper", "fused"),
        "aggressive": ("aggressive", None),
        "bf16": ("bf16", None)}
#: the runs whose decode steps through the prompt are saved
DECODED = ("paper/two_step", "bf16")
B, S, GEN = 2, 12, 3


def etp_config(cfg):
    """A grok-1 smoke config (either package's) -> the float32 config run
    here (see the module docstring)."""
    return dataclasses.replace(
        cfg, dtype="float32", n_kv_heads=4, moe=dataclasses.replace(
            cfg.moe, n_experts=2, capacity_factor=0.5))


def prompts() -> np.ndarray:
    from repro_torch.train.data import DataConfig, make_dataset
    return make_dataset(DataConfig(vocab=512, seq_len=S,
                                   global_batch=B)).batch(0)["tokens"]


def _decode_logits(params, cfg, plan, policy, axis, toks) -> np.ndarray:
    """The decode steps through the prompt ``toks`` (B, S) -> the logits
    after each position over the whole vocabulary (B, S, vocab)."""
    from repro_torch.core.collectives import all_gather_rows
    from repro_torch.train.serve_step import (make_cache_init,
                                              make_decode_step)
    step = make_decode_step(cfg, plan, policy, group=axis)
    caches = make_cache_init(cfg, plan, B, S + GEN, "cpu")()
    out = []
    for i in range(S):
        logits, caches = step(params, caches, toks[:, i:i + 1])
        full = all_gather_rows(logits, axis).transpose(0, 1).reshape(B, -1)
        out.append(full[:, :cfg.vocab].numpy())
    return np.stack(out, 1)


def run_serve(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import build_policy, serve
    from repro_torch.models.model import forward
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.shardings import load_jax_store
    from _torch_train_worker import read_store, wait_load
    cfg = etp_config(get_smoke_config(ARCH))
    plan = make_plan(cfg, tp=world)
    cpu = torch.device("cpu")
    mesh = mesh_lib.init_mesh(1, world, 0, rank, init_file, cpu, 0,
                              plan.moe)
    axis = mesh.model
    try:
        params = load_jax_store(read_store(wait_load(
            os.path.join(out_dir, "store.npz"))), cfg, plan, cpu,
            torch.float32, rank=rank)
        toks = torch.from_numpy(prompts())
        out = {"ep_ranks": np.array(dist.get_process_group_ranks(
                   axis.ep.pg)),
               "etp_ranks": np.array(dist.get_process_group_ranks(
                   axis.etp.pg)),
               "sub_index": np.array([axis.ep.rank, axis.etp.rank])}
        with torch.no_grad():
            for name, (pol, scheme) in RUNS.items():
                policy = build_policy(pol, scheme=scheme)
                stats = {}
                out[f"{name}/hidden"] = forward(
                    params, toks, cfg, plan, policy, dtype=torch.float32,
                    group=axis, stats=stats)[0].numpy()
                out[f"{name}/prefill_dropped"] = np.array(
                    int(stats["dropped"]))
                res = serve(params, cfg, plan, policy, batch=B,
                            prompt_len=S, gen=GEN, device=cpu,
                            log=lambda *a: None, group=axis)
                out[f"{name}/generated"] = res["generated"]
                out[f"{name}/dropped"] = np.array(
                    [res["dropped_prefill"], res["dropped_decode"]])
                if name in DECODED:
                    out[f"{name}/decode_logits"] = _decode_logits(
                        params, cfg, plan, policy, axis, toks)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        mesh_lib.close_mesh(mesh)


def run_train(argv) -> None:
    """``tests/_torch_train_worker.py``'s main on ``argv``, for
    :func:`etp_config`'s model in both packages, :data:`TRAIN_STEPS`
    steps, and ``init_mesh`` given the plan's MoE subgroups."""
    import _torch_train_worker as tw
    tw.STEPS = TRAIN_STEPS
    for name in ("repro.configs", "repro_torch.configs"):
        if name == "repro.configs" and argv[0] != "jax":
            continue
        mod = __import__(name, fromlist=["get_smoke_config"])
        mod.get_smoke_config = functools.partial(
            lambda get, arch: etp_config(get(arch)), mod.get_smoke_config)
    if argv[0] != "jax":
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.parallel.plan import make_plan
        model = mesh_lib.parse_train_mesh(argv[1])[1]
        moe = make_plan(get_smoke_config(ARCH), tp=model).moe
        mesh_lib.init_mesh = functools.partial(mesh_lib.init_mesh, moe=moe)
    sys.argv = [tw.__file__] + list(argv)
    tw.main()


def main():
    mode = sys.argv[1]
    if mode == "serve":
        import torch.distributed as dist  # noqa: F401
        run_serve(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
    else:
        run_train(sys.argv[2:])


if __name__ == "__main__":
    main()
