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
        out = run_moe(rank, world) if mode == "moe" else \
            run_allreduce(rank, world)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
