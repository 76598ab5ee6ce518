"""One rank of a gloo run of the port's quantized AllReduce.

    python tests/_torch_gloo_worker.py RANK WORLD INIT_FILE OUT_DIR

Every rank draws the same (WORLD, N) input from a fixed seed, all-reduces
its own row under each config in ``CONFIGS`` and both schemes, and saves
the results as ``OUT_DIR/rank{RANK}.npz`` for the test to hold against a
single-process replay with the JAX codec.
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


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, out_dir = sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        x = torch.from_numpy(inputs(world)[rank])
        out = {}
        for name, kw in CONFIGS.items():
            for scheme in ("two_step", "fused"):
                cfg = CommConfig(scheme=scheme, **kw)
                out[f"{name}_{scheme}"] = quantized_all_reduce(
                    x, cfg, dist.group.WORLD).numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
