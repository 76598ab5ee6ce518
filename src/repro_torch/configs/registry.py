"""Architecture registry: full configs, reduced smoke variants, and the
per-(arch, shape) lowering plans (mode, window override, skips).

Every architecture of the JAX package's registry; the lowering plans are
the JAX package's, field for field.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

ARCH_IDS = ("qwen3-14b", "moonshot-v1-16b-a3b", "llama3-8b", "glm4-9b",
            "command-r-35b", "grok-1-314b", "llama4-maverick-400b-a17b",
            "recurrentgemma-2b", "xlstm-125m", "whisper-tiny",
            "llama-3.2-vision-11b")

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}"
                                   ).config()


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family variant (2 layers, narrow widths)."""
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}"
                                   ).smoke_config()


# ---------------------------------------------------------------------------
# per-(arch, shape) lowering plan
# ---------------------------------------------------------------------------

# long_500k needs sub-quadratic attention. SSM/hybrid archs run natively;
# full-attention archs run the sliding-window decode variant (ring-buffer
# KV cache, window 8192). whisper-tiny's decoder is positional-capped by
# construction, so long_500k is skipped for it.
LONG_WINDOW = 8192

NATIVE_SUBQUADRATIC = {"recurrentgemma-2b", "xlstm-125m"}


@dataclasses.dataclass(frozen=True)
class LoweringPlan:
    arch: str
    shape: InputShape
    mode: str                       # train | prefill | decode
    window_override: Optional[int]  # sliding-window variant for attn
    cache_len: int                  # decode KV/ring length
    n_micro: int                    # grad-accum microbatches (train)
    skip: Optional[str] = None      # reason, when not lowered
    variant: str = "native"         # native | sliding_window
    # fsdp ways of the param store at this shape: serving keeps weights
    # resident (fsdp = 1) when the TP-local weights are small; giant MoEs
    # stay ZeRO-sharded and rely on the (optionally quantized) gather
    fsdp: int = 16


def lowering_plan(arch: str, shape_name: str) -> LoweringPlan:
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch)
    window = None
    variant = "native"
    skip = None
    cache_len = shape.seq_len
    n_micro = 1

    if shape_name == "long_500k":
        if arch == "whisper-tiny":
            skip = ("decoder is positional-capped (448 abs positions by "
                    "construction); 524k decode is meaningless for the "
                    "family — documented skip in DESIGN.md")
        elif arch in NATIVE_SUBQUADRATIC:
            # recurrent state is O(1); local-attn layers already windowed
            cache_len = min(cfg.window or LONG_WINDOW, shape.seq_len)
        else:
            window = LONG_WINDOW
            variant = "sliding_window"
            cache_len = LONG_WINDOW
    elif shape.mode == "decode":
        cache_len = shape.seq_len
        if arch in NATIVE_SUBQUADRATIC:
            cache_len = min(cfg.window or shape.seq_len, shape.seq_len)

    if shape.mode == "train":
        # keep per-rank activation memory bounded for the largest models
        big = {"grok-1-314b": 8, "llama4-maverick-400b-a17b": 4,
               "command-r-35b": 2, "qwen3-14b": 2,
               "llama-3.2-vision-11b": 2}
        n_micro = big.get(arch, 1)
    if shape.mode == "prefill":
        big = {"grok-1-314b": 2}
        n_micro = big.get(arch, 1)

    fsdp = 16
    if shape.mode in ("decode", "prefill"):
        tp_local_bytes = cfg.param_count() * 2 / 16
        if tp_local_bytes <= 8e9:
            fsdp = 1
    return LoweringPlan(arch=arch, shape=shape, mode=shape.mode,
                        window_override=window, cache_len=cache_len,
                        n_micro=n_micro, skip=skip, variant=variant,
                        fsdp=fsdp)


def all_pairs():
    """Every (arch, shape name) the plans cover: each arch but the paper's
    own model (llama3-8b, measured on its own) at every input shape."""
    for arch in ARCH_IDS:
        if arch == "llama3-8b":
            continue
        for shape in INPUT_SHAPES:
            yield arch, shape
