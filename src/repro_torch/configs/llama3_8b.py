"""llama3-8b: the paper's own evaluation model (Tables 1/3/7, Figs 1-2):
32L d4096 32H (GQA kv=8) d_ff=14336 v=128256. [meta-llama/Meta-Llama-3-8B]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256, head_dim=128,
        pattern=("dense",), pattern_repeats=32,
        act="swiglu", norm="rms", rope_theta=500000.0,
        source="hf:meta-llama/Meta-Llama-3-8B")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-smoke", d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, head_dim=64,
        pattern=("dense",), pattern_repeats=2,
        act="swiglu", norm="rms", rope_theta=500000.0)
